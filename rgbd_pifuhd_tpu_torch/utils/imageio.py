"""``cv2.imread(path)`` without OpenCV: the file's format is told from its
first bytes, as OpenCV tells it, and PNG and JPEG go to the port's own
decoders (``utils/png.py``, ``utils/jpeg.py``).

``imread_rgb8`` returns ``[H, W, 3]`` uint8 in RGB order (the pixels
``cv2.imread`` gives, channels reversed), or ``None`` where OpenCV finds
no decoder for the file (unknown bytes, an empty file, a missing path).
A format that OpenCV reads but the port does not decode (BMP, TIFF, WebP,
GIF, ...) raises ``ValueError`` naming it; so does a damaged PNG or JPEG
(where OpenCV may return ``None`` or the part it could decode).
"""

from __future__ import annotations

import os

import numpy as np

from . import jpeg, png

# leading bytes of the formats OpenCV's imgcodecs reads that the port does
# not decode -> the name the error gives
_OTHER_FORMATS = (
    (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
    (b"GIF8", "GIF"), (b"#?", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", "Sun raster"), (b"\x76\x2f\x31\x01", "OpenEXR"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"\xff\x4f\xff\x51",
                                             "JPEG 2000"),
)


def image_format(head: bytes) -> str | None:
    """The format name of a file's first 16 bytes, or ``None``."""
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:8] == b"ftyp" and head[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if len(head) > 2 and head[:1] == b"P" and head[1:2] in \
            b"1234567fF" and head[2:3].isspace():
        return "PNM/PAM/PFM"
    for magic, name in _OTHER_FORMATS:
        if head.startswith(magic):
            return name
    return None


def imread_rgb8(path: str) -> np.ndarray | None:
    """``cv2.imread(path)`` (``IMREAD_COLOR``) in RGB order, or ``None``."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        head = f.read(16)
    kind = image_format(head)
    if kind == "PNG":
        return png.read_rgb8(path)
    if kind == "JPEG":
        return jpeg.read_rgb8(path)
    if kind is not None:
        raise ValueError(f"{path}: {kind} images are not decoded by this "
                         "package (PNG and JPEG are)")
    return None
