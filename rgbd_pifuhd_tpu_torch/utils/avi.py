"""Motion-JPEG AVI files written and read with the standard library: the
port's turntable videos, without OpenCV's ``VideoWriter``.

``write_mjpeg_avi`` writes a RIFF ``AVI `` file of one video stream: an
``hdrl`` list (``avih`` main header, one ``strl`` with ``strh`` and a
``BITMAPINFOHEADER`` ``strf``, handler and compression ``MJPG``), a
``movi`` list with one ``00dc`` chunk per frame (a whole JPEG file), and an
``idx1`` index (every frame a key frame, offsets from the ``movi`` tag).
``read_avi`` returns the stream's frame rate, size and the frame chunks.
"""

from __future__ import annotations

import struct

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    pad = b"\x00" if len(body) % 2 else b""
    return fourcc + struct.pack("<I", len(body)) + body + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def write_mjpeg_avi(path: str, frames, width: int, height: int,
                    fps: int) -> int:
    """Write ``frames`` (an iterable of JPEG files' bytes) as an MJPG AVI;
    returns the number of frames."""
    movi, index = [], []
    offset = 4                      # past the 'movi' tag
    for jpg in frames:
        index.append(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME, offset,
                                 len(jpg)))
        c = _chunk(b"00dc", jpg)
        movi.append(c)
        offset += len(c)
    n = len(movi)
    biggest = max((len(c) - 8 for c in movi), default=0)
    avih = struct.pack("<10I4I", round(1e6 / fps), biggest * fps, 0,
                       AVIF_HASINDEX, n, 0, 1, biggest, width, height,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0,
                       0, 1, fps, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0,
                       width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return n


def read_avi(path: str) -> dict:
    """``{"fps", "width", "height", "frames": [bytes, ...]}`` of an AVI's
    first video stream (its ``00dc`` chunks in ``movi`` order)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    out = {"fps": None, "width": None, "height": None, "frames": []}

    def walk(pos: int, end: int, in_movi: bool) -> None:
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
            body = pos + 8
            if fourcc == b"LIST":
                walk(body + 4, body + size, data[body:body + 4] == b"movi")
            elif fourcc == b"strh" and out["fps"] is None:
                scale, rate = struct.unpack("<II", data[body + 20:body + 28])
                out["fps"] = rate / scale
            elif fourcc == b"avih":
                out["width"], out["height"] = struct.unpack(
                    "<II", data[body + 32:body + 40])
            elif in_movi and fourcc == b"00dc":
                out["frames"].append(data[body:body + size])
            pos = body + size + (size & 1)

    walk(12, len(data), False)
    return out
