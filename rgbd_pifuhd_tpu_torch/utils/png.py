"""PNG files read and written with the standard library (``zlib``) and
NumPy: the port decodes subjects without OpenCV or PIL.

Read: non-interlaced gray, gray + alpha, RGB and RGBA at 8 and 16 bits,
gray at 1, 2 and 4 bits (scaled to 8 as libpng expands it), and palette
images at 1-8 bits (expanded to RGB; a ``tRNS`` chunk is ignored, as
``cv2.imread`` drops alpha), all five scanline filters.  Write: 8-bit gray
or RGB (filter 0).  Adam7 interlacing raises ``ValueError`` naming the
limit.  ``read_rgb8`` returns what ``cv2.imread(path)`` (``IMREAD_COLOR``)
returns, in RGB order: three 8-bit channels, gray replicated, alpha
dropped, 16-bit samples cut to their high byte.

Filters 0-2 (none, sub, up) are undone with whole-row NumPy operations;
average and Paeth carry a dependency from pixel to pixel and run a Python
loop per byte of the row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: ``raw`` holds ``height`` rows of one
    filter byte + ``stride`` data bytes; ``bpp`` bytes per pixel."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ft = int(rows[y, 0])
        line = rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:       # sub: a running sum per byte lane of a pixel
            cur = np.empty(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        elif ft == 2:       # up
            cur = line + prev
        elif ft in (3, 4):
            cur = _unfilter_serial(ft, line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"PNG filter type {ft} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_serial(ft: int, line: bytes, prev: bytes,
                     bpp: int) -> np.ndarray:
    cur = bytearray(len(line))
    if ft == 3:             # average of left and up
        for i, v in enumerate(line):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (v + ((left + prev[i]) >> 1)) & 255
    else:                   # Paeth
        for i, v in enumerate(line):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (v + pred) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def _unpack_bits(px: np.ndarray, w: int, depth: int) -> np.ndarray:
    """Rows of packed 1/2/4-bit samples (most significant first) ->
    ``[H, w]`` uint8 sample values."""
    bits = np.unpackbits(px, axis=1).reshape(px.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w]


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: ``[H, W]`` (gray) or ``[H, W, C]``, uint8, or uint16
    at 16 bits; palette images come back as ``[H, W, 3]`` RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    header = None
    idat = []
    palette = None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    valid = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
             6: (8, 16)}
    if depth not in valid.get(ctype, ()):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits "
                         "is not defined")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: PNG colour type 3 (palette) without a "
                         "PLTE chunk")
    ch = _CHANNELS.get(ctype, 1)
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if depth < 8:
        px = _unpack_bits(px, w, depth)
        if ctype == 0:      # libpng's expand_gray_1_2_4_to_8
            return px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        idx = px.reshape(h, w)
        return palette[np.minimum(idx, len(palette) - 1)]
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def read_rgb8(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB, converted as ``cv2.imread`` converts."""
    a = read_png(path)
    if a.dtype == np.uint16:
        a = (a >> 8).astype(np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.shape[2] in (1, 2):        # gray (+ alpha)
        return np.repeat(a[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(a[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 3) -> None:
    """Write ``[H, W]`` gray or ``[H, W, 3]`` RGB uint8."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2
                                   or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError("write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + w * (1 if a.ndim == 2 else 3)), np.uint8)
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))
