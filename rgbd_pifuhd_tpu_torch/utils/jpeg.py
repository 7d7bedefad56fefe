"""Baseline JPEG files decoded with the standard library and NumPy: the
port reads JPEG subjects without OpenCV or PIL.

``read_rgb8(path)`` returns what ``cv2.imread(path)`` (``IMREAD_COLOR``)
returns, in RGB order: ``[H, W, 3]`` uint8, grey replicated, the EXIF
orientation applied.  OpenCV decodes through libjpeg(-turbo), and this
module repeats its arithmetic step for step so that the pixels are the
same:

- Huffman decoding of a sequential (baseline or extended) 8-bit scan, one
  or more scans, interleaved or not, with restart markers;
- dequantisation and the integer "islow" IDCT (``jidctint.c``: 13-bit
  constants, 2 extra bits between the passes, the post-IDCT range-limit
  table with its wrap-around);
- "fancy" upsampling of 4:2:2 (h2v1) and 4:2:0 (h2v2) chroma: the
  triangle filter with libjpeg's rounding biases, edge samples replicated;
- fixed-point YCbCr -> RGB (``jdcolor.c``: 16-bit tables).

Progressive, arithmetic-coded, lossless, 12-bit and CMYK files, and other
chroma sampling, raise ``ValueError`` naming the limit.

Huffman decoding is a Python loop over the symbols (a 16-bit lookup table
per code); everything after it runs on whole NumPy arrays.

``encode`` / ``write_jpeg`` write a baseline 4:2:0 file with OpenCV's
defaults, byte for byte what ``cv2.imwrite`` writes (libjpeg-turbo's
fixed-point colour conversion and downsampling, islow forward DCT,
reciprocal quantiser, standard Huffman tables, JFIF header), whole-array
NumPy throughout.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC1: None, 0xC0: None, 0xC2: "progressive",
              0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential",
              0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


class _Huffman:
    """A DHT table as one lookup list over the next 16 bits of the stream:
    ``(code length << 8) | symbol``, 0 where no code starts."""

    def __init__(self, counts, symbols):
        lut = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
                code += 1
                k += 1
            code <<= 1
        self.lut = lut


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


def _scan_end(data: bytes, pos: int) -> int:
    """Index of the first marker after entropy-coded data at ``pos`` that
    is not a restart marker or a stuffed zero."""
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            return n
        m = data[i + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos = i + 1 if m == 0xFF else i + 2
            continue
        return i


def _restart_segments(ecs: bytes) -> list:
    """Split entropy-coded data at its RSTn markers, unstuffed, each padded
    with zero bytes so the bit reader may look past its end."""
    out, start, pos = [], 0, 0
    while True:
        i = ecs.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(ecs):
            break
        if 0xD0 <= ecs[i + 1] <= 0xD7:
            out.append(_unstuff(ecs[start:i]) + b"\x00" * 8)
            start = pos = i + 2
        else:
            pos = i + 2
    out.append(_unstuff(ecs[start:]) + b"\x00" * 8)
    return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _decode_scan(segments, comps, scan, mcux, mcuy, restart, coefs,
                 dc_tabs, ac_tabs, hmax, vmax, width, height):
    """Huffman-decode one sequential scan into ``coefs`` (per component a
    flat list of 64 coefficients per block, in natural order)."""
    scomps = [(comps[cid], dc_tabs[td].lut, ac_tabs[ta].lut)
              for cid, td, ta in scan]
    if len(scomps) == 1:
        c = scomps[0][0]
        bw = _ceil(_ceil(width * c.h, hmax), 8)
        bh = _ceil(_ceil(height * c.v, vmax), 8)
        units = [[(c.id, by * c.bw + bx)] for by in range(bh)
                 for bx in range(bw)]
    else:
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                units.append([(c.id, (my * c.v + y) * c.bw + mx * c.h + x)
                              for c, _, _ in scomps
                              for y in range(c.v) for x in range(c.h)])
    tables = {c.id: (dc, ac) for c, dc, ac in scomps}
    per = restart or len(units)
    if -(-len(units) // per) > len(segments):
        raise ValueError("JPEG scan ends before its last restart interval")
    for s in range(-(-len(units) // per)):
        data = segments[s]
        p = 0
        pred = {cid: 0 for cid in tables}
        for unit in units[s * per:(s + 1) * per]:
            for cid, blk in unit:
                dc, ac = tables[cid]
                out = coefs[cid]
                base = blk * 64
                q = p >> 3
                w = int.from_bytes(data[q:q + 5], "big") << (p & 7)
                e = dc[(w >> 24) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data (bad Huffman code)")
                ln, t = e >> 8, e & 0xFF
                diff = 0
                if t:
                    diff = (w >> (40 - ln - t)) & ((1 << t) - 1)
                    if diff < (1 << (t - 1)):
                        diff -= (1 << t) - 1
                p += ln + t
                pred[cid] += diff
                out[base] = pred[cid]
                k = 1
                while k < 64:
                    q = p >> 3
                    w = int.from_bytes(data[q:q + 5], "big") << (p & 7)
                    e = ac[(w >> 24) & 0xFFFF]
                    if not e:
                        raise ValueError(
                            "corrupt JPEG data (bad Huffman code)")
                    ln, rs = e >> 8, e & 0xFF
                    r, t = rs >> 4, rs & 15
                    if t == 0:
                        p += ln
                        if r != 15:
                            break
                        k += 16
                        continue
                    k += r
                    v = (w >> (40 - ln - t)) & ((1 << t) - 1)
                    if v < (1 << (t - 1)):
                        v -= (1 << t) - 1
                    p += ln + t
                    if k < 64:
                        out[base + _ZIGZAG_LIST[k]] = v
                    k += 1


_ZIGZAG_LIST = _ZIGZAG.tolist()

# jidctint.c constants (13 fractional bits)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7, shift):
    """One pass of ``jpeg_idct_islow`` over int64 arrays (the eight inputs
    of a column or a row); returns the eight outputs descaled by
    ``shift``."""
    z1 = (s2 + s6) * _F0541
    tmp2 = z1 + s6 * -_F1847
    tmp3 = z1 + s2 * _F0765
    tmp0 = (s0 + s4) << _CONST_BITS
    tmp1 = (s0 - s4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift),
            _descale(tmp12 + t1, shift), _descale(tmp13 + t0, shift),
            _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
            _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift)]


def _post_idct_table() -> np.ndarray:
    """libjpeg's range limit after the IDCT, indexed by ``x & 1023``:
    ``x + 128`` clamped to [0, 255] for |x| < 512, wrapping beyond."""
    i = np.arange(1024)
    t = np.where(i < 128, i + 128, 255)
    t = np.where(i >= 512, 0, t)
    t = np.where(i >= 896, i - 896, t)
    return t.astype(np.uint8)


_RANGE = _post_idct_table()


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """``[N, 64]`` dequantised coefficients (natural order) -> ``[N, 8, 8]``
    uint8 samples, exactly as libjpeg's ``jpeg_idct_islow``."""
    c = blocks.astype(np.int64).reshape(-1, 8, 8)
    cols = _idct_1d(*[c[:, k, :] for k in range(8)],
                    _CONST_BITS - _PASS1_BITS)     # each [N, 8]: row k
    ws = np.stack(cols, axis=1)                     # [N, row, col]
    rows = _idct_1d(*[ws[:, :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2)                          # [N, row, col]
    return _RANGE[out & 1023]


def _fancy_h2v1(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample``: each sample -> two, 3/4 nearer + 1/4
    further, rounding biases +1 (left) and +2 (right), edges copied."""
    x = x.astype(np.int32)
    h, w = x.shape
    out = np.empty((h, 2 * w), np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out[:, 0::2] = (x * 3 + left + 1) >> 2
    out[:, 1::2] = (x * 3 + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: triangle filter in both directions (9/16,
    3/16, 3/16, 1/16) on column sums of the nearer row x3 + the further
    row, rounding biases +8 / +7, edge rows and columns replicated."""
    x = x.astype(np.int32)
    h, w = x.shape
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * h, 2 * w), np.int32)
    for r, other in ((0, above), (1, below)):
        cs = x * 3 + other                                # column sums
        last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        o = out[r::2]
        o[:, 0::2] = (cs * 3 + last + 8) >> 4
        o[:, 1::2] = (cs * 3 + nxt + 7) >> 4
        o[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        o[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``ycc_rgb_convert`` with libjpeg's 16-bit fixed-point tables."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _exif_orientation(app1: bytes) -> int:
    """Orientation tag (0x0112) of an ``Exif`` APP1 payload's IFD0, or 1."""
    if not app1.startswith(b"Exif\x00\x00") or len(app1) < 14:
        return 1
    t = app1[6:]
    end = {b"II": "<", b"MM": ">"}.get(t[:2])
    if end is None:
        return 1
    (ifd,) = struct.unpack(end + "I", t[4:8])
    if ifd + 2 > len(t):
        return 1
    (n,) = struct.unpack(end + "H", t[ifd:ifd + 2])
    for i in range(n):
        e = t[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        if len(e) < 12:
            break
        tag, typ = struct.unpack(end + "HH", e[:4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(end + "H", e[8:10])[0]
    return 1


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV's ``ExifTransform`` for orientation ``o`` (1-8)."""
    if o in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if o in (2, 6):
        img = img[:, ::-1]
    elif o in (3, 7):
        img = img[::-1, ::-1]
    elif o in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> ``[H, W, C]`` uint8 (C = 1 or 3, RGB), before
    the EXIF orientation."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt: dict = {}
    dc_tabs: dict = {}
    ac_tabs: dict = {}
    comps: dict = {}
    order: list = []
    width = height = 0
    restart = 0
    adobe = None
    coefs: dict = {}
    pos = 2
    n = len(data)
    while pos < n:
        if pos + 1 >= n or data[pos] != 0xFF:
            raise ValueError(f"corrupt or truncated JPEG: no marker at byte "
                             f"{pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:                                   # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG file")
        (ln,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + ln]
        pos += ln
        if marker == 0xDB:                                   # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    raise ValueError("JPEG with 16-bit quantisation tables "
                                     "(12-bit files) is not supported")
                q = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(
                    np.int64)
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = q
                qt[tq] = nat
                i += 65
        elif marker == 0xC4:                                 # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                syms = list(seg[i + 17:i + 17 + sum(counts)])
                (dc_tabs if tc == 0 else ac_tabs)[th] = _Huffman(counts,
                                                                 syms)
                i += 17 + sum(counts)
        elif marker in _SOF_NAMES or marker == 0xCC:
            kind = _SOF_NAMES.get(marker, "arithmetic-coded")
            if kind is not None:
                raise ValueError(f"{kind} JPEG is not supported: this "
                                 "decoder reads baseline (sequential, "
                                 "Huffman-coded) 8-bit files")
            if seg[0] != 8:
                raise ValueError(f"{seg[0]}-bit JPEG is not supported: this "
                                 "decoder reads 8-bit files")
            height, width, nc = struct.unpack(">HHB", seg[1:6])
            if height == 0:
                raise ValueError("JPEG with a DNL marker is not supported")
            if nc not in (1, 3):
                raise ValueError(f"JPEG with {nc} components is not "
                                 "supported (grey or YCbCr only)")
            for k in range(nc):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                comps[cid] = _Component(cid, hv >> 4, hv & 15, tq)
                order.append(cid)
        elif marker == 0xDD:                                 # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:                                 # SOS
            if not comps:
                raise ValueError("corrupt JPEG: SOS before SOF")
            hmax = max(c.h for c in comps.values())
            vmax = max(c.v for c in comps.values())
            mcux = _ceil(width, 8 * hmax)
            mcuy = _ceil(height, 8 * vmax)
            if not coefs:
                for c in comps.values():
                    c.bw, c.bh = mcux * c.h, mcuy * c.v
                    coefs[c.id] = [0] * (c.bw * c.bh * 64)
            ns = seg[0]
            scan = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4,
                     seg[2 + 2 * k] & 15) for k in range(ns)]
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise ValueError("progressive JPEG scans are not supported")
            end = _scan_end(data, pos)
            _decode_scan(_restart_segments(data[pos:end]), comps, scan, mcux,
                         mcuy, restart, coefs, dc_tabs, ac_tabs, hmax, vmax,
                         width, height)
            pos = end
        # APPn, COM and other markers: skipped
    if not coefs:
        raise ValueError("JPEG without image data")
    hmax = max(c.h for c in comps.values())
    vmax = max(c.v for c in comps.values())
    planes = []
    for cid in order:
        c = comps[cid]
        blocks = np.asarray(coefs[cid], np.int64).reshape(-1, 64) * qt[c.tq]
        px = _idct_islow(blocks).reshape(c.bh, c.bw, 8, 8).transpose(
            0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        dw = _ceil(width * c.h, hmax)
        dh = _ceil(height * c.v, vmax)
        px = px[:dh, :dw]
        ratio = (hmax // c.h, vmax // c.v)
        if ratio == (2, 1) and dw > 2:
            px = _fancy_h2v1(px)
        elif ratio == (2, 2) and dw > 2:
            px = _fancy_h2v2(px)
        elif ratio != (1, 1):
            raise ValueError(f"JPEG chroma sampling {hmax}x{vmax} over "
                             f"{c.h}x{c.v} is not supported (4:4:4, 4:2:2 "
                             "and 4:2:0 are)")
        planes.append(px[:height, :width])
    if len(planes) == 1:
        return planes[0][:, :, None]
    if adobe == 0:              # Adobe transform 0: the components are RGB
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def read_rgb8(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB of a JPEG file, as ``cv2.imread(path)``
    returns it (in BGR): grey replicated, EXIF orientation applied."""
    with open(path, "rb") as f:
        data = f.read()
    img = decode(data)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    pos, o = 2, 1
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xDA or marker == 0xD9:
            break
        (ln,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\x00\x00":
            o = _exif_orientation(data[pos + 4:pos + 2 + ln])
            break
        pos += 2 + ln
    return _orient(img, o) if o in range(2, 9) else img



# ------------------------------------------------------------------ encoder
# ``encode`` writes what ``cv2.imwrite(path, img)`` writes for a colour
# image with OpenCV's defaults: baseline, quality 95, 4:2:0, libjpeg's
# standard Huffman tables (no optimisation), a JFIF 1.01 header, no restart
# markers.

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.full(64, 99)
_STD_CHROMA_Q[:4], _STD_CHROMA_Q[8:12] = [17, 18, 24, 47], [18, 21, 26, 66]
_STD_CHROMA_Q[16:19], _STD_CHROMA_Q[24:26] = [24, 26, 56], [47, 66]

# (BITS: codes per length 1..16, HUFFVAL) of libjpeg's std_huff_tables
# (JPEG Annex K.3), by (class, table): DC luma, AC luma, DC and AC chroma
_STD_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
             bytes.fromhex(
                 "01020300041105122131410613516107227114328191a108"
                 "2342b1c11552d1f02433627282090a161718191a25262728"
                 "292a3435363738393a434445464748494a53545556575859"
                 "5a636465666768696a737475767778797a83848586878889"
                 "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
                 "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
                 "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             bytes(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291"
                 "a1b1c109233352f0156272d10a162434e125f11718191a26"
                 "2728292a35363738393a434445464748494a535455565758"
                 "595a636465666768696a737475767778797a828384858687"
                 "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
                 "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
                 "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_add_quant_table`` with ``force_baseline``, natural order."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huff_codes(bits, values) -> tuple:
    """Canonical codes by symbol: ``(code [256], length [256])``."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[values[k]], size[values[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _fdct_1d(d, shift: int, first: bool):
    """One pass of ``jpeg_fdct_islow`` (jfdctint.c) over eight int64
    arrays: the row pass (``first``) keeps PASS1_BITS extra bits, the
    column pass removes them."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, shift)
    out[6] = _descale(z1 + tmp12 * -_F1847, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4 = tmp4 * _F0298
    tmp5 = tmp5 * _F2053
    tmp6 = tmp6 * _F3072
    tmp7 = tmp7 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``[N, 8, 8]`` samples minus 128 -> ``[N, 64]`` coefficients (natural
    order) scaled by 8, exactly as ``jpeg_fdct_islow``."""
    b = blocks.astype(np.int64)
    ws = np.stack(_fdct_1d([b[:, :, k] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS, True), axis=2)
    out = np.stack(_fdct_1d([ws[:, k, :] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS, False), axis=1)
    return out.reshape(-1, 64)


def _quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's ``quantize``: |x| divided by ``8 q`` through the
    16-bit reciprocal of ``compute_reciprocal``, the sign restored."""
    d = q * 8
    r = 16 + np.floor(np.log2(d)).astype(np.int64)
    fq, fr = (np.int64(1) << r) // d, (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    fq = np.where(pow2, fq >> 1, np.where(fr > d // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    v = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -v, v)


def _rgb_to_ycc(rgb: np.ndarray):
    """``rgb_ycc_convert`` with libjpeg's 16-bit fixed-point tables."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half, off = 1 << 15, 128 << 16
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return y, cb, cr


def _pad_edges(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to ``h`` x ``w``."""
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1])), mode="edge")


def _h2v2_downsample(x: np.ndarray, out_w: int) -> np.ndarray:
    """``h2v2_downsample``: 2x2 sums + the alternating bias 1, 2, >> 2."""
    x = _pad_edges(x, x.shape[0], out_w * 2)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return (s + np.tile([1, 2], out_w)[:out_w]) >> 2


def _nbits(x: np.ndarray) -> np.ndarray:
    """Magnitude category: bits of |x| (0 for 0)."""
    a = np.abs(x)
    n = np.zeros(a.shape, np.int64)
    while (a > 0).any():
        n += a > 0
        a = a >> 1
    return n


def _entropy_code(zz: np.ndarray, tab: np.ndarray, codes: dict) -> bytes:
    """Huffman-code blocks ``zz [n, 64]`` (zigzag order, DC already the
    difference to its component's previous DC), block ``i`` with the
    tables of ``tab[i]``, into stuffed bytes padded with 1-bits."""
    n = len(zz)
    vals, lens, keys = [], [], []

    def emit(v, ln, blk, pos):
        vals.append(v)
        lens.append(ln)
        keys.append(blk * 256 + pos)

    dcc = np.stack([codes[(0, t)][0] for t in (0, 1)])
    dcs = np.stack([codes[(0, t)][1] for t in (0, 1)])
    acc = np.stack([codes[(1, t)][0] for t in (0, 1)])
    acs = np.stack([codes[(1, t)][1] for t in (0, 1)])
    blk = np.arange(n)
    diff = zz[:, 0]
    nb = _nbits(diff)
    emit((dcc[tab, nb] << nb) | (np.where(diff < 0, diff - 1, diff)
                                 & ((1 << nb) - 1)),
         dcs[tab, nb] + nb, blk, 0)
    bi, ki = np.nonzero(zz[:, 1:])
    k = ki + 1
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], bi[1:] != bi[:-1]])] = 0
    run = k - prev - 1
    v = zz[bi, k]
    nb = _nbits(v)
    t = tab[bi]
    sym = ((run & 15) << 4) | nb
    emit((acc[t, sym] << nb) | (np.where(v < 0, v - 1, v) & ((1 << nb) - 1)),
         acs[t, sym] + nb, bi, 2 * k)
    nz = run // 16                          # ZRL: sixteen zeros each
    zi = np.repeat(np.arange(len(bi)), nz)
    emit(acc[t[zi], 0xF0], acs[t[zi], 0xF0], bi[zi], 2 * k[zi] - 1)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    emit(acc[tab[eob], 0x00], acs[tab[eob], 0x00], eob, 255)
    # ZRLs of one coefficient share its key - 1: stable sort keeps them
    # in order; every token left-aligned in 32 bits, then cut to its length
    perm = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[perm]
    lens = np.concatenate(lens)[perm]
    words = (vals << (32 - lens)).astype(">u4")
    bits = np.unpackbits(words.view(np.uint8)).reshape(-1, 32)
    bits = bits[np.arange(32)[None, :] < lens[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode(rgb: np.ndarray, quality: int = 95) -> bytes:
    """``[H, W, 3]`` uint8 RGB -> a baseline 4:2:0 JFIF file's bytes, as
    ``cv2.imwrite`` writes them through libjpeg-turbo: fixed-point colour
    conversion and downsampling, the islow forward DCT, the reciprocal
    quantiser, the standard Huffman tables."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], got {a.dtype} "
                         f"{a.shape}")
    h, w = a.shape[:2]
    mcux, mcuy = _ceil(w, 16), _ceil(h, 16)
    qy = _quant_table(_STD_LUMA_Q, quality)
    qc = _quant_table(_STD_CHROMA_Q, quality)
    y, cb, cr = _rgb_to_ycc(a)
    # rows padded to the row group (2) before downsampling, every plane
    # then to whole blocks by replication (jcprepct.c, jcsample.c)
    planes = [(y, 2, qy)] + [
        (_h2v2_downsample(_pad_edges(c, h + h % 2, w),
                          _ceil(_ceil(w, 2), 8) * 8), 1, qc) for c in (cb, cr)]
    coefs = []
    for plane, s, q in planes:
        bh, bw = _ceil(plane.shape[0], 8), _ceil(plane.shape[1], 8)
        p = _pad_edges(plane, bh * 8, bw * 8) - 128
        blk = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        qz = _quantize(_fdct_islow(blk), q).reshape(bh, bw, 64)
        # blocks past the component's edge inside the last MCU are dummy
        # blocks: zero AC and the DC of the MCU's block before it in its
        # row, or for a row of them, of the row above's last (compress_data)
        full = np.zeros((mcuy * s, mcux * s, 64), np.int64)
        full[:bh, :bw] = qz
        for bx in range(bw, mcux * s):
            full[:bh, bx, 0] = full[:bh, bx - 1, 0]
        for by in range(bh, mcuy * s):
            full[by, :, 0] = np.repeat(full[by - 1, s - 1::s, 0], s)
        coefs.append(full)
    yb = coefs[0].reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
    mcu = np.concatenate([yb.reshape(mcuy, mcux, 4, 64),
                          coefs[1][:, :, None], coefs[2][:, :, None]],
                         axis=2).reshape(-1, 6, 64)    # Y00 Y01 Y10 Y11 Cb Cr
    zz = mcu[:, :, _ZIGZAG]
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):  # DC prediction
        dc = zz[:, sl, 0].reshape(-1)
        zz[:, sl, 0] = np.diff(dc, prepend=0).reshape(-1, sl.stop - sl.start)
    tab = np.tile([0, 0, 0, 0, 1, 1], len(zz))
    codes = {key: _huff_codes(*tv) for key, tv in _STD_HUFF.items()}
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate((qy, qc)):
        out.append(_segment(0xDB, bytes([i]) + bytes(q[_ZIGZAG].tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, t in ((0, 0), (1, 0), (0, 1), (1, 1)):
        bits, huffval = _STD_HUFF[(cls, t)]
        out.append(_segment(0xC4, bytes([cls << 4 | t] + bits) + huffval))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out.append(_entropy_code(zz.reshape(-1, 64), tab, codes))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write ``[H, W, 3]`` uint8 RGB as ``cv2.imwrite`` writes it (given the
    same image in BGR order)."""
    with open(path, "wb") as f:
        f.write(encode(rgb, quality))
