"""Flax msgpack checkpoints read without flax or msgpack, and mapped onto
the reference's parameter names.

Frozen copy of ``rgbd_pifuhd_tpu_torch/utils/checkpoint.py`` (``_Reader``,
``msgpack_restore``, and the kernel layouts of ``params_from_flax``): the
benchmark reads the committed checkpoint with this copy, so its reference
takes nothing that the measured program has made.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

_ND_EXT = 1            # flax _MsgpackExtType.ndarray


class _Reader:
    """Minimal msgpack decoder over a bytes buffer."""

    def __init__(self, buf, raw: bool = False):
        self.b = memoryview(buf)
        self.i = 0
        self.raw = raw

    def _take(self, n: int):
        s = self.b[self.i:self.i + n]
        if len(s) != n:
            raise ValueError("truncated msgpack data")
        self.i += n
        return s

    def _unpack(self, fmt: str):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(n))[0]

    def _str(self, n: int):
        s = bytes(self._take(n))
        return s if self.raw else s.decode("utf-8")

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code != _ND_EXT:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(data, raw=True).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        # one copy out of the file's buffer: the array owns its memory
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
            shape).copy()

    def read(self):
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t >= 0xE0:
            return t - 0x100
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            # an array's raw bytes stay a view until the array copies them
            return self._take(n) if self.raw else bytes(self._take(n))
        if t in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self._unpack(">b")
            return self._ext(code, n)
        if t == 0xCA:
            return self._unpack(">f")
        if t == 0xCB:
            return self._unpack(">d")
        if 0xCC <= t <= 0xD3:
            fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[t]
            return self._unpack(fmt)
        if 0xD4 <= t <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return self._str(n)
        if t in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def msgpack_restore(data: bytes):
    """Decode a ``flax.serialization.msgpack_serialize`` payload (arrays
    below flax's 2 GiB chunking limit, as every checkpoint of this repo)."""
    r = _Reader(data)
    out = r.read()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after msgpack payload")
    return out




_DECONV = re.compile(r"^(g_|l_)?up\d*$")


def load_flax(path: str) -> dict:
    """The checkpoint's payload: ``{epoch, opt, opt_netG, params}``, numpy
    leaves."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def state_dict_from_flax(tree: dict) -> dict:
    """Flax parameter tree -> float32 state dict of ``reference.model``:
    Dense ``[in, out]`` -> ``[out, in]``; Conv HWIO -> OIHW; the generators'
    ConvTranspose (``up{i}``) HWIO -> ``[in, out, kh, kw]`` with the
    spatial flip undone; norm ``scale`` -> ``weight``."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            t = torch.from_numpy(np.asarray(v, np.float32).copy())
            parent = path[-1] if path else ""
            name = k
            if k == "kernel":
                name = "weight"
                if t.ndim == 2:
                    t = t.t()
                elif _DECONV.match(parent):
                    t = t.flip(0, 1).permute(2, 3, 0, 1)
                else:
                    t = t.permute(3, 2, 0, 1)
            elif k == "scale":
                name = "weight"
            out[".".join(path + [name])] = t.contiguous()

    walk(tree, [])
    return out
