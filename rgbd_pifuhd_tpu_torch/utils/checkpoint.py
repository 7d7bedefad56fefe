"""Flax msgpack checkpoints read without flax or msgpack.

The JAX package writes a checkpoint as one ``flax.serialization`` msgpack
file holding ``{epoch, opt, opt_netG, params}``.  ``msgpack`` is not
installed beside the card, so ``msgpack_restore`` below decodes the subset
flax writes: maps, str, bin, ints, floats, bool, nil, arrays, and ext type
1 — an ndarray packed as ``(shape, dtype name, raw bytes)``.

``params_from_flax`` maps the flax parameter tree onto this port's modules,
whose attribute names follow the flax tree one to one (``netG/netF/down0``
-> ``netG.netF.down0``):

- Dense ``kernel [in, out]`` -> ``nn.Linear`` ``weight [out, in]`` (the
  layout the fused query kernel reads: each output column contiguous in K);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- ConvTranspose (``up{i}`` of a GlobalGenerator) HWIO -> torch
  ``ConvTranspose2d`` ``[in, out, kh, kw]`` with the spatial flip undone
  (the inverse of ``rgbd_pifuhd_tpu/utils/torch_import.py:102-106``);
- GroupNorm and BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- the ``batch_stats`` collection's ``mean`` / ``var`` -> the BatchNorm
  buffers of the same names.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

from .device import resolve_device
from .options import Options

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
        data = bytes(self._take(n))
        if code != _ND_EXT:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(data, raw=True).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)

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
            return bytes(self._take(n))
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


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def load_checkpoint(path: str, device=None) -> dict:
    """Read a JAX-package checkpoint, or a reference PyTorch one (detected
    by its magic; ``utils.torch_import``, which marks the payload
    ``torch_import``); params become f32 tensors on ``device`` (default
    ``cuda``; raises without CUDA unless 'cpu')."""
    from .torch_import import is_torch_checkpoint, load_reference_checkpoint

    dev = resolve_device(device)
    if is_torch_checkpoint(path):
        payload = load_reference_checkpoint(path)
    else:
        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())

    def to_tensor(x):
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            return torch.from_numpy(x.astype(np.float32)).to(dev)
        return x

    payload["params"] = _map_leaves(payload["params"], to_tensor)
    return payload


def restore_options(cli_opt: Options, ckpt: dict) -> tuple[Options, Options]:
    """Checkpoint opts override CLI except the kept fields."""
    if not ckpt.get("opt"):
        return cli_opt, cli_opt
    opt = cli_opt.restore_from_checkpoint_dict(ckpt["opt"])
    return opt, Options.from_dict(ckpt["opt_netG"])


_DECONV = re.compile(r"^up\d+$")


def params_from_flax(tree: dict) -> dict:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) or a bare
    parameter tree, numpy or torch leaves -> torch state_dict."""
    trees = [tree]
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        trees = [tree["params"], tree.get("batch_stats", {})]
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))
            t = t.float()
            parent = path[-1] if path else ""
            if k == "kernel":
                if t.ndim == 2:                       # Dense [in, out]
                    t = t.t()
                elif _DECONV.match(parent):           # ConvTranspose
                    t = t.flip(0, 1).permute(2, 3, 0, 1)
                else:                                 # Conv HWIO -> OIHW
                    t = t.permute(3, 2, 0, 1)
                name = "weight"
            elif k == "scale":
                name = "weight"
            else:
                name = k
            out[".".join(path + [name])] = t.contiguous()

    for t in trees:
        walk(t, [])
    return out


def load_params(model: torch.nn.Module, tree: dict) -> None:
    """Load a flax tree into ``model`` (strict: every name must match)."""
    model.load_state_dict(params_from_flax(tree), strict=True)
