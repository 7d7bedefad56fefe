"""Flax msgpack checkpoints read and written without flax or msgpack.

The JAX package writes a checkpoint as one ``flax.serialization`` msgpack
file holding ``{epoch, opt, opt_netG, params}`` (a port checkpoint may add
``netC`` and ``opt_netC``: PIFu's texture network, ``models.texture``,
which the JAX package has not).  ``msgpack`` is not
installed beside the card, so ``msgpack_restore`` below decodes the subset
flax writes: maps, str, bin, ints, floats, bool, nil, arrays, and ext type
1 — an ndarray packed as ``(shape, dtype name, raw bytes)``;
``msgpack_serialize`` encodes the same subset as flax does (floats as
doubles, the smallest integer and length formats), so the JAX package's
``load_checkpoint`` reads what ``save_checkpoint`` writes.  Checkpoint
names follow the JAX package: ``<name>_train_latest`` and
``<name>_train_epoch_<N>``.

``params_from_flax`` maps the flax parameter tree onto this port's modules,
whose attribute names follow the flax tree one to one (``netG/netF/down0``
-> ``netG.netF.down0``):

- Dense ``kernel [in, out]`` -> ``nn.Linear`` ``weight [out, in]`` (the
  layout the fused query kernel reads: each output column contiguous in K);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- ConvTranspose (``up{i}`` of a GlobalGenerator or an Encoder, ``g_up{i}``
  and ``l_up`` of a LocalEnhancer) HWIO -> torch ``ConvTranspose2d``
  ``[in, out, kh, kw]`` with the spatial flip undone (the inverse of
  ``rgbd_pifuhd_tpu/utils/torch_import.py:102-106``).  ``load_params``
  takes which kernels are transposed from the model's modules (the
  perceptual decoder's ``up{i}`` are plain convolutions);
- GroupNorm and BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- the ``batch_stats`` collection's ``mean`` / ``var`` -> the BatchNorm
  buffers of the same names.

``params_to_flax`` is the inverse: a module's parameters and batch-norm
buffers as the flax variables tree (``{"params": ..., "batch_stats": ...}``,
the latter only when the model has batch norm), numpy float32 leaves.
"""

from __future__ import annotations

import json
import os
import re
import struct

import numpy as np
import torch

from .device import resolve_device
from .options import ColorConfig, Options

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
            return torch.from_numpy(x.astype(np.float32, copy=False)).to(dev)
        return x

    payload["params"] = _map_leaves(payload["params"], to_tensor)
    if isinstance(payload.get("netC"), dict):
        payload["netC"] = _map_leaves(payload["netC"], to_tensor)
    return payload


def restore_options(cli_opt: Options, ckpt: dict) -> tuple[Options, Options]:
    """Checkpoint opts override CLI except the kept fields."""
    if not ckpt.get("opt"):
        return cli_opt, cli_opt
    opt = cli_opt.restore_from_checkpoint_dict(ckpt["opt"])
    return opt, Options.from_dict(ckpt["opt_netG"])


_DECONV = re.compile(r"^(g_|l_)?up\d*$")


def params_from_flax(tree: dict, deconv: set | None = None) -> dict:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) or a bare
    parameter tree, numpy or torch leaves -> torch state_dict.
    ``deconv``: the dotted module paths whose kernels are transposed
    convolutions (default: the generators' names, ``_DECONV``)."""
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
                elif (_DECONV.match(parent) if deconv is None
                      else ".".join(path) in deconv):  # ConvTranspose
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
    from ..models.pix2pix import ConvTranspose

    deconv = {n for n, m in model.named_modules()
              if isinstance(m, ConvTranspose)}
    model.load_state_dict(params_from_flax(tree, deconv), strict=True)


def params_to_flax(model: torch.nn.Module) -> dict:
    """The flax variables tree of ``model`` (numpy float32 leaves): the
    inverse of ``params_from_flax``."""
    from ..models.blocks import BatchNorm, Conv, GroupNorm
    from ..models.pix2pix import ConvTranspose

    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf, t):
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        # one copy, which the tree owns: it must not alias the module's
        # live parameters
        t = t.detach().to(torch.float32).contiguous()
        node[leaf] = (t.cpu() if t.is_cuda else t.clone()).numpy()

    for name, m in model.named_modules():
        path = name.split(".") if name else []
        if isinstance(m, Conv):
            put(params, path, "kernel", m.weight.permute(2, 3, 1, 0))
        elif isinstance(m, torch.nn.Linear):
            put(params, path, "kernel", m.weight.t())
        elif isinstance(m, ConvTranspose):
            put(params, path, "kernel",
                m.weight.permute(2, 3, 0, 1).flip(0, 1))
        elif isinstance(m, (GroupNorm, BatchNorm)):
            put(params, path, "scale", m.weight)
            if isinstance(m, BatchNorm):
                put(stats, path, "mean", m.mean)
                put(stats, path, "var", m.var)
        else:
            continue
        if m.bias is not None:
            put(params, path, "bias", m.bias)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


class _Writer:
    """Minimal msgpack encoder (the formats msgpack-python chooses)."""

    def __init__(self):
        self.parts: list = []

    def _len(self, n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max and fix is not None:
            self.parts.append(bytes([fix | n]))
        elif n < 1 << 8 and codes[0] is not None:
            self.parts.append(struct.pack(">BB", codes[0], n))
        elif n < 1 << 16:
            self.parts.append(struct.pack(">BH", codes[1], n))
        else:
            self.parts.append(struct.pack(">BI", codes[2], n))

    def _int(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.parts.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">BB"),
                                  (0, 0xFFFF, 0xCD, ">BH"),
                                  (0, 0xFFFFFFFF, 0xCE, ">BI"),
                                  (0, 2 ** 64 - 1, 0xCF, ">BQ"),
                                  (-128, 127, 0xD0, ">Bb"),
                                  (-2 ** 15, 2 ** 15 - 1, 0xD1, ">Bh"),
                                  (-2 ** 31, 2 ** 31 - 1, 0xD2, ">Bi"),
                                  (-2 ** 63, 2 ** 63 - 1, 0xD3, ">Bq")):
            if lo <= v <= hi:
                self.parts.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")

    def write(self, o) -> None:
        if o is None:
            self.parts.append(b"\xc0")
        elif isinstance(o, bool):
            self.parts.append(b"\xc3" if o else b"\xc2")
        elif isinstance(o, int):
            self._int(o)
        elif isinstance(o, float):
            self.parts.append(struct.pack(">Bd", 0xCB, o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            self._len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.parts.append(b)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            b = bytes(o)
            self._len(len(b), None, -1, (0xC4, 0xC5, 0xC6))
            self.parts.append(b)
        elif isinstance(o, dict):            # keys sorted, as flax's
            self._len(len(o), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in sorted(o.items()):
                self.write(k)
                self.write(v)
        elif isinstance(o, (list, tuple)):
            self._len(len(o), 0x90, 15, (None, 0xDC, 0xDD))
            for v in o:
                self.write(v)
        elif isinstance(o, np.ndarray):
            # ext 1 around packb((shape, dtype name, raw bytes)); the raw
            # bytes are kept as a view of the array, not copied
            # (ascontiguousarray alone makes a 0-d array 1-d)
            a = np.ascontiguousarray(o).reshape(o.shape)
            inner = _Writer()
            inner.write([list(a.shape), a.dtype.name])
            inner.parts[0] = b"\x93"            # a 3-array, not a 2-array
            inner._len(a.nbytes, None, -1, (0xC4, 0xC5, 0xC6))
            head = b"".join(inner.parts)
            n = len(head) + a.nbytes
            fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if n in fixed:
                self.parts.append(struct.pack(">Bb", fixed[n], _ND_EXT))
            else:
                self._len(n, None, -1, (0xC7, 0xC8, 0xC9))
                self.parts.append(struct.pack(">b", _ND_EXT))
            self.parts.append(head)
            self.parts.append(memoryview(a.reshape(-1)).cast("B"))
        else:
            raise TypeError(f"cannot serialise {type(o).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts / lists / scalars / numpy arrays as
    ``flax.serialization.msgpack_serialize`` does (arrays below its 2 GiB
    chunking limit)."""
    w = _Writer()
    w.write(tree)
    return b"".join(w.parts)


def save_checkpoint(path: str, params: dict, opt: Options,
                    opt_netG: Options | None = None, epoch: int = 0,
                    netC: dict | None = None,
                    opt_netC: ColorConfig | None = None) -> None:
    """Write ``{params, opt, opt_netG, epoch}`` as the JAX package's
    ``save_checkpoint`` does: ``params`` a flax variables tree (e.g.
    ``params_to_flax(model)``), the options through a JSON round trip
    (tuples become lists).  ``netC`` (the texture network's tree, which
    the JAX package has not) adds ``netC`` and its sizes ``opt_netC``."""
    payload = {
        "params": params,
        "opt": json.loads(json.dumps(opt.to_dict())),
        "opt_netG": json.loads(json.dumps((opt_netG or opt).to_dict())),
        "epoch": epoch,
    }
    if netC is not None:
        payload["netC"] = netC
        payload["opt_netC"] = json.loads(json.dumps(
            (opt_netC or ColorConfig()).to_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    w = _Writer()
    w.write(payload)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:          # the arrays' bytes, uncopied
        for part in w.parts:
            f.write(part)
    os.replace(tmp, path)


def latest_path(checkpoints_path: str, name: str) -> str:
    return os.path.join(checkpoints_path, f"{name}_train_latest")


def epoch_path(checkpoints_path: str, name: str, epoch: int) -> str:
    return os.path.join(checkpoints_path, f"{name}_train_epoch_{epoch}")
