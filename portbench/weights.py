"""A trained checkpoint's normal nets embedded at the configuration's
``nml_ngf``.

Every channel width of pix2pixHD's generator is a multiple of ``ngf``.
Each such axis of netF / netB grows by ``ngf / ngf_checkpoint``: the
trained values fill the leading channels, the rest are zero.  A zero
channel stays zero through the convolutions (zero weights and bias),
InstanceNorm (no affine: ``0 * rsqrt(0 + eps)``), ReLU and the residual
adds, so the wider nets give the narrow ones' normals while doing the
wider nets' work.  Applied to the raw checkpoint payload, so the program
and the reference each read the same widened weights.
"""

from __future__ import annotations

import contextlib

import numpy as np

NORMAL_NETS = ("netF", "netB")


def _zeros(shape, like):
    if isinstance(like, np.ndarray):
        return np.zeros(shape, like.dtype)
    import torch

    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _widen(node, old: int, new: int):
    if isinstance(node, dict):
        return {k: _widen(v, old, new) for k, v in node.items()}
    shape = tuple(s * new // old if s % old == 0 else s for s in node.shape)
    out = _zeros(shape, node)
    out[tuple(slice(0, s) for s in node.shape)] = node
    return out


def widen_normal_nets(payload: dict, ngf: int) -> dict:
    """``payload`` (``{opt, params, ...}``, numpy or torch leaves) with
    netF / netB at ``ngf``; unchanged where the checkpoint already has it."""
    old = payload["opt"]["netG"]["nml_ngf"]
    if old == ngf:
        return payload
    if ngf % old:
        raise ValueError(f"nml_ngf {ngf} is not a multiple of {old}")
    tree = payload["params"]
    tree = tree.get("params", tree)
    for k in NORMAL_NETS:
        if k in tree["netG"]:
            tree["netG"][k] = _widen(tree["netG"][k], old, ngf)
    for key in ("opt", "opt_netG"):
        if isinstance(payload.get(key), dict) and "netG" in payload[key]:
            payload[key]["netG"]["nml_ngf"] = ngf
    return payload


@contextlib.contextmanager
def widened_loader(module, ngf: int):
    """``module.load_checkpoint`` (the program's reader) returns payloads
    widened to ``ngf`` while the block runs."""
    orig = module.load_checkpoint

    def load(*a, **kw):
        return widen_normal_nets(orig(*a, **kw), ngf)

    module.load_checkpoint = load
    try:
        yield
    finally:
        module.load_checkpoint = orig
