"""Fused per-point MLP: the whole norm-free PointMLP chain in one launch.

Port of the TPU kernel ``rgbd_pifuhd_tpu/ops/pallas_mlp.py``
``fused_point_mlp`` (``pallas_call`` at :136).  ``x [N, C0]`` (features
already gathered) runs through the Dense layers with leaky_relu(0.01)
between them, residual layers reading ``concat(h, x)``, and an optional
sigmoid head; only ``[N, C_out]`` f32 comes back.  No GroupNorm and no
``phi``: this is the inference path of a ``mlp_norm='none'`` level that
needs only its prediction (the fine level).

Rounding follows the chain this kernel replaces on the port's path, flax's
``PointMLP``: f32 stays f32; with bf16 the product is rounded to bf16, the
bias is added in bf16, leaky_relu runs in bf16 (its slope 0.01 rounded to
bf16 as well) and the sigmoid in f32.  The Pallas kernel itself keeps the
f32 accumulator through the bias add and the activation; for f32 inputs,
the only ones its tests use, the two agree.

``fused_point_mlp`` dispatches on the tensor's device: a CPU tensor goes to
the plain PyTorch version ``fused_point_mlp_ref``; a CUDA tensor launches
``csrc/fused_mlp.cu`` (built with nvcc at first use) or raises.  There is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import torch

from . import fused_query as fq
from .fused_query import PackedMLP

_SRC = os.path.join(fq._PKG, "csrc", "fused_mlp.cu")
_SO = os.path.join(fq._BUILD, "libfused_mlp.so")
_LIB: list = []

MAX_LAYERS = 8


# ------------------------------------------------------- plain version
def fused_point_mlp_ref(x: torch.Tensor, layers: PackedMLP, *,
                        res_layers: Sequence[int] = (),
                        last_op: str | None = "sigmoid") -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding at the same places."""
    cd = layers.compute_dtype
    res = frozenset(int(r) for r in res_layers)
    x0 = x[:, :layers.in_dim].to(cd)
    h = x0
    n_layers = len(layers.layers)
    for i, L in enumerate(layers.layers):
        inp = torch.cat([h, x0], dim=-1) if i in res else h
        y = fq._round(inp.float() @ L.weight.float().t(), cd)
        y = fq._round(y + L.bias, cd)
        if i == n_layers - 1:
            break
        h = fq._leaky(y, cd).to(cd)
    return torch.sigmoid(y) if last_op == "sigmoid" else y


# -------------------------------------------------------- CUDA binding
class _MlpParams(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("w", ctypes.c_void_p * MAX_LAYERS),
                ("bias", ctypes.c_void_p * MAX_LAYERS),
                ("M", ctypes.c_int * MAX_LAYERS),
                ("res", ctypes.c_int * MAX_LAYERS),
                ("K1p", ctypes.c_int * MAX_LAYERS),
                ("K2p", ctypes.c_int * MAX_LAYERS)] + [
                    (n, ctypes.c_int) for n in (
                        "n_layers", "N", "C0", "ldx", "sigmoid", "ldx_s",
                        "ldh0", "ldh1")]


def build() -> str:
    """Compile ``csrc/fused_mlp.cu`` into ``_build/`` (nvcc, sm_90a);
    returns the compiler's output, raises if the build fails."""
    return fq.build_cuda(_SRC, _SO)


def _lib():
    if _LIB:
        return _LIB[0]
    build()
    lib = ctypes.CDLL(_SO)
    lib.fm_forward.restype = ctypes.c_int
    lib.fm_forward.argtypes = [ctypes.c_int, ctypes.POINTER(_MlpParams),
                               ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.c_void_p]
    _LIB.append(lib)
    return lib


def _check_args(x: torch.Tensor, mlp: PackedMLP) -> None:
    cd = mlp.compute_dtype
    if cd not in fq._DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cd}")
    if x.dim() != 2 or x.shape[1] not in (mlp.in_dim, fq._r8(mlp.in_dim)):
        raise ValueError(f"expected x [N, {mlp.in_dim}] (or padded to "
                         f"{fq._r8(mlp.in_dim)}), got {tuple(x.shape)}")
    if x.dtype != cd or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {cd} tensor")
    if x.shape[0] == 0:
        raise ValueError("empty query")
    if len(mlp.layers) > MAX_LAYERS:
        raise ValueError(f"{len(mlp.layers)} layers > {MAX_LAYERS}")
    for i, L in enumerate(mlp.layers):
        if L.weight.device != x.device or L.weight.dtype != cd:
            raise ValueError(f"layer {i} weights not {cd} on {x.device}")


def _launch(x: torch.Tensor, mlp: PackedMLP, last_op, block) -> torch.Tensor:
    lib = _lib()
    N = int(x.shape[0])
    out = torch.empty((N, mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    p = _MlpParams()
    p.x, p.out = x.data_ptr(), out.data_ptr()
    for i, L in enumerate(mlp.layers):
        p.w[i], p.bias[i] = L.weight_p.data_ptr(), L.bias.data_ptr()
        p.M[i], p.res[i] = int(L.weight.shape[0]), int(L.k2p > 0)
    p.n_layers, p.N, p.C0, p.ldx = len(mlp.layers), N, mlp.in_dim, \
        int(x.shape[1])
    p.sigmoid = int(last_op == "sigmoid")
    used = ctypes.c_int(0)
    rc = lib.fm_forward(fq._DTYPE_CODE[mlp.compute_dtype], ctypes.byref(p),
                        int(block or 0), ctypes.byref(used),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if rc == -1:
        raise RuntimeError(
            f"fused_mlp: no point tile ({block or 'any'}) of the chain "
            f"{[mlp.in_dim] + mlp.widths} fits shared memory")
    if rc != 0:
        raise RuntimeError(f"fused_mlp: CUDA error {rc}")
    fused_point_mlp.last_block = used.value
    return out


def fused_point_mlp(x: torch.Tensor, layers: PackedMLP, *,
                    res_layers: Sequence[int] = (),
                    last_op: str | None = "sigmoid",
                    block: int | None = None) -> torch.Tensor:
    """``x [N, C0]`` in the compute dtype -> ``[N, C_out]`` f32 through the
    whole chain in one launch.

    Args:
        x: gathered features; may carry the zero padding to a multiple of 8
            columns that ``fused_query.gather_concat`` appends.
        layers: ``pack_layers`` output of a norm-free MLP.
        res_layers: layers whose input is ``concat(h, x)``.
        last_op: ``'sigmoid'`` or None.
        block: points per thread block (64, 32, or 16 for f32); None takes
            the largest whose tiles leave room for two blocks on an SM,
            else the largest that fits shared memory.
    """
    if any(L.gn_scale is not None for L in layers.layers):
        raise ValueError("fused_point_mlp runs norm-free chains only; a "
                         "GroupNorm MLP goes through fused_gather_mlp")
    if frozenset(int(r) for r in res_layers) != layers.res_layers:
        raise ValueError("res_layers differ from the packed layers'")
    if x.device.type == "cpu":
        return fused_point_mlp_ref(x, layers, res_layers=res_layers,
                                   last_op=last_op)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_args(x, layers)
    out = _launch(x, layers, last_op, block)
    fused_point_mlp.launches += 1
    return out


fused_point_mlp.launches = 0
fused_point_mlp.last_block = 0
