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

A bf16 chain runs the persistent wgmma kernel on a plan made here
(``plan_wgmma``): the point tile (128 or 64 rows), the cluster of blocks
that share each weight box, the columns of each layer's passes and the
shared-memory layout (activations, then the ring of TMA stages).  An f32
chain runs FMA tiles whose size the library picks.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Sequence

import torch

from . import fused_query as fq
from .fused_query import PackedMLP

_SRC = os.path.join(fq._PKG, "csrc", "fused_mlp.cu")
_SO = os.path.join(fq._BUILD, "libfused_mlp.so")
_LIB: list = []

MAX_LAYERS = 8
LINE = 128              # bytes of a 64-wide bf16 K slice: one swizzle line
BK = fq.BK              # K values per ring stage (64)
SMEM_PLAN_MAX = 232448 - 1024   # dynamic shared memory a plan may take
MAX_STAGES = 8
TILE_ROWS = (128, 64)   # point tiles the bf16 kernel takes, in preference
CLUSTERS = (1, 2, 4)    # blocks that share each weight box
# Measured on the H100 (PERF.md section 6): clusters of 2 and 4 cut
# the weights' L2 reads but were slower at both full widths (the blocks of a
# cluster wait for each other at every weight stage).
DEFAULT_CLUSTER = 1


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


# ------------------------------------------------------- the bf16 plan
def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass
class WgPlan:
    """Everything about one bf16 chain launch that the library does not
    decide: the point tile, the cluster, each layer's passes and the
    shared-memory layout (offsets from a 1024-byte aligned base)."""
    bm: int                 # points per tile
    cluster: int            # blocks that share each weight box (multicast)
    cp: int                 # consumer warpgroups splitting a pass's columns
    a_bytes: int            # resident activations [bm, a_cols] bf16, at 0
    xstages: int            # x0 ring: stages of bm x 64 bf16
    xring_off: int
    stages: int             # weights' ring
    stage_bytes: int
    ring_off: int
    smem_bytes: int         # dynamic shared memory, alignment slack included
    layers: list            # per layer: M, KT1, KT2, CN, SC, P, G


def plan_wgmma(mlp: PackedMLP, rows: int | None = None,
               cluster: int | None = None) -> WgPlan:
    """Plan the bf16 kernel for ``mlp``.

    Each layer's output columns are covered in passes of ``SC = cp * CN``
    columns (a weight stage of ``SC`` rows x 64 K, at most 128 rows: the
    ring then keeps twice the stages that 256 rows leave, which was faster
    on the H100).  ``cp`` consumer warpgroups split a pass (2 at 64-row
    tiles, where both own the same rows; 1 at 128-row tiles, where each
    owns 64 rows), ``CN`` the smallest power of two >= 8 that covers the
    layer in one pass, capped at ``128 / cp``.  A hidden layer covers at
    least 64 columns, so that the next layer's zero K padding is written
    too.  A
    warpgroup holds the accumulators of ``G`` passes at once (``G * CN / 2``
    <= 128 a thread, ``G`` <= 4); a layer that reads the resident
    activations must finish within one group, since its output goes over
    its input; layer 0 reads x0 from its ring and may take several.

    After the activations come the x0 ring (4 stages where the weights'
    ring keeps 4 as well, else 2) and the weights' ring (up to
    ``MAX_STAGES``).  The
    tile is the first of ``TILE_ROWS`` (or ``rows``) whose layers all obey
    the rules above and that leaves the weights 3 stages (2 if no tile
    leaves 3).  Raises ``ValueError`` if none fits."""
    if mlp.compute_dtype != torch.bfloat16:
        raise ValueError("plan_wgmma plans bf16 chains")
    cluster = DEFAULT_CLUSTER if cluster is None else int(cluster)
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster {cluster} not in {CLUSTERS}")
    if rows is not None and int(rows) not in TILE_ROWS:
        raise ValueError(f"tile rows {rows} not in {TILE_ROWS}")
    cands = TILE_ROWS if rows is None else (int(rows),)
    n = len(mlp.layers)
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"{n} layers: the kernel takes 1 to {MAX_LAYERS}")
    for min_stages in (3, 2):
        for bm in cands:
            cp = 2 // (bm // 64)
            layers, ok, a_cols = [], True, BK
            for i, L in enumerate(mlp.layers):
                M = int(L.weight.shape[0])
                last = i == n - 1
                want = -(-M // cp)
                if not last:
                    want = max(want, 64 // cp)
                cn = min(128 // cp, max(8, _pow2_at_least(want)))
                sc = cp * cn
                P = -(-M // sc)
                G = min(P, 4, 256 // cn)
                if i > 0 and P > G:
                    ok = False
                if not last:
                    a_cols = max(a_cols, P * sc)
                layers.append(dict(M=M, KT1=L.k1k // BK, KT2=L.k2k // BK,
                                   CN=cn, SC=sc, P=P, G=G))
            if not ok:
                continue
            a_bytes = bm * a_cols * 2
            x_bytes = bm * LINE
            stage_bytes = max(d["SC"] * LINE for d in layers)
            room = SMEM_PLAN_MAX - 1024 - a_bytes
            xstages = 4 if room >= 4 * (x_bytes + stage_bytes) else 2
            stages = min(MAX_STAGES,
                         (room - xstages * x_bytes) // stage_bytes)
            if stages < min_stages:
                continue
            ring_off = a_bytes + xstages * x_bytes
            return WgPlan(bm, cluster, cp, a_bytes, xstages, a_bytes, stages,
                          stage_bytes, ring_off,
                          ring_off + stages * stage_bytes + 1024, layers)
    raise ValueError(f"fused_mlp: no point tile ({rows or 'any'}) of the "
                     f"chain {[mlp.in_dim] + mlp.widths} fits shared memory")


# -------------------------------------------------------- CUDA binding
_PER_LAYER = ctypes.c_int * MAX_LAYERS


class _MlpParams(ctypes.Structure):
    """Mirror of ``struct MlpParams`` (the f32 launch)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("w", ctypes.c_void_p * MAX_LAYERS),
                ("bias", ctypes.c_void_p * MAX_LAYERS),
                ("M", _PER_LAYER), ("res", _PER_LAYER), ("K1p", _PER_LAYER),
                ("K2p", _PER_LAYER)] + [
                    (n, ctypes.c_int) for n in (
                        "n_layers", "N", "C0", "ldx", "sigmoid", "ldx_s",
                        "ldh0", "ldh1")]


class _WgParams(ctypes.Structure):
    """Mirror of ``struct WgParams`` (the bf16 launch and its plan)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("w", ctypes.c_void_p * MAX_LAYERS),
                ("bias", ctypes.c_void_p * MAX_LAYERS)] + [
                    (n, _PER_LAYER) for n in ("M", "KT1", "KT2", "CN", "P",
                                              "G")] + [
                    (n, ctypes.c_int) for n in (
                        "n_layers", "N", "C0", "ldx", "sigmoid", "bm",
                        "cluster", "stages", "stage_bytes", "ring_off",
                        "xstages", "xring_off", "smem_bytes")]


def build() -> str:
    """Compile ``csrc/fused_mlp.cu`` into ``_build/`` (nvcc, sm_90a);
    returns the compiler's output, raises if the build fails."""
    return fq.build_cuda(_SRC, _SO)


def _lib():
    if _LIB:
        return _LIB[0]
    build()
    lib = ctypes.CDLL(_SO)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.fm_abi.restype = ci
    lib.fm_abi.argtypes = [ci]
    lib.fm_forward.restype = ci
    lib.fm_forward.argtypes = [ctypes.POINTER(_MlpParams), ci,
                               ctypes.POINTER(ci), vp]
    lib.fm_wg_forward.restype = ci
    lib.fm_wg_forward.argtypes = [ctypes.POINTER(_WgParams), vp]
    got = [lib.fm_abi(i) for i in range(5)]
    want = [ctypes.sizeof(_MlpParams), ctypes.sizeof(_WgParams), MAX_LAYERS,
            MAX_STAGES, SMEM_PLAN_MAX]
    if got != want:
        raise RuntimeError(f"fused_mlp: the library says {got} for struct "
                           f"sizes, layers, stages and shared memory; this "
                           f"module {want}")
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


def _hint(block) -> tuple:
    """``block`` -> (tile rows or None, cluster or None)."""
    if block is None:
        return None, None
    if isinstance(block, (tuple, list)):
        rows, cluster = block
        return (int(rows) if rows else None,
                int(cluster) if cluster else None)
    return int(block), None


def _launch_f32(x, mlp: PackedMLP, last_op, block) -> torch.Tensor:
    rows, cluster = _hint(block)
    if cluster not in (None, 1):
        raise ValueError("the f32 kernel runs no clusters")
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
    rc = _lib().fm_forward(ctypes.byref(p), int(rows or 0),
                           ctypes.byref(used),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if rc == -1:
        raise RuntimeError(
            f"fused_mlp: no point tile ({rows or 'any'}) of the chain "
            f"{[mlp.in_dim] + mlp.widths} fits shared memory")
    if rc != 0:
        raise RuntimeError(f"fused_mlp: CUDA error {rc}")
    fused_point_mlp.last_block, fused_point_mlp.last_cluster = used.value, 1
    return out


def padded_biases(mlp: PackedMLP, plan: WgPlan) -> list:
    """Each layer's biases zero-padded to the columns its passes cover, so
    that the kernel reads them without bounds checks.  Cached on ``mlp``."""
    cols = tuple(d["P"] * d["SC"] for d in plan.layers)
    key = ("wg_bias", cols)
    if key not in mlp.plans:
        out = []
        for L, n in zip(mlp.layers, cols):
            b = torch.zeros(n, dtype=torch.float32, device=L.bias.device)
            b[:L.bias.shape[0]] = L.bias
            out.append(b)
        mlp.plans[key] = out
    return mlp.plans[key]


def wg_params(x, out, mlp: PackedMLP, plan: WgPlan, last_op) -> _WgParams:
    """The bf16 launch's argument struct for ``plan``."""
    p = _WgParams()
    p.x, p.out = x.data_ptr(), out.data_ptr()
    biases = padded_biases(mlp, plan)
    for i, (L, d) in enumerate(zip(mlp.layers, plan.layers)):
        p.w[i], p.bias[i] = L.weight_k.data_ptr(), biases[i].data_ptr()
        for k in ("M", "KT1", "KT2", "CN", "P", "G"):
            getattr(p, k)[i] = d[k]
    p.n_layers, p.N, p.C0, p.ldx = (len(mlp.layers), int(x.shape[0]),
                                    mlp.in_dim, int(x.shape[1]))
    p.sigmoid = int(last_op == "sigmoid")
    for k in ("bm", "cluster", "stages", "stage_bytes", "ring_off",
              "xstages", "xring_off", "smem_bytes"):
        setattr(p, k, getattr(plan, k))
    return p


def _launch_wg(x, mlp: PackedMLP, last_op, block) -> torch.Tensor:
    rows, cluster = _hint(block)
    key = ("wg", rows, cluster)
    plan = mlp.plans.get(key)
    if plan is None:
        plan = mlp.plans[key] = plan_wgmma(mlp, rows, cluster)
    if (x.shape[1] * 2) % 16:
        # TMA reads rows 16-byte aligned: pad x0 as gather_concat does
        xp = torch.zeros((x.shape[0], fq._r8(x.shape[1])), dtype=x.dtype,
                         device=x.device)
        xp[:, :x.shape[1]] = x
        x = xp
    out = torch.empty((int(x.shape[0]), mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    p = wg_params(x, out, mlp, plan, last_op)
    rc = _lib().fm_wg_forward(ctypes.byref(p),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp: launch refused or failed ({rc}) for "
                           f"the plan {plan}")
    fused_point_mlp.last_block = plan.bm
    fused_point_mlp.last_cluster = plan.cluster
    return out


def fused_point_mlp(x: torch.Tensor, layers: PackedMLP, *,
                    res_layers: Sequence[int] = (),
                    last_op: str | None = "sigmoid",
                    block=None) -> torch.Tensor:
    """``x [N, C0]`` in the compute dtype -> ``[N, C_out]`` f32 through the
    whole chain in one launch.

    Args:
        x: gathered features; may carry the zero padding to a multiple of 8
            columns that ``fused_query.gather_concat`` appends.
        layers: ``pack_layers`` output of a norm-free MLP.
        res_layers: layers whose input is ``concat(h, x)``.
        last_op: ``'sigmoid'`` or None.
        block: tile hint, validated by the plan.  None: the plan's choice;
            an int: points per tile (bf16: 128 or 64; f32: 64, 32 or 16);
            ``(rows, cluster)``: also the blocks of a cluster (bf16: 1, 2
            or 4), either entry None for the plan's choice.
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
    if layers.compute_dtype == torch.bfloat16:
        out = _launch_wg(x, layers, last_op, block)
    else:
        out = _launch_f32(x, layers, last_op, block)
    fused_point_mlp.launches += 1
    return out


fused_point_mlp.launches = 0
fused_point_mlp.last_block = 0
fused_point_mlp.last_cluster = 0
