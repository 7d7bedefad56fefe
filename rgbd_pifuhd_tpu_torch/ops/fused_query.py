"""Fused field query: bilinear gather + PointMLP chain (CUDA kernel).

Port of the TPU kernel ``rgbd_pifuhd_tpu/ops/pallas_query.py``
``fused_gather_mlp`` (``pallas_call`` at :364).  Per point: a 4-tap
hat-weight bilinear gather from ``feat [H, W, C]`` (equal to grid_sample
with zeros padding and ``align_corners=True``), concat of ``extra [N, E]``,
then the PointMLP chain — Dense, GroupNorm(32) with ``E[x^2] - E[x]^2``
statistics in f32 (or no norm), leaky_relu(0.01), residual concat of the
original input, ``phi`` after the merge layer, and a sigmoid head (the
occupancy fields) or a tanh head (the texture field's RGB,
``models.texture``).

GroupNorm scope is a parameter: ``gn_scope=None`` pools the statistics over
all N points of the call (what flax ``GroupNorm`` does inside the JAX main
path's XLA ``PointMLP``, so the port's field equals that field);
``gn_scope=512`` pools over 512-point segments like the Pallas kernel's
tiles (``pallas_query.gn_scoped_apply``).

``fused_gather_mlp`` dispatches on the tensors' device: a CPU tensor goes to
the plain PyTorch version ``fused_gather_mlp_ref``; a CUDA tensor launches
``csrc/fused_query.cu`` (built with nvcc at first use) or raises.  There is
no fallback from the kernel to the plain version.

A CUDA call is planned once per shape (``plan_chain``: the launches and one
workspace that holds every intermediate), bound to addresses (``Chain``)
and enqueued by one host call, ``fq_chain``: the gather, then per Dense
layer one launch (f32: FMA tiles; bf16: wgmma tiles fed by TMA, or the
per-row head for a last layer of 1 or ``HEAD_COLS`` columns) and the
reduce of its GroupNorm statistics.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "fused_query.cu")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libfused_query.so")
_LOCKS: dict = {}
_LIB: list = []

# by compute dtype: point rows per row block of the layer kernel's statistics
# partials, and per block tile (what gn_scope must be a multiple of)
BM = {torch.float32: 64, torch.bfloat16: 64}
TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}
BK = 64             # K values per ring stage of the bf16 layer kernel
STATS_SPLIT = 8     # partial (sum, sum of squares) pairs per (segment, group)
MAXK_NORM = 1024    # widest normalised layer the kernel's prologue holds
EPS = 1e-5
SLOPE = 0.01
SLOPE_BF16 = 0.010009765625     # 0.01 rounded to bf16
HEAD_COLS = 3       # the bf16 head kernel's wider last layer (RGB)
LAST_OPS = (None, "sigmoid", "tanh")
# LayerParams.kind: which kernel a layer launches
KIND_F32, KIND_WGMMA, KIND_HEAD = 0, 1, 2


# ------------------------------------------------------------- packing
def _rup(n: int, m: int) -> int:
    return -(-n // m) * m


def _r8(n: int) -> int:
    return _rup(n, 8)


@dataclass
class PackedLayer:
    weight: torch.Tensor            # [M, K1 + K2] compute dtype (plain)
    # [M, k1p + k2p], K ranges zero-padded to 8: read by the f32 layer
    # kernel of csrc/fused_query.cu and by csrc/fused_mlp.cu
    weight_p: torch.Tensor
    # [M, k1k + k2k], K ranges zero-padded to BK: read by the bf16 layer
    # and head kernels of csrc/fused_query.cu; None for f32
    weight_k: torch.Tensor | None
    bias: torch.Tensor              # [M] f32, rounded to the compute dtype
    gn_scale: torch.Tensor | None   # [M] f32
    gn_bias: torch.Tensor | None    # [M] f32
    k1: int                         # real width of the first K range
    k1p: int                        # k1 padded to a multiple of 8
    k2p: int                        # padded residual (x0) range, or 0
    k1k: int                        # k1 padded to a multiple of BK
    k2k: int                        # residual range padded to BK, or 0


@dataclass
class PackedMLP:
    layers: list
    in_dim: int
    res_layers: frozenset
    compute_dtype: torch.dtype
    plans: dict = field(default_factory=dict)   # plan_chain's cache

    @property
    def widths(self) -> list:
        return [int(L.weight.shape[0]) for L in self.layers]


def _pad_ranges(wc: torch.Tensor, k1: int, k2: int, to: int) -> torch.Tensor:
    """``[M, k1 + k2]`` -> ``[M, rup(k1) + rup(k2)]``, each K range
    zero-padded to a multiple of ``to``."""
    wp = torch.zeros((int(wc.shape[0]), _rup(k1, to) + _rup(k2, to)),
                     dtype=wc.dtype, device=wc.device)
    wp[:, :k1] = wc[:, :k1]
    wp[:, _rup(k1, to):_rup(k1, to) + k2] = wc[:, k1:]
    return wp


def pack_layers(linears: Sequence, norms: Sequence,
                compute_dtype: torch.dtype,
                res_layers: Sequence[int] = ()) -> PackedMLP:
    """Pack ``(weight [out, in], bias [out])`` per layer and ``(scale,
    bias)`` or None per layer, once, for the kernels and their plain
    versions.  Weights keep the ``nn.Linear`` layout (each output column's
    weights contiguous in K: the B operand layout the kernels load); the
    kernels' copies pad each K range (h_prev, then x0 for a residual layer)
    with zeros: to a multiple of 8, so operands move in 16-byte chunks, and
    for bf16 also to a multiple of ``BK``, a whole ring stage."""
    res = frozenset(int(r) for r in res_layers)
    c0 = int(linears[0][0].shape[1]) // (2 if 0 in res else 1)
    layers = []
    for i, ((w, b), nrm) in enumerate(zip(linears, norms)):
        k1 = c0 if i == 0 else int(linears[i - 1][0].shape[0])
        k2 = c0 if i in res else 0
        if int(w.shape[1]) != k1 + k2:
            raise ValueError(f"layer {i}: {w.shape[1]} inputs, expected "
                             f"{k1} + {k2}")
        wc = w.detach().to(compute_dtype)
        layers.append(PackedLayer(
            weight=wc.contiguous(), weight_p=_pad_ranges(wc, k1, k2, 8),
            weight_k=_pad_ranges(wc, k1, k2, BK)
            if compute_dtype == torch.bfloat16 else None,
            bias=b.detach().to(compute_dtype).float().contiguous(),
            gn_scale=None if nrm is None else nrm[0].detach().float()
            .contiguous(),
            gn_bias=None if nrm is None else nrm[1].detach().float()
            .contiguous(), k1=k1, k1p=_r8(k1), k2p=_r8(k2),
            k1k=_rup(k1, BK), k2k=_rup(k2, BK)))
    return PackedMLP(layers, c0, res, compute_dtype)


# ------------------------------------------------------- plain version
def gather_rows_weights(uv: torch.Tensor, H: int, W: int):
    """Tap indices and hat weights (``pallas_query.gather_rows_weights``):
    returns ``(ix, iy)`` of the top-left tap and ``[N, 4]`` weights for
    taps (y0,xl), (y0,xl+1), (y1,xl), (y1,xl+1); out-of-range taps weigh
    exactly 0."""
    x = (uv[:, 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[:, 1] + 1.0) * 0.5 * (H - 1)
    xl = torch.clamp(torch.floor(x), 0, max(W - 2, 0))
    yt = torch.clamp(torch.floor(y), 0, max(H - 2, 0))
    wxl = torch.clamp(1.0 - torch.abs(x - xl), min=0.0)
    wxr = torch.clamp(1.0 - torch.abs(x - (xl + 1.0)), min=0.0)
    wyt = torch.clamp(1.0 - torch.abs(y - yt), min=0.0)
    wyb = torch.clamp(1.0 - torch.abs(y - (yt + 1.0)), min=0.0)
    wts = torch.stack([wyt * wxl, wyt * wxr, wyb * wxl, wyb * wxr], dim=-1)
    return xl.long(), yt.long(), wts


def gather_ref(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``[H, W, C]`` x ``[N, 2]`` -> ``[N, C]`` f32, the kernel's gather."""
    H, W, C = feat.shape
    ix, iy, w = gather_rows_weights(uv.float(), H, W)
    f = feat.reshape(H * W, C).float()

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        ok = ((yy < H) & (xx < W)).float()[:, None]
        idx = yy.clamp(max=H - 1) * W + xx.clamp(max=W - 1)
        return f[idx] * ok

    return (tap(0, 0) * w[:, 0:1] + tap(0, 1) * w[:, 1:2]
            + tap(1, 0) * w[:, 2:3] + tap(1, 1) * w[:, 3:4])


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _segments(N: int, gn_scope: int | None) -> int:
    if gn_scope is None:
        return 1
    if N % gn_scope:
        raise ValueError(f"N={N} is not a multiple of gn_scope={gn_scope}")
    return N // gn_scope


def group_norm_ref(h32: torch.Tensor, scale, bias, num_groups: int,
                   gn_scope: int | None) -> torch.Tensor:
    """GroupNorm over ``[N, C]`` with statistics per (segment, group):
    ``E[x^2] - E[x]^2`` in f32, clipped at 0 (flax's fast variance)."""
    N, C = h32.shape
    n_seg = _segments(N, gn_scope)
    x = h32.reshape(n_seg, N // n_seg, num_groups, C // num_groups)
    mean = x.mean(dim=(1, 3), keepdim=True)
    mean2 = (x * x).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = (1.0 / torch.sqrt(var + EPS)) * scale.reshape(
        1, 1, num_groups, -1)
    y = (x - mean) * mul + bias.reshape(1, 1, num_groups, -1)
    return y.reshape(N, C)


def _leaky(x: torch.Tensor, dtype: torch.dtype = torch.float32):
    """leaky_relu(0.01) of f32 ``x`` as JAX computes it in ``dtype``: in
    bf16 the slope is rounded to bf16 first and the product rounded after
    (``x`` then holds bf16 values; a norm-free bf16 chain).  After
    GroupNorm the activation is f32 whatever the compute dtype."""
    if dtype == torch.bfloat16:
        return torch.where(x >= 0, x, _round(SLOPE_BF16 * x, dtype))
    return torch.where(x >= 0, x, SLOPE * x)


def fused_gather_mlp_ref(feat, uv, extra, layers: PackedMLP, *,
                         res_layers=(), merge_layer: int = -1,
                         num_groups: int = 32,
                         last_op: str | None = "sigmoid",
                         gn_scope: int | None = None):
    """Plain PyTorch version of the kernel, rounding at the same places."""
    cd = layers.compute_dtype
    x0 = torch.cat([gather_ref(feat, uv), extra.float()], dim=-1).to(cd)
    res = frozenset(int(r) for r in res_layers)
    n_layers = len(layers.layers)
    h = x0
    phi = None
    out = None
    for i, L in enumerate(layers.layers):
        inp = torch.cat([h, x0], dim=-1) if i in res else h
        y = _round(inp.float() @ L.weight.float().t(), cd)
        y = _round(y + L.bias, cd)
        if i == n_layers - 1:
            out = y
            if i == merge_layer:
                phi = y
            break
        if L.gn_scale is not None:
            y = _leaky(group_norm_ref(y, L.gn_scale, L.gn_bias, num_groups,
                                      gn_scope))
        else:
            y = _leaky(y, cd)
        if i == merge_layer:
            phi = y
        h = y.to(cd)
    if last_op == "sigmoid":
        out = torch.sigmoid(out)
    elif last_op == "tanh":
        out = torch.tanh(out)
    return out, phi


# -------------------------------------------------------- CUDA binding
# Mirrors of the structs of csrc/fused_query.cu, field for field.
_GATHER_PTRS = ("feat", "uv", "extra", "x0")
_GATHER_INTS = ("H", "W", "C", "E", "ldx", "N")
_LAYER_PTRS = ("a1", "a2", "w", "bias", "stats_in", "gs_in", "gb_in", "out",
               "raw_out", "phi_out", "part_out", "stats_out")
_LAYER_INTS = ("kind", "N", "K1", "K1p", "K2p", "M", "ldo", "lda1", "lda2",
               "norm_in", "cg_in", "g_in", "cg_out", "g_out", "seg_rows",
               "n_seg", "last", "sigmoid", "tanh")


class _GatherParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _GATHER_PTRS] + [
        (n, ctypes.c_int) for n in _GATHER_INTS]


class _LayerParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _LAYER_PTRS] + [
        (n, ctypes.c_int) for n in _LAYER_INTS]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def build_cuda(src: str, so: str) -> str:
    """Compile one CUDA source into ``_build/`` (nvcc, sm_90a) unless the
    library is newer than the source and every header (``*.cuh``) beside
    it.  Returns the compiler's output (``-Xptxas -v``: registers, spills);
    raises if the build fails."""
    with _LOCKS.setdefault(so, threading.Lock()):
        deps = [src] + glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))
        if (os.path.exists(so) and os.path.getmtime(so)
                >= max(os.path.getmtime(d) for d in deps)):
            return ""
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
        return r.stdout + r.stderr


def build() -> str:
    """Compile ``csrc/fused_query.cu``; see ``build_cuda``."""
    return build_cuda(_SRC, _SO)


def _lib():
    if _LIB:
        return _LIB[0]
    build()
    lib = ctypes.CDLL(_SO)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    gp, lp = ctypes.POINTER(_GatherParams), ctypes.POINTER(_LayerParams)
    lib.fq_abi.restype = ci
    lib.fq_abi.argtypes = [ci]
    lib.fq_gather.restype = ci
    lib.fq_gather.argtypes = [ci, gp, vp]
    lib.fq_launch.restype = ci
    lib.fq_launch.argtypes = [ci, gp, lp, ci, ci, vp]
    lib.fq_chain.restype = ci
    lib.fq_chain.argtypes = [ci, gp, lp, ci, vp, ctypes.POINTER(ci)]
    got = [lib.fq_abi(i) for i in range(8)]
    want = [ctypes.sizeof(_GatherParams), ctypes.sizeof(_LayerParams),
            BM[torch.float32], BM[torch.bfloat16], BK,
            TILE_ROWS[torch.bfloat16], STATS_SPLIT, HEAD_COLS]
    if got != want:
        raise RuntimeError(f"fused_query: the library says {got} for struct "
                           f"sizes, row blocks, K padding, tile rows and "
                           f"head columns; this module {want}")
    _LIB.append(lib)
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_query {what}: CUDA error {rc}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 256        # bytes between the workspace's buffers


@dataclass
class LayerPlan:
    """One layer launch of a chain: the int fields of ``LayerParams`` and,
    by name, the workspace buffers its pointers take."""
    ints: dict
    a1: str                     # "x0" or "h<i-1>"
    a2: str | None              # "x0" for a residual layer
    out: str                    # "h<i>", or "pred" (the last layer)
    stats_in: str | None        # "stats<i-1>" after a GroupNorm layer
    part_out: str | None        # "part<i>" / "stats<i>" of a GroupNorm layer
    stats_out: str | None
    phi: str | None             # which field writes phi: "phi_out" (this
    #                             layer's activated input) or "raw_out"


@dataclass
class ChainPlan:
    """Everything about one chain call that does not depend on addresses:
    the workspace layout and each launch's arguments."""
    dtype: torch.dtype
    k0p: int                    # x0's row length (C + E padded to 8)
    nbytes: int                 # workspace size
    buffers: dict               # name -> (byte offset, byte size)
    layers: list                # LayerPlan per Dense
    phi_cols: int | None        # width of phi, None without a merge layer
    pred_cols: int


def plan_chain(mlp: PackedMLP, N: int, C: int, E: int, merge: int,
               num_groups: int, last_op: str | None,
               gn_scope: int | None) -> ChainPlan:
    """The launches of one ``fused_gather_mlp`` call over ``N`` points:
    gather into ``x0``, then per Dense one layer launch (f32: FMA tiles;
    bf16: wgmma tiles, or the per-row head for a last layer of 1 or
    ``HEAD_COLS`` columns) that reads ``h<i-1>`` (and ``x0`` for a residual
    layer) and writes ``h<i>`` with its column partials ``part<i>`` reduced
    into ``stats<i>``.  phi comes from the layer after the merge layer, which
    writes its activated input, or from ``raw_out`` when the merge layer is
    the last.  All buffers lie in one workspace, ``_ALIGN`` bytes apart at
    least.  Cached on ``mlp``."""
    key = (N, C, E, merge, num_groups, last_op, gn_scope)
    if key in mlp.plans:
        return mlp.plans[key]
    cd = mlp.compute_dtype
    bf = cd == torch.bfloat16
    es = 2 if bf else 4
    n_layers = len(mlp.layers)
    seg_rows = N if gn_scope is None else int(gn_scope)
    n_seg = _segments(N, gn_scope)
    n_rb = -(-N // BM[cd])
    k0p = _r8(C + E)
    buffers: dict = {}
    nbytes = 0

    def alloc(name: str, size: int) -> str:
        nonlocal nbytes
        buffers[name] = (nbytes, size)
        nbytes += _rup(size, _ALIGN)
        return name

    alloc("x0", N * k0p * es)
    layers = []
    phi_cols = None
    for i, L in enumerate(mlp.layers):
        M = int(L.weight.shape[0])
        last = i == n_layers - 1
        kind = KIND_F32 if not bf else (
            KIND_HEAD if last and M in (1, HEAD_COLS) else KIND_WGMMA)
        k1p, k2p = (L.k1p, L.k2p) if kind == KIND_F32 else (L.k1k, L.k2k)
        ints = dict(kind=kind, N=N, K1=L.k1, K1p=k1p, K2p=k2p, M=M,
                    seg_rows=seg_rows, n_seg=n_seg, last=int(last),
                    sigmoid=int(last and last_op == "sigmoid"),
                    tanh=int(last and last_op == "tanh"))
        lp = LayerPlan(ints, "x0", "x0" if L.k2p else None, "pred", None,
                       None, None, None)
        if i == 0:
            ints.update(lda1=k0p, norm_in=0)
        else:
            prev = mlp.layers[i - 1]
            lp.a1 = f"h{i - 1}"
            ints.update(lda1=_r8(L.k1), norm_in=1)
            if prev.gn_scale is not None:
                lp.stats_in = f"stats{i - 1}"
                ints.update(norm_in=2, cg_in=L.k1 // num_groups,
                            g_in=num_groups)
            if merge == i - 1:
                lp.phi, phi_cols = "phi_out", L.k1
        if lp.a2:
            ints.update(lda2=k0p)
        if last:
            ints.update(ldo=M)
            if merge == i:
                lp.phi, phi_cols = "raw_out", M
        else:
            lp.out = alloc(f"h{i}", N * _r8(M) * es)
            ints.update(ldo=_r8(M))
            if L.gn_scale is not None:
                lp.part_out = alloc(f"part{i}", n_rb * M * 2 * 4)
                lp.stats_out = alloc(
                    f"stats{i}", n_seg * num_groups * STATS_SPLIT * 2 * 4)
                ints.update(cg_out=M // num_groups, g_out=num_groups)
        layers.append(lp)
    plan = ChainPlan(cd, k0p, nbytes, buffers, layers, phi_cols,
                     mlp.widths[-1])
    mlp.plans[key] = plan
    return plan


class Chain:
    """One bound chain call: the workspace, the outputs and the argument
    structs.  ``run`` enqueues every launch from one host call; ``run_one``
    enqueues one of them (0 the gather, i + 1 layer i) so that it can be
    timed alone after a ``run`` has filled its inputs."""

    def __init__(self, feat, uv, extra, mlp: PackedMLP, merge, num_groups,
                 last_op, gn_scope):
        self.lib = _lib()
        dev = feat.device
        H, W, C = feat.shape
        N, E = extra.shape
        self.plan = plan = plan_chain(mlp, N, C, E, merge, num_groups,
                                      last_op, gn_scope)
        self.code = _DTYPE_CODE[plan.dtype]
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.ws = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
        self.pred = torch.empty((N, plan.pred_cols), dtype=torch.float32,
                                device=dev)
        self.phi = None if plan.phi_cols is None else torch.empty(
            (N, plan.phi_cols), dtype=torch.float32, device=dev)
        base = self.ws.data_ptr()
        at = {k: base + off for k, (off, _) in plan.buffers.items()}
        at["pred"] = self.pred.data_ptr()
        at[None] = None
        self.gather = g = _GatherParams()
        g.feat, g.uv, g.extra, g.x0 = (feat.data_ptr(), uv.data_ptr(),
                                       extra.data_ptr(), at["x0"])
        g.H, g.W, g.C, g.E, g.ldx, g.N = H, W, C, E, plan.k0p, N
        self.layers = arr = (_LayerParams * len(plan.layers))()
        for i, (lp, L) in enumerate(zip(plan.layers, mlp.layers)):
            p = arr[i]              # a view of the array's element
            for k, v in lp.ints.items():
                setattr(p, k, v)
            p.a1, p.a2, p.out = at[lp.a1], at[lp.a2], at[lp.out]
            p.stats_in, p.part_out, p.stats_out = (
                at[lp.stats_in], at[lp.part_out], at[lp.stats_out])
            p.w = (L.weight_p if lp.ints["kind"] == KIND_F32
                   else L.weight_k).data_ptr()
            p.bias = L.bias.data_ptr()
            if i:
                prev = mlp.layers[i - 1]
                p.gs_in, p.gb_in = _ptr(prev.gn_scale), _ptr(prev.gn_bias)
            if lp.phi:
                setattr(p, lp.phi, self.phi.data_ptr())

    def run(self) -> None:
        at = ctypes.c_int(-1)
        rc = self.lib.fq_chain(self.code, ctypes.byref(self.gather),
                               self.layers, len(self.layers), self.stream,
                               ctypes.byref(at))
        if rc != 0:
            what = "gather" if at.value == 0 else f"layer {at.value - 1}"
            raise RuntimeError(f"fused_query launch {at.value} ({what}): "
                               f"CUDA error {rc}")

    def run_one(self, which: int) -> None:
        _check(self.lib.fq_launch(self.code, ctypes.byref(self.gather),
                                  self.layers, len(self.layers), which,
                                  self.stream), f"launch {which}")


def _launch(feat, uv, extra, mlp: PackedMLP, merge, num_groups, last_op,
            gn_scope):
    """Gather + one layer launch per Dense, from one host call."""
    c = Chain(feat, uv, extra, mlp, merge, num_groups, last_op, gn_scope)
    c.run()
    return c.pred, c.phi


def _check_args(feat, uv, extra, mlp: PackedMLP, num_groups, gn_scope):
    cd = mlp.compute_dtype
    if cd not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cd}")
    if feat.dim() != 3 or uv.dim() != 2 or uv.shape[1] != 2 \
            or extra.dim() != 2 or extra.shape[0] != uv.shape[0]:
        raise ValueError("expected feat [H, W, C], uv [N, 2], extra [N, E]")
    for name, t, dt in (("feat", feat, cd), ("uv", uv, torch.float32),
                        ("extra", extra, torch.float32)):
        if t.device != feat.device:
            raise ValueError(f"{name} is on {t.device}, feat on {feat.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feat.shape[2] + extra.shape[1] != mlp.in_dim:
        raise ValueError(f"C + E = {feat.shape[2] + extra.shape[1]} but the "
                         f"first layer takes {mlp.in_dim}")
    for i, L in enumerate(mlp.layers):
        if L.weight.device != feat.device or L.weight.dtype != cd:
            raise ValueError(f"layer {i} weights not {cd} on {feat.device}")
        if L.gn_scale is not None:
            M = int(L.weight.shape[0])
            if M % num_groups:
                raise ValueError(f"layer {i}: width {M} not divisible by "
                                 f"{num_groups} groups")
            if M > MAXK_NORM:
                raise ValueError(f"layer {i}: normalised width {M} > "
                                 f"{MAXK_NORM}")
            if gn_scope is not None and gn_scope % TILE_ROWS[cd]:
                raise ValueError(f"gn_scope {gn_scope} must be a multiple "
                                 f"of {TILE_ROWS[cd]}")


def fused_gather_mlp(feat: torch.Tensor, uv: torch.Tensor,
                     extra: torch.Tensor, layers: PackedMLP, *,
                     res_layers: Sequence[int] = (), merge_layer: int = -1,
                     num_groups: int = 32, last_op: str | None = "sigmoid",
                     gn_scope: int | None = None,
                     compute_dtype: torch.dtype | None = None):
    """Fused bilinear gather + MLP over ``N`` query points.

    Args:
        feat: ``[H, W, C]`` feature map in the compute dtype.
        uv: ``[N, 2]`` f32 normalised coords (x, y) in [-1, 1].
        extra: ``[N, E]`` f32 channels appended after the gathered features
            (the depth feature on the coarse level, phi on the fine one).
        layers: ``pack_layers`` output.
        merge_layer: layer whose post-activation output is returned as phi;
            -1 disables.
        last_op: the last layer's activation, ``"sigmoid"``, ``"tanh"`` or
            None.
        gn_scope: None = GroupNorm statistics over all N points; an int =
            over segments of that many points (N must be a multiple).

    Returns ``(pred [N, C_out] f32, phi [N, C_merge] f32 or None)``.
    """
    if compute_dtype is not None and compute_dtype != layers.compute_dtype:
        raise ValueError("compute_dtype differs from the packed layers'")
    if frozenset(int(r) for r in res_layers) != layers.res_layers:
        raise ValueError("res_layers differ from the packed layers'")
    if last_op not in LAST_OPS:
        raise ValueError(f"unknown last_op {last_op!r}")
    if feat.device.type == "cpu":
        return fused_gather_mlp_ref(
            feat, uv, extra, layers, res_layers=res_layers,
            merge_layer=merge_layer, num_groups=num_groups, last_op=last_op,
            gn_scope=gn_scope)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    _check_args(feat, uv, extra, layers, num_groups, gn_scope)
    if extra.shape[0] == 0:
        raise ValueError("empty query")
    out = _launch(feat, uv, extra, layers, int(merge_layer), num_groups,
                  last_op, gn_scope)
    fused_gather_mlp.launches += 1
    return out


fused_gather_mlp.launches = 0


def gather_concat(feat: torch.Tensor, uv: torch.Tensor,
                  extra: torch.Tensor) -> torch.Tensor:
    """The kernel's gather on its own: ``feat [H, W, C]``, ``uv [N, 2]``
    f32, ``extra [N, E]`` f32 -> ``x0 [N, r8(C + E)]`` in ``feat``'s dtype
    (gathered channels, then ``extra``, then zero padding to a multiple of
    8), the input of ``ops.fused_mlp.fused_point_mlp``.  A CPU tensor takes
    ``gather_ref``; a CUDA tensor launches ``gather_kernel`` or raises."""
    H, W, C = feat.shape
    N, E = extra.shape
    K0p = _r8(C + E)
    if feat.device.type == "cpu":
        x0 = torch.zeros((N, K0p), dtype=feat.dtype)
        x0[:, :C + E] = torch.cat([gather_ref(feat, uv), extra.float()],
                                  dim=-1).to(feat.dtype)
        return x0
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    if feat.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {feat.dtype}")
    for name, t, dt in (("feat", feat, feat.dtype),
                        ("uv", uv, torch.float32),
                        ("extra", extra, torch.float32)):
        if t.device != feat.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{feat.device}")
    if uv.shape != (N, 2) or N == 0:
        raise ValueError("expected uv [N, 2] and extra [N, E] with N > 0")
    x0 = torch.empty((N, K0p), dtype=feat.dtype, device=feat.device)
    g = _GatherParams()
    g.feat, g.uv, g.extra, g.x0 = (feat.data_ptr(), uv.data_ptr(),
                                   extra.data_ptr(), x0.data_ptr())
    g.H, g.W, g.C, g.E, g.ldx, g.N = H, W, C, E, K0p, N
    _check(_lib().fq_gather(
        _DTYPE_CODE[feat.dtype], ctypes.byref(g),
        torch.cuda.current_stream(feat.device).cuda_stream), "gather")
    gather_concat.launches += 1
    return x0


gather_concat.launches = 0
