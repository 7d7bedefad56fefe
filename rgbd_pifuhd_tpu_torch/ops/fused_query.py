"""Fused field query: bilinear gather + PointMLP chain (CUDA kernel).

Port of the TPU kernel ``rgbd_pifuhd_tpu/ops/pallas_query.py``
``fused_gather_mlp`` (``pallas_call`` at :364).  Per point: a 4-tap
hat-weight bilinear gather from ``feat [H, W, C]`` (equal to grid_sample
with zeros padding and ``align_corners=True``), concat of ``extra [N, E]``,
then the PointMLP chain — Dense, GroupNorm(32) with ``E[x^2] - E[x]^2``
statistics in f32, leaky_relu(0.01), residual concat of the original input,
``phi`` after the merge layer, sigmoid head.

GroupNorm scope is a parameter: ``gn_scope=None`` pools the statistics over
all N points of the call (what flax ``GroupNorm`` does inside the JAX main
path's XLA ``PointMLP``, so the port's field equals that field);
``gn_scope=512`` pools over 512-point segments like the Pallas kernel's
tiles (``pallas_query.gn_scoped_apply``).

``fused_gather_mlp`` dispatches on the tensors' device: a CPU tensor goes to
the plain PyTorch version ``fused_gather_mlp_ref``; a CUDA tensor launches
``csrc/fused_query.cu`` (built with nvcc at first use) or raises.  There is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "fused_query.cu")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libfused_query.so")
_LOCKS: dict = {}
_LIB: list = []

BM = 64             # point rows per block tile of the layer kernel
MAXK_NORM = 1024    # widest normalised layer the kernel's prologue holds
EPS = 1e-5
SLOPE = 0.01
SLOPE_BF16 = 0.010009765625     # 0.01 rounded to bf16


# ------------------------------------------------------------- packing
def _r8(n: int) -> int:
    return -(-n // 8) * 8


@dataclass
class PackedLayer:
    weight: torch.Tensor            # [M, K1 + K2] compute dtype (plain)
    weight_p: torch.Tensor          # [M, K1p + K2p] zero-padded (kernel)
    bias: torch.Tensor              # [M] f32, rounded to the compute dtype
    gn_scale: torch.Tensor | None   # [M] f32
    gn_bias: torch.Tensor | None    # [M] f32
    k1: int                         # real width of the first K range
    k1p: int                        # k1 padded to a multiple of 8
    k2p: int                        # padded residual (x0) range, or 0


@dataclass
class PackedMLP:
    layers: list
    in_dim: int
    res_layers: frozenset
    compute_dtype: torch.dtype

    @property
    def widths(self) -> list:
        return [int(L.weight.shape[0]) for L in self.layers]


def pack_layers(linears: Sequence, norms: Sequence,
                compute_dtype: torch.dtype,
                res_layers: Sequence[int] = ()) -> PackedMLP:
    """Pack ``(weight [out, in], bias [out])`` per layer and ``(scale,
    bias)`` or None per layer, once, for the kernel and its plain version.
    Weights keep the ``nn.Linear`` layout (each output column's weights
    contiguous in K: the B operand layout the kernel loads); the kernel's
    copy pads each K range (h_prev, then x0 for a residual layer) to a
    multiple of 8 with zeros, so operands move in 16-byte chunks."""
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
        wp = torch.zeros((int(w.shape[0]), _r8(k1) + _r8(k2)),
                         dtype=compute_dtype, device=w.device)
        wp[:, :k1] = wc[:, :k1]
        wp[:, _r8(k1):_r8(k1) + k2] = wc[:, k1:]
        layers.append(PackedLayer(
            weight=wc.contiguous(), weight_p=wp,
            bias=b.detach().to(compute_dtype).float().contiguous(),
            gn_scale=None if nrm is None else nrm[0].detach().float()
            .contiguous(),
            gn_bias=None if nrm is None else nrm[1].detach().float()
            .contiguous(), k1=k1, k1p=_r8(k1), k2p=_r8(k2)))
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
    return out, phi


# -------------------------------------------------------- CUDA binding
class _LayerParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "a1", "a2", "w", "bias", "stats_in", "gs_in", "gb_in", "out",
        "raw_out", "part_out", "stats_out")] + [(n, ctypes.c_int) for n in (
            "N", "K1", "K1p", "K2p", "M", "ldo", "lda1", "lda2", "norm_in",
            "cg_in",
            "g_in", "cg_out", "g_out", "seg_rows", "n_seg", "last",
            "sigmoid")]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def build_cuda(src: str, so: str) -> str:
    """Compile one CUDA source into ``_build/`` (nvcc, sm_90a) unless the
    library is newer than the source.  Returns the compiler's output
    (``-Xptxas -v``: registers, spills); raises if the build fails."""
    with _LOCKS.setdefault(so, threading.Lock()):
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            return ""
        os.makedirs(_BUILD, exist_ok=True)
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
    lib.fq_gather.restype = ci
    lib.fq_gather.argtypes = [ci, vp, ci, ci, ci, vp, vp, ci, vp, ci, ci,
                              vp]
    lib.fq_layer.restype = ci
    lib.fq_layer.argtypes = [ci, ctypes.POINTER(_LayerParams), vp]
    lib.fq_act.restype = ci
    lib.fq_act.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, vp, ci, ci, ci,
                           vp, vp]
    _LIB.append(lib)
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_query {what}: CUDA error {rc}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(feat, uv, extra, mlp: PackedMLP, merge, num_groups, last_op,
            gn_scope):
    """Gather + one layer launch per Dense + the phi activation."""
    lib = _lib()
    cd = mlp.compute_dtype
    code = _DTYPE_CODE[cd]
    dev = feat.device
    H, W, C = feat.shape
    N, E = extra.shape
    K0p = _r8(C + E)
    n_layers = len(mlp.layers)
    seg_rows = N if gn_scope is None else int(gn_scope)
    n_seg = _segments(N, gn_scope)
    stream = torch.cuda.current_stream(dev).cuda_stream

    x0 = torch.empty((N, K0p), dtype=cd, device=dev)
    _check(lib.fq_gather(code, feat.data_ptr(), H, W, C, uv.data_ptr(),
                         extra.data_ptr(), E, x0.data_ptr(), K0p, N, stream),
           "gather")
    hs, stats = [], []
    pred = phi = None
    for i, L in enumerate(mlp.layers):
        M = int(L.weight.shape[0])
        last = i == n_layers - 1
        p = _LayerParams()
        p.K1, p.K1p, p.K2p = L.k1, L.k1p, L.k2p
        if i == 0:
            p.a1, p.lda1, p.norm_in = x0.data_ptr(), K0p, 0
        else:
            prev = mlp.layers[i - 1]
            p.a1, p.lda1 = hs[-1].data_ptr(), hs[-1].shape[1]
            if prev.gn_scale is not None:
                p.norm_in = 2
                p.stats_in = stats[-1].data_ptr()
                p.gs_in, p.gb_in = _ptr(prev.gn_scale), _ptr(prev.gn_bias)
                p.cg_in, p.g_in = L.k1 // num_groups, num_groups
            else:
                p.norm_in = 1
        if L.k2p:
            p.a2, p.lda2 = x0.data_ptr(), K0p
        p.w, p.bias, p.M, p.N = L.weight_p.data_ptr(), L.bias.data_ptr(), M, N
        p.seg_rows, p.n_seg = seg_rows, n_seg
        st = None
        if last:
            pred = torch.empty((N, M), dtype=torch.float32, device=dev)
            p.out, p.ldo, p.last = pred.data_ptr(), M, 1
            p.sigmoid = int(last_op == "sigmoid")
            if merge == i:
                phi = torch.empty((N, M), dtype=torch.float32, device=dev)
                p.raw_out = phi.data_ptr()
        else:
            h = torch.empty((N, _r8(M)), dtype=cd, device=dev)
            p.out, p.ldo = h.data_ptr(), h.shape[1]
            if L.gn_scale is not None:
                st = torch.empty((n_seg, num_groups, 2), dtype=torch.float32,
                                 device=dev)
                part = torch.empty((-(-N // BM), M, 2), dtype=torch.float32,
                                   device=dev)
                p.part_out, p.stats_out = part.data_ptr(), st.data_ptr()
                p.cg_out, p.g_out = M // num_groups, num_groups
            hs.append(h)
        stats.append(st)
        _check(lib.fq_layer(code, ctypes.byref(p), stream), f"layer {i}")
    if 0 <= merge < n_layers - 1:
        L = mlp.layers[merge]
        M = int(L.weight.shape[0])
        phi = torch.empty((N, M), dtype=torch.float32, device=dev)
        gn = L.gn_scale is not None
        _check(lib.fq_act(code, hs[merge].data_ptr(), hs[merge].shape[1], N,
                          M, 2 if gn else 1, _ptr(stats[merge]),
                          _ptr(L.gn_scale), _ptr(L.gn_bias),
                          M // num_groups if gn else 1, num_groups, seg_rows,
                          phi.data_ptr(), stream), "phi")
    return pred, phi


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
            if gn_scope is not None and gn_scope % BM:
                raise ValueError(f"gn_scope {gn_scope} must be a multiple "
                                 f"of {BM}")


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
        gn_scope: None = GroupNorm statistics over all N points; an int =
            over segments of that many points (N must be a multiple).

    Returns ``(pred [N, C_out] f32, phi [N, C_merge] f32 or None)``.
    """
    if compute_dtype is not None and compute_dtype != layers.compute_dtype:
        raise ValueError("compute_dtype differs from the packed layers'")
    if frozenset(int(r) for r in res_layers) != layers.res_layers:
        raise ValueError("res_layers differ from the packed layers'")
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
    _check(_lib().fq_gather(
        _DTYPE_CODE[feat.dtype], feat.data_ptr(), H, W, C, uv.data_ptr(),
        extra.data_ptr(), E, x0.data_ptr(), K0p, N,
        torch.cuda.current_stream(feat.device).cuda_stream), "gather")
    gather_concat.launches += 1
    return x0


gather_concat.launches = 0
