"""Plain version of the port's fused query against the JAX package: the
Pallas kernel in interpret mode (GroupNorm over point tiles) and the XLA
``PointMLP`` chain (GroupNorm over the whole call), f32.  Mirrors
``tests/test_pallas_query.py``.  The CUDA kernel itself runs only on the
card (``chip_smoke.py`` holds it against this plain version there); on the
CPU the wrapper takes the plain version and its launch counter stays 0.

Tolerances: the hat-weight gather is the same arithmetic (atol 1e-6); MLP
chains rtol 2e-4 / atol 2e-5 as the Pallas test (f32 sums in other
orders)."""

import ctypes
import os
import re
import stat
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models.mlp import PointMLP as JPointMLP
from rgbd_pifuhd_tpu.ops import geometry as jgeom
from rgbd_pifuhd_tpu.ops.pallas_query import (
    fused_gather_mlp as pallas_fused, gn_scoped_apply, mlp_params_from_tree)
from rgbd_pifuhd_tpu_torch.models.mlp import PointMLP
from rgbd_pifuhd_tpu_torch.ops import fused_query as fq
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params

T = torch.from_numpy


def _port_mlp(dims, merge, res, norm, params):
    m = PointMLP(dims, merge, res, norm, device="cpu")
    load_params(m, jax.tree.map(np.asarray, params))
    return m


def _xla_input(feat, uv, extra):
    g = jgeom.grid_sample_bilinear(jnp.asarray(feat)[None],
                                   jnp.asarray(uv)[None])[0]
    return jnp.concatenate([g, jnp.asarray(extra)], -1)[None]


def test_gather_matches_grid_sample(rng):
    H, W, C = 13, 17, 5
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = np.concatenate([
        rng.uniform(-1.3, 1.3, (200, 2)),
        np.array([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [0.0, 0.0]]),
    ]).astype(np.float32)
    ref = jgeom.grid_sample_bilinear(jnp.asarray(feat)[None],
                                     jnp.asarray(uv)[None])[0]
    got = fq.gather_ref(T(feat), T(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("norm,tile,N", [("group", 128, 256),
                                         ("none", 128, 256),
                                         ("group", 512, 512)])
def test_tile_scope_matches_pallas_interpret(rng, norm, tile, N):
    """gn_scope = the Pallas tile (its default 512 included): the Pallas
    kernel in interpret mode."""
    H, W, C, E = 19, 23, 71, 1          # C forces the 128-pad path there
    dims = (C + E, 64, 32, 1)
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = rng.uniform(-1.1, 1.1, (N, 2)).astype(np.float32)
    extra = rng.standard_normal((N, E)).astype(np.float32)
    jm = JPointMLP(dims, merge_layer=1, res_layers=(1,), norm=norm)
    params = jm.init(jax.random.PRNGKey(0), _xla_input(feat, uv, extra))
    weights, gn = mlp_params_from_tree(params["params"], 3, norm)
    ref, phi_ref = pallas_fused(
        jnp.asarray(feat), jnp.asarray(uv), jnp.asarray(extra), weights, gn,
        res_layers=(1,), merge_layer=1, tile=tile,
        compute_dtype=jnp.float32, feat_dtype=jnp.float32, interpret=True)
    m = _port_mlp(dims, 1, (1,), norm, params)
    pred, phi = fq.fused_gather_mlp(T(feat), T(uv), T(extra), m.packed(),
                                    res_layers=(1,), merge_layer=1,
                                    gn_scope=tile)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_ref), rtol=2e-4,
                               atol=2e-5)
    assert fq.fused_gather_mlp.launches == 0


@pytest.mark.parametrize("scope", [None, 64])
def test_call_scope_matches_xla_pointmlp(rng, scope):
    """gn_scope=None is the JAX main path's XLA PointMLP (GroupNorm over
    the whole call); an int scope is gn_scoped_apply."""
    H, W, C, E = 16, 16, 31, 1
    N = 192
    dims = (C + E, 64, 96, 32, 1)
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    extra = rng.standard_normal((N, E)).astype(np.float32)
    x = _xla_input(feat, uv, extra)
    jm = JPointMLP(dims, merge_layer=2, res_layers=(2, 3), norm="group")
    params = jm.init(jax.random.PRNGKey(1), x)
    ref, phi_ref = (jm.apply(params, x) if scope is None
                    else gn_scoped_apply(jm, params, x, scope))
    m = _port_mlp(dims, 2, (2, 3), "group", params)
    pred, phi = fq.fused_gather_mlp(T(feat), T(uv), T(extra), m.packed(),
                                    res_layers=(2, 3), merge_layer=2,
                                    gn_scope=scope)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref[0]), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_ref[0]),
                               rtol=2e-4, atol=2e-5)


def test_ragged_n_and_narrow_widths(rng):
    """N not a multiple of anything, widths not multiples of 32 (no norm),
    residual into layer 0: against the XLA chain."""
    H, W, C, E = 9, 9, 8, 2
    dims = (C + E, 24, 13, 1)
    N = 133
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = rng.uniform(-0.9, 0.9, (N, 2)).astype(np.float32)
    extra = rng.standard_normal((N, E)).astype(np.float32)
    x = _xla_input(feat, uv, extra)
    jm = JPointMLP(dims, merge_layer=1, res_layers=(0, 2), norm="none")
    params = jm.init(jax.random.PRNGKey(2), x)
    ref, phi_ref = jm.apply(params, x)
    m = _port_mlp(dims, 1, (0, 2), "none", params)
    pred, phi = fq.fused_gather_mlp(T(feat), T(uv), T(extra), m.packed(),
                                    res_layers=(0, 2), merge_layer=1)
    assert pred.shape == (N, 1) and phi.shape == (N, 13)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref[0]), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_ref[0]),
                               rtol=2e-4, atol=2e-5)


def test_two_level_phi_chain(rng):
    """Coarse phi feeds the fine level (the flagship topology), both levels
    through the fused query, against the XLA chain over the whole call."""
    N = 256
    Hg, Wg, Cg = 16, 16, 31
    Hl, Wl, Cl = 24, 24, 7
    dims_g = (Cg + 1, 64, 32, 1)
    dims_l = (Cl + 32, 32, 1)
    feat_g = rng.standard_normal((Hg, Wg, Cg)).astype(np.float32)
    feat_l = rng.standard_normal((Hl, Wl, Cl)).astype(np.float32)
    uv = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    z = rng.standard_normal((N, 1)).astype(np.float32)
    mg = JPointMLP(dims_g, merge_layer=1, res_layers=(1,), norm="group")
    ml = JPointMLP(dims_l, merge_layer=-1, res_layers=(), norm="group")
    xg = _xla_input(feat_g, uv, z)
    pg = mg.init(jax.random.PRNGKey(0), xg)
    _, phi_ref = mg.apply(pg, xg)
    xl = _xla_input(feat_l, uv, np.asarray(phi_ref[0]))
    pl = ml.init(jax.random.PRNGKey(1), xl)
    ref, _ = ml.apply(pl, xl)
    tg = _port_mlp(dims_g, 1, (1,), "group", pg)
    tl = _port_mlp(dims_l, -1, (), "group", pl)
    _, phi = fq.fused_gather_mlp(T(feat_g), T(uv), T(z), tg.packed(),
                                 res_layers=(1,), merge_layer=1)
    pred, _ = fq.fused_gather_mlp(T(feat_l), T(uv), phi, tl.packed())
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref[0]), rtol=5e-4,
                               atol=5e-5)


def test_bf16_plain_version_rounds_like_flax(rng):
    """bf16: the plain version rounds where flax Dense(dtype=bf16) does, so
    it equals the port's PointMLP.forward (the flax chain step by step) up
    to the matmuls' sum order, which can move a value across one bf16
    rounding edge (rtol 2^-7: one bf16 ulp).  The weights come from the
    test's own seeded generator, not torch's global one: the data must
    not depend on the tests that ran before in the same process."""
    H, W, C, E = 12, 12, 30, 2
    N = 128
    dims = (C + E, 64, 32, 1)
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    extra = rng.standard_normal((N, E)).astype(np.float32)
    m = PointMLP(dims, 1, (1,), "group", dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for i in range(m.n_layers):
            w = getattr(m, f"dense{i}").weight
            w.copy_(torch.empty(w.shape).normal_(0.0, 0.02, generator=gen))
    fb = T(feat).bfloat16()
    with torch.no_grad():
        x0 = torch.cat([fq.gather_ref(fb, T(uv)), T(extra)], -1)
        ref, phi_ref = m(x0[None])
        pred, phi = fq.fused_gather_mlp(fb, T(uv), T(extra), m.packed(),
                                        res_layers=(1,), merge_layer=1)
    np.testing.assert_allclose(pred.numpy(), ref[0].float().numpy(),
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(phi.numpy(), phi_ref[0].float().numpy(),
                               rtol=2 ** -7, atol=1e-6)


def test_wrapper_checks_and_counter(rng):
    m = PointMLP((10, 32, 1), 1, (), "group", device="cpu")
    feat = T(rng.standard_normal((4, 4, 8)).astype(np.float32))
    uv = T(rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="gn_scope"):
        fq.fused_gather_mlp_ref(feat, uv, torch.zeros(64, 2), m.packed(),
                                gn_scope=48)
    fq.fused_gather_mlp(feat, uv, torch.zeros(64, 2), m.packed())
    assert fq.fused_gather_mlp.launches == 0


# ---------------------------------------------------------------------------
# What surrounds the CUDA kernels and can be checked without a card: the
# packed weight layouts, the launch plan of a chain, the ctypes mirrors of
# the kernels' argument structs, and the rebuild rule of the nvcc build.

CHAINS = {
    # flagship-lite's coarse and fine MLPs, and a narrow norm-free chain
    # with residuals whose widths are multiples of neither 8 nor 64
    "coarse": ((257, 1024, 512, 256, 128, 1), (2, 3, 4), 2, "group"),
    "fine": ((272, 512, 256, 128, 1), (1, 2), -1, "group"),
    "narrow": ((37, 72, 40, 1), (1, 2), 1, "none"),
}


def _chain_mlp(name, dtype):
    dims, res, merge, norm = CHAINS[name]
    torch.manual_seed(7)
    return PointMLP(dims, max(merge, 0), res, norm, dtype=dtype,
                    device="cpu"), res, merge


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_packed_weight_layouts(name):
    """The BK-padded copy (bf16 layer and head kernels) and the 8-padded
    copy (f32 layer kernel, fused_mlp) hold the original weights in each K
    range and zeros in every pad column."""
    m, res, _ = _chain_mlp(name, torch.bfloat16)
    packed = m.packed()
    c0 = packed.in_dim
    for i, L in enumerate(packed.layers):
        w = getattr(m, f"dense{i}").weight.detach().to(torch.bfloat16)
        k2 = c0 if i in res else 0
        assert L.k1 + k2 == w.shape[1]
        assert torch.equal(L.weight, w)
        for wp, k1p, k2p, to in ((L.weight_p, L.k1p, L.k2p, 8),
                                 (L.weight_k, L.k1k, L.k2k, fq.BK)):
            assert k1p == -(-L.k1 // to) * to and k2p == -(-k2 // to) * to
            assert wp.shape == (w.shape[0], k1p + k2p) and wp.is_contiguous()
            assert torch.equal(wp[:, :L.k1], w[:, :L.k1])
            assert torch.equal(wp[:, k1p:k1p + k2], w[:, L.k1:])
            assert not wp[:, L.k1:k1p].any() and not wp[:, k1p + k2:].any()
    # f32 chains run the FMA kernel only: no BK-padded copy
    m32, _, _ = _chain_mlp(name, None)
    assert all(L.weight_k is None for L in m32.packed().layers)
    assert [tuple(L.weight_p.shape) for L in m32.packed().layers] == \
        [tuple(L.weight_p.shape) for L in packed.layers]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scope", [None, 512])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_plan(name, scope, dtype):
    """The launches the wrapper hands to ``fq_chain``: kinds, K ranges,
    leading dimensions, the workspace layout and where phi comes from."""
    m, res, merge = _chain_mlp(name, None if dtype == torch.float32
                               else dtype)
    packed = m.packed()
    dims = CHAINS[name][0]
    N = 1536 if scope else 1000
    C, E = dims[0] - 1, 1
    plan = fq.plan_chain(packed, N, C, E, merge, 32, "sigmoid", scope)
    assert plan is fq.plan_chain(packed, N, C, E, merge, 32, "sigmoid",
                                 scope)
    bf = dtype == torch.bfloat16
    es = 2 if bf else 4
    k0p = -(-dims[0] // 8) * 8
    assert plan.k0p == k0p and plan.pred_cols == 1
    n_layers = len(dims) - 1
    assert len(plan.layers) == n_layers
    # workspace: aligned, inside, non-overlapping, each buffer large enough
    spans = sorted(plan.buffers.values())
    for (off, size), nxt in zip(spans, spans[1:] + [(plan.nbytes, 0)]):
        assert off % 16 == 0 and size > 0 and off + size <= nxt[0]
    assert plan.buffers["x0"][1] == N * k0p * es
    n_rb = -(-N // fq.BM[dtype])
    for i, (lp, L) in enumerate(zip(plan.layers, packed.layers)):
        d = lp.ints
        M, last = dims[i + 1], i == n_layers - 1
        want_kind = fq.KIND_F32 if not bf else (
            fq.KIND_HEAD if last else fq.KIND_WGMMA)
        assert d["kind"] == want_kind
        pad = 8 if want_kind == fq.KIND_F32 else fq.BK
        k2 = dims[0] if i in res else 0
        assert (d["K1"], d["K1p"], d["K2p"]) == (
            L.k1, -(-L.k1 // pad) * pad, -(-k2 // pad) * pad)
        assert (d["N"], d["M"], d["last"]) == (N, M, int(last))
        assert d["sigmoid"] == int(last)
        assert d["seg_rows"] == (scope or N)
        assert d["n_seg"] == (N // scope if scope else 1)
        # A operands: x0 first, then the previous layer's output
        assert lp.a1 == ("x0" if i == 0 else f"h{i - 1}")
        assert d["lda1"] == (k0p if i == 0 else -(-dims[i] // 8) * 8)
        assert d["lda1"] <= d["K1p"] or want_kind == fq.KIND_F32
        assert lp.a2 == ("x0" if k2 else None)
        assert d.get("lda2", 0) == (k0p if k2 else 0)
        gn_prev = i > 0 and packed.layers[i - 1].gn_scale is not None
        assert d["norm_in"] == (0 if i == 0 else 2 if gn_prev else 1)
        assert lp.stats_in == (f"stats{i - 1}" if gn_prev else None)
        if gn_prev:
            assert (d["g_in"], d["cg_in"]) == (32, dims[i] // 32)
        if last:
            assert lp.out == "pred" and d["ldo"] == M
            assert lp.part_out is None and lp.stats_out is None
        else:
            ldo = -(-M // 8) * 8
            assert lp.out == f"h{i}" and d["ldo"] == ldo
            assert plan.buffers[lp.out][1] == N * ldo * es
            if L.gn_scale is not None:
                assert plan.buffers[lp.part_out][1] == n_rb * M * 8
                assert plan.buffers[lp.stats_out][1] == \
                    d["n_seg"] * 32 * fq.STATS_SPLIT * 8
                assert (d["g_out"], d["cg_out"]) == (32, M // 32)
            else:
                assert lp.part_out is None and lp.stats_out is None
        # phi: the layer after the merge layer writes its activated input
        assert lp.phi == ("phi_out" if merge >= 0 and i == merge + 1
                          else None)
    assert plan.phi_cols == (dims[merge + 1] if merge >= 0 else None)


def test_plan_phi_from_a_last_merge_layer():
    m = PointMLP((10, 32, 3), 1, (), "group", device="cpu")
    plan = fq.plan_chain(m.packed(), 64, 8, 2, 1, 32, None, None)
    assert [lp.phi for lp in plan.layers] == [None, "raw_out"]
    assert plan.phi_cols == 3 and plan.layers[1].ints["sigmoid"] == 0


def _c_struct_fields(name):
    """(pointer names, int names) of ``struct <name>`` in fused_query.cu,
    in declaration order; fails on any other member type."""
    src = open(fq._SRC).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs, ints = [], []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        if "*" in decl:
            assert not ints, "pointers come first"
            ptrs.append(decl.split("*")[-1].strip())
        else:
            kind, names = decl.split(None, 1)
            assert kind == "int", decl
            ints += [n.strip() for n in names.split(",")]
    return ptrs, ints


@pytest.mark.parametrize("cname,mirror", [("GatherParams", "_GatherParams"),
                                          ("LayerParams", "_LayerParams")])
def test_ctypes_mirror_matches_c_struct(cname, mirror):
    ptrs, ints = _c_struct_fields(cname)
    fields = getattr(fq, mirror)._fields_
    assert [n for n, _ in fields] == ptrs + ints
    assert [t for _, t in fields] == [ctypes.c_void_p] * len(ptrs) + \
        [ctypes.c_int] * len(ints)
    size = 8 * len(ptrs) + 4 * len(ints)
    assert ctypes.sizeof(getattr(fq, mirror)) == -(-size // 8) * 8


def test_build_cuda_rebuilds_when_a_header_is_newer(tmp_path, monkeypatch):
    """``build_cuda`` compares the library with the source and with every
    ``*.cuh`` beside it; a failing compiler raises.  nvcc is a stub."""
    bindir, src_dir = tmp_path / "bin", tmp_path / "csrc"
    bindir.mkdir()
    src_dir.mkdir()
    log = tmp_path / "calls.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        f"[ -e {tmp_path}/fail ] && {{ echo boom >&2; exit 3; }}\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        "echo lib > \"$2\"\necho 'ptxas info: stub'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src, hdr = src_dir / "k.cu", src_dir / "h.cuh"
    src.write_text("// kernel\n")
    hdr.write_text("// header\n")
    so = tmp_path / "_build" / "libk.so"

    def calls():
        return len(log.read_text().splitlines()) if log.exists() else 0

    old = time.time() - 100
    for f in (src, hdr):
        os.utime(f, (old, old))
    assert "stub" in fq.build_cuda(str(src), str(so)) and calls() == 1
    assert so.exists() and "sm_90a" in log.read_text()
    assert fq.build_cuda(str(src), str(so)) == "" and calls() == 1
    new = time.time() + 100
    os.utime(hdr, (new, new))               # the header alone is newer
    assert fq.build_cuda(str(src), str(so)) != "" and calls() == 2
    os.utime(so, (new + 1, new + 1))
    assert fq.build_cuda(str(src), str(so)) == "" and calls() == 2
    os.utime(src, (new + 2, new + 2))       # the source is newer
    (tmp_path / "fail").write_text("")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fq.build_cuda(str(src), str(so))
    assert calls() == 3
