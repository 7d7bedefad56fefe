"""``ops.fused_mlp``: the plain version of the whole-chain kernel against
the JAX package — the Pallas ``fused_point_mlp`` (interpret mode) and the
flax ``PointMLP(norm='none')`` — on the same seeded inputs and weights, and
the model's dispatch to it (norm-free fine level) against the JAX
``MultiResPIFu.query`` with the trained ``bench_tiny`` weights.

Tolerances.  f32: rtol 1e-5 / atol 1e-6, those of ``tests/test_pallas_mlp
.py``.  bf16 against flax ``PointMLP(dtype=bf16)``: both round the product,
the bias add and the leaky to bf16, but sum the products in another order,
so a pre-rounding value can fall on the other side of a bf16 rounding edge:
one ulp, 2^-8 relative, at a layer's output, which then runs through the
remaining layers.  With a sigmoid head (slope <= 1/4) and pre-sigmoid
values of a few units the measured differences stay under 4e-3; 2e-2 is the
tolerance the card check of this kernel uses as well.  Without the head the
same steps are held relative to the largest value: 4e-2.
"""

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

from rgbd_pifuhd_tpu import models as jmodels
from rgbd_pifuhd_tpu.ops.pallas_mlp import (fused_point_mlp as j_fused,
                                            mlp_weights_from_params)
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch import models as tmodels
from rgbd_pifuhd_tpu_torch.models import coarse as tcoarse
from rgbd_pifuhd_tpu_torch.ops import fused_mlp as fm
from rgbd_pifuhd_tpu_torch.ops import fused_query as fq
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tck
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [
    ((257, 1024, 512, 256, 128, 1), (2, 3, 4), 300),   # coarse MLP shape
    ((272, 512, 256, 128, 1), (1, 2), 300),            # fine MLP shape
    ((16, 64, 32, 1), (1,), 333),                      # narrow, ragged N
]
IDS = ["coarse", "fine", "narrow"]
TOL_BF16_SIGMOID = 2e-2
TOL_BF16_RAW_REL = 4e-2


def _pair(chans, res, N, dtype=None, scale=0.3, seed=0, last_op="sigmoid",
          gain=None):
    """Seeded input, flax PointMLP + params, and the port's PointMLP with
    the same weights.  ``gain`` rescales the init (std 0.02 leaves every
    activation near zero) so the chain carries O(1) values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, N, chans[0])).astype(np.float32) * scale
    jm = jmodels.PointMLP(chans, merge_layer=2, res_layers=res, norm="none",
                          last_op=last_op,
                          dtype=None if dtype is None else "bfloat16")
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    if gain is not None:
        params = jax.tree.map(np.array, params)
        for i in range(len(chans) - 1):
            d = params["params"][f"dense{i}"]
            d["kernel"] = (rng.standard_normal(d["kernel"].shape) * gain
                           / np.sqrt(d["kernel"].shape[0])).astype(np.float32)
            d["bias"] = (rng.standard_normal(d["bias"].shape) * 0.1).astype(
                np.float32)
    tm = tmodels.PointMLP(chans, 2, res, "none", last_op, dtype=dtype,
                          device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return x, jm, params, tm


@pytest.mark.parametrize("chans,res,N", SHAPES, ids=IDS)
def test_ref_matches_pallas_kernel_and_flax_f32(chans, res, N):
    x, jm, params, tm = _pair(chans, res, N)
    y_flax, _ = jm.apply(params, jnp.asarray(x))
    weights = mlp_weights_from_params(params["params"], len(chans) - 1)
    y_pallas = j_fused(jnp.asarray(x[0]), weights, res_layers=res, block=128,
                       interpret=True)
    got = fm.fused_point_mlp_ref(torch.from_numpy(x[0]), tm.packed(),
                                 res_layers=res)
    assert got.shape == (N, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(y_pallas), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_flax[0]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("chans,res,N", SHAPES, ids=IDS)
def test_last_op_none_f32(chans, res, N):
    x, jm, params, tm = _pair(chans, res, N, last_op=None, gain=1.4)
    y_flax, _ = jm.apply(params, jnp.asarray(x))
    got = fm.fused_point_mlp(torch.from_numpy(x[0]), tm.packed(),
                             res_layers=res, last_op=None)
    assert float(np.abs(np.asarray(y_flax)).max()) > 0.5   # not squashed
    np.testing.assert_allclose(got.numpy(), np.asarray(y_flax[0]), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("last_op", ["sigmoid", None])
@pytest.mark.parametrize("chans,res,N", SHAPES, ids=IDS)
def test_ref_matches_flax_bf16(chans, res, N, last_op):
    x, jm, params, tm = _pair(chans, res, N, dtype=torch.bfloat16, scale=0.7,
                              last_op=last_op, gain=1.4)
    y_flax, _ = jm.apply(params, jnp.asarray(x))
    y_flax = np.asarray(y_flax[0].astype(jnp.float32))
    xb = torch.from_numpy(x[0]).to(torch.bfloat16)
    got = fm.fused_point_mlp_ref(xb, tm.packed(), res_layers=res,
                                 last_op=last_op).numpy()
    mag = float(np.abs(y_flax).max())
    err = float(np.abs(got - y_flax).max())
    if last_op == "sigmoid":
        assert np.ptp(y_flax) > 0.3           # a head that is not flat
        assert err <= TOL_BF16_SIGMOID, err
    else:
        assert mag > 0.5
        assert err <= TOL_BF16_RAW_REL * mag, (err, mag)
    # and the port's own step-by-step PointMLP, which rounds the same way
    with torch.no_grad():
        own, _ = tm(xb[None])
    np.testing.assert_allclose(got, own[0].float().numpy(),
                               atol=TOL_BF16_SIGMOID if last_op
                               else TOL_BF16_RAW_REL * mag)


def test_padded_rows_and_gather_concat(rng):
    """``gather_concat`` appends zero columns up to a multiple of 8; the
    chain reads only the real ones."""
    feat = torch.from_numpy(rng.standard_normal((9, 11, 13))
                            .astype(np.float32))
    uv = torch.from_numpy(rng.uniform(-1.1, 1.1, (50, 2)).astype(np.float32))
    extra = torch.from_numpy(rng.standard_normal((50, 4)).astype(np.float32))
    x0 = fq.gather_concat(feat, uv, extra)
    assert x0.shape == (50, 24) and float(x0[:, 17:].abs().max()) == 0.0
    assert torch.equal(x0[:, :13], fq.gather_ref(feat, uv))
    assert torch.equal(x0[:, 13:17], extra)
    m = tmodels.PointMLP((17, 32, 16, 1), 2, (1,), "none", device="cpu")
    a = fm.fused_point_mlp(x0, m.packed(), res_layers=(1,))
    b = fm.fused_point_mlp(x0[:, :17].contiguous(), m.packed(),
                           res_layers=(1,))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="res_layers"):
        fm.fused_point_mlp(x0, m.packed(), res_layers=())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_two_routes_round_alike(rng, dtype):
    """Gather + whole chain against the per-layer kernel's plain version on
    the same norm-free chain: the same operations rounded at the same
    places, so the same bits (bf16: product, bias add and leaky each
    rounded to bf16, the slope too)."""
    chans, res = (40, 64, 48, 32, 1), (1, 3)
    m = tmodels.PointMLP(chans, 2, res, "none", dtype=dtype, device="cpu")
    with torch.no_grad():
        for i in range(m.n_layers):
            lin = getattr(m, f"dense{i}")
            lin.weight.copy_(torch.from_numpy(
                rng.standard_normal(tuple(lin.weight.shape)).astype(
                    np.float32) * 1.4 / np.sqrt(lin.weight.shape[1])))
            lin.bias.copy_(torch.from_numpy(
                rng.standard_normal(tuple(lin.bias.shape)).astype(np.float32)
                * 0.1))
    m._packed.clear()
    cd = dtype or torch.float32
    feat = torch.from_numpy(rng.standard_normal((9, 11, 37))
                            .astype(np.float32)).to(cd)
    uv = torch.from_numpy(rng.uniform(-1.1, 1.1, (700, 2)).astype(np.float32))
    extra = torch.from_numpy(rng.standard_normal((700, 3)).astype(np.float32))
    for last_op in ("sigmoid", None):
        whole = fm.fused_point_mlp(fq.gather_concat(feat, uv, extra),
                                   m.packed(), res_layers=res,
                                   last_op=last_op)
        per_layer, phi = fq.fused_gather_mlp(
            feat, uv, extra, m.packed(), res_layers=res, merge_layer=-1,
            last_op=last_op)
        assert phi is None and torch.equal(whole, per_layer)
    assert float(whole.abs().max()) > 0.5 and (whole < 0).any()


def test_group_norm_chain_raises_and_cpu_launches_nothing():
    gn = tmodels.PointMLP((40, 64, 32, 1), 2, (1,), "group", device="cpu")
    with pytest.raises(ValueError, match="norm-free"):
        fm.fused_point_mlp(torch.zeros((8, 40)), gn.packed(),
                           res_layers=(1,))
    assert fm.fused_point_mlp.launches == 0
    assert fq.gather_concat.launches == 0


@pytest.fixture(scope="module")
def tiny():
    """``bench_tiny`` (f16-stored, f32 compute) in both packages."""
    from flax import serialization

    path = os.path.join(REPO, "assets", "bench_tiny", "ckpt")
    state = tck.load_checkpoint(path, device="cpu")
    opt = Options.from_dict(state["opt"])
    tm = tmodels.MultiResPIFu(opt.netMR, opt.netG, device="cpu")
    tck.load_params(tm, state["params"])
    raw = serialization.msgpack_restore(open(path, "rb").read())
    jopt = JOptions.from_dict(raw["opt"])
    jm = jmodels.MultiResPIFu(cfg=jopt.netMR, cfg_global=jopt.netG)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          raw["params"])
    rng = np.random.default_rng(0)
    x = dict(img_l=rng.standard_normal((1, 1, 64, 64, 6)).astype(np.float32),
             img_g=rng.standard_normal((1, 64, 64, 6)).astype(np.float32),
             pts=rng.uniform(-0.9, 0.9, (1, 1, 500, 3)).astype(np.float32),
             calib=np.eye(4, dtype=np.float32))
    return jm, params, tm, x


def _port_query(tm, x):
    tc = torch.from_numpy(x["calib"])
    with torch.no_grad():
        gf = tm.filter_global(torch.from_numpy(x["img_g"]), last_only=True)
        lf = tm.filter_local(torch.from_numpy(x["img_l"]), gf,
                             last_only=True)
        return tm.query(lf, gf, torch.from_numpy(x["pts"]), tc[None, None],
                        tc[None])


def test_bench_tiny_query_matches_jax(tiny):
    """The trained norm-free model: the fine level goes gather ->
    ``fused_point_mlp``, the coarse level (it owes phi) through
    ``fused_gather_mlp``; the result is the JAX model's (atol 1e-4)."""
    jm, params, tm, x = tiny
    assert tm.mlp.norm == "none" and tm.netG.mlp.norm == "none"
    c = jnp.asarray(x["calib"])
    gf = jm.apply(params, jnp.asarray(x["img_g"]), last_only=True,
                  method=jmodels.MultiResPIFu.filter_global)
    lf = jm.apply(params, jnp.asarray(x["img_l"]), gf, last_only=True,
                  method=jmodels.MultiResPIFu.filter_local)
    ref = jm.apply(params, lf, gf, jnp.asarray(x["pts"]), c[None, None],
                   c[None], method=jmodels.MultiResPIFu.query)
    got = _port_query(tm, x)
    assert np.ptp(np.asarray(ref.preds)) > 0.5      # a real field
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(ref.preds),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.preds_low.numpy(),
                               np.asarray(ref.preds_low), rtol=0, atol=1e-4)


def test_dispatch_takes_whole_chain_only_for_norm_free_fine(tiny,
                                                            monkeypatch):
    """Which wrapper each level calls, and that the route does not change
    the result: the fine level forced through ``fused_gather_mlp_ref``
    gives the same predictions (f32, atol 1e-6)."""
    _, _, tm, x = tiny
    calls = {"chain": 0, "per_layer": []}
    real_chain, real_layer = tcoarse.fused_point_mlp, tcoarse.fused_gather_mlp

    def chain(*a, **kw):
        calls["chain"] += 1
        return real_chain(*a, **kw)

    def per_layer(*a, **kw):
        calls["per_layer"].append(kw["merge_layer"])
        return real_layer(*a, **kw)

    monkeypatch.setattr(tcoarse, "fused_point_mlp", chain)
    monkeypatch.setattr(tcoarse, "fused_gather_mlp", per_layer)
    got = _port_query(tm, x)
    assert calls["chain"] == 1 and calls["per_layer"] == [tm.netG.mlp.merge]

    def forced(mlp, feat, uv, extra, merge_layer):
        packed = mlp.packed()
        pred, phi = fq.fused_gather_mlp_ref(
            feat[0].to(packed.compute_dtype), uv[0].float(),
            extra[0].float(), packed, res_layers=mlp.res_layers,
            merge_layer=merge_layer)
        return pred[None], None if phi is None else phi[None]

    import rgbd_pifuhd_tpu_torch.models.multires as tmulti
    monkeypatch.setattr(tmulti, "query_mlp", forced)
    monkeypatch.setattr(tcoarse, "query_mlp", forced)
    old = _port_query(tm, x)
    np.testing.assert_allclose(got.preds.numpy(), old.preds.numpy(), rtol=0,
                               atol=1e-6)

    # a GroupNorm fine level stays on the per-layer kernel
    calls["chain"], calls["per_layer"] = 0, []
    monkeypatch.undo()
    monkeypatch.setattr(tcoarse, "fused_point_mlp", chain)
    monkeypatch.setattr(tcoarse, "fused_gather_mlp", per_layer)
    gn = tmodels.PointMLP((20, 32, 32, 1), -1, (1,), "group", device="cpu")
    tcoarse.query_mlp(gn, torch.zeros((1, 4, 4, 17)),
                      torch.zeros((1, 64, 2)), torch.zeros((1, 64, 3)), -1)
    assert calls["chain"] == 0 and calls["per_layer"] == [-1]


# ------------------------------------------- the bf16 kernel's host side
PLAN_SHAPES = {   # chain, residual layers, tile rows, x0 / weight stages
    "coarse": ((257, 1024, 512, 256, 128, 1), (2, 3, 4), 64, (4, 4)),
    "fine": ((272, 512, 256, 128, 1), (1, 2), 128, (2, 4)),
    "bench_tiny": ((48, 64, 32, 1), (1,), 128, (4, 8)),
}


def _bf16_mlp(chans, res):
    return tmodels.PointMLP(chans, 2, res, "none", dtype=torch.bfloat16,
                            device="cpu").packed()


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_wgmma_plan_fits_and_covers_every_layer(name):
    chans, res, bm, stages = PLAN_SHAPES[name]
    packed = _bf16_mlp(chans, res)
    plan = fm.plan_wgmma(packed)
    assert (plan.bm, (plan.xstages, plan.stages), plan.cluster) == (
        bm, stages, fm.DEFAULT_CLUSTER)
    assert plan.cp == 2 // (bm // 64)
    # regions: activations at 0, the x0 ring, the weights' ring, each
    # 1024-byte aligned, inside the block's 232,448 bytes with the static
    # barriers
    assert plan.xring_off == plan.a_bytes and plan.a_bytes % 1024 == 0
    assert plan.ring_off == plan.xring_off + plan.xstages * plan.bm * fm.LINE
    assert plan.ring_off % 1024 == 0 and plan.stage_bytes % 1024 == 0
    assert plan.smem_bytes == plan.ring_off + plan.stages * \
        plan.stage_bytes + 1024
    assert plan.smem_bytes <= fm.SMEM_PLAN_MAX < 232448
    assert 2 <= plan.xstages <= fm.MAX_STAGES
    assert 2 <= plan.stages <= fm.MAX_STAGES
    a_cols = plan.a_bytes // (plan.bm * 2)
    n = len(chans) - 1
    for i, (d, L) in enumerate(zip(plan.layers, packed.layers)):
        M = chans[i + 1]
        assert d["M"] == M and d["SC"] == plan.cp * d["CN"] <= 128
        assert d["CN"] >= 8 and d["CN"] & (d["CN"] - 1) == 0
        assert d["SC"] * fm.LINE <= plan.stage_bytes    # a weight box
        assert d["P"] * d["SC"] >= M and (d["P"] - 1) * d["SC"] < M
        assert d["G"] * d["CN"] // 2 <= 128 and d["G"] <= 4   # accumulators
        assert (d["KT1"], d["KT2"]) == (L.k1k // 64, L.k2k // 64)
        assert d["KT1"] * 64 >= (chans[0] if i == 0 else chans[i])
        assert d["KT2"] * 64 == (-(-chans[0] // 64) * 64 if i in res else 0)
        if i > 0:       # reads the resident activations, writes over them
            assert d["P"] <= d["G"] and d["KT1"] * 64 <= a_cols
        if i < n - 1:   # the next layer's K padding is written as well
            assert d["SC"] % 64 == 0 and d["P"] * d["SC"] <= a_cols
    assert plan is not fm.plan_wgmma(packed) and \
        fm.plan_wgmma(packed) == plan


def test_wgmma_plan_hints():
    fine = _bf16_mlp(*PLAN_SHAPES["fine"][:2])
    p64 = fm.plan_wgmma(fine, rows=64, cluster=4)
    assert (p64.bm, p64.cp, p64.cluster, p64.xstages, p64.stages) == (
        64, 2, 4, 4, 8)
    assert [d["CN"] for d in p64.layers] == [64, 64, 64, 8]
    assert [d["P"] for d in p64.layers] == [4, 2, 1, 1]
    coarse = _bf16_mlp(*PLAN_SHAPES["coarse"][:2])
    assert [d["P"] for d in fm.plan_wgmma(coarse).layers] == [8, 4, 2, 1, 1]
    assert [d["G"] for d in fm.plan_wgmma(coarse).layers] == [4, 4, 2, 1, 1]
    # 128 rows of the 1024-wide activation do not fit; 512 columns of a
    # layer that reads resident activations would need two groups
    with pytest.raises(ValueError, match="fits shared memory"):
        fm.plan_wgmma(coarse, rows=128)
    for bad in (dict(rows=32), dict(cluster=3)):
        with pytest.raises(ValueError):
            fm.plan_wgmma(fine, **bad)
    f32 = tmodels.PointMLP((48, 64, 32, 1), 2, (1,), "none",
                           device="cpu").packed()
    with pytest.raises(ValueError, match="bf16"):
        fm.plan_wgmma(f32)
    assert fm._hint(None) == (None, None) and fm._hint(64) == (64, None)
    assert fm._hint((None, 4)) == (None, 4) and fm._hint((128, 1)) == (128, 1)


def test_wgmma_params_from_plan():
    chans, res = PLAN_SHAPES["coarse"][:2]
    packed = _bf16_mlp(chans, res)
    plan = fm.plan_wgmma(packed, cluster=1)
    x = torch.zeros((100, 264), dtype=torch.bfloat16)
    out = torch.zeros((100, 1))
    p = fm.wg_params(x, out, packed, plan, "sigmoid")
    assert (p.x, p.out) == (x.data_ptr(), out.data_ptr())
    assert (p.n_layers, p.N, p.C0, p.ldx, p.sigmoid) == (5, 100, 257, 264, 1)
    assert (p.bm, p.cluster, p.stages, p.stage_bytes, p.ring_off, p.xstages,
            p.xring_off, p.smem_bytes) == (
        plan.bm, 1, plan.stages, plan.stage_bytes, plan.ring_off,
        plan.xstages, plan.xring_off, plan.smem_bytes)
    for i, (d, L) in enumerate(zip(plan.layers, packed.layers)):
        assert p.w[i] == L.weight_k.data_ptr()
        b = fm.padded_biases(packed, plan)[i]
        assert p.bias[i] == b.data_ptr() and len(b) == d["P"] * d["SC"]
        assert torch.equal(b[:d["M"]], L.bias) and not b[d["M"]:].any()
        assert [getattr(p, k)[i] for k in ("M", "KT1", "KT2", "CN", "P",
                                            "G")] == \
            [d[k] for k in ("M", "KT1", "KT2", "CN", "P", "G")]
    assert list(p.M)[5:] == [0, 0, 0]


@pytest.mark.parametrize("name", ["coarse", "fine"])
def test_k_padded_weights(name, rng):
    """The kernel's weights: each K range (h, then x0 for a residual layer)
    zero-padded to a multiple of 64, the residual rows at the x0 range."""
    chans, res = PLAN_SHAPES[name][:2]
    m = tmodels.PointMLP(chans, 2, res, "none", dtype=torch.bfloat16,
                         device="cpu")
    with torch.no_grad():
        for i in range(m.n_layers):
            lin = getattr(m, f"dense{i}")
            lin.weight.copy_(torch.from_numpy(rng.standard_normal(
                tuple(lin.weight.shape)).astype(np.float32)) + 3.0)
    m._packed.clear()
    for i, L in enumerate(m.packed().layers):
        w, wk = L.weight, L.weight_k
        k1 = chans[0] if i == 0 else chans[i]
        k2 = chans[0] if i in res else 0
        assert wk.shape == (chans[i + 1], L.k1k + L.k2k)
        assert L.k1k == -(-k1 // 64) * 64 and L.k2k == -(-k2 // 64) * 64
        assert torch.equal(wk[:, :k1], w[:, :k1])
        assert not wk[:, k1:L.k1k].any()
        assert torch.equal(wk[:, L.k1k:L.k1k + k2], w[:, k1:])
        assert not wk[:, L.k1k + k2:].any()
        assert (wk[:, :k1] != 0).all()


def _c_struct(name):
    """[(field name, 'ptr' | 'int', count)] of ``struct <name>`` in
    fused_mlp.cu, in declaration order."""
    src = open(fm._SRC).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = "ptr" if "*" in decl else "int"
        if kind == "int":
            assert decl.split(None, 1)[0] == "int", decl
            names = decl.split(None, 1)[1]
        else:
            names = decl.split("*")[-1]
        for n in names.split(","):
            n = n.strip()
            count = 1
            if n.endswith("[MAX_LAYERS]"):
                n, count = n[:-len("[MAX_LAYERS]")], fm.MAX_LAYERS
            out.append((n, kind, count))
    return out


@pytest.mark.parametrize("cname,mirror", [("MlpParams", "_MlpParams"),
                                          ("WgParams", "_WgParams")])
def test_ctypes_mirror_matches_c_struct(cname, mirror):
    fields = _c_struct(cname)
    got = getattr(fm, mirror)._fields_
    assert [n for n, _ in got] == [n for n, _, _ in fields]
    for (n, t), (_, kind, count) in zip(got, fields):
        base = ctypes.c_void_p if kind == "ptr" else ctypes.c_int
        assert t == (base if count == 1 else base * count), n
    size = sum((8 if k == "ptr" else 4) * c for _, k, c in fields)
    assert ctypes.sizeof(getattr(fm, mirror)) == -(-size // 8) * 8


def test_build_rebuilds_when_hopper_header_is_newer(tmp_path, monkeypatch):
    """``fused_mlp.build`` goes through ``build_cuda``: the library is
    rebuilt when ``hopper.cuh`` beside the source is newer (stub nvcc)."""
    bindir, src_dir = tmp_path / "bin", tmp_path / "csrc"
    bindir.mkdir()
    src_dir.mkdir()
    log = tmp_path / "calls.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "echo lib > \"$2\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src, hdr = src_dir / "fused_mlp.cu", src_dir / "hopper.cuh"
    src.write_text('#include "hopper.cuh"\n')
    hdr.write_text("// helpers\n")
    so = tmp_path / "_build" / "libfused_mlp.so"
    monkeypatch.setattr(fm, "_SRC", str(src))
    monkeypatch.setattr(fm, "_SO", str(so))
    old = time.time() - 100
    for f in (src, hdr):
        os.utime(f, (old, old))
    fm.build()
    assert so.exists() and len(log.read_text().splitlines()) == 1
    fm.build()
    assert len(log.read_text().splitlines()) == 1       # up to date
    new = time.time() + 100
    os.utime(hdr, (new, new))
    fm.build()
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and "sm_90a" in calls[1] and str(src) in calls[1]
