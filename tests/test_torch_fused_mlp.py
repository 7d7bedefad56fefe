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

import os

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
