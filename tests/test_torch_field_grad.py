"""``field_last``, its gradient and ``CoarsePIFu.calc_normal``: the port
against the JAX package on the tiny configs of
``tests/test_torch_models.py`` (norm-free and GroupNorm MLPs; the
norm-free fine level runs ``gather_concat`` + ``fused_point_mlp``), the
same weights and seeded points, f32.

- ``field_last`` values, both models: atol 1e-5.
- ``torch.autograd.grad`` of the chunk sum (the autograd function at
  ``models.coarse.query_mlp``: the kernels forward, the port's torch
  modules backward) against ``jax.grad``: within 1e-4 of the largest
  gradient component (measured: up to 8.9e-6 of it).  The chunk sum mixes
  the points through GroupNorm's statistics, as in the JAX package.
- ``CoarsePIFu.calc_normal`` (fd, delta 0.1): atol 1e-5 plus f32
  rounding over the stencil's size (see the test).
- Gradients of the feature map or of the weights raise (training is a
  later slice of the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu import models as jmodels
from rgbd_pifuhd_tpu_torch import models as tmodels
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from tests.test_torch_models import configs


@pytest.fixture(scope="module", params=["none", "group"])
def pair(request):
    rng = np.random.default_rng(1)
    (jl, jg), (tl, tg) = configs(request.param)
    jm = jmodels.MultiResPIFu(cfg=jl, cfg_global=jg)
    img_l = rng.standard_normal((1, 1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 1, 500, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    calib[:3, 3] = [0.05, -0.1, 0.02]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l),
                     jnp.asarray(img_g), jnp.asarray(pts),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 500, 1)))
    tm = tmodels.MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    tm.requires_grad_(False)
    gf = jm.apply(params, jnp.asarray(img_g), last_only=True,
                  method=jmodels.MultiResPIFu.filter_global)
    lf = jm.apply(params, jnp.asarray(img_l), gf, last_only=True,
                  method=jmodels.MultiResPIFu.filter_local)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img_g), last_only=True)
        tlf = tm.filter_local(torch.from_numpy(img_l), tgf, last_only=True)
    return dict(jm=jm, params=params, tm=tm, gf=gf, lf=lf, tgf=tgf, tlf=tlf,
                pts=pts, calib=calib)


def _jfield(x, pts, coarse):
    c = jnp.asarray(x["calib"])
    if coarse:
        jc = jmodels.CoarsePIFu(x["jm"].cfg_global)
        return jc.apply({"params": x["params"]["params"]["netG"]}, x["gf"],
                        pts[0], c[None], method=jmodels.CoarsePIFu.field_last)
    return x["jm"].apply(x["params"], x["lf"], x["gf"], pts, c[None, None],
                         c[None], method=jmodels.MultiResPIFu.field_last)


def _tfield(x, pts, coarse):
    c = torch.from_numpy(x["calib"])
    if coarse:
        return x["tm"].netG.field_last(x["tgf"], pts[0], c[None])
    return x["tm"].field_last(x["tlf"], x["tgf"], pts, c[None, None],
                              c[None])


@pytest.mark.parametrize("coarse", [False, True], ids=["multires", "coarse"])
def test_field_last_matches_jax(pair, coarse):
    ref = _jfield(pair, jnp.asarray(pair["pts"]), coarse)
    with torch.no_grad():
        got = _tfield(pair, torch.from_numpy(pair["pts"]), coarse)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("coarse", [False, True], ids=["multires", "coarse"])
def test_field_gradient_matches_jax(pair, coarse):
    ref = np.asarray(jax.grad(lambda p: _jfield(pair, p, coarse).sum())(
        jnp.asarray(pair["pts"])))
    p = torch.from_numpy(pair["pts"]).requires_grad_()
    (got,) = torch.autograd.grad(_tfield(pair, p, coarse).sum(), p)
    scale = float(np.abs(ref).max())
    assert scale > 0
    d = float(np.abs(got.numpy() - ref).max())
    assert d <= 1e-4 * scale, (d, scale)


def test_coarse_calc_normal_matches_jax(pair):
    """atol 1e-5 where the fd stencil is well conditioned.  The untrained
    field is flat: where its four taps differ by |d| (the un-normalised
    stencil), f32 rounding of the field values (< 1e-7 in either package)
    moves the unit normal by up to ~2e-7 / |d|, so each component is held
    to 1e-5 + 8e-7 / |d| (measured: at most 0.47 of that bound)."""
    jc = jmodels.CoarsePIFu(pair["jm"].cfg_global)
    params = {"params": pair["params"]["params"]["netG"]}
    pts = jnp.asarray(pair["pts"][0])
    c = pair["calib"][None]
    ref = np.asarray(jc.apply(params, pair["gf"], pts, jnp.asarray(c),
                              method=jmodels.CoarsePIFu.calc_normal))
    taps = pts[:, :, None, :] + jnp.asarray(
        np.concatenate([np.zeros((1, 3)), np.eye(3) * 0.1]), jnp.float32)
    f = np.asarray(jc.apply(params, pair["gf"], taps.reshape(1, -1, 3),
                            jnp.asarray(c),
                            method=jmodels.CoarsePIFu.field_last))
    f = f.reshape(1, -1, 4)
    stencil = np.linalg.norm(f[..., 1:] - f[..., :1], axis=-1,
                             keepdims=True)
    with torch.no_grad():
        got = pair["tm"].netG.calc_normal(
            pair["tgf"], torch.from_numpy(pair["pts"][0]),
            torch.from_numpy(c)).numpy()
    assert got.shape == ref.shape == (1, 500, 3)
    bound = 1e-5 + 8e-7 / stencil
    ratio = float((np.abs(got - ref) / bound).max())
    assert ratio <= 1.0, ratio


def test_feature_and_weight_gradients_refused(pair):
    """Only the points' gradient exists: asking through a feature map that
    requires grad, or with weights that require grad, raises and names
    training."""
    tm, c = pair["tm"], torch.from_numpy(pair["calib"])
    p = torch.from_numpy(pair["pts"]).requires_grad_()
    feat = pair["tgf"].im_feats.clone().requires_grad_()
    gf = pair["tgf"]._replace(im_feats=feat)
    out = tm.netG.field_last(gf, p[0], c[None]).sum()
    with pytest.raises(RuntimeError, match="training"):
        torch.autograd.grad(out, p)
    tm.netG.mlp.requires_grad_(True)
    try:
        out = tm.netG.field_last(pair["tgf"], p[0], c[None]).sum()
        with pytest.raises(RuntimeError, match="training"):
            torch.autograd.grad(out, p)
    finally:
        tm.netG.mlp.requires_grad_(False)
