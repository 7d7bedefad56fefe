"""Port models against the JAX package's on the same weights (JAX init ->
``params_from_flax``) and the same seeded inputs, in f32.  Tolerance: atol
1e-4 (deep conv stacks summed in other orders).  Configs: the tiny ones of
``tests/test_models_pifu.py`` (norm-free MLPs) and a variant with
``mlp_norm='group'``, the normal nets on, and MLP widths that are multiples
of 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu import models as jmodels
from rgbd_pifuhd_tpu.utils.options import PIFuLevelConfig as JCfg
from rgbd_pifuhd_tpu_torch import models as tmodels
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig

ATOL = 1e-4


def configs(variant: str):
    group = variant == "group"
    g = dict(num_stack=2, hg_depth=1, hg_dim=8, norm="group",
             hg_down="ave_pool",
             mlp_dim=(9, 64, 64, 32, 1) if group else (9, 64, 32, 16, 1),
             mlp_res_layers=(1,), mlp_norm="group" if group else "none",
             merge_layer=2, use_depth=True, use_front_normal=group,
             use_back_normal=group, nml_ngf=8, nml_n_downsampling=2,
             nml_n_blocks=1, load_size=64, z_size=200.0)
    l = dict(num_stack=1, hg_depth=1, hg_dim=4, norm="group",
             hg_down="no_down",
             mlp_dim=(36, 64, 32, 1) if group else (20, 32, 16, 1),
             mlp_res_layers=(1,), mlp_norm="group" if group else "none",
             merge_layer=-1, use_depth=True, use_front_normal=False,
             use_back_normal=False, load_size=64, z_size=200.0)
    return (JCfg(**l), JCfg(**g)), (PIFuLevelConfig(**l),
                                    PIFuLevelConfig(**g))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module", params=["none", "group"])
def pair(request):
    """(JAX model, params, port model, inputs) for one variant."""
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs(request.param)
    jm = jmodels.MultiResPIFu(cfg=jl, cfg_global=jg)
    img_l = rng.standard_normal((1, 1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 1, 300, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    calib[:3, 3] = [0.05, -0.1, 0.02]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l),
                     jnp.asarray(img_g), jnp.asarray(pts),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 300, 1)))
    tm = tmodels.MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm, dict(img_l=img_l, img_g=img_g, pts=pts,
                                calib=calib)


def test_filter_global(pair):
    jm, params, tm, x = pair
    ref = jm.apply(params, jnp.asarray(x["img_g"]), last_only=False,
                   method=jmodels.MultiResPIFu.filter_global)
    with torch.no_grad():
        got = tm.filter_global(torch.from_numpy(x["img_g"]))
    _close(got.im_feats, ref.im_feats)
    _close(got.normx, ref.normx)
    if ref.nml_front is not None:
        _close(got.nml_front, ref.nml_front, 1e-5)
        _close(got.nml_back, ref.nml_back, 1e-5)


def test_coarse_query(pair):
    jm, params, tm, x = pair
    gf = jm.apply(params, jnp.asarray(x["img_g"]),
                  method=jmodels.MultiResPIFu.filter_global)
    pts = x["pts"][0]
    calib = x["calib"][None]
    ref = jmodels.CoarsePIFu(jm.cfg_global).apply(
        {"params": params["params"]["netG"]}, gf, jnp.asarray(pts),
        jnp.asarray(calib), method=jmodels.CoarsePIFu.query)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(x["img_g"]))
        got = tm.netG.query(tgf, torch.from_numpy(pts),
                            torch.from_numpy(calib))
    _close(got.preds, ref.preds)
    _close(got.phi, ref.phi)
    _close(got.mask, ref.mask, 0)


def _feats(jm, params, tm, x):
    gf = jm.apply(params, jnp.asarray(x["img_g"]), last_only=True,
                  method=jmodels.MultiResPIFu.filter_global)
    lf = jm.apply(params, jnp.asarray(x["img_l"]), gf, last_only=True,
                  method=jmodels.MultiResPIFu.filter_local)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(x["img_g"]), last_only=True)
        tlf = tm.filter_local(torch.from_numpy(x["img_l"]), tgf,
                              last_only=True)
    return gf, lf, tgf, tlf


def test_filter_local_and_fine_query(pair):
    jm, params, tm, x = pair
    gf, lf, tgf, tlf = _feats(jm, params, tm, x)
    _close(tlf.im_feats, lf.im_feats)
    c = jnp.asarray(x["calib"])
    ref = jm.apply(params, lf, gf, jnp.asarray(x["pts"]), c[None, None],
                   c[None], method=jmodels.MultiResPIFu.query)
    tc = torch.from_numpy(x["calib"])
    with torch.no_grad():
        got = tm.query(tlf, tgf, torch.from_numpy(x["pts"]), tc[None, None],
                       tc[None])
    _close(got.preds, ref.preds)
    _close(got.preds_low, ref.preds_low)
    _close(got.mask, ref.mask, 0)


def test_calc_normal(pair):
    jm, params, tm, x = pair
    gf, lf, tgf, tlf = _feats(jm, params, tm, x)
    c = jnp.asarray(x["calib"])
    ref = jm.apply(params, lf, gf, jnp.asarray(x["pts"]), c[None, None],
                   c[None], method=jmodels.MultiResPIFu.calc_normal)
    tc = torch.from_numpy(x["calib"])
    with torch.no_grad():
        got = tm.calc_normal(tlf, tgf, torch.from_numpy(x["pts"]),
                             tc[None, None], tc[None])
    # fd normals with delta 1e-3: a 1e-7 field difference moves a unit
    # normal's component by ~1e-4, and where the stencil is flat (a
    # saturated untrained field) the direction is noise, so count rows
    assert np.isfinite(got.numpy()).all()
    agree = (np.abs(got.numpy() - np.asarray(ref)) < 1e-2).all(-1).mean()
    assert agree > 0.97, agree        # measured 0.99 (none), 1.0 (group)


@pytest.mark.parametrize("norm", ["group", "none"])
def test_point_mlp(rng, norm):
    dims = (40, 64, 96, 32, 1)
    x = rng.standard_normal((2, 128, 40)).astype(np.float32)
    jm = jmodels.PointMLP(dims, merge_layer=2, res_layers=(2, 3), norm=norm)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref, phi = jm.apply(params, jnp.asarray(x))
    tm = tmodels.PointMLP(dims, 2, (2, 3), norm, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got, tphi = tm(torch.from_numpy(x))
    _close(got, ref, 1e-5)
    _close(tphi, phi, 1e-5)


def test_hgfilter_and_generator(rng):
    x = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    jf = jmodels.HGFilter(n_stack=2, depth=2, last_channels=16,
                          norm="group", down_type="ave_pool")
    params = jf.init(jax.random.PRNGKey(2), jnp.asarray(x))
    outs, normx = jf.apply(params, jnp.asarray(x))
    tf = tmodels.HGFilter(2, 2, 16, 6, "group", "ave_pool", device="cpu")
    load_params(tf, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        touts, tnormx = tf(torch.from_numpy(x))
    for a, b in zip(touts, outs):
        _close(a, b)
    _close(tnormx, normx)

    jg = jmodels.GlobalGenerator(output_nc=3, ngf=8, n_downsampling=2,
                                 n_blocks=2)
    pg = jg.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tg = tmodels.GlobalGenerator(6, 3, 8, 2, 2, device="cpu")
    load_params(tg, jax.tree.map(np.asarray, pg))
    with torch.no_grad():
        _close(tg(torch.from_numpy(x)), jg.apply(pg, jnp.asarray(x)), 1e-5)
