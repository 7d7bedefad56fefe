"""Batch norm (inference: running statistics) and the ``conv64`` /
``conv128`` down types, the port against the JAX package on the same
weights and seeded inputs (f32 unless stated).

- Encoders (``HGFilter``, ``norm='batch'``, every down type): atol 1e-4,
  as ``tests/test_torch_models.py`` (deep conv stacks summed in other
  orders).
- ``PointMLP(norm='batch')``: the plain chain (flax's steps) atol 1e-5; the
  kernels' route, where ``packed()`` folds each batch norm into the Dense
  before it, atol 1e-5 in f32.  In bf16 the folding rounds elsewhere (the
  folded weights, and leaky in bf16 where flax's runs in f32 after the
  norm): the sigmoid head within 2e-2 of the JAX package's bf16 chain, the
  kernels' bf16 tolerance (measured 4.8e-4 to 9.5e-4 over three seeds; f32
  folded 6e-8); the plain bf16 chain within 1e-5 (measured 3e-8).
- ``CoarsePIFu`` / ``MultiResPIFu`` with batch norm in the encoders and the
  MLPs: query output atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu import models as jmodels
from rgbd_pifuhd_tpu.utils.options import PIFuLevelConfig as JCfg
from rgbd_pifuhd_tpu_torch import models as tmodels
from rgbd_pifuhd_tpu_torch.models.coarse import query_mlp
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig


def _random_stats(variables, seed):
    """Non-trivial running statistics in place of flax's 0 / 1 init."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                node[k] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    fill(out["batch_stats"])
    # scales and biases away from 1 / 0 as well
    for path, leaf in jax.tree_util.tree_leaves_with_path(out["params"]):
        if path[-1].key in ("scale", "bias") and leaf.ndim == 1:
            leaf += rng.normal(0.0, 0.2, leaf.shape).astype(np.float32)
    return out


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("down", ["ave_pool", "no_down", "conv64", "conv128"])
def test_hgfilter_batch_norm_and_down_types(down, rng):
    x = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    jf = jmodels.HGFilter(n_stack=2, depth=2, last_channels=16, norm="batch",
                          down_type=down)
    v = _random_stats(jf.init(jax.random.PRNGKey(2), jnp.asarray(x)), 3)
    outs, normx = jf.apply(v, jnp.asarray(x))
    tf = tmodels.HGFilter(2, 2, 16, 6, "batch", down, device="cpu")
    load_params(tf, v)
    with torch.no_grad():
        touts, tnormx = tf(torch.from_numpy(x))
    assert tnormx.shape == normx.shape
    for a, b in zip(touts, outs):
        _close(a, b, 1e-4)
    _close(tnormx, normx, 1e-4)


def test_group_norm_conv128(rng):
    """``conv128`` with the default GroupNorm as well (``conv64``'s 16-wide
    convs do not divide into 32 groups, in either package)."""
    x = rng.standard_normal((1, 32, 32, 6)).astype(np.float32)
    for down in ("conv128",):
        jf = jmodels.HGFilter(n_stack=1, depth=1, last_channels=8,
                              norm="group", down_type=down)
        v = jf.init(jax.random.PRNGKey(4), jnp.asarray(x))
        outs, _ = jf.apply(v, jnp.asarray(x))
        tf = tmodels.HGFilter(1, 1, 8, 6, "group", down, device="cpu")
        load_params(tf, jax.tree.map(np.asarray, v))
        with torch.no_grad():
            _close(tf(torch.from_numpy(x))[0][0], outs[0], 1e-4)


def _mlp_pair(dtype, seed=5):
    dims, merge, res = (40, 64, 96, 32, 1), 2, (1, 3)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 512, 40)).astype(np.float32)
    jm = jmodels.PointMLP(dims, merge_layer=merge, res_layers=res,
                          norm="batch",
                          dtype=None if dtype == "float32" else dtype)
    v = _random_stats(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed)
    tm = tmodels.PointMLP(dims, merge, res, "batch",
                          dtype=None if dtype == "float32"
                          else torch.bfloat16, device="cpu")
    load_params(tm, v)
    return jm, v, tm, x


def test_point_mlp_batch_norm_plain_and_folded():
    jm, v, tm, x = _mlp_pair("float32")
    # the first 8 channels the same at every point: a 1 x 1 feature map,
    # which the kernels' gather returns whole at any uv
    x[:, :, :8] = x[:, :1, :8]
    ref, phi = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got, tphi = tm(torch.from_numpy(x))
        _close(got, ref, 1e-5)
        _close(tphi, phi, 1e-5)
        # the kernels' route: every batch norm folded into its Dense
        assert all(L.gn_scale is None for L in tm.packed().layers)
        kpred, kphi = query_mlp(tm, torch.from_numpy(x[:, :1, :8])[:, None],
                                torch.zeros((1, 512, 2)),
                                torch.from_numpy(x[:, :, 8:]), 2)
        _close(kpred, ref, 1e-5)
        _close(kphi, phi, 1e-5)
        kpred, _ = query_mlp(tm, torch.from_numpy(x[:, :1, :8])[:, None],
                             torch.zeros((1, 512, 2)),
                             torch.from_numpy(x[:, :, 8:]), -1)
        _close(kpred, ref, 1e-5)


def test_point_mlp_batch_norm_bf16_folding_spread():
    jm, v, tm, x = _mlp_pair("bfloat16")
    ref, _ = jm.apply(v, jnp.asarray(x))
    from rgbd_pifuhd_tpu_torch.ops.fused_mlp import fused_point_mlp_ref

    with torch.no_grad():
        plain, _ = tm(torch.from_numpy(x))
        folded = fused_point_mlp_ref(torch.from_numpy(x[0]).to(
            torch.bfloat16), tm.packed(), res_layers=(1, 3))
    # the plain chain rounds where flax does
    _close(plain, ref, 1e-5)
    d = float(np.abs(folded.numpy() - np.asarray(ref)[0]).max())
    assert d <= 2e-2, d


def _level(norm, mlp_dim, merge, down, **kw):
    d = dict(num_stack=1, hg_depth=1, hg_dim=8, norm=norm, hg_down=down,
             mlp_dim=mlp_dim, mlp_res_layers=(1,), mlp_norm="batch",
             merge_layer=merge, use_depth=True, use_front_normal=False,
             use_back_normal=False, load_size=64, z_size=200.0, **kw)
    return JCfg(**d), PIFuLevelConfig(**d)


def test_multires_batch_norm_query(rng):
    """The two-level model with batch norm everywhere: the coarse level's
    encoder ``conv128``, the fine one ``no_down``; the query (both kernels'
    routes, folded) against the JAX package's."""
    jg, tg = _level("batch", (9, 64, 64, 32, 1), 2, "conv128")
    jl, tl = _level("batch", (40, 32, 16, 1), -1, "no_down")
    img_l = rng.standard_normal((1, 1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 1, 300, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)
    jm = jmodels.MultiResPIFu(cfg=jl, cfg_global=jg)
    v = _random_stats(jm.init(
        jax.random.PRNGKey(0), jnp.asarray(img_l), jnp.asarray(img_g),
        jnp.asarray(pts), jnp.asarray(c)[None, None], jnp.asarray(c)[None],
        jnp.zeros((1, 1, 300, 1))), 7)
    gf = jm.apply(v, jnp.asarray(img_g), last_only=True,
                  method=jmodels.MultiResPIFu.filter_global)
    lf = jm.apply(v, jnp.asarray(img_l), gf, last_only=True,
                  method=jmodels.MultiResPIFu.filter_local)
    ref = jm.apply(v, lf, gf, jnp.asarray(pts), jnp.asarray(c)[None, None],
                   jnp.asarray(c)[None], method=jmodels.MultiResPIFu.query)
    tm = tmodels.MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, v)
    tc = torch.from_numpy(c)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img_g), last_only=True)
        tlf = tm.filter_local(torch.from_numpy(img_l), tgf, last_only=True)
        got = tm.query(tlf, tgf, torch.from_numpy(pts), tc[None, None],
                       tc[None])
    _close(tgf.im_feats, gf.im_feats, 1e-4)
    _close(got.preds, ref.preds, 1e-4)
    _close(got.preds_low, ref.preds_low, 1e-4)
