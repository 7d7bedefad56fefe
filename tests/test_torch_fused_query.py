"""Plain version of the port's fused query against the JAX package: the
Pallas kernel in interpret mode (GroupNorm over point tiles) and the XLA
``PointMLP`` chain (GroupNorm over the whole call), f32.  Mirrors
``tests/test_pallas_query.py``.  The CUDA kernel itself runs only on the
card (``chip_smoke.py`` holds it against this plain version there); on the
CPU the wrapper takes the plain version and its launch counter stays 0.

Tolerances: the hat-weight gather is the same arithmetic (atol 1e-6); MLP
chains rtol 2e-4 / atol 2e-5 as the Pallas test (f32 sums in other
orders)."""

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
    rounding edge (rtol 2^-7: one bf16 ulp)."""
    H, W, C, E = 12, 12, 30, 2
    N = 128
    dims = (C + E, 64, 32, 1)
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    uv = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    extra = rng.standard_normal((N, E)).astype(np.float32)
    m = PointMLP(dims, 1, (1,), "group", dtype=torch.bfloat16, device="cpu")
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
