"""The port's pix2pixHD zoo (``models/pix2pix.py``) against the JAX
package's, on the CPU, f32, at tiny widths (ngf 8, two downsamplings, one
residual block; ndf 8, two layers, two scales), from the same parameters
and the same seeded input.

- ``GlobalGenerator``, ``LocalEnhancer``, ``Encoder``,
  ``NLayerDiscriminator`` and ``MultiscaleDiscriminator`` forwards: every
  output (every layer's features for the discriminators) within 1e-5 of the
  largest |value| of the JAX output (relative, f32).
  ``MultiscaleDiscriminator`` runs from a JAX initialisation, the others
  from the port's ``init_flax`` draw fed to both packages (which holds
  the transposed-convolution layout of ``g_up{i}`` / ``l_up`` / ``up{i}``
  through the JAX forward).
- ``instance_average_pool``: within 1e-6 of the largest |value|; each
  region's pixels all equal, and the same bits from run to run (one-hot
  products, no atomics).
- Weights carried across: every module's parameter tree has the flax
  module's paths and shapes (``jax.eval_shape`` of its ``init``), loads
  into the port (``load_params``, strict) and comes back out of
  ``params_to_flax`` bit for bit — the JAX-initialised
  ``MultiscaleDiscriminator`` tree (reversed ``scale{num_D - 1 - i}``
  names) included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import pix2pix as jp
from rgbd_pifuhd_tpu_torch.models import pix2pix as tp
from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt

FWD_REL = 1e-5
POOL_REL = 1e-6

# name -> (JAX module, port module, input channels, input size)
MODULES = {
    "global": (lambda: jp.GlobalGenerator(output_nc=3, ngf=8,
                                          n_downsampling=2, n_blocks=1),
               lambda: tp.GlobalGenerator(6, 3, 8, 2, 1, device="cpu"),
               6, 32),
    "local": (lambda: jp.LocalEnhancer(output_nc=3, ngf=8,
                                       n_downsample_global=2,
                                       n_blocks_global=1, n_blocks_local=1),
              lambda: tp.LocalEnhancer(6, 3, 8, 2, 1, 1, device="cpu"),
              6, 64),
    "encoder": (lambda: jp.Encoder(output_nc=3, ngf=8, n_downsampling=2),
                lambda: tp.Encoder(6, 3, 8, 2, device="cpu"), 6, 32),
    "nlayer": (lambda: jp.NLayerDiscriminator(ndf=8, n_layers=2),
               lambda: tp.NLayerDiscriminator(9, 8, 2, device="cpu"), 9, 37),
    "multiscale": (lambda: jp.MultiscaleDiscriminator(ndf=8, n_layers=2,
                                                      num_D=2),
                   lambda: tp.MultiscaleDiscriminator(9, 8, 2, 2,
                                                      device="cpu"),
                   9, 64),
}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


JAX_INIT = ("multiscale",)


def _leaves_abstract(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_abstract(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def inits():
    """Parameters (a flax tree, numpy leaves) and an input per module."""
    out = {}
    rng = np.random.default_rng(0)
    for i, (name, (jmod, tmod, cin, size)) in enumerate(MODULES.items()):
        x = rng.standard_normal((1, size, size, cin)).astype(np.float32)
        if name in JAX_INIT:
            v = jax.tree.map(np.asarray, jax.jit(jmod().init)(
                jax.random.PRNGKey(1), x))
        else:
            m = tmod()
            init_flax(m, torch.Generator().manual_seed(i))
            v = tckpt.params_to_flax(m)
        out[name] = (v, x)
    return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_forward_matches_jax(inits, name):
    jmod, tmod, _, _ = MODULES[name]
    v, x = inits[name]
    want = list(_leaves(jax.jit(jmod().apply)(v, x)))
    m = tmod()
    tckpt.load_params(m, v)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    got = list(_leaves(jax.tree.map(lambda t: t.numpy(), got)
                       if not isinstance(got, torch.Tensor)
                       else got.numpy()))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= FWD_REL * float(np.abs(w).max()), (path, err)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_weights_cross_bit_for_bit(inits, name):
    jmod, tmod, _, _ = MODULES[name]
    v, x = inits[name]
    shapes = jax.eval_shape(jmod().init, jax.random.PRNGKey(1), x)
    assert [(p, a.shape) for p, a in _leaves(v)] == [
        (p, tuple(a.shape)) for p, a in _leaves_abstract(shapes)]
    m = tmod()
    tckpt.load_params(m, v)
    back = tckpt.params_to_flax(m)
    lb, lv = list(_leaves(back)), list(_leaves(v))
    assert [p for p, _ in lb] == [p for p, _ in lv]
    for (path, a), (_, b) in zip(lb, lv):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_multiscale_names_run_in_reverse(inits):
    v, _ = inits["multiscale"]
    assert sorted(v["params"]) == ["scale0", "scale1"]
    m = MODULES["multiscale"][1]()
    # the first scale (full resolution) is the module named scale1
    assert [n for n, _ in m.named_children()] == ["scale1", "scale0"]


def test_instance_average_pool_matches_jax(rng):
    feats = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    inst = rng.integers(0, 4, (2, 12, 10)).astype(np.int32)
    inst[1][inst[1] == 2] = 1                   # an empty region
    want = np.asarray(jp.instance_average_pool(jnp.asarray(feats),
                                               jnp.asarray(inst), 4))
    got = tp.instance_average_pool(torch.from_numpy(feats),
                                   torch.from_numpy(inst), 4).numpy()
    assert np.abs(got - want).max() <= POOL_REL * np.abs(want).max()
    for b in range(2):
        for k in np.unique(inst[b]):
            region = got[b][inst[b] == k]
            assert np.array_equal(region, np.broadcast_to(region[0],
                                                          region.shape))
    again = tp.instance_average_pool(torch.from_numpy(feats),
                                     torch.from_numpy(inst), 4).numpy()
    assert np.array_equal(got, again)
