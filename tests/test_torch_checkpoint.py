"""The port's flax-checkpoint reader and weight mapping against the JAX
package: the pure-Python msgpack decoder gives flax's own tree, options
round-trip, and ``params_from_flax`` maps a JAX model's weights so the
port computes the same outputs (f32, atol 1e-4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rgbd_pifuhd_tpu.models import GlobalGenerator as JGlobalGenerator
from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import GlobalGenerator, MultiResPIFu
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tck
from rgbd_pifuhd_tpu_torch.utils.options import Options, PIFuLevelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = ["assets/bench_tiny/ckpt", "assets/bench_flagship_lite/ckpt"]


def _same_tree(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for x, y in zip(a, b):
            _same_tree(x, y, path)
    else:
        assert a == b, path


@pytest.mark.parametrize("rel", CKPTS)
def test_msgpack_decoder_matches_flax(rel):
    raw = open(os.path.join(REPO, rel), "rb").read()
    mine = tck.msgpack_restore(raw)
    _same_tree(mine, serialization.msgpack_restore(raw))
    assert set(mine) == {"epoch", "opt", "opt_netG", "params"}


def test_msgpack_decoder_scalar_types():
    tree = {"a": 1, "b": -3, "c": 2 ** 40, "d": 1.5, "e": None, "f": True,
            "g": [1, "x", [2.5]], "h": np.arange(6, dtype=np.int32)
            .reshape(2, 3), "s": "é" * 40, "n": -(2 ** 40)}
    got = tck.msgpack_restore(serialization.msgpack_serialize(tree))
    _same_tree(got, serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))


@pytest.mark.parametrize("rel", CKPTS)
def test_options_round_trip(rel):
    state = tck.load_checkpoint(os.path.join(REPO, rel), device="cpu")
    mine = Options.from_dict(state["opt"])
    ref = JOptions.from_dict(state["opt"])
    assert mine.to_dict() == ref.to_dict()
    assert Options.from_dict(mine.to_dict()) == mine
    opt, _ = tck.restore_options(Options(resolution=256), state)
    assert opt.resolution == 256 and opt.netG == mine.netG
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(state["params"])
    assert all(x.dtype == torch.float32 for x in leaves)


def test_bench_tiny_loads_strictly():
    """Every tensor of a committed checkpoint finds its module; the
    f16-stored weights arrive as f32 holding the f16 values (what the JAX
    demo's cast gives), and the model is the norm-free two-level one."""
    state = tck.load_checkpoint(os.path.join(REPO, CKPTS[0]), device="cpu")
    opt = Options.from_dict(state["opt"])
    model = MultiResPIFu(opt.netMR, opt.netG, device="cpu")
    tck.load_params(model, state["params"])
    raw = serialization.msgpack_restore(open(os.path.join(
        REPO, CKPTS[0]), "rb").read())["params"]["params"]
    k = raw["mlp"]["dense0"]["kernel"]
    assert k.dtype == np.float16
    w = model.mlp.dense0.weight
    assert w.dtype == torch.float32
    assert np.array_equal(w.detach().numpy(), k.astype(np.float32).T)
    assert model.mlp.norm == model.netG.mlp.norm == "none"
    assert model.mlp.filter_channels == [48, 64, 32, 1]
    n = sum(p.numel() for p in model.parameters())
    ref = sum(np.asarray(x).size for x in jax.tree.leaves(
        serialization.msgpack_restore(open(os.path.join(
            REPO, CKPTS[0]), "rb").read())["params"]))
    assert n == ref


def _tiny(normals: bool):
    g = PIFuLevelConfig(
        num_stack=2, hg_depth=1, hg_dim=8, norm="group", hg_down="ave_pool",
        mlp_dim=(9, 64, 64, 32, 1), mlp_res_layers=(1,), mlp_norm="group",
        merge_layer=2, use_front_normal=normals, use_back_normal=normals,
        nml_ngf=8, nml_n_downsampling=2, nml_n_blocks=1, load_size=64)
    l = PIFuLevelConfig(
        num_stack=1, hg_depth=1, hg_dim=4, norm="group", hg_down="no_down",
        mlp_dim=(36, 64, 32, 1), mlp_res_layers=(1,), mlp_norm="group",
        merge_layer=-1, use_front_normal=False, use_back_normal=False,
        load_size=64)
    return l, g


def test_params_from_flax_tiny_model(rng):
    """JAX init -> numpy tree -> params_from_flax -> the port's filter and
    query match the JAX model's (normal nets on: ConvTranspose flip)."""
    l, g = _tiny(True)
    jm = JMultiResPIFu(cfg=l, cfg_global=g)
    img_l = rng.standard_normal((1, 1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 1, 256, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l),
                     jnp.asarray(img_g), jnp.asarray(pts),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 256, 1)))
    tree = jax.tree.map(np.asarray, params)
    tm = MultiResPIFu(l, g, device="cpu")
    tck.load_params(tm, tree)

    gf = jm.apply(params, jnp.asarray(img_g), method=JMultiResPIFu
                  .filter_global)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img_g))
    for a, b in ((tgf.nml_front, gf.nml_front), (tgf.im_feats, gf.im_feats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    lf = jm.apply(params, jnp.asarray(img_l), gf,
                  method=JMultiResPIFu.filter_local)
    out = jm.apply(params, lf, gf, jnp.asarray(pts),
                   jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                   method=JMultiResPIFu.query)
    with torch.no_grad():
        tlf = tm.filter_local(torch.from_numpy(img_l), tgf)
        tout = tm.query(tlf, tgf, torch.from_numpy(pts),
                        torch.from_numpy(calib)[None, None],
                        torch.from_numpy(calib)[None])
    np.testing.assert_allclose(tout.preds.numpy(), np.asarray(out.preds),
                               atol=1e-4)


def test_global_generator_deconv_mapping(rng):
    """ConvTranspose: flax kernel -> torch weight undoes the spatial flip
    (a generator with random, non-symmetric kernels)."""
    jg = JGlobalGenerator(output_nc=3, ngf=4, n_downsampling=2, n_blocks=1)
    x = rng.standard_normal((1, 16, 16, 6)).astype(np.float32)
    params = jg.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tg = GlobalGenerator(6, 3, 4, 2, 1, device="cpu")
    tck.load_params(tg, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tg(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jg.apply(params, jnp.asarray(x))),
                               atol=1e-5)
