"""Normal-net pretraining in the port (L1 and GAN) and the training CLI's
new stages, against the JAX package, on the CPU, f32, at tiny widths (netF / netB ngf 8, two
downsamplings, one residual block; discriminators ndf 8, two layers, two
scales; the ``tiny_global`` / ``tiny_local`` models of
``tests/test_models_pifu.py``), from the same JAX-initialised parameters.

- One normal step (``make_normal_train_step``, 5 L1 + the committed
  backbone's perceptual loss) and one GAN step
  (``make_gan_normal_train_step``, the same plus a multiscale
  discriminator on ``concat(images, map)``) against the JAX steps on the
  same 32x32 batch: losses within 1e-6 relative; gradients (the JAX
  package's taken from its own step, through an optimiser that hands them
  back as its state) within 16 times the JAX gradient's spread under a
  one-ulp change of the input images plus 1e-6 of the largest |gradient|
  (``tests/test_torch_train_step.py``); the parameters after Adam within
  1e-6 of optax's update (``make_optimizer("adam")``) by the same
  gradients.  The GAN step's discriminator gradient is taken at the
  generator's output from before its update, as in the JAX step.
- ``pretrain_normals`` (two steps a net) end to end on a tree the JAX
  package wrote, one prefetch thread: each net's per-step losses
  (``train_result`` histories) within 1e-4 relative of the JAX package's,
  from the port's seeded draw of the coarse model given to both; the
  returned tree and the ``<name>_netG`` checkpoint carry the trained
  netF / netB.
- ``pretrain_normals`` without a coarse tree (the CLI's path): netF and
  netB start from one seed, no checkpoint is written, montages are.
- The montage: the same pixels as the JAX package's PNG after decoding,
  from the same generator output.
- Both CLIs dispatch ``--stage normals|alternating|eval`` (recorded, not
  run) as the JAX CLI does.

``tests/test_torch_train_alternating.py`` holds the curriculum and the
evaluation.
"""

import dataclasses
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgbd_pifuhd_tpu.cli import run_train as jcli
from rgbd_pifuhd_tpu.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu.models import perceptual as jper
from rgbd_pifuhd_tpu.models import pix2pix as jp
from rgbd_pifuhd_tpu.models.vgg import make_perceptual_loss as jperceptual
from rgbd_pifuhd_tpu.train import loop as jloop
from rgbd_pifuhd_tpu.train import trainers as jtr
from rgbd_pifuhd_tpu.utils.logging import load_error_history as jhistory
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.cli import run_train
from rgbd_pifuhd_tpu_torch.models import CoarsePIFu
from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
from rgbd_pifuhd_tpu_torch.models import perceptual as tper
from rgbd_pifuhd_tpu_torch.models import pix2pix as tp
from rgbd_pifuhd_tpu_torch.models.vgg import make_perceptual_loss
from rgbd_pifuhd_tpu_torch.train import loop as tloop
from rgbd_pifuhd_tpu_torch.train import trainers as ttr
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from rgbd_pifuhd_tpu_torch.utils.logging import load_error_history
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig
from tests.test_models_pifu import tiny_global, tiny_local
from tests.test_torch_perceptual import _check_adam
from tests.test_torch_train_step import _check_grads, _port_grads, _ulp_noise

LOSS_REL = 1e-6
LOOP_REL = 1e-4
LR = 1e-3

G = dataclasses.replace(tiny_global(True), mlp_dim=(9, 64, 32, 32, 1),
                        mlp_norm="group", load_size=128)
L = dataclasses.replace(tiny_local(), mlp_dim=(36, 32, 32, 1),
                        mlp_norm="group", load_size=128)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _grab():
    """An optax transformation that applies nothing and keeps the
    gradients as its state: the JAX step's own gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return {"images": rng.standard_normal((2, 32, 32, 6)).astype(np.float32),
            "target": np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(
                np.float32),
            "style": np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(
                np.float32)}


@pytest.fixture(scope="module")
def nets():
    """The JAX modules and parameters (the port's seeded draw, flax
    trees) of the tiny generator and discriminator, and the committed
    backbone."""
    gen = jp.GlobalGenerator(output_nc=3, ngf=8, n_downsampling=2,
                             n_blocks=1)
    disc = jp.MultiscaleDiscriminator(ndf=8, n_layers=2, num_D=2)
    tg = tp.GlobalGenerator(6, 3, 8, 2, 1, device="cpu")
    td = tp.MultiscaleDiscriminator(9, 8, 2, 2, device="cpu")
    init_flax(tg, torch.Generator().manual_seed(0))
    init_flax(td, torch.Generator().manual_seed(1))
    backbone = jper.load_backbone(jper.find_backbone())
    return (gen, disc, tckpt.params_to_flax(tg), tckpt.params_to_flax(td),
            backbone)


def _port_nets(gv, dv=None):
    gen = tp.GlobalGenerator(6, 3, 8, 2, 1, device="cpu")
    tckpt.load_params(gen, gv)
    if dv is None:
        return gen
    disc = tp.MultiscaleDiscriminator(9, 8, 2, 2, device="cpu")
    tckpt.load_params(disc, dv)
    return gen, disc


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _perceptual(backbone, port):
    kw = dict(style_weight=1e2, weight=0.3)
    if port:
        return make_perceptual_loss(
            backbone, feature_model=tper.CompactFeatures(device="cpu"), **kw)
    return jperceptual(backbone, feature_model=jper.CompactFeatures(), **kw)


def test_normal_step_matches_jax(nets, batch):
    gen, _, gv, _, backbone = nets
    jstep = jax.jit(jtr.make_normal_train_step(
        lambda p, x: gen.apply(p, x), _grab(), _perceptual(backbone, False)))
    tx = _grab()
    _, jgrad, m = jstep(gv, tx.init(gv), batch)
    spread = _ulp_noise(lambda p, b: jstep(p, tx.init(p), b)[1], gv, batch,
                        ("images",))
    tg = _port_nets(gv)
    opt = ttr.make_optimizer("adam", LR, tg.parameters())
    step = ttr.make_normal_train_step(tg, opt, _perceptual(backbone, True))
    loss = float(step(_tb(batch))["loss"])
    assert abs(loss - float(m["loss"])) <= LOSS_REL * abs(float(m["loss"]))
    tgrad = {"params": _port_grads(tg)}
    _check_grads(tgrad, _np(jgrad), spread, set())
    _check_adam(jtr.make_optimizer("adam", LR), gv, tgrad,
                tckpt.params_to_flax(tg))


def test_gan_step_matches_jax(nets, batch):
    gen, disc, gv, dv, backbone = nets

    def disc_apply(p, imgs, maps):
        return disc.apply(p, jnp.concatenate([imgs, maps], -1))

    jstep = jax.jit(jtr.make_gan_normal_train_step(
        lambda p, x: gen.apply(p, x), disc_apply, _grab(), _grab(),
        _perceptual(backbone, False)))
    tx = _grab()

    def grads(p, b):
        out = jstep(p["g"], p["d"], tx.init(p["g"]), tx.init(p["d"]), b)
        return {"g": out[2], "d": out[3]}

    out = jstep(gv, dv, tx.init(gv), tx.init(dv), batch)
    jgrad, m = {"g": out[2], "d": out[3]}, out[4]
    spread = _ulp_noise(grads, {"g": gv, "d": dv}, batch, ("images",))
    tg, td = _port_nets(gv, dv)
    opt_g = ttr.make_optimizer("adam", LR, tg.parameters())
    opt_d = ttr.make_optimizer("adam", LR, td.parameters())
    step = ttr.make_gan_normal_train_step(
        tg, lambda i, x: td(torch.cat([i, x], -1)), opt_g, opt_d,
        _perceptual(backbone, True))
    got = step(_tb(batch))
    for k in ("g_loss", "d_loss"):
        assert abs(float(got[k]) - float(m[k])) <= LOSS_REL * abs(
            float(m[k])), k
    tgrad = {"g": {"params": _port_grads(tg)},
             "d": {"params": _port_grads(td)}}
    _check_grads(tgrad, _np(jgrad), spread, set())
    _check_adam(jtr.make_optimizer("adam", LR), {"g": gv, "d": dv}, tgrad,
                {"g": tckpt.params_to_flax(tg),
                 "d": tckpt.params_to_flax(td)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tree the JAX package wrote, and the port's seeded initialisation
    of the coarse and the two-level model (flax trees)."""
    base = tmp_path_factory.mktemp("normals")
    root = str(base / "tree")
    generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                               load_size=128, seed=1)
    _, to = _opts(root, "")
    coarse = CoarsePIFu(to.netG, device="cpu")
    init_flax(coarse, torch.Generator().manual_seed(to.seed))
    fine = tloop.build_multires(to, "cpu")
    tloop.init_multires_params(to, fine)
    return {"base": base, "root": root,
            "coarse": tckpt.params_to_flax(coarse),
            "fine": tckpt.params_to_flax(fine)}


def _opts(root, ckpt_dir, g=G, loc=L):
    common = dict(dataroot=root, load_size=128, load_size_big=64,
                  load_size_local=64, num_sample_inout=128, sigma=3.0,
                  batch_size=1, num_epoch=1, checkpoints_path=ckpt_dir,
                  name="t", freq_save=1)
    return (JOptions(netG=g, netMR=loc, **common),
            TOptions(netG=PIFuLevelConfig(**dataclasses.asdict(g)),
                     netMR=PIFuLevelConfig(**dataclasses.asdict(loc)),
                     **common))


def _one_thread(monkeypatch):
    for mod in (jloop, tloop):
        monkeypatch.setattr(mod, "_batches", functools.partial(
            mod._batches, num_threads=1))


def _jax_inits(monkeypatch, world):
    """The JAX package's initialisers give the port's seeded draw (the
    port's own initialisers draw it from ``opt.seed``)."""
    monkeypatch.setattr(jloop.CoarsePIFu, "init", lambda self, *a, **k:
                        jax.tree.map(np.copy, world["coarse"]))
    monkeypatch.setattr(jloop, "init_multires_params", lambda *a:
                        jax.tree.map(np.copy, world["fine"]))


def _histories(names, port):
    load = load_error_history if port else jhistory
    return {n: load("./train_result", f"t_{n}")[-1] for n in names}


def test_pretrain_normals_matches_jax(world, monkeypatch):
    _one_thread(monkeypatch)
    got = {}
    for pkg in ("jax", "port"):
        d = world["base"] / f"nml_{pkg}"
        d.mkdir()
        monkeypatch.chdir(d)
        jo, to = _opts(world["root"], str(d / "ck"))
        if pkg == "jax":
            out = jloop.pretrain_normals(jo, world["coarse"], max_steps=2,
                                         use_vgg="auto")
        else:
            out = tloop.pretrain_normals(to, world["coarse"], max_steps=2,
                                         use_vgg="auto", device="cpu")
        got[pkg] = (_histories(("netF", "netB"), pkg == "port"), _np(out))
        for net in ("netF", "netB"):
            assert os.path.exists(f"train_result/t_{net}/sample_epoch_0.png")
    for net in ("netF", "netB"):
        assert len(got["port"][0][net]) == len(got["jax"][0][net]) == 2
        np.testing.assert_allclose(got["port"][0][net], got["jax"][0][net],
                                   rtol=LOOP_REL)
    # the trained nets are in the returned tree and its checkpoint
    tree = got["port"][1]
    ck = tckpt.load_checkpoint(str(world["base"] / "nml_port" / "ck" /
                                   "t_netG_train_latest"), "cpu")
    for net in ("netF", "netB"):
        start = world["coarse"]["params"][net]["stem"]["kernel"]
        end = tree["params"][net]["stem"]["kernel"]
        assert not np.array_equal(start, end)
        assert np.array_equal(ck["params"]["params"][net]["stem"][
            "kernel"].numpy(), end)


def test_pretrain_normals_without_coarse_tree(world, monkeypatch):
    """The CLI's path: both nets from one seed, no checkpoint."""
    _one_thread(monkeypatch)
    d = world["base"] / "nml_cli"
    d.mkdir()
    monkeypatch.chdir(d)
    _, to = _opts(world["root"], str(d / "ck"))
    starts = []
    real = tloop.init_flax

    def spy(model, generator, **kw):
        real(model, generator, **kw)
        starts.append(tckpt.params_to_flax(model))

    monkeypatch.setattr(tloop, "init_flax", spy)
    out = tloop.pretrain_normals(to, max_steps=1, device="cpu")
    assert sorted(out) == ["netB", "netF"] and len(starts) == 2
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaves(starts[0]), _leaves(starts[1])))
    assert not os.path.exists(str(d / "ck"))
    for net in ("netF", "netB"):
        assert len(load_error_history("./train_result", f"t_{net}")[-1]) == 1
        assert os.path.exists(f"train_result/t_{net}/sample_epoch_0.png")


def test_montage_pixels_match_jax(nets, batch, tmp_path, monkeypatch):
    gen, _, gv, _, _ = nets
    monkeypatch.chdir(tmp_path)
    opt = JOptions(name="m")
    jb = {k: jnp.asarray(v[:1]) for k, v in batch.items()}
    jloop._save_normal_montage(opt, gen, gv, jb, "netF", 0)
    want = cv2.imread("train_result/m_netF/sample_epoch_0.png")
    fake = torch.from_numpy(np.asarray(gen.apply(gv, jb["images"])))

    class Fixed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x):
            return fake

    os.remove("train_result/m_netF/sample_epoch_0.png")
    tloop._save_normal_montage(TOptions(name="m"), Fixed(),
                               {k: torch.from_numpy(np.asarray(v))
                                for k, v in jb.items()}, "netF", 0)
    got = cv2.imread("train_result/m_netF/sample_epoch_0.png")
    assert got.shape == want.shape == (32, 96, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("stage", ["normals", "alternating", "eval"])
def test_cli_dispatch(monkeypatch, stage):
    calls = {}

    def rec(name):
        def fn(opt, **kw):
            calls[name] = (opt.name, sorted(kw))
            return {}
        return fn

    names = {"normals": "pretrain_normals", "alternating":
             "train_alternating", "eval": "evaluate_checkpoints"}
    for name in names.values():
        monkeypatch.setattr(tloop, name, rec(f"port.{name}"))
        monkeypatch.setattr(jloop, name, rec(f"jax.{name}"))
        if hasattr(jcli, name):
            monkeypatch.setattr(jcli, name, rec(f"jax.{name}"))
    import rgbd_pifuhd_tpu.utils.jax_cache as jcache
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda: None)
    argv = ["--stage", stage, "--name", "d"]
    run_train.main(argv + ["--device", "cpu"])
    jcli.main(argv)
    fn = names[stage]
    assert calls[f"port.{fn}"] == ("d", ["device"])
    assert calls[f"jax.{fn}"][0] == "d"
