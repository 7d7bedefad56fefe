"""The port's perceptual losses (``models/vgg.py``, ``models/perceptual.py``)
against the JAX package's, on the CPU, f32, on seeded 32x32 images.

- ``VGG16Features`` (the port's random draw fed to both packages): every
  tap within 1e-5 of its largest |value|; the weight loaders (a torchvision-layout
  ``state_dict`` written with ``torch.save``, an ``.npz``) give the JAX
  package's trees bit for bit; ``find_weights`` searches the explicit path,
  ``RGBD_PIFUHD_VGG16`` and ``~/.cache/torch/hub/checkpoints/*vgg16*`` in
  that order; the port's random draw has flax's tree of shapes
  (``jax.eval_shape``) and ``lecun_normal``'s spread (the numbers differ
  by design: JAX's PRNG).
- ``make_perceptual_loss`` with VGG16 and with the committed native
  backbone (``CompactFeatures``, style weight 1e2, weight 0.3): the loss
  within 1e-6 relative of the JAX package's loss evaluated in float64
  (``jax.enable_x64``, the same parameters and images widened): the JAX
  package's own float32 loss is 5.3e-6 relative from that value on the
  VGG16 case (its 131,072-term content mean), the port's 8e-8, so the
  float32 JAX value cannot serve as a 1e-6 reference; the gradients
  with respect to both images within 1e-5 of their largest |value| of
  the JAX package's float32 gradients.  The port runs this test without
  oneDNN (PyTorch's CPU convolution library): on the VGG16 case oneDNN's
  float32 backward puts the first image's gradient up to 3e-4 off, in the
  rows of one batch item, where PyTorch's own CPU kernels are within
  4e-7 of the float64 value and the port in float64 equals the JAX
  package in float64 to 1e-15.  The card uses cuDNN, not oneDNN.  The content term's stop-gradient
  sits on the second image's features, as in the JAX package.
- ``CompactFeatures`` with the committed ``assets/perceptual/backbone.npz``
  and ``_DenoiseDecoder``: within 1e-5.  One pretext step
  (``backbone_step``) against the JAX step on the same batch and noise:
  loss 1e-6 relative; gradients within the training tests' tolerance (16
  times the JAX gradient's own spread under a one-ulp change of the input
  image, plus 1e-6 of the largest |gradient|,
  ``tests/test_torch_train_step.py``); the parameters after Adam within
  1e-6 of optax's update by the same gradients.
  ``save_backbone`` / ``load_backbone`` round-trip; ``find_backbone``
  finds the committed file.
- ``select_perceptual``: the same label as the JAX package's for "auto"
  (``l1_only`` here: no VGG16 weights exist), "native", True and False.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgbd_pifuhd_tpu.models import perceptual as jper
from rgbd_pifuhd_tpu.models import vgg as jvgg
from rgbd_pifuhd_tpu.train import loop as jloop
from rgbd_pifuhd_tpu_torch.models import perceptual as tper
from rgbd_pifuhd_tpu_torch.models import vgg as tvgg
from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
from rgbd_pifuhd_tpu_torch.train import loop as tloop
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_train_step import _check_grads, _port_grads, _ulp_noise

FWD_REL = 1e-5
LOSS_REL = 1e-6
ADAM_ATOL = 1e-6


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _check_adam(tx, before, grads, after):
    """``after`` (the port's parameters after its step) within
    ``ADAM_ATOL`` of optax's update of ``before`` by the port's own
    gradients ``grads``: the update's arithmetic, apart from the gradients
    (held to the JAX package's by ``_check_grads``), whose rounding the
    first Adam step amplifies without bound where a gradient is near 0."""
    grads = jax.tree.map(np.asarray, grads)
    upd, _ = tx.update(grads, tx.init(before), before)
    want = optax.apply_updates(before, upd)
    la, lw = list(_leaves(after)), list(_leaves(want))
    assert [p for p, _ in la] == [p for p, _ in lw]
    for (path, a), (_, w) in zip(la, lw):
        np.testing.assert_allclose(a, w, rtol=0, atol=ADAM_ATOL,
                                   err_msg=str(path))


def _leaves_abstract(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_abstract(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close(got, want, rel=FWD_REL):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err
    return err


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return [np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def vgg_vars():
    """The port's random VGG16 draw (flax's tree), fed to both packages."""
    return tvgg.VGG16Features.init_params(rng_key=0)


def _port_init(module, seed):
    init_flax(module, torch.Generator().manual_seed(seed), lecun=True)
    return tckpt.params_to_flax(module)


def test_vgg_forward_matches_jax(vgg_vars, images):
    want = jax.jit(jvgg.VGG16Features().apply)(vgg_vars, images[0])
    m = tvgg.VGG16Features(device="cpu")
    tckpt.load_params(m, vgg_vars)
    with torch.no_grad():
        got = m(torch.from_numpy(images[0]))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def test_vgg_loaders_match_jax(tmp_path, vgg_vars, monkeypatch):
    rng = np.random.default_rng(5)
    sd = {}
    for i, tid in enumerate(tvgg._TORCH_IDS):
        k = vgg_vars["params"][f"conv{i}"]["kernel"]
        sd[f"features.{tid}.weight"] = torch.from_numpy(
            rng.standard_normal(k.shape[::-1][:2] + k.shape[:2]).astype(
                np.float32))
        sd[f"features.{tid}.bias"] = torch.from_numpy(
            rng.standard_normal(k.shape[-1]).astype(np.float32))
    pth = str(tmp_path / "vgg16-test.pth")
    torch.save(sd, pth)
    a = tvgg.VGG16Features.load_torch_weights(pth)
    b = jax.tree.map(np.asarray, jvgg.VGG16Features.load_torch_weights(pth))
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{f"{n}_{k}": leaf for n, d in a["params"].items()
                     for k, leaf in d.items()})
    c = tvgg.VGG16Features.load_npz_weights(npz)
    d = jax.tree.map(np.asarray, jvgg.VGG16Features.load_npz_weights(npz))
    for x, y in ((a, b), (c, d), (a, c)):
        lx, ly = list(_leaves(x)), list(_leaves(y))
        assert [p for p, _ in lx] == [p for p, _ in ly]
        assert all(np.array_equal(u, w) for (_, u), (_, w) in zip(lx, ly))
    # the search order: explicit path, the variable, the hub cache
    home = tmp_path / "home"
    cache = home / ".cache" / "torch" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("RGBD_PIFUHD_VGG16", raising=False)
    for mod in (tvgg, jvgg):
        assert mod.VGG16Features.find_weights() is None
    os.replace(pth, str(cache / "vgg16-397923af.pth"))
    monkeypatch.setenv("RGBD_PIFUHD_VGG16", npz)
    for mod in (tvgg, jvgg):
        assert mod.VGG16Features.find_weights() == npz
        assert mod.VGG16Features.find_weights(str(tmp_path / "none")) == npz
    monkeypatch.delenv("RGBD_PIFUHD_VGG16")
    for mod in (tvgg, jvgg):
        assert mod.VGG16Features.find_weights() == str(
            cache / "vgg16-397923af.pth")
    got = tvgg.VGG16Features.load_weights()
    assert all(np.array_equal(u, w) for (_, u), (_, w) in zip(
        _leaves(got), _leaves(a)))


def test_vgg_random_draw_follows_flax(vgg_vars, images):
    shapes = jax.eval_shape(jvgg.VGG16Features().init,
                            jax.random.PRNGKey(0), images[0])
    want = [(p, tuple(a.shape)) for p, a in _leaves_abstract(shapes)]
    assert [(p, a.shape) for p, a in _leaves(vgg_vars)] == want
    for path, g in _leaves(vgg_vars):
        if path[-1] == "bias":
            assert not g.any()
            continue
        # lecun_normal: a unit normal cut at +-2, scaled to std 1/sqrt(fan)
        fan_in = np.prod(g.shape[:3])
        assert abs(g.std() * np.sqrt(fan_in) - 1) < 0.05, path
        assert np.abs(g).max() <= 2 / 0.87962566103423978 / np.sqrt(
            fan_in) + 1e-7, path
    again = tvgg.VGG16Features.init_params(rng_key=0)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaves(again), _leaves(vgg_vars)))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _loss_f64(make, params, kw, arrays) -> float:
    """The JAX package's loss in float64 on the same (widened) inputs."""
    with jax.enable_x64(True):
        return float(make(_f64(params), **kw)(*_f64(list(arrays))))


@pytest.mark.parametrize("kind", ["vgg16", "native"])
def test_perceptual_loss_matches_jax(vgg_vars, images, kind):
    x, y, s = images
    if kind == "vgg16":
        params, kw, tkw = vgg_vars, {}, {}
    else:
        params = jax.tree.map(np.asarray, jper.load_backbone(
            jper.find_backbone()))
        kw = dict(style_weight=1e2, feature_model=jper.CompactFeatures(),
                  weight=0.3)
        tkw = dict(style_weight=1e2, weight=0.3,
                   feature_model=tper.CompactFeatures(device="cpu"))
    jfn = jvgg.make_perceptual_loss(params, **kw)
    jg = jax.jit(jax.grad(jfn, argnums=(0, 1)))(x, y, s)
    jl = _loss_f64(jvgg.make_perceptual_loss, params, kw, (x, y, s))
    tfn = tvgg.make_perceptual_loss(params, **tkw)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    # oneDNN's float32 backward gives the first image's gradient up to
    # 3e-4 off (rows of one batch item) on this VGG16 draw, where PyTorch's
    # own CPU kernels, the port in float64 and the JAX package agree
    with torch.backends.mkldnn.flags(enabled=False):
        loss = tfn(tx, ty, torch.from_numpy(s))
        loss.backward()
    assert abs(float(loss.detach()) - jl) <= LOSS_REL * abs(jl)
    _close(ty.grad.numpy(), np.asarray(jg[1]))
    # the first image's gradient: content only, through its own features
    _close(tx.grad.numpy(), np.asarray(jg[0]))
    if kind == "native":        # the feature model is frozen
        assert not any(p.requires_grad
                       for p in tkw["feature_model"].parameters())


def test_backbone_and_decoder_match_jax(images, tmp_path):
    path = tper.find_backbone()
    assert path is not None and path.endswith(os.path.join(
        "assets", "perceptual", "backbone.npz"))
    assert path == os.path.normpath(jper.find_backbone())
    params = tper.load_backbone(path)
    enc = tper.CompactFeatures(device="cpu")
    tckpt.load_params(enc, params)
    want = jper.CompactFeatures().apply(params, images[0])
    with torch.no_grad():
        taps = enc(torch.from_numpy(images[0]))
    assert taps[0].shape == (2, 32, 32, 16)
    for g, w in zip(taps, want):
        _close(g.numpy(), np.asarray(w))
    dec = tper._DenoiseDecoder(device="cpu")
    dv = _port_init(dec, 2)
    with torch.no_grad():
        rec = dec(taps)
    _close(rec.numpy(), np.asarray(jper._DenoiseDecoder().apply(dv, want)))
    out = str(tmp_path / "b.npz")
    tper.save_backbone(out, params)
    back = tper.load_backbone(out)
    assert all(np.array_equal(u, w) for (_, u), (_, w) in zip(
        _leaves(back), _leaves(params)))


def test_backbone_step_matches_jax(images):
    """One pretext step, the batch and the noise given as arrays."""
    batch = {"clean": images[0],
             "noise": np.random.default_rng(9).standard_normal(
                 images[0].shape).astype(np.float32)}
    enc_j, dec_j = jper.CompactFeatures(), jper._DenoiseDecoder()
    enc, dec = tper.CompactFeatures(device="cpu"), tper._DenoiseDecoder(
        device="cpu")
    params = {"enc": _port_init(enc, 4), "dec": _port_init(dec, 5)}

    def loss_fn(p, b):
        rec = dec_j.apply(p["dec"], enc_j.apply(
            p["enc"], b["clean"] + 0.35 * b["noise"]))
        return jnp.mean((rec - b["clean"]) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    jl, jgrad = vg(params, batch)
    spread = _ulp_noise(lambda p, b: vg(p, b)[1], params, batch, ("clean",))

    opt = torch.optim.Adam(list(enc.parameters()) + list(dec.parameters()),
                           lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss = tper.backbone_step(enc, dec, opt, torch.from_numpy(
        batch["clean"]), torch.from_numpy(batch["noise"]))
    assert abs(float(loss) - float(jl)) <= LOSS_REL * abs(float(jl))
    tgrad = {"enc": {"params": _port_grads(enc)},
             "dec": {"params": _port_grads(dec)}}
    _check_grads(tgrad, jax.tree.map(np.asarray, jgrad), spread, set())
    _check_adam(optax.adam(1e-3), params, tgrad,
                {"enc": tckpt.params_to_flax(enc),
                 "dec": tckpt.params_to_flax(dec)})


def test_train_backbone_runs(images):
    params, loss = tper.train_backbone(np.concatenate(images), steps=2,
                                       batch=2, seed=1, device="cpu")
    assert np.isfinite(loss) and sorted(params["params"]) == sorted(
        f"conv{i}{s}" for i in range(4) for s in "ab")


@pytest.mark.parametrize("use_vgg", ["auto", "native", True, False])
def test_select_perceptual_matches_jax(monkeypatch, tmp_path, use_vgg,
                                      vgg_vars):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RGBD_PIFUHD_VGG16", raising=False)
    # the JAX package's random VGG16 (True) from the port's draw: the
    # choice, not the draw, is under test here
    monkeypatch.setattr(jvgg.VGG16Features, "load_weights",
                        staticmethod(lambda rng_key=0: vgg_vars))
    fn, label = tloop.select_perceptual(use_vgg, device="cpu")
    jfn, jlabel = jloop.select_perceptual(use_vgg)
    assert label == jlabel
    assert (fn is None) == (jfn is None)
    if use_vgg == "auto":
        assert label == "l1_only"
