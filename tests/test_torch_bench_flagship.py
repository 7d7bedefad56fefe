"""The flagship recipe in the port (``tools/train_bench_flagship.py``)
against the JAX package's script, on the CPU, f32, at tiny widths, on one
tree the port wrote (sphere and capsule, 128^2 renders read at 1024^2:
the fine stage's 512^2 crop window needs them), the JAX script loaded
with ``importlib`` and its ``flagship_options`` / ``FLAG_DATA_KW`` patched
in this process only (so are ``cv2.imread`` and the compile cache, which
the script changes process-wide, and the 65^3 ambiguity lattice, which
has its own test).  Both start from the port's seeded draw
(``init_vars``, patched into the JAX models' ``init``); the JAX steps are
recorded through a wrapper of ``jax.jit``.
(``tests/test_torch_bench_tiny.py`` holds the tiny recipe's.)

- Unmarked, the default recipe, 1 step a stage: an uninterrupted run's
  stage files (copied as written) left for a second run, as a run killed
  after stage 2 leaves them: it trains stage 3 alone and writes a
  checkpoint bit-equal to the uninterrupted one (resuming from another
  run's stage files would also compare two runs of stage 1, and a first
  CPU training in a process can round differently, rarely, which Adam's
  first step amplifies).  The JAX script given those stage files resumes
  from them (its recipe tag equals the port's) and its first coarse batch
  (``sample_batch`` with ``far_boost``) and fine batch (``crop_batch``:
  window, ``calib_local``, points, labels), recorded before any step
  compiles, equal the port's byte for byte.
- ``-m slow`` (~95 s alone: each package's 512^2 fine step costs ~5 s on
  the CPU, and the JAX steps compile): ``train_flagship`` end to end, 2
  steps a stage.  The JAX script runs stage 1, then stage 2 from the
  port's stage-1 files, then stage 3 from the port's stage-2 file (each
  stage from equal parameters).  Every step's loss within 1e-4 relative
  (the tolerance of ``tests/test_torch_train_loop.py``), with Adam at lr
  1e-5 in the occupancy stages (the recipe's ``--lr``): at the default
  3e-3 Adam's first update is +-lr for every parameter whose gradient is
  at the rounding level, so the two packages' second losses part by
  ~4e-4; the batches and the resume as above; the recipe tag equal to
  the JAX script's tag file; the final checkpoints with the same keys,
  shapes and dtypes (f16).
- The stage files load in both packages (both directions), an untagged
  or corrupt one means "retrain", and a mismatched tag too.
- ``_coarse_ambiguity`` of one tiny coarse model with the same weights:
  the same count of ambiguous cells.
- ``--lite``: the port's flagship-lite tree has the keys, shapes and
  dtypes of the committed ``assets/bench_flagship_lite/ckpt`` (read, not
  written).
- ``main``: ``--supervised`` hands a child command without the flag to
  ``utils.watchdog.run_watchdog``; the default output directories are the
  port's cache, not ``assets/``.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu.utils.options import PIFuLevelConfig as JLevel
from rgbd_pifuhd_tpu_torch.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu_torch.tools import train_bench_flagship as tbf
from rgbd_pifuhd_tpu_torch.tools import train_bench_tiny as tbt
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig as TLevel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(subjects=("sphere", "capsule"), size=128, load_size=1024,
               seed=0)
G = dict(num_stack=2, hg_depth=1, hg_dim=8, norm="group",
         hg_down="ave_pool", mlp_dim=(9, 64, 32, 32, 1),
         mlp_res_layers=(1,), mlp_norm="group", merge_layer=2,
         use_front_normal=True, use_back_normal=True, nml_ngf=4,
         nml_n_downsampling=2, nml_n_blocks=1, load_size=1024)
L = dict(num_stack=1, hg_depth=1, hg_dim=4, norm="group",
         hg_down="no_down", mlp_dim=(36, 32, 32, 1), mlp_res_layers=(1,),
         mlp_norm="group", merge_layer=-1, use_front_normal=False,
         use_back_normal=False, load_size=1024)
COMMON = dict(load_size=1024, load_size_big=1024, load_size_local=128,
              num_sample_inout=256, sigma=8.0)
RTOL = 1e-4
STAGES = ["stage1_nml_netF", "stage1_nml_netB", "stage2_coarse"]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _same_layout(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert (x.shape, x.dtype) == (y.shape, y.dtype), p


def _read(path):
    with open(path, "rb") as f:
        return tckpt.msgpack_restore(f.read())


class _Stop(Exception):
    pass


def _stopper(*_a, **_k):
    raise _Stop()


class _Record(list):
    """Each train step's ``(loss, batch)``; with ``stop`` set, the first
    step's batch is recorded and ``_Stop`` raised before the step is
    compiled."""
    stop = False


@pytest.fixture
def recording_jit(monkeypatch):
    """``jax.jit`` that records each train step's loss and batch."""
    real = jax.jit
    rec = _Record()

    def jit(fun=None, *a, **k):
        if fun is None:
            return lambda f: jit(f, *a, **k)
        f = real(fun, *a, **k)

        def call(*args):
            step = len(args) == 3 and isinstance(args[2], dict)
            if step and rec.stop:
                rec.append((None, {k: np.asarray(v)
                                   for k, v in args[2].items()}))
                raise _Stop()
            out = f(*args)
            if step:
                rec.append((float(out[2]["loss"]),
                            {k: np.asarray(v) for k, v in args[2].items()}))
            return out

        return call

    monkeypatch.setattr(jax, "jit", jit)
    return rec


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flagship") / "tree")
    generate_synthetic_dataset(root, **DATA_KW)
    return root


def _port_init_vars():
    """The port's default initial draws at these widths, as flax trees:
    both packages start from them (the JAX script's ``init`` calls are
    patched to return them)."""
    from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.models.pix2pix import GlobalGenerator

    def draw(model, seed):
        init_flax(model, torch.Generator().manual_seed(seed))
        return tckpt.params_to_flax(model)

    g = TLevel(**G)
    nml = draw(GlobalGenerator(6, 3, g.nml_ngf, g.nml_n_downsampling,
                               g.nml_n_blocks, device="cpu"), 0)
    return {"netF": nml, "netB": nml,
            "coarse": draw(CoarsePIFu(g, device="cpu"), 0),
            "fine": draw(MultiResPIFu(TLevel(**L), g, device="cpu"), 1)}


def _patch_jax_inits(monkeypatch, init):
    from rgbd_pifuhd_tpu.models import CoarsePIFu, MultiResPIFu
    from rgbd_pifuhd_tpu.models.pix2pix import GlobalGenerator

    for cls, key in ((GlobalGenerator, "netF"), (CoarsePIFu, "coarse"),
                     (MultiResPIFu, "fine")):
        monkeypatch.setattr(cls, "init", lambda self, *a, _k=key, **k:
                            jax.tree.map(jnp.asarray, init[_k]))


def _copy_stages(src, dst, names):
    import shutil

    os.makedirs(dst, exist_ok=True)
    for n in names:
        for ext in ("", ".tag"):
            shutil.copyfile(os.path.join(src, n + ext),
                            os.path.join(dst, n + ext))


def _recipes_at_tiny_widths(monkeypatch):
    """Both scripts at the tiny widths on ``DATA_KW``'s tree, from the
    port's seeded draw; the JAX script's process-wide side effects
    (``cv2.imread``, the compile cache) undone after the test; the 65^3
    ambiguity lattice (its own test below) skipped.  Returns the loaded
    JAX script and the initial trees."""
    import cv2

    import rgbd_pifuhd_tpu.utils.jax_cache as jcache

    monkeypatch.setattr(cv2, "imread", cv2.imread)
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda: None)
    js = _load_script("train_bench_flagship")
    monkeypatch.setattr(js, "flagship_options", lambda root, lite=False:
                        JOptions(dataroot=root, netG=JLevel(**G),
                                 netMR=JLevel(**L), **COMMON))
    monkeypatch.setattr(js, "FLAG_DATA_KW", DATA_KW)
    monkeypatch.setattr(tbf, "flagship_options", lambda root, lite=False:
                        TOptions(dataroot=root, netG=TLevel(**G),
                                 netMR=TLevel(**L), **COMMON))
    monkeypatch.setattr(tbf, "FLAG_DATA_KW", DATA_KW)
    init = _port_init_vars()
    _patch_jax_inits(monkeypatch, init)
    for mod in (js, tbf):
        monkeypatch.setattr(mod, "_coarse_ambiguity", lambda *a: 0)
    return js, init


def _port_run_keeping_stages(monkeypatch, tree, out, kept, **kw):
    """An uninterrupted port run, its stage files copied to ``kept`` as
    they are written (the run deletes them at its end)."""
    save = tbf._save_stage

    def save_and_keep(path, *a):
        r = save(path, *a)
        _copy_stages(os.path.dirname(path), kept, [os.path.basename(path)])
        return r

    with monkeypatch.context() as m:
        m.setattr(tbf, "_save_stage", save_and_keep)
        tbf.train_flagship(tree, out, device="cpu", **kw)
    assert sorted(os.listdir(out)) == ["ckpt"]     # resume points removed


def _first_batches(tree):
    """The port's first coarse batch (``sample_batch`` with ``far_boost``,
    after the init draw) and first fine batch (``crop_batch``, after the
    init draw) of item 0."""
    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset

    opt = tbf.flagship_options(tree)
    ds = TrainDataset(opt, seed=0)
    items = [ds[i] for i in range(len(ds))]
    data = tbf.RecipeData(ds, items, opt, 2.0)
    rng = np.random.default_rng(0)
    data.sample_batch(0, rng)
    s, lbl = data.sample_batch(0, rng)
    assert len(s) == 3 * COMMON["num_sample_inout"]
    rng = np.random.default_rng(101)
    big = torch.from_numpy(np.asarray(items[0]["img"], np.float32))
    data.crop_batch(0, rng, big, None, None)
    fine = data.crop_batch(0, rng, big, None, None)
    return {"points": s, "labels": lbl}, {k: fine[k].numpy() for k in (
        "images_local", "calib_local", "points", "labels")}


def test_resume_is_bit_equal_and_batches_match_jax(tree, tmp_path,
                                                   monkeypatch,
                                                   recording_jit):
    """The default recipe (Adam 3e-3), 1 step a stage.  A run left with an
    uninterrupted run's stage files, as a run killed after stage 2 leaves
    them, trains stage 3 alone and writes the same checkpoint bit for bit.
    The JAX script, given the port's stage files, resumes from them (so
    its recipe tag is the port's) and its first coarse and fine batches,
    recorded before any step is compiled, equal the port's byte for
    byte."""
    js, init = _recipes_at_tiny_widths(monkeypatch)
    kw = dict(steps_nml=1, steps_coarse=1, steps_fine=1, log_every=1)
    full, kept = str(tmp_path / "full"), str(tmp_path / "kept")
    _port_run_keeping_stages(monkeypatch, tree, full, kept, init_vars=init,
                             **kw)
    tag = tbf.recipe_tag(1, 1, 1, "adam", 3e-3, 2.0, 0, False, 10000, 0)
    assert open(os.path.join(kept, "stage2_coarse.tag")).read() == tag
    part = str(tmp_path / "resumed")
    _copy_stages(kept, part, STAGES)
    steps = []
    tbf.train_flagship(tree, part, device="cpu",  # default draws
                       on_step=lambda *a: steps.append(a[0]), **kw)
    assert steps == ["fine"]
    with open(os.path.join(part, "ckpt"), "rb") as a, \
            open(os.path.join(full, "ckpt"), "rb") as b:
        assert a.read() == b.read()

    coarse, fine = _first_batches(tree)
    recording_jit.stop = True
    for n, names, want in ((1, STAGES[:2], coarse), (2, STAGES, fine)):
        jout = str(tmp_path / f"jax{n}")
        _copy_stages(kept, jout, names)
        with pytest.raises(_Stop):
            js.train_flagship(tree, jout, **kw)
        assert len(recording_jit) == n      # resumed: no stage retrained
        got = recording_jit[-1][1]
        for k, v in want.items():
            assert np.array_equal(got[k][(0,) * (got[k].ndim - v.ndim)], v), k


@pytest.mark.slow
def test_train_flagship_matches_jax_and_resumes_bit_equal(
        tree, tmp_path, monkeypatch, recording_jit):
    import rgbd_pifuhd_tpu.models as jmodels

    js, init = _recipes_at_tiny_widths(monkeypatch)
    # Adam at lr 1e-5 in the occupancy stages (the recipe's --lr): Adam's
    # first update is +-lr for every parameter whose gradient is at the
    # rounding level, and the packages round differently, so at the
    # recipe's 3e-3 the second step's loss parts by ~4e-4 relative (the
    # update against optax on equal gradients:
    # tests/test_torch_train_normals.py)
    kw = dict(steps_nml=2, steps_coarse=2, steps_fine=2, log_every=1,
              lr=1e-5)
    s1 = STAGES[:2]

    # ---- the port, uninterrupted, then resumed after stage 2
    steps = []
    full, kept = str(tmp_path / "port_full"), str(tmp_path / "port_stages")
    _port_run_keeping_stages(monkeypatch, tree, full, kept, init_vars=init,
                             on_step=lambda *a: steps.append(a), **kw)
    assert [s[0] for s in steps] == ["netF"] * 2 + ["netB"] * 2 + \
        ["coarse"] * 2 + ["fine"] * 2
    part = str(tmp_path / "port_resumed")
    _copy_stages(kept, part, STAGES)
    resumed = []
    tbf.train_flagship(tree, part, device="cpu",  # default draws
                       on_step=lambda *a: resumed.append(a), **kw)
    assert [s[0] for s in resumed] == ["fine"] * 2
    with open(os.path.join(part, "ckpt"), "rb") as a, \
            open(os.path.join(full, "ckpt"), "rb") as b:
        assert a.read() == b.read()

    # ---- the JAX script, each stage from the port's stage files
    jout = str(tmp_path / "jax")
    recording_jit.clear()
    with monkeypatch.context() as m:
        m.setattr(jmodels, "CoarsePIFu", _stopper)
        with pytest.raises(_Stop):
            js.train_flagship(tree, jout, **kw)
    tag = open(os.path.join(jout, "stage1_nml_netF.tag")).read()
    assert tag == open(os.path.join(kept, "stage1_nml_netF.tag")).read()
    assert tag == tbf.recipe_tag(2, 2, 2, "adam", 1e-5, 2.0, 0, False,
                                 10000, 0)
    _copy_stages(kept, jout, s1)
    with monkeypatch.context() as m:
        m.setattr(jmodels, "MultiResPIFu", _stopper)
        with pytest.raises(_Stop):
            js.train_flagship(tree, jout, **kw)
    _copy_stages(kept, jout, ["stage2_coarse"])
    js.train_flagship(tree, jout, **kw)
    jrec = list(recording_jit)
    assert len(jrec) == 8
    np.testing.assert_allclose([s[2] for s in steps], [r[0] for r in jrec],
                               rtol=RTOL)

    # the first coarse and fine batches, byte for byte
    coarse, fine = _first_batches(tree)
    for (_, got), want in ((jrec[4], coarse), (jrec[6], fine)):
        for k, v in want.items():
            assert np.array_equal(got[k][(0,) * (got[k].ndim - v.ndim)], v), k

    # the checkpoints: same tree, f16
    jck, tck = _read(os.path.join(jout, "ckpt")), _read(
        os.path.join(full, "ckpt"))
    _same_layout(tck["params"], jck["params"])
    assert {x.dtype for _, x in _leaves(tck["params"])} == {
        np.dtype(np.float16)}
    assert tck["epoch"] == jck["epoch"] == 6


def test_stage_files_load_in_both_packages(tmp_path):
    js = _load_script("train_bench_flagship")
    rng = np.random.default_rng(0)
    tree = {"params": {"enc": {
        "kernel": rng.standard_normal((3, 4)).astype(np.float16),
        "bias": rng.standard_normal(4).astype(np.float16)}},
        "count": np.asarray(7, np.int32)}
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tbf._save_stage(a, tree, TOptions(), "t")
    js._save_stage(b, tree, JOptions(), "t")
    for got in (js._load_stage(a, "t"), tbf._load_stage(b, "t", "cpu"),
                tbf._load_stage(a, "t", "cpu")):
        assert got is not None
        for (_, x), (_, y) in zip(_leaves(got), _leaves(tree)):
            x = np.asarray(x)
            assert x.dtype == (np.float32 if y.dtype == np.float16
                               else y.dtype)
            assert np.array_equal(x, y.astype(x.dtype))
    assert tbf._load_stage(a, "other recipe", "cpu") is None
    os.remove(a + ".tag")
    assert tbf._load_stage(a, "t", "cpu") is None      # killed mid-write
    with open(b, "wb") as f:
        f.write(b"\x00garbage")
    assert tbf._load_stage(b, "t", "cpu") is None      # corrupt
    assert tbf._load_stage(str(tmp_path / "none"), "t", "cpu") is None


def test_coarse_ambiguity_matches_jax():
    """The same count of ambiguous cells, but for cells whose spread lies
    within 1e-5 of the 0.05 threshold (the packages' rounding differs):
    at most that many."""
    from rgbd_pifuhd_tpu.models import CoarsePIFu as JCoarse
    from rgbd_pifuhd_tpu_torch.models import CoarsePIFu as TCoarse
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax

    js = _load_script("train_bench_flagship")
    g = dict(G, use_front_normal=False, use_back_normal=False,
             mlp_norm="none", load_size=64)
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (1, 64, 64, 6)).astype(np.float32)
    calib = np.diag([1 / 32, -1 / 32, 1 / 32, 1.0]).astype(np.float32)
    calib[:3, 3] = [2.0, -1.5, 6.8]
    tc = TCoarse(TLevel(**g), device="cpu")
    init_flax(tc, torch.Generator().manual_seed(2))
    v = tckpt.params_to_flax(tc)
    # a field that varies over the lattice: the MLP's kernels scaled up
    for k, layer in v["params"]["mlp"].items():
        layer["kernel"] = layer["kernel"] * 20.0
    tckpt.load_params(tc, v)
    want = js._coarse_ambiguity(JCoarse(JLevel(**g)),
                                jax.tree.map(jnp.asarray, v),
                                jnp.asarray(img), calib)
    spread = tbf._lattice_spread(tc, torch.from_numpy(img), calib)
    got = tbf._coarse_ambiguity(tc, torch.from_numpy(img), calib)
    assert got == int((spread > 0.05).sum())
    ties = int((np.abs(spread - 0.05) < 1e-5).sum())
    assert abs(got - want) <= ties, (got, want, ties)
    assert 0.05 * 64 ** 3 < want < 0.95 * 64 ** 3


def test_lite_tree_matches_committed_asset():
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu

    opt = tbf.flagship_options("unused", lite=True)
    model = MultiResPIFu(opt.netMR, opt.netG, device="cpu")
    mine = tbf._pull_f16(tckpt.params_to_flax(model))
    asset = _read(os.path.join(REPO, "assets", "bench_flagship_lite",
                               "ckpt"))
    _same_layout(mine, asset["params"])
    assert asset["opt"]["netG"] == json.loads(json.dumps(
        dataclasses.asdict(opt.netG)))
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 1) == 42.6


def test_main_supervised_and_default_outputs(monkeypatch):
    import rgbd_pifuhd_tpu_torch.utils.watchdog as wd

    calls = {}

    def fake_watchdog(cmd=None, retry_sleep=30.0, probe=None):
        calls.update(cmd=cmd, probe=probe)
        raise SystemExit(0)

    monkeypatch.setattr(wd, "run_watchdog", fake_watchdog)
    monkeypatch.setattr(tbf, "train_flagship",
                        lambda *a, **k: calls.update(args=a, kw=k))
    for flag in ("--supervised", "--super"):
        calls.clear()
        with pytest.raises(SystemExit):
            tbf.main([flag, "--steps-fine", "7", "--lite"])
        assert "args" not in calls and calls["probe"] is True
        cmd = calls["cmd"]
        assert not any(a.startswith("--su") for a in cmd)
        assert cmd[cmd.index("--steps-fine") + 1] == "7"
        assert cmd[cmd.index("--out") + 1] == tbf.DEFAULT_LITE_OUT
        assert "--lite" in cmd
    calls.clear()
    tbf.main(["--steps-nml", "3", "--device", "cpu"])
    assert calls["args"][1] == tbf.DEFAULT_OUT
    assert calls["args"][2] == 3 and calls["kw"]["device"] == "cpu"
    assets = os.path.join(REPO, "assets")
    for out in (tbf.DEFAULT_OUT, tbf.DEFAULT_LITE_OUT, tbt.DEFAULT_OUT):
        assert not os.path.abspath(out).startswith(assets)
        assert os.path.join(".cache", "rgbd_pifuhd_tpu_torch") in out
