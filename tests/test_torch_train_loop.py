"""The port's training drivers and CLIs, on the CPU.

- ``pretrain_coarse(max_steps=2)`` and ``train_fine(max_steps=2)`` in both
  packages on a tree the JAX package wrote, from the same JAX-initialised
  parameters, one prefetch thread each (the reader's generator is shared
  by the items, so with more threads the draws follow the threads): the
  per-step losses (each package's ``train_result`` error history) within
  1e-4 relative; each package's checkpoint loads in the other with an
  equal tree.
- ``cli.run_train --device cpu``: ``--stage coarse`` then ``--stage fine
  --load_netG_checkpoint_path`` at narrow widths set by the CLI's own
  flags, on a tree the port wrote: netG comes out of the fine stage
  bit-equal to the coarse checkpoint, netMR changed, the error histories
  written, every loss finite; ``--stage eval`` then evaluates the epoch
  checkpoint.  Without ``--device cpu`` it raises on a host without CUDA;
  an unknown stage and the multi-process flags (slice 9) raise by name.
- ``cli.run_recon --demo-sphere --device cpu`` at narrow widths, 32^3.
- ``train_fine`` with ``continue_train`` / ``resume_epoch`` starts from the
  named checkpoint; ``profile_trace`` writes a trace.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu.models import MultiResPIFu as JMulti
from rgbd_pifuhd_tpu.train import loop as jloop
from rgbd_pifuhd_tpu.utils import checkpoint as jckpt
from rgbd_pifuhd_tpu.utils.logging import load_error_history as jhistory
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.cli import run_recon, run_train
from rgbd_pifuhd_tpu_torch.data.synthetic import (
    generate_synthetic_dataset as port_generate)
from rgbd_pifuhd_tpu_torch.recon.mesh import load_obj
from rgbd_pifuhd_tpu_torch.train import loop as tloop
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from rgbd_pifuhd_tpu_torch.utils.logging import load_error_history
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig
from tests.test_models_pifu import tiny_global, tiny_local

G = dataclasses.replace(tiny_global(), mlp_dim=(9, 64, 32, 32, 1),
                        mlp_norm="group", load_size=128)
L = dataclasses.replace(tiny_local(), mlp_dim=(36, 32, 32, 1),
                        mlp_norm="group", load_size=128)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _equal_trees(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and np.array_equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    root = str(base / "tree")
    generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                               load_size=128, seed=1)
    x = jnp.zeros((1, 1, 32, 32, 6))
    v = jax.jit(JMulti(cfg=L, cfg_global=G).init)(
        jax.random.PRNGKey(0), x, x[:, 0], jnp.zeros((1, 1, 8, 3)),
        jnp.eye(4)[None, None], jnp.eye(4)[None], jnp.zeros((1, 1, 8, 1)))
    return {"base": base, "root": root,
            "vars": jax.tree.map(np.asarray, v)}


def _opts(root, ckpt_dir):
    common = dict(dataroot=root, load_size=128, load_size_big=128,
                  load_size_local=64, num_sample_inout=128, sigma=3.0,
                  batch_size=1, num_epoch=1, checkpoints_path=ckpt_dir,
                  name="t", freq_save=1)
    return (JOptions(netG=G, netMR=L, **common),
            TOptions(netG=PIFuLevelConfig(**dataclasses.asdict(G)),
                     netMR=PIFuLevelConfig(**dataclasses.asdict(L)),
                     **common))


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_drivers_match_jax(world, monkeypatch, stage):
    for mod in (jloop, tloop):
        monkeypatch.setattr(mod, "_batches", functools.partial(
            mod._batches, num_threads=1))
    v = world["vars"]
    params = {k: t["netG"] for k, t in v.items()} if stage == "coarse" \
        else v
    name = "t_netG" if stage == "coarse" else "t_netMR"
    ckname = "t_netG" if stage == "coarse" else "t"
    losses, trees = {}, {}
    for pkg in ("jax", "port"):
        d = world["base"] / f"{stage}_{pkg}"
        d.mkdir()
        monkeypatch.chdir(d)
        jo, to = _opts(world["root"], str(d / "ckpt"))
        if pkg == "jax":
            fn = jloop.pretrain_coarse if stage == "coarse" \
                else jloop.train_fine
            fn(jo, max_steps=2, params=params)
            losses[pkg] = jhistory("./train_result", name)[-1]
        else:
            fn = tloop.pretrain_coarse if stage == "coarse" \
                else tloop.train_fine
            fn(to, max_steps=2, params=params, device="cpu")
            losses[pkg] = load_error_history("./train_result", name)[-1]
        trees[pkg] = str(d / "ckpt" / f"{ckname}_train_latest")
    assert len(losses["port"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    # each package reads the other's checkpoint as its writer meant it
    port_in_jax = jckpt.load_checkpoint(trees["port"])
    port_in_port = tckpt.load_checkpoint(trees["port"], device="cpu")
    assert _equal_trees(port_in_jax["params"], jax.tree.map(
        lambda t: t.numpy(), port_in_port["params"]))
    jax_in_port = tckpt.load_checkpoint(trees["jax"], device="cpu")
    assert _equal_trees(jax.tree.map(lambda t: t.numpy(),
                                     jax_in_port["params"]),
                        jckpt.load_checkpoint(trees["jax"])["params"])
    assert port_in_jax["opt"]["netG"]["mlp_dim"] == list(G.mlp_dim)


CLI_WIDTHS = ["--num_stack_global", "1", "--hg_depth_global", "1",
              "--hg_dim_global", "16", "--mlp_dim_global", "17", "64", "32",
              "32", "1", "--mlp_res_layers_global", "1",
              "--hg_depth_local", "1", "--hg_dim_local", "4",
              "--mlp_dim_local", "36", "32", "1", "--mlp_res_layers_local",
              "1", "--no_front_normal", "--no_back_normal"]


def opt_of(argv):
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options
    return parse_options(argv[:-2])


def test_cli_coarse_then_fine(world, monkeypatch):
    base = world["base"] / "cli"
    root = str(base / "tree")
    port_generate(root, ("sphere", "capsule"), size=128, load_size=128,
                  seed=2)
    monkeypatch.chdir(base)
    common = ["--dataroot", root, "--name", "c", "--checkpoints_path",
              str(base / "ck"), "--loadSize", "128", "--loadSizeBig", "128",
              "--loadSizeLocal", "64", "--num_sample_inout", "128",
              "--sigma", "3", "--num_epoch", "2", "--freq_save", "100"
              ] + CLI_WIDTHS + ["--device", "cpu"]
    run_train.main(["--stage", "coarse"] + common)
    g = str(base / "ck" / "c_netG_train_latest")
    run_train.main(["--stage", "fine", "--load_netG_checkpoint_path", g]
                   + common)
    coarse = tckpt.load_checkpoint(g, device="cpu")
    fine = tckpt.load_checkpoint(str(base / "ck" / "c_train_latest"),
                                 device="cpu")
    assert fine["epoch"] == 1 and coarse["epoch"] == 1
    assert os.path.exists(str(base / "ck" / "c_train_epoch_0"))
    assert not os.path.exists(str(base / "ck" / "c_train_epoch_1"))
    for path, t in _leaves(jax.tree.map(lambda x: x.numpy(),
                                        coarse["params"]["params"])):
        node = fine["params"]["params"]["netG"]
        for k in path:
            node = node[k]
        assert np.array_equal(node.numpy(), t), path
    fresh = tloop.build_multires(opt_of(common), "cpu")
    tloop.init_multires_params(opt_of(common), fresh)
    start = tckpt.params_to_flax(fresh)["params"]["mlp"]["dense0"]["kernel"]
    end = fine["params"]["params"]["mlp"]["dense0"]["kernel"].numpy()
    assert start.shape == end.shape and not np.array_equal(start, end)
    for name in ("c_netG", "c_netMR"):
        hist = load_error_history("./train_result", name)
        assert len(hist) == 2 and len(hist[-1]) == 4
        assert np.isfinite(hist[-1]).all()
    # continue_train from epoch 0: no step, so latest = what was loaded
    topt = opt_of(common)
    topt.continue_train, topt.resume_epoch = True, 0
    tloop.train_fine(topt, max_steps=0, device="cpu")
    e0 = tckpt.load_checkpoint(str(base / "ck" / "c_train_epoch_0"), "cpu")
    again = tckpt.load_checkpoint(str(base / "ck" / "c_train_latest"), "cpu")
    assert again["epoch"] == 0
    assert _equal_trees(jax.tree.map(lambda x: x.numpy(), e0["params"]),
                        jax.tree.map(lambda x: x.numpy(), again["params"]))
    # --stage eval over the epoch checkpoint the fine stage wrote
    run_train.main(["--stage", "eval"] + common)
    errs = np.load(str(base / "ck" / "c_eval_epoch_0.npy"))
    assert len(errs) == 2 and np.isfinite(errs).all()
    with pytest.raises(SystemExit, match="unknown --stage"):
        run_train.main(["--stage", "nonsense"] + common)
    with pytest.raises(SystemExit, match="slice 9"):
        run_train.main(["--coordinator_address", "x:1"] + common)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_train.main(["--stage", "coarse"] + common[:-2])


def test_demo_sphere(world):
    out = world["base"] / "demo"
    run_recon.main(["--demo-sphere", "--device", "cpu", "--resolution", "32",
                    "--results_path", str(out), "--loadSize", "256"]
                   + CLI_WIDTHS)
    assert os.path.exists(str(out / "_demo_data" / "gen" / "sphere_0.png"))
    path = str(out / "pifuhd" / "recon" / "result_sphere_32.obj")
    if os.path.exists(path):       # a fresh model's field may be empty
        v, f, c = load_obj(path)
        assert np.isfinite(v).all() and np.isfinite(c).all()


def test_profile_trace_writes_a_trace(tmp_path):
    from rgbd_pifuhd_tpu_torch.utils.logging import profile_trace

    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
