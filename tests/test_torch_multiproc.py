"""Multi-process runs of the port on the CPU: two processes joined by gloo
on localhost (``parallel.distributed``), children that import torch and
the port only.

- ``tests/torch_multiproc_child.py``: the tiny batch-norm pair (the JAX
  multi-host test's model) takes 3 data-parallel fine steps on a global
  batch of 8 through ``shard_host_batch`` + ``shard_train_step``; its
  losses meet JAX's ``shard_train_step`` on the 8-device mesh from the
  same parameters within rtol 1e-4 / atol 1e-6 (that test's tolerance),
  and the port's one-process steps on the global batch within rtol 1e-5.
  A grid query whose point axis spans both processes (8 shards) equals the
  port's one-process 8-shard query and the unsharded one (a norm-free
  MLP) within 1e-6;
- ``cli.run_train --num_processes 2 --device cpu`` on a tiny tree: rank 0
  writes the checkpoint and the error history, rank 1 writes no file,
  and the losses are the one-process run's;
- ``run_train`` on a host with two GPUs and no multi-process flag starts
  two ranks itself (device count and spawner patched);
- ``shard_host_batch``: a no-op for one process, and an indivisible batch
  raises.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.parallel import make_device_mesh as jmake_mesh
from rgbd_pifuhd_tpu.train.trainers import make_fine_train_step as jfine
from rgbd_pifuhd_tpu.train.trainers import make_optimizer as jmake_opt
from rgbd_pifuhd_tpu.train.trainers import shard_train_step as jshard
from rgbd_pifuhd_tpu_torch.cli import run_train
from rgbd_pifuhd_tpu_torch.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu_torch.parallel import distributed, make_device_mesh
from rgbd_pifuhd_tpu_torch.parallel import shard_host_batch
from rgbd_pifuhd_tpu_torch.train import loop as tloop
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from rgbd_pifuhd_tpu_torch.utils.logging import load_error_history
from tests import torch_multiproc_child as child
from tests.test_torch_train_loop import CLI_WIDTHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # two ranks beside the parent: without the root conftest's per-worker
    # budget, three processes of one thread per core ran the file 2-2.6x
    # slower than with two threads a child
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.Popen([sys.executable] + args, cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(procs, timeout=240):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a child timed out")
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{text[-4000:]}"
    return outs


def _jax_losses(batch, tree) -> list:
    """JAX's ``shard_train_step`` on the 8-device mesh, 3 steps."""
    from tests.multihost_child import build_model_and_batch

    model, jbatch = build_model_and_batch()
    for k, v in batch.items():
        np.testing.assert_array_equal(np.asarray(jbatch[k]), v)
    tx = jmake_opt("rmsprop", 1e-3)
    variables = jax.tree.map(np.asarray, tree)
    opt_state = jax.tree.map(np.asarray, tx.init(variables["params"]))
    step = jshard(jfine(model, tx), jmake_mesh())
    losses = []
    for _ in range(3):
        variables, opt_state, m = step(variables, opt_state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_two_process_training_and_query_match(tmp_path):
    from __graft_entry__ import _configs

    jg, jl, _, _ = _configs(tiny=True)
    g, l = child.bn_configs()
    assert dataclasses.asdict(g) == dataclasses.asdict(
        dataclasses.replace(jg, norm="batch"))
    assert dataclasses.asdict(l) == dataclasses.asdict(
        dataclasses.replace(jl, norm="batch"))
    port, out = _free_port(), str(tmp_path / "out.npz")
    procs = [_start([child.__file__, str(port), str(pid), out],
                    str(tmp_path)) for pid in (0, 1)]
    # the references run while the children do
    batch = child.example_batch()
    tree = tckpt.params_to_flax(child.build_model())
    want = _jax_losses(batch, tree)
    one = child.train_steps(child.build_model(), batch)
    model = child.build_model().eval()
    vol_one = child.grid_query(model, batch,
                               make_device_mesh(devices=["cpu"] * 8))
    vol_plain = child.grid_query(model, batch)
    _wait(procs)
    res = np.load(out)
    assert res["losses"][-1] < res["losses"][0]
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res["losses"], one, rtol=1e-5)
    np.testing.assert_allclose(res["vol"], vol_one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["vol"], vol_plain, rtol=0, atol=1e-6)


def _files(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs)


def test_run_train_two_processes_cpu(tmp_path, monkeypatch):
    root = str(tmp_path / "tree")
    generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                               load_size=128, seed=2)
    common = ["--dataroot", root, "--name", "c", "--loadSize", "128",
              "--loadSizeBig", "128", "--loadSizeLocal", "64",
              "--num_sample_inout", "128", "--sigma", "3", "--num_epoch",
              "2", "--batch_size", "2", "--freq_save", "100"] + CLI_WIDTHS \
        + ["--device", "cpu"]
    port = _free_port()
    procs = []
    for pid in (0, 1):
        cwd = tmp_path / f"rank{pid}"
        cwd.mkdir()
        procs.append(_start(
            ["-m", "rgbd_pifuhd_tpu_torch.cli.run_train", "--stage",
             "coarse", "--checkpoints_path", str(tmp_path / f"ck{pid}"),
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(pid)] + common,
            str(cwd)))
    # the same run in one process, one reader thread (as under a mesh)
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    monkeypatch.setattr(tloop, "_batches", functools.partial(
        tloop._batches, num_threads=1))
    run_train.main(["--stage", "coarse", "--checkpoints_path",
                    str(one / "ck")] + common)
    outs = _wait(procs)
    assert "Name: c_netG" in outs[0] and "Name: c_netG" not in outs[1]
    assert _files(tmp_path / "rank1") == [] and not os.path.exists(
        tmp_path / "ck1")
    assert os.path.exists(tmp_path / "ck0" / "c_netG_train_latest")
    two = load_error_history(str(tmp_path / "rank0" / "train_result"),
                             "c_netG")
    ref = load_error_history(str(one / "train_result"), "c_netG")
    # each epoch's file holds every step's loss so far
    assert len(two[-1]) == len(ref[-1]) == 2 and np.isfinite(two[-1]).all()
    np.testing.assert_allclose(two[-1], ref[-1], rtol=1e-5)


def test_run_train_spawns_one_rank_per_gpu(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(run_train, "spawn_ranks",
                        lambda argv, n: seen.append((argv, n)))
    argv = ["--stage", "coarse", "--dataroot", "/nonexistent"]
    run_train.main(argv)
    assert seen == [(argv, 2)]
    # the multi-process flags (or the variables) start no ranks
    monkeypatch.setenv("RGBD_NUM_PROCESSES", "1")
    with pytest.raises(RuntimeError, match="dataset too small"):
        run_train.main(argv)        # it ran the stage itself
    assert len(seen) == 1
    # a spawned rank runs main with its own flags
    got = []
    monkeypatch.setattr(run_train, "main", lambda a: got.append(a))
    run_train._rank_main(1, argv, 2, 1234)
    assert got == [argv + ["--coordinator_address", "127.0.0.1:1234",
                           "--num_processes", "2", "--process_id", "1"]]


def test_shard_host_batch_single_process_noop():
    mesh = make_device_mesh(devices=["cpu"] * 8)
    batch = {"x": torch.ones(8, 3)}
    assert shard_host_batch(mesh, batch) is batch


def test_shard_host_batch_rejects_indivisible(monkeypatch):
    mesh = make_device_mesh(devices=["cpu"] * 8)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    with pytest.raises(ValueError, match="not divisible"):
        shard_host_batch(mesh, {"x": np.ones((7, 3), np.float32)})
    out = shard_host_batch(mesh, {"x": np.arange(8)})
    assert out["x"].tolist() == [4, 5, 6, 7]
