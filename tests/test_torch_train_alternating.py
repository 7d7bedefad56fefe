"""The alternating curriculum and checkpoint evaluation in the port against
the JAX package, on the CPU, f32, at the tiny widths and on the tree of
``tests/test_torch_train_normals.py`` (whose fixtures this file shares).

- ``train_alternating`` (one cycle, one step a stage: the fine stage
  trains on 512^2 crops, the slowest step here) end to end, one prefetch
  thread: every stage's per-step losses (``train_result`` histories of
  netF, netB, netG, netMR) within 1e-4 relative of the JAX package's.
  Both packages start from the port's seeded draw (patched into the JAX
  package's initialisers).  The returned tree carries the trained netF;
  the fine checkpoint loads into the two-level model.  At two steps a
  stage the fine stage's second loss is 1.4e-3 relative from the JAX
  package's: the stages before it leave netG a rounding apart, and the
  fine stage's RMSprop step carries that into the second loss; from
  equal parameters the fine stage with crops matches to 3.7e-6 over two
  steps.
- ``train_alternating`` with batch norm: the fine stage is handed the
  coarse stage's netG ``params`` with the fine tree's own netG statistics,
  as the JAX package copies ``params`` alone.
- ``evaluate_checkpoints`` on epoch checkpoints the JAX package wrote (0
  and 1, ``freq_save`` 1), with a batch larger than the dataset and with
  a batch of one: each epoch's result within 1e-5 relative, the ``.npy``
  files of equal length.
"""

import dataclasses

import jax
import numpy as np
import pytest

from rgbd_pifuhd_tpu.train import loop as jloop
from rgbd_pifuhd_tpu.utils import checkpoint as jckpt
from rgbd_pifuhd_tpu_torch.train import loop as tloop
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_train_normals import (  # noqa: F401 (fixture)
    LOOP_REL, _histories, _jax_inits, _leaves, _np, _one_thread, _opts,
    G, L, world)

EVAL_REL = 1e-5


def test_train_alternating_matches_jax(world, monkeypatch):
    _one_thread(monkeypatch)
    _jax_inits(monkeypatch, world)
    names = ("netF", "netB", "netG", "netMR")
    got = {}
    for pkg in ("jax", "port"):
        d = world["base"] / f"alt_{pkg}"
        d.mkdir()
        monkeypatch.chdir(d)
        jo, to = _opts(world["root"], str(d / "ck"))
        kw = dict(cycles=1, nml_epochs=1, coarse_epochs=1, fine_epochs=1,
                  max_steps=1)
        if pkg == "jax":
            out = jloop.train_alternating(jo, **kw)
        else:
            out = tloop.train_alternating(to, device="cpu", **kw)
        got[pkg] = (_histories(names, pkg == "port"), _np(out))
    for n in names:
        assert len(got["port"][0][n]) == len(got["jax"][0][n]) == 1, n
        np.testing.assert_allclose(got["port"][0][n], got["jax"][0][n],
                                   rtol=LOOP_REL, err_msg=n)
    tree = got["port"][1]
    assert "netF" in tree["params"]["netG"]
    # the fine checkpoint loads into the two-level model
    m = tloop.build_multires(_opts(world["root"], "")[1], "cpu")
    tckpt.load_params(m, tckpt.load_checkpoint(str(
        world["base"] / "alt_port" / "ck" / "t_train_latest"), "cpu")[
            "params"])


def test_train_alternating_keeps_fine_netG_statistics(world, monkeypatch):
    """Batch norm: the fine stage receives the coarse stage's netG
    ``params`` and its own netG statistics (as initialised in the first
    cycle), not the coarse stage's; the JAX package copies ``params``
    alone (and, unlike the port, fails at its second coarse stage on such
    a model: its ``pretrain_normals`` drops the statistics)."""
    _one_thread(monkeypatch)
    g = dataclasses.replace(G, norm="batch", mlp_norm="batch")
    loc = dataclasses.replace(L, norm="batch", mlp_norm="batch")
    d = world["base"] / "alt_bn"
    d.mkdir()
    monkeypatch.chdir(d)
    _, to = _opts(world["root"], str(d / "ck"), g, loc)
    handed = []
    real = tloop.train_fine

    def spy(opt, params=None, **kw):
        # what the fine stage is handed (the stage itself is held to the
        # JAX package's elsewhere; its 512^2 crops are slow here)
        handed.append(jax.tree.map(np.copy, params))
        return real(dataclasses.replace(opt, num_epoch=0), params=params,
                    **kw)

    monkeypatch.setattr(tloop, "train_fine", spy)
    out = tloop.train_alternating(to, cycles=1, nml_epochs=1,
                                  coarse_epochs=1, fine_epochs=1,
                                  max_steps=1, device="cpu")
    coarse = jax.tree.map(lambda t: t.numpy(), tckpt.load_checkpoint(
        str(d / "ck" / "t_netG_train_latest"), "cpu")["params"])
    (given,) = handed
    for (p, a), (_, b) in zip(_leaves(given["params"]["netG"]),
                              _leaves(coarse["params"])):
        assert np.array_equal(a, b), p
    moved = 0
    for (path, a), (_, c) in zip(_leaves(given["batch_stats"]["netG"]),
                                 _leaves(coarse["batch_stats"])):
        assert np.array_equal(a, np.zeros_like(a) if path[-1] == "mean"
                              else np.ones_like(a)), path
        moved += not np.array_equal(a, c)
    assert moved
    assert "netF" in out["params"]["netG"]


@pytest.mark.parametrize("batch_size", [3, 1])
def test_evaluate_checkpoints_matches_jax(world, monkeypatch, batch_size):
    _one_thread(monkeypatch)
    d = world["base"] / f"eval_{batch_size}"
    jo, to = _opts(world["root"], str(d))
    jo = dataclasses.replace(jo, batch_size=batch_size)
    to = dataclasses.replace(to, batch_size=batch_size)
    v = world["fine"]
    moved = jax.tree.map(lambda a: a * np.float32(0.9), v)
    for epoch, tree in ((0, v), (1, moved)):
        jckpt.save_checkpoint(jckpt.epoch_path(str(d), "t", epoch), tree,
                              jo, epoch=epoch)
    want = jloop.evaluate_checkpoints(jo)
    jnpy = [np.load(str(d / f"t_eval_epoch_{e}.npy")) for e in (0, 1)]
    got = tloop.evaluate_checkpoints(to, device="cpu")
    assert sorted(got) == sorted(want) == [0, 1]
    for e in (0, 1):
        assert np.isfinite(got[e])
        assert abs(got[e] - want[e]) <= EVAL_REL * abs(want[e]), e
        assert len(np.load(str(d / f"t_eval_epoch_{e}.npy"))) == len(
            jnpy[e]) == (1 if batch_size == 3 else 2)


