"""The tiny recipe in the port (``tools/train_bench_tiny.py``, the recipe
of the committed ``assets/bench_tiny``) on the CPU, f32:

- unmarked: one step a stage writes the committed checkpoint's tree (keys,
  shapes, f16), options and epoch rule;
- ``-m slow`` (~35 s alone, most of it the JAX steps' compiles):
  ``train_tiny`` (3 steps a stage) against ``scripts/train_bench_tiny.py``'s
  ``main`` (its steps recorded through a wrapper of ``jax.jit``), both from
  the port's seeded draw (patched into the JAX models' ``init``): every
  loss within 1e-4 relative (the trainer tests' tolerance; Adam 3e-3, b1
  0.9, as the recipe), the same checkpoint tree, epoch and options.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu_torch.tools import train_bench_tiny as tbt
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_bench_flagship import (  # noqa: F401 (fixtures)
    REPO, RTOL, _load_script, _read, _same_layout, recording_jit)


def test_tiny_tree_matches_committed_asset(tmp_path):
    path = tbt.train_tiny(str(tmp_path / "tree"), str(tmp_path / "out"),
                          steps=1, device="cpu")
    mine = _read(path)
    asset = _read(os.path.join(REPO, "assets", "bench_tiny", "ckpt"))
    _same_layout(mine["params"], asset["params"])
    assert mine["epoch"] == 1
    for k in ("netG", "netMR", "load_size", "num_sample_inout", "sigma"):
        assert mine["opt"][k] == asset["opt"][k], k


@pytest.mark.slow
def test_train_tiny_matches_jax(tmp_path, monkeypatch, recording_jit):
    from rgbd_pifuhd_tpu.models import CoarsePIFu, MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models import CoarsePIFu as TCoarse
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu as TMulti
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax

    js = _load_script("train_bench_tiny")
    root = str(tmp_path / "tree")
    tbt.ensure_tiny_dataset(root)
    topt = tbt.tiny_options(root)
    init = {}
    for key, model, seed in (
            ("coarse", TCoarse(topt.netG, device="cpu"), 0),
            ("fine", TMulti(topt.netMR, topt.netG, device="cpu"), 1)):
        init_flax(model, torch.Generator().manual_seed(seed))
        init[key] = tckpt.params_to_flax(model)
    for cls, key in ((CoarsePIFu, "coarse"), (MultiResPIFu, "fine")):
        monkeypatch.setattr(cls, "init", lambda self, *a, _k=key, **k:
                            jax.tree.map(jnp.asarray, init[_k]))

    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train_bench_tiny.py", "--steps", "3",
                                      "--out", jout, "--dataroot", root])
    js.main()
    jloss = [r[0] for r in recording_jit]
    steps = []
    path = tbt.train_tiny(root, str(tmp_path / "port"), steps=3,
                          device="cpu", init_vars=init,
                          on_step=lambda st, i, x: steps.append((st, x)))
    assert [st for st, _ in steps] == ["coarse"] * 3 + ["fine"] * 3
    np.testing.assert_allclose([x for _, x in steps], jloss, rtol=RTOL)
    jck, tck = _read(os.path.join(jout, "ckpt")), _read(path)
    _same_layout(tck["params"], jck["params"])
    assert tck["epoch"] == jck["epoch"] == 3
    assert tck["opt"] == jck["opt"]
