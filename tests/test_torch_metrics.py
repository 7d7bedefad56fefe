"""The port's metrics (``utils/metrics.py``) and loss-plot CLI
(``cli/plot_error.py``) against the JAX package's, on the CPU.

- ``compute_acc``: IoU, precision and recall exactly equal, thresholds and
  empty sets included.
- ``chamfer_l2``: within 1e-6 relative on seeded point sets; 0 for a set
  against itself.
- ``calc_error``: (loss, IoU, precision, recall) within 1e-5 relative over
  the first items of the same tree, each package with its own reader,
  collate and a fixed occupancy function of the points.
- ``plot_error``: the same standard output as the JAX CLI's on the same
  histories, with matplotlib (the plot written) and without it (the text
  summary alone, the path the card's host takes).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.cli import plot_error as jplot
from rgbd_pifuhd_tpu.data.datasets import TrainDataset as JTrainDataset
from rgbd_pifuhd_tpu.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu.train.loop import collate_coarse as jcollate
from rgbd_pifuhd_tpu.utils import metrics as jm
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.cli import plot_error as tplot
from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
from rgbd_pifuhd_tpu_torch.train.loop import collate_coarse
from rgbd_pifuhd_tpu_torch.utils import metrics as tm
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions

CHAMFER_REL = 1e-6
CALC_REL = 1e-5


@pytest.mark.parametrize("thresh", [0.5, 0.3, 2.0])
def test_compute_acc_matches_jax(rng, thresh):
    pred = rng.uniform(0, 1, (3, 257, 1)).astype(np.float32)
    gt = (rng.uniform(0, 1, (3, 257, 1)) > 0.6).astype(np.float32)
    want = jm.compute_acc(jnp.asarray(pred), jnp.asarray(gt), thresh)
    got = tm.compute_acc(torch.from_numpy(pred), torch.from_numpy(gt),
                         thresh)
    for g, w in zip(got, want):
        assert float(g) == float(w)


def test_chamfer_matches_jax(rng):
    a = rng.standard_normal((300, 3)).astype(np.float32)
    b = rng.standard_normal((211, 3)).astype(np.float32) + 0.1
    want = float(jm.chamfer_l2(jnp.asarray(a), jnp.asarray(b)))
    got = float(tm.chamfer_l2(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= CHAMFER_REL * abs(want)
    assert float(tm.chamfer_l2(torch.from_numpy(a),
                               torch.from_numpy(a))) == 0.0


def test_calc_error_matches_jax(tmp_path):
    root = str(tmp_path / "tree")
    generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                               load_size=128, seed=3)
    kw = dict(dataroot=root, load_size=128, load_size_big=64,
              load_size_local=64, num_sample_inout=256, sigma=3.0)

    def occupancy(pts, xp):
        # a fixed field of the points: a soft ball in the training box
        d = pts - xp.asarray(np.array([-128.0, 100.0, -434.0], np.float32))
        r = xp.sqrt((d ** 2).sum(-1, keepdims=True))
        return 1.0 / (1.0 + xp.exp((r - 80.0) / 10.0))

    def japply(_, b):
        p = occupancy(b["points"], jnp)
        loss = jnp.mean(jnp.abs(p - b["labels"]))
        return loss, p, b["labels"]

    def tapply(_, b):
        p = occupancy(b["points"], torch)
        return torch.mean(torch.abs(p - b["labels"])), p, b["labels"]

    want = jm.calc_error(japply, None, JTrainDataset(JOptions(**kw)),
                         jcollate, 2)
    got = tm.calc_error(tapply, None, TrainDataset(TOptions(**kw)),
                        collate_coarse, 2)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert abs(g - w) <= CALC_REL * abs(w), (got, want)
    assert 0 < got[1] <= 1


@pytest.mark.parametrize("matplotlib", [True, False])
def test_plot_error_prints_as_jax(tmp_path, monkeypatch, capsys, rng,
                                  matplotlib):
    out = tmp_path / "train_result"
    for suffix, n in (("netG", 120), ("netMR", 7), ("netF", 60)):
        d = out / f"x_{suffix}"
        d.mkdir(parents=True)
        for e in range(2):
            np.save(str(d / f"error_epoch_{e}.npy"),
                    rng.uniform(0, 1, n * (e + 1)))
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = ["--out_dir", str(out), "--name", "x"]
    texts = []
    for mod in (jplot, tplot):
        mod.main(args)
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert texts[1].count(" iters | first ") == 3
    assert ("saved plot:" in texts[1]) == matplotlib
    tplot.main(["--out_dir", str(out), "--name", "none"])
    assert capsys.readouterr().out == "no error histories found\n"
    for arr, groups in ((np.arange(120.0), 50), (np.arange(7.0), 50)):
        assert np.array_equal(tplot.group_average(arr, groups),
                              jplot.group_average(arr, groups))
