"""``tools/train_perceptual_backbone.py`` against the JAX script
(``scripts/train_perceptual_backbone.py``): the corpus of crops is the same
array on the same seed, each package's from the tree it wrote itself; a
few training steps on the CPU write an ``.npz`` that the JAX package's
``load_backbone`` reads with the committed backbone's names and shapes
(under ``tmp_path``: the committed file is never written)."""

import importlib.util
import os

import numpy as np

from rgbd_pifuhd_tpu.models.perceptual import load_backbone as jload
from rgbd_pifuhd_tpu_torch.tools import train_perceptual_backbone as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "assets", "perceptual", "backbone.npz")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_backbone_script",
        os.path.join(REPO, "scripts", "train_perceptual_backbone.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_matches_jax_script(tmp_path):
    want = _jax_script().build_corpus(str(tmp_path / "jax_tree"))
    got = tool.build_corpus(str(tmp_path / "port_tree"))
    assert got.shape == want.shape == (96, 64, 64, 3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_tool_writes_a_backbone_jax_reads(tmp_path, capsys):
    stamp = os.stat(COMMITTED).st_mtime_ns
    out = str(tmp_path / "backbone.npz")
    tool.main(["--steps", "2", "--device", "cpu", "--out", out,
               "--dataroot", str(tmp_path / "tree")])
    assert "final denoise mse" in capsys.readouterr().out
    got, ref = jload(out)["params"], jload(COMMITTED)["params"]
    assert sorted(got) == sorted(ref)
    for name in ref:
        for leaf in ("kernel", "bias"):
            a, b = np.asarray(got[name][leaf]), np.asarray(ref[name][leaf])
            assert a.shape == b.shape and np.isfinite(a).all()
    assert os.stat(COMMITTED).st_mtime_ns == stamp
