"""The control of each cell's correctness check comes out not correct: the
reference, one precision below the configuration's, put in the program's
place.  On the CPU at tiny widths (``tiny.py``, the configuration stating
bfloat16 as the cells do); on the card at the cells' own sizes, three
seeds each (``chip``)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import run as R
from portbench.tests import tiny


def _bf16(cell):
    cfg = dict(cell["config"])
    for k in ("netG", "netMR"):
        cfg[k] = dict(cfg[k], compute_dtype="bfloat16")
    return dict(cell, config=cfg)


def test_control_fails_serve_tiny(tmp_path):
    p = str(tmp_path / "tiny")
    tiny.checkpoint(p)
    cell = tiny.serve_cell(p)
    res = R.run_cell(cell, 31415926535, 2.0, False, device="cpu",
                     t_start=time.perf_counter(), control=True)
    assert not res["correct"], res["compared"]


def test_control_fails_train_tiny():
    res = R.run_cell(_bf16(tiny.train_cell()), 27182818284, 1.0, False,
                     device="cpu",
                     t_start=time.perf_counter(), control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["lite-serve-fd", "flagship-train-coarse"])
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, os.path.join(tiny.ROOT, "portbench", "tests",
                                      "readings.py"), workload, "10",
         "161803", "271828", "314159", "--control"],
        capture_output=True, text=True, check=True)
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)
