"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
of a tiny cell on the CPU (``portbench/tests/tiny.py``) with the cell's
own limits: first sound (``correct`` true), then once for each fault the
cell can have -- a value altered where it is produced, half of the work
left out, a step that leaves its state unchanged -- and sees ``correct``
false."""

import time

import pytest
import torch

from portbench import run as R
from portbench.tests import faults, tiny

torch.set_num_threads(4)


def _run(cell, seconds=2.0, seed=123456789012345):
    res = R.run_cell(cell, seed, seconds, False, device="cpu",
                     t_start=time.perf_counter())
    assert not R.forbidden_modules()
    return res


@pytest.fixture(scope="module")
def serve_cell(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    tiny.checkpoint(p)
    return tiny.serve_cell(p, "lite-batch-fd")


def test_serve_sound(serve_cell):
    res = _run(serve_cell)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("fault,number", [
    ("levels_altered", "p3_level_share2"), ("half_surface", "edge_missing"),
    ("vertex_moved", "vertex_off"), ("no_escalation", "active_miss")])
def test_serve_fault(serve_cell, fault, number):
    # the tiny field has few active cells: its first budget cut to 1/64
    undo = faults.apply(fault, **({"cut": 64} if fault == "no_escalation"
                                  else {}))
    try:
        res = _run(serve_cell)
    finally:
        undo()
    assert not res["correct"]
    assert res["numbers"][number] > serve_cell["limits"][number]


@pytest.fixture(scope="module")
def train_cell():
    return tiny.train_cell()


def test_train_sound(train_cell):
    res = _run(train_cell)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "change_gap_med"), ("half_points", "grad_gap_med"),
    ("labels_flipped", "label_miss")])
def test_train_fault(train_cell, fault, number):
    undo = faults.apply(fault)
    try:
        res = _run(train_cell)
    finally:
        undo()
    assert not res["correct"]
    assert res["numbers"][number] > train_cell["limits"][number]
