"""The texture cell (``texpifu-serve-512``) at a tiny size on the CPU: a
sound run is ``correct`` and its seeded netC colours (the spread the
configuration asks for); each fault of ``faults_tex.py`` makes ``correct``
false by a colour number; on a program without the texture network the
entry ends at once with an error."""

import time

import pytest
import torch

from portbench import run as R
from portbench.tests import faults_tex, tiny, tiny_tex

torch.set_num_threads(4)


def _run(cell, seconds=2.0, seed=223456789012345):
    res = R.run_cell(cell, seed, seconds, False, device="cpu",
                     t_start=time.perf_counter())
    assert not R.forbidden_modules()
    return res


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    tiny.checkpoint(p)
    return tiny_tex.tex_cell(p)


def test_tex_sound(cell):
    res = _run(cell)
    assert res["correct"], res["compared"]
    n = res["numbers"]
    assert n["checked"] == 2 and n["tex_color_std"] >= 0.1
    # float32 on both sides; the reference reads the vertices from the
    # OBJ's four decimals, the program coloured them unrounded (one run
    # read 6.6e-5 of the channels two levels off, none eight)
    assert n["tex_level_share8"] == 0 and n["tex_level_share2"] < 1e-3
    assert res["data"]["color_points"] > 0
    assert res["data"]["color_flops_per_point"] > 0


@pytest.mark.parametrize("fault,number", [
    ("tex_half_chunks", "tex_level_share8"),
    ("tex_one_chunk", "tex_level_share8"),
    ("tex_filter_zeroed", "tex_level_share8")])
def test_tex_fault(cell, fault, number):
    undo = faults_tex.apply(fault)
    try:
        res = _run(cell)
    finally:
        undo()
    assert not res["correct"]
    assert res["numbers"][number] > cell["limits"][number]


def test_program_without_texture_ends_at_once(cell, monkeypatch):
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    monkeypatch.delattr(Reconstructor, "encode_texture")
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="no texture network"):
        _run(cell)
    assert time.perf_counter() - t < 5


def test_frozen_counts_at_the_published_widths():
    import json
    import os

    from portbench import flops_tex as FT

    with open(os.path.join(tiny.ROOT, "portbench", "configs",
                           "pifuhd-lite-texpifu.json")) as f:
        cfg = json.load(f)
    c = cfg["netC"]
    assert FT.color_flops_per_point(c) == 2 * 1_675_011
    # the [128, 128, 512] bf16 map and the chain's weights and biases
    weights = 1_675_011 * 2 + 4 * (1024 + 512 + 256 + 128 + 3)
    assert FT.color_call_bytes(c, cfg["netG"]) == 128 * 128 * 512 * 2 \
        + weights
    assert 0.25e12 < FT.encode_flops(c) < 0.27e12
