"""The native marcher's sharded vertex merge (``native/marching.cc``):

- a session (``IncrementalMarcher3``) stepped over the scan cells gives the
  one-shot ``marching_tetrahedra_sparse3`` mesh as sorted vertex and
  triangle sets, whatever the steps (one cell each, a few cells, every
  cell at once, a step that shares no edge with the one before, a step of
  cells already visited), the thread count (1, 2, 3, 8) and the first
  step's map sizing (maps that must grow while a step inserts);
- the session's counters (``IncrementalMarcher3.stats``) add up;
- the reconstructor carries them per mesh on a ``bench_tiny`` mesh.

The field is ``tests/test_torch_grid.py``'s capsule at res 128: 17 k
(marching cubes) and 65 k (tetrahedra) vertices, so a step of every cell
merges on the pool and a step of a few cells on the calling thread.
"""

import os

import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu_torch.native import load_marching
from rgbd_pifuhd_tpu_torch.recon import grid as tgrid
from rgbd_pifuhd_tpu_torch.recon.marching import (
    IncrementalMarcher3, marching_tetrahedra_sparse3)
from tests.test_torch_grid import CALIB_INV, C, tfield

RES = 128
FACTOR = 8


@pytest.fixture(scope="module")
def field():
    out = tgrid.eval_grid_three_phase_sparse(
        tfield, RES, torch.from_numpy(CALIB_INV), torch.tensor(C),
        budget_cells=1024, budget_subcells=8192)
    fld = [np.ascontiguousarray(x.numpy()) for x in out[:5]]
    cells, _ = tgrid.sparse_scan_cells(fld[0], fld[1], RES)
    return fld, cells


def _canon(v, f):
    """Vertices sorted, triangles as sorted rows of their corners'
    positions (each row in the face's own order: the winding stays)."""
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], t[np.lexsort(t.T)]


def _apart(cells, verts):
    """Two scan cells with surface in their own cubes whose scanned cubes
    share no lattice edge (three cells apart on some axis)."""
    own = {tuple(o) for o in np.floor(verts).astype(np.int64) // FACTOR
           * FACTOR}
    surface = [i for i, o in enumerate(cells.tolist()) if tuple(o) in own]
    a = surface[0]
    b = next(i for i in surface
             if np.abs(cells[i] - cells[a]).max() >= 3 * FACTOR)
    return a, b


def _schedule(name, cells, verts):
    """Steps of cell rows; ``None`` marks a step of cells already visited
    (it must add nothing)."""
    if name == "single":
        return [cells[i:i + 1] for i in range(len(cells))]
    if name == "few":
        return [cells[i:i + 5] for i in range(0, len(cells), 5)]
    if name in ("all", "all_small_estimate"):
        return [cells]
    a, b = _apart(cells, verts)                     # "apart_revisit"
    rest = np.delete(cells, [a, b], axis=0)
    return [cells[a:a + 1], cells[b:b + 1], rest, None]


def _march(fld, steps, algorithm, n_threads, first_per_cell=0.0):
    """Step a session: the steps' ``(verts, faces)``, those of the steps of
    visited cells, the counters and the session's vertex total."""
    out, revisits, done = [], [], []
    with IncrementalMarcher3(*fld, RES, algorithm=algorithm,
                             n_threads=n_threads,
                             first_per_cell=first_per_cell) as m:
        for s in steps:
            if s is None:
                revisits.append(m.step(np.concatenate(done)[:7]))
            else:
                out.append(m.step(s))
                done.append(s)
        return out, revisits, m.stats(), m.total_verts


@pytest.mark.parametrize("n_threads", [1, 2, 3, 8])
@pytest.mark.parametrize("schedule", ["single", "few", "all",
                                      "all_small_estimate",
                                      "apart_revisit"])
@pytest.mark.parametrize("algorithm", ["mc", "mt"])
def test_stepped_mesh_is_the_one_shot_mesh(field, algorithm, schedule,
                                           n_threads):
    fld, cells = field
    ref_v, ref_f = marching_tetrahedra_sparse3(*fld, cells, RES,
                                               algorithm=algorithm)
    assert len(ref_v) > 10_000
    small = schedule == "all_small_estimate"
    steps = _schedule(schedule, cells, ref_v)
    out, revisits, st, total = _march(fld, steps, algorithm, n_threads,
                                      0.01 if small else 0.0)
    vs, fs = [v for v, _ in out], [f for _, f in out]
    v, f = np.concatenate(vs), np.concatenate(fs)
    assert total == len(v) == len(ref_v)
    # every face indexes three distinct vertices below the total so far
    assert f.min() >= 0 and f.max() < len(v)
    assert ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
            & (f[:, 0] != f[:, 2])).all()
    seen = 0
    for vi, fi in zip(vs, fs):
        seen += len(vi)
        assert len(fi) == 0 or fi.max() < seen
    for a, b in zip(_canon(v, f), _canon(ref_v, ref_f)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # a step of visited cells adds nothing
    assert all(len(rv) == len(rf) == 0 for rv, rf in revisits)
    if small:      # the thread-local maps grew while the step inserted
        assert st["map_grows"] > 0
    assert st["map_resizes"] > 0           # the shard maps start small
    if schedule == "apart_revisit":   # the far cell's step: its own only
        assert len(vs[0]) > 0 and len(vs[1]) > 0
        assert fs[1].min() >= len(vs[0])


@pytest.mark.parametrize("n_threads", [1, 3, 8])
@pytest.mark.parametrize("algorithm", ["mc", "mt"])
def test_session_counters_add_up(field, algorithm, n_threads):
    """New plus resolved vertices are the workers' thread-local vertices.
    With one worker those are, step by step, the vertices its faces use
    (each vertex a step makes is in one of its faces).  A generous first
    estimate leaves every map unchanged while a step inserts; a step of
    nearly every cell merges on the pool, a step of five cells on the
    calling thread."""
    fld, cells = field
    a, _ = _apart(cells, marching_tetrahedra_sparse3(
        *fld, cells, RES, algorithm=algorithm)[0])
    steps = [cells[a:a + 5], np.delete(cells, range(a, a + 5), axis=0)]
    with IncrementalMarcher3(*fld, RES, algorithm=algorithm,
                             n_threads=n_threads,
                             first_per_cell=1000.0) as m:
        out = [m.step(s) for s in steps]
        st = m.stats()
    V = sum(len(v) for v, _ in out)
    assert st["steps"] == 2
    assert st["verts_new"] == V
    assert st["verts_new"] + st["verts_resolved"] == st["verts_local"]
    used = sum(len(np.unique(f)) for _, f in out)
    if n_threads == 1:
        assert st["verts_local"] == used
    else:       # workers share the apron cubes' edges
        assert st["verts_local"] >= used
    assert st["verts_resolved"] > 0        # edges on the steps' border
    assert st["map_grows"] == 0
    assert st["scan_s"] > 0 and st["merge_s"] > 0
    # the first step's thread-local vertices (at most five workers' own)
    # are too few to wake the pool, the second's are not
    pooled_min = load_marching().mt_pooled_merge_min()
    assert len(out[0][0]) * 5 < pooled_min <= len(out[1][0])
    assert st["merges_pooled"] == (0 if n_threads == 1 else 1)

    with IncrementalMarcher3(*fld, RES, algorithm=algorithm,
                             n_threads=n_threads) as m:
        v, _ = m.step(cells)
        one = m.stats()
    assert one["verts_new"] == len(v) == V
    if n_threads == 1:
        assert one["verts_resolved"] == 0 and one["verts_local"] == V


def test_reconstructor_counts_the_marcher(tmp_path):
    """A ``bench_tiny`` mesh (trained capsule, res 64, band-streamed):
    ``host_secs`` carries the native step's scan and merge seconds inside
    ``march``, ``march_counts`` the session's counts, per mesh."""
    from rgbd_pifuhd_tpu_torch.cli.common import load_item, load_reconstructor
    from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.join(repo, "tests", "data", "jpeg_subject")
    opt, dev = parse_options(
        ["--load_netMR_checkpoint_path",
         os.path.join(repo, "assets", "bench_tiny", "ckpt"),
         "--dataroot", root, "--loadSize", "128", "--device", "cpu"],
        with_device=True)
    recon = load_reconstructor(opt, dev)[0]
    data = load_item(InferenceDataset(root, 128), 0)
    outs = [recon.gen_mesh(data, str(tmp_path / f"m{i}.obj"), 64)
            for i in range(2)]
    for out in outs:
        hs, mc = out["host_secs"], out["march_counts"]
        assert hs["march_scan"] > 0 and hs["march_merge"] > 0
        assert hs["march_scan"] + hs["march_merge"] <= hs["march"]
        assert mc["steps"] >= 1
        assert mc["verts_new"] == len(out["verts"]) > 100
        assert mc["verts_new"] + mc["verts_resolved"] == mc["verts_local"]
    # counted per mesh: the second mesh's counts are its own
    assert outs[1]["march_counts"]["steps"] == \
        outs[0]["march_counts"]["steps"]
    assert outs[1]["march_counts"]["verts_new"] == \
        outs[0]["march_counts"]["verts_new"]
