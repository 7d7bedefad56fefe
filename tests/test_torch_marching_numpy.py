"""The port's NumPy marchers (``recon/marching.py``: ``marching_cubes_numpy``,
``marching_tetrahedra_cells``) against the JAX package's, and the port's
native marchers against them, on seeded volumes, as vertex and triangle
sets.

- ``marching_cubes_numpy``: the JAX package's result exactly (both
  interpolate in float64), on a sphere and on random fields; watertight.
- ``marching_tetrahedra_cells`` (MT and MC) on a sphere with half of its
  surface cells dropped: the JAX package's (its native masked scan) within
  1e-5 (the native kernel interpolates in float32), the same triangles.
- The port's native marchers against the NumPy references: the dense
  ``marching_tetrahedra`` (MC against ``marching_cubes_numpy``, both
  against ``marching_tetrahedra_cells`` over every cell), the two-level
  ``marching_tetrahedra_sparse`` and the three-level
  ``marching_tetrahedra_sparse3`` against ``marching_tetrahedra_cells`` on
  the densified fields of ``tests/test_torch_grid.py``'s capsule.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.recon import marching as jm
from rgbd_pifuhd_tpu_torch.recon import grid as tgrid
from rgbd_pifuhd_tpu_torch.recon import marching as tm
from tests.test_torch_grid import CALIB_INV, C, tfield

ATOL = 1e-5


def _sphere(n=24, r=7.5):
    g = np.arange(n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2.0
    d = np.sqrt((x - c) ** 2 + (y - 0.8 * c) ** 2 + (z - c) ** 2)
    return (1.0 / (1.0 + np.exp((d - r) * 2.0))).astype(np.float32)


def _random(seed, n=11):
    vol = np.zeros((n, n, n), np.float32)
    vol[1:-1, 1:-1, 1:-1] = np.random.default_rng(seed).uniform(
        0, 1, (n - 2,) * 3)
    return vol


def _same(name, got, ref, atol=0.0):
    (v, f), (rv, rf) = got, ref
    assert len(rv) > 50 and len(rf) > 50, name
    assert v.shape == rv.shape and f.shape == rf.shape, (name, v.shape,
                                                         rv.shape)
    o, ro = np.lexsort(np.round(v, 3).T), np.lexsort(np.round(rv, 3).T)
    np.testing.assert_allclose(v[o], rv[ro], atol=atol, rtol=0, err_msg=name)
    t, rt = np.round(v[f], 3).reshape(-1, 9), np.round(rv[rf], 3).reshape(
        -1, 9)
    assert np.array_equal(t[np.lexsort(t.T)], rt[np.lexsort(rt.T)]), name
    return float(np.abs(v[o] - rv[ro]).max())


def _watertight(f):
    cnt = Counter()
    for a, b, c in f:
        for e in ((a, b), (b, c), (c, a)):
            cnt[tuple(sorted(e))] += 1
    return all(n == 2 for n in cnt.values())


@pytest.mark.parametrize("vol", [_sphere(), _random(3), _random(5)],
                         ids=["sphere", "random3", "random5"])
def test_marching_cubes_numpy_matches_jax(vol):
    got = tm.marching_cubes_numpy(vol, 0.5)
    _same("mc numpy", got, jm.marching_cubes_numpy(vol, 0.5))
    assert _watertight(got[1])


def _surface_cells(vol, factor=8, keep=0.5, seed=0):
    """Origins of the factor^3 cells holding a mixed cube, a seeded
    ``keep`` share of them."""
    n = (np.asarray(vol.shape) - 1) // factor
    ins = vol > 0.5
    cells = []
    for idx in np.ndindex(*n):
        o = np.asarray(idx) * factor
        blk = ins[o[0]:o[0] + factor + 1, o[1]:o[1] + factor + 1,
                  o[2]:o[2] + factor + 1]
        if blk.any() and not blk.all():
            cells.append(o)
    cells = np.asarray(cells, np.int32)
    pick = np.random.default_rng(seed).random(len(cells)) < keep
    return cells[pick]


@pytest.mark.parametrize("algorithm", ["mt", "mc"])
def test_cells_matches_jax_and_native_dense(algorithm):
    vol = _sphere(65, 20.0)
    cells = _surface_cells(vol)
    got = tm.marching_tetrahedra_cells(vol, cells, factor=8,
                                       algorithm=algorithm)
    _same("cells", got, jm.marching_tetrahedra_cells(
        vol, cells, factor=8, algorithm=algorithm), ATOL)
    every = np.stack(np.meshgrid(*[np.arange(0, 64, 8)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    full = tm.marching_tetrahedra_cells(vol, every, algorithm=algorithm)
    assert len(full[0]) > len(got[0])
    _same("native dense", tm.marching_tetrahedra(vol, algorithm=algorithm),
          full, ATOL)
    if algorithm == "mc":
        small = _sphere()
        _same("native dense vs loop", tm.marching_tetrahedra(
            small, algorithm="mc"), tm.marching_cubes_numpy(small), ATOL)


@pytest.mark.parametrize("algorithm", ["mt", "mc"])
def test_native_sparse_matches_numpy_cells(algorithm):
    tinv, tc = torch.from_numpy(CALIB_INV), torch.tensor(C)
    res2 = 128
    corner, top, refined, _ = tgrid.eval_grid_two_phase_sparse(
        tfield, res2, tinv, tc, budget_cells=1024)
    corner, top, refined = corner.numpy(), top.numpy(), refined.numpy()
    cells, marks = tgrid.sparse_scan_cells(corner, top, res2)
    vol = tgrid.densify_sparse_volume(corner, top, refined, res2,
                                      scan_marks=marks)
    _same("two-level", tm.marching_tetrahedra_sparse(
        corner, top, refined, cells, res2, algorithm=algorithm),
        tm.marching_tetrahedra_cells(vol, cells, algorithm=algorithm), ATOL)

    res3 = 64
    out = [np.ascontiguousarray(x.numpy()) for x in
           tgrid.eval_grid_three_phase_sparse(
               tfield, res3, tinv, tc, budget_cells=128,
               budget_subcells=640)[:5]]
    cells, _ = tgrid.sparse_scan_cells(out[0], out[1], res3)
    vol = tgrid.densify_sparse3_volume(*out, res3)
    _same("three-level", tm.marching_tetrahedra_sparse3(
        *out, cells, res3, algorithm=algorithm),
        tm.marching_tetrahedra_cells(vol, cells, algorithm=algorithm), ATOL)
