"""Grid evaluation: the port against the JAX package on one analytic
capsule field, byte for byte — the three-level octree at res 64, the
two-level one (at res 128 too, so that its budget takes several query
calls), the dense lattice, the host reassembly of the sparse results
(``densify_*``) and the marchers over each field.

The field is exact in both frameworks: lattice points map to dyadic world
coordinates (calib_inv = 2 I + t), and the capsule's squared distance and
occupancy are sums and products of short dyadic numbers, so f32 computes
them without rounding whatever the summation order or FMA use.  Every
quantised byte and every top-K index must then agree; a 4-bit flip would
be a fault to find, not a tolerance to grant.  The second budget pair
covers every cell, so tied (zero-activity) cells fill the tail of both
top-Ks: the stable sort must order ties like ``lax.top_k``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.recon import grid as jgrid
from rgbd_pifuhd_tpu_torch.recon import grid as tgrid

RES = 64
C = (-0.5, 0.25, 0.125)      # capsule centre (world)
R2, H = 0.5625, 0.625        # radius^2 and half-height, dyadic

CALIB_INV = np.eye(4, dtype=np.float32)
CALIB_INV[:3, :3] *= 2.0
CALIB_INV[:3, 3] = [-0.5, 0.25, 0.0]


def jfield(p, c):
    dy = p[:, 1] - jnp.clip(p[:, 1], c[1] - H, c[1] + H)
    d2 = (p[:, 0] - c[0]) ** 2 + dy ** 2 + (p[:, 2] - c[2]) ** 2
    return jnp.clip(0.5 + (R2 - d2) * 0.25, 0.0, 1.0)


def tfield(p, c):
    dy = p[:, 1] - torch.clamp(p[:, 1], c[1] - H, c[1] + H)
    d2 = (p[:, 0] - c[0]) ** 2 + dy ** 2 + (p[:, 2] - c[2]) ** 2
    return torch.clamp(0.5 + (R2 - d2) * 0.25, 0.0, 1.0)


def _eq(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    bad = int((a != b).sum())
    assert bad == 0, f"{name}: {bad} of {a.size} entries differ"


@pytest.mark.parametrize("budgets", [(96, 300), (512, 4096)])
def test_three_phase_byte_equal(budgets):
    K1, K2 = budgets
    jc, tc = jnp.asarray(C, jnp.float32), torch.tensor(C)
    jinv, tinv = jnp.asarray(CALIB_INV), torch.from_numpy(CALIB_INV)
    jcq, jt8, jbase, jd1 = jgrid._three_phase_p1(
        jfield, RES, 8, K1, 4, 4.0, jinv, jc)
    tcq, tt8, tbase, td1 = tgrid._three_phase_p1(
        tfield, RES, 8, K1, 4, 4.0, tinv, tc)
    _eq("corner_q", tcq, jcq)
    assert len(np.unique(tcq.numpy())) > 4     # the band holds the surface
    _eq("top8", tt8, jt8)
    _eq("cell_base", tbase, jbase)
    assert int(td1["n_active"]) == int(jd1["n_active"])
    jsq, jt4, jsb, jd2 = jgrid._three_phase_p2(
        jfield, RES, 8, K2, 4, 4.0, jinv, jbase, jc)
    tsq, tt4, tsb, td2 = tgrid._three_phase_p2(
        tfield, RES, 8, K2, 4, 4.0, tinv, tbase, tc)
    _eq("sub_q", tsq, jsq)
    _eq("top4", tt4, jt4)
    _eq("sub_base", tsb, jsb)
    assert int(td2["n_active_subcells"]) == int(jd2["n_active_subcells"])
    band_sz, n_bands, tsb_p = tgrid.p3_bands(tsb)
    jsb_p = jnp.asarray(tsb_p.numpy())
    for b in range(n_bands):
        rows = slice(b * band_sz, (b + 1) * band_sz)
        _eq(f"band {b}",
            tgrid.three_phase_p3_band(tfield, RES, 4, 4.0, tinv,
                                      tsb_p[rows], tc),
            jgrid.three_phase_p3_band(jfield, RES, 4, 4.0, jinv,
                                      jsb_p[rows], jc))
    # the packed head and the scan cells the marcher reads
    jh = jgrid.pack_sparse3_head(jcq, jt8, jsq, jt4, {**jd1, **jd2})
    th = tgrid.pack_sparse3_head(tcq, tt8, tsq, tt4, {**td1, **td2})
    for name, a, b in zip(("data", "ids", "dvec"), th, jh):
        _eq(name, a, b)
    tcells, tmarks = tgrid.sparse_scan_cells(tcq.numpy(), tt8.numpy(), RES)
    jcells, jmarks = jgrid.sparse_scan_cells(np.asarray(jcq),
                                             np.asarray(jt8), RES)
    _eq("scan cells", tcells, jcells)
    assert tmarks.sum() > 0


def test_eval_grid_three_phase_sparse_matches():
    jc, tc = jnp.asarray(C, jnp.float32), torch.tensor(C)
    out_j = jgrid.eval_grid_three_phase_sparse(
        jfield, RES, jnp.asarray(CALIB_INV), jc, budget_cells=128,
        budget_subcells=640)
    out_t = tgrid.eval_grid_three_phase_sparse(
        tfield, RES, torch.from_numpy(CALIB_INV), tc, budget_cells=128,
        budget_subcells=640)
    for name, a, b in zip(("corner_q", "top8", "sub_q", "top4", "refined"),
                          out_t[:5], out_j[:5]):
        _eq(name, a, b)
    assert int(out_t[5]["n_active"]) > 0


@pytest.mark.parametrize("algorithm", ["mc", "mt"])
def test_marching_matches_reference(algorithm, tmp_path):
    """The port's tables + native marcher give the reference's mesh on the
    same sparse field, one-shot and in slabs; its OBJ writer the same
    bytes."""
    from rgbd_pifuhd_tpu.recon.marching import (
        marching_tetrahedra_sparse3 as jmarch)
    from rgbd_pifuhd_tpu.recon.mesh import save_obj_with_color as jsave
    from rgbd_pifuhd_tpu_torch.recon.marching import (
        IncrementalMarcher3, marching_tetrahedra_sparse3)
    from rgbd_pifuhd_tpu_torch.recon.mesh import save_obj_with_color

    out = tgrid.eval_grid_three_phase_sparse(
        tfield, RES, torch.from_numpy(CALIB_INV), torch.tensor(C),
        budget_cells=128, budget_subcells=640)
    field = [np.ascontiguousarray(x.numpy()) for x in out[:5]]
    cells, _ = tgrid.sparse_scan_cells(field[0], field[1], RES)
    jv, jf = jmarch(*field, cells, RES, algorithm=algorithm)
    assert len(jv) > 100

    def same_mesh(name, v, f):
        # the native marcher runs threads: vertex order varies run to run
        # (in either package), the vertex set and triangles do not
        o, oj = np.lexsort(v.T), np.lexsort(jv.T)
        _eq(f"{name} verts", v[o], jv[oj])
        t, tj = v[f].reshape(-1, 9), jv[jf].reshape(-1, 9)
        _eq(f"{name} triangles", t[np.lexsort(t.T)], tj[np.lexsort(tj.T)])

    v, f = marching_tetrahedra_sparse3(*field, cells, RES,
                                       algorithm=algorithm)
    same_mesh("one-shot", v, f)
    half = len(cells) // 2
    with IncrementalMarcher3(*field, RES, algorithm=algorithm) as m:
        v1, f1 = m.step(cells[:half])
        v2, f2 = m.step(cells[half:])
    same_mesh("slabs", np.concatenate([v1, v2]), np.concatenate([f1, f2]))

    colors = (np.arange(len(v) * 3).reshape(-1, 3) % 255 / 255.0)
    save_obj_with_color(str(tmp_path / "port.obj"), v, f, colors)
    jsave(str(tmp_path / "jax.obj"), v, f, colors)
    assert (tmp_path / "port.obj").read_bytes() == \
        (tmp_path / "jax.obj").read_bytes()


# ------------------------------------------- two-level and dense evaluators
RES2 = 128      # 16^3 cells: budgets below n^3 take several query calls


@pytest.mark.parametrize("budget", [700, 1024, 4096])
def test_two_phase_sparse_byte_equal(budget):
    """Budgets round down to the 512-cell query chunk (700 -> 512) and
    cap at n^3 (4096: every cell, ties in the tail of the top-K)."""
    jc, tc = jnp.asarray(C, jnp.float32), torch.tensor(C)
    jo = jgrid.eval_grid_two_phase_sparse(
        jfield, RES2, jnp.asarray(CALIB_INV), jc, budget_cells=budget)
    to = tgrid.eval_grid_two_phase_sparse(
        tfield, RES2, torch.from_numpy(CALIB_INV), tc, budget_cells=budget)
    for name, a, b in zip(("corner_q", "top_idx", "refined"), to[:3],
                          jo[:3]):
        _eq(name, a, b)
    for k in ("kth_activity", "n_active", "budget_cells"):
        assert float(to[3][k]) == float(jo[3][k]), k
    assert int(to[3]["budget_cells"]) == min(budget // 512 * 512, 4096)
    assert len(np.unique(to[2].numpy())) > 4


def test_two_phase_dense_and_dense_equal():
    jc, tc = jnp.asarray(C, jnp.float32), torch.tensor(C)
    jinv, tinv = jnp.asarray(CALIB_INV), torch.from_numpy(CALIB_INV)
    jv, jd = jgrid.eval_grid_two_phase(jfield, RES, jinv, jc,
                                       budget_cells=200, cells_per_chunk=64)
    tv, td = tgrid.eval_grid_two_phase(tfield, RES, tinv, tc,
                                       budget_cells=200, cells_per_chunk=64)
    _eq("two-phase volume", tv, jv)
    assert int(td["n_active"]) == int(jd["n_active"])
    _eq("dense volume", tgrid.eval_grid_dense(tfield, RES, tinv, tc),
        jgrid.eval_grid_dense(jfield, RES, jinv, jc))


def test_densify_equal():
    """Host reassembly of both sparse results: the three-level oracle and
    the two-level native ``densify`` (dense, and limited to the scan
    marks' neighbourhood) against the JAX package's."""
    tinv, tc = torch.from_numpy(CALIB_INV), torch.tensor(C)
    out3 = [np.asarray(x) for x in tgrid.eval_grid_three_phase_sparse(
        tfield, RES, tinv, tc, budget_cells=128, budget_subcells=640)[:5]]
    _eq("densify3", tgrid.densify_sparse3_volume(*out3, RES),
        jgrid.densify_sparse3_volume(*out3, RES))
    corner, top, refined, _ = tgrid.eval_grid_two_phase_sparse(
        tfield, RES2, tinv, tc, budget_cells=1024)
    corner, top, refined = corner.numpy(), top.numpy(), refined.numpy()
    _eq("densify", tgrid.densify_sparse_volume(corner, top, refined, RES2),
        jgrid.densify_sparse_volume(corner, top, refined, RES2))
    _, marks = tgrid.sparse_scan_cells(corner, top, RES2)
    buf = np.full((RES2,) * 3, 7.0, np.float32)
    got = tgrid.densify_sparse_volume(corner, top, refined, RES2,
                                      scan_marks=marks, out=buf)
    assert got is buf
    _eq("densify marked", got, jgrid.densify_sparse_volume(
        corner, top, refined, RES2, scan_marks=marks))


@pytest.mark.parametrize("algorithm", ["mc", "mt"])
def test_dense_and_two_level_marching_match_reference(algorithm):
    """``marching_tetrahedra`` (dense, ``mt_run``) and
    ``marching_tetrahedra_sparse`` (two-level, ``mt_run_sparse``): the
    reference's mesh as vertex and triangle sets."""
    from rgbd_pifuhd_tpu.recon import marching as jm
    from rgbd_pifuhd_tpu_torch.recon import marching as tm

    def same(name, got, ref):
        (v, f), (jv, jf) = got, ref
        assert len(jv) > 100
        o, oj = np.lexsort(v.T), np.lexsort(jv.T)
        _eq(f"{name} verts", v[o], jv[oj])
        t, tj = v[f].reshape(-1, 9), jv[jf].reshape(-1, 9)
        _eq(f"{name} triangles", t[np.lexsort(t.T)], tj[np.lexsort(tj.T)])

    tinv, tc = torch.from_numpy(CALIB_INV), torch.tensor(C)
    vol = tgrid.eval_grid_dense(tfield, RES, tinv, tc).numpy()
    same("dense", tm.marching_tetrahedra(vol, algorithm=algorithm),
         jm.marching_tetrahedra(vol, algorithm=algorithm))
    corner, top, refined, _ = tgrid.eval_grid_two_phase_sparse(
        tfield, RES2, tinv, tc, budget_cells=1024)
    corner, top, refined = corner.numpy(), top.numpy(), refined.numpy()
    cells, _ = tgrid.sparse_scan_cells(corner, top, RES2)
    same("two-level", tm.marching_tetrahedra_sparse(
        corner, top, refined, cells, RES2, algorithm=algorithm),
        jm.marching_tetrahedra_sparse(corner, top, refined, cells, RES2,
                                      algorithm=algorithm))
