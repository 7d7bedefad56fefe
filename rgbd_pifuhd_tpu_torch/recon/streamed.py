"""Band-streamed reconstruction (port of ``Reconstructor._reconstruct_
streamed``, ``recon/pipeline.py:678-918``).

Phases 1 and 2 run on the device; the head (corner and stride-4 lattices,
ids, budget diagnostics) is queued for the host first, then phase 3 is
queued in bands of 4096 sub-cells, each followed by a non-blocking copy
into its rows of one pinned ``refined`` buffer and a CUDA event.  While the
device works through the bands, the host scans the head for surface cells
and marches every cell whose data (its own and its 26 neighbours'
sub-cells) has landed, dispatching its colours (fd or grad normals, or the
texture field) per 4 x 65536 vertices as it goes.  The native session's
global edge dedup makes the result the one-shot mesh up to vertex order.
The budgets are ``Reconstructor._budgeted``'s: a head that overflows them
is dispatched again.
"""

from __future__ import annotations

import numpy as np
import torch

from . import grid as grid_mod
from .landing import ColorJob, Landed
from .marching import IncrementalMarcher3


def _dispatch(recon, res, budget, sub_budget, calib_inv, feats, calib):
    """Queue phases 1-2 at the budgets, the head's copy to the host, then
    every phase-3 band and its copy into one pinned buffer.  Returns
    ``(head_host, head_landed, refined_host, landed, band_sz, K1, K2)``."""
    l_feats, g_feats = feats
    K1 = min(budget, (res // 8) ** 3)
    K2 = min(sub_budget, K1 * 8)
    dev = recon.device
    pin = dev.type == "cuda"
    recon._phase = "p1"
    corner_q, top8, cell_base, d1 = grid_mod._three_phase_p1(
        recon._query, res, 8, K1, 4, 4.0, calib_inv, l_feats, g_feats, calib)
    recon._phase = "p2"
    sub_q, top4, sub_base, d2 = grid_mod._three_phase_p2(
        recon._query, res, 8, K2, 4, 4.0, calib_inv, cell_base, l_feats,
        g_feats, calib)
    head_dev = grid_mod.pack_sparse3_head(corner_q, top8, sub_q, top4,
                                          {**d1, **d2})
    head_host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                 for t in head_dev]
    for h, t in zip(head_host, head_dev):
        h.copy_(t, non_blocking=True)
    head_landed = Landed(dev)

    band_sz, n_bands, sub_base_p = grid_mod.p3_bands(sub_base)
    refined_host = torch.empty((n_bands * band_sz, 32), dtype=torch.uint8,
                               pin_memory=pin)
    landed = []
    recon._phase = "p3"
    for b in range(n_bands):
        rows = slice(b * band_sz, (b + 1) * band_sz)
        band = grid_mod.three_phase_p3_band(
            recon._query, res, 4, 4.0, calib_inv, sub_base_p[rows], l_feats,
            g_feats, calib)
        refined_host[rows].copy_(band, non_blocking=True)
        landed.append(Landed(dev))
    return head_host, head_landed, refined_host, landed, band_sz, K1, K2


def _march_order(cells, top8_h, top4_h, n, K1, K2, band_sz, n_bands):
    """Sort scan cells by the last band they need: a cell's own sub-cells'
    band, dilated over its 26 neighbours (the marcher reads their blocks for
    shared boundary values).  Returns ``(cells_sorted, ready_sorted,
    group_end)``; cells of group b are ready once band b has landed."""
    sub_band = (np.arange(K2) // band_sz).astype(np.int32)
    cell_band = np.full(K1, -1, np.int32)
    np.maximum.at(cell_band, top4_h // 8, sub_band)
    vol = np.full(n ** 3, -1, np.int32)
    vol[top8_h] = cell_band
    vol3 = vol.reshape(n, n, n)
    padv = np.pad(vol3, 1, constant_values=-1)
    ready3 = vol3.copy()
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                ready3 = np.maximum(ready3,
                                    padv[dx:dx + n, dy:dy + n, dz:dz + n])
    ci = cells // 8
    cell_ready = ready3[ci[:, 0], ci[:, 1], ci[:, 2]]
    order = np.argsort(cell_ready, kind="stable")
    ready_sorted = cell_ready[order]
    return (cells[order], ready_sorted,
            np.searchsorted(ready_sorted, np.arange(n_bands), side="right"))


def reconstruct_streamed(recon, res: int, calib: torch.Tensor,
                         calib_np: np.ndarray, feats, color_one):
    """``calib`` on the device, ``calib_np`` its host copy (reading the
    device copy back would wait for the queued bands).  ``color_one``
    colours a 65536-vertex chunk (``recon._color_fn``).  Returns ``(verts,
    faces, colour job)``."""
    factor = 8
    n = res // factor
    calib_inv = torch.linalg.inv_ex(calib)[0]

    def attempt(budget, sub_budget):
        with recon.timed("field_dispatch"):
            out = _dispatch(recon, res, budget, sub_budget, calib_inv, feats,
                            calib)
        with recon.timed("wait_head"):
            out[1].wait()
        return out, grid_mod.diag_from_dvec(out[0][2].numpy())

    head_host, _, refined_host, landed, band_sz, K1, K2 = recon._budgeted(
        res, attempt)
    n_bands = len(landed)

    # ---- host scan while the bands compute
    with recon.timed("scan"):
        head, ids = head_host[0].numpy(), head_host[1].numpy()
        n_corner = (n + 1) ** 3
        corner_h = head[:n_corner]
        sub_q_h = head[n_corner:].reshape(K1, 27)
        top8_h, top4_h = ids[:K1], ids[K1:]
        cells, _ = grid_mod.sparse_scan_cells(corner_h, top8_h, res,
                                              factor=factor)
        cells_sorted, ready_sorted, group_end = _march_order(
            cells, top8_h, top4_h, n, K1, K2, band_sz, n_bands)

    # ---- march groups as their bands land; colour per 4 x 65536 verts
    refined_np = refined_host.numpy()[:K2]
    trans_mat = recon._grid_to_world_mat(calib_np, res)
    flip = np.linalg.det(trans_mat[:3, :3]) < 0.0
    chunk = recon._COLOR_CHUNK
    group_rows = 4 * chunk
    parts, vparts, fparts, pending = [], [], [], []
    n_pending = 0

    def take_group() -> np.ndarray:
        nonlocal n_pending
        out, got = [], 0
        while got < group_rows:
            a = pending[0]
            need = group_rows - got
            if len(a) <= need:
                out.append(pending.pop(0))
                got += len(a)
            else:
                out.append(a[:need])
                pending[0] = a[need:]
                got += need
        n_pending -= group_rows
        return out[0] if len(out) == 1 else np.concatenate(out)

    def march_range(marcher, lo_i: int, hi_i: int):
        nonlocal n_pending
        if hi_i <= lo_i:
            return
        with recon.timed("march"):
            vi, fc = marcher.step(cells_sorted[lo_i:hi_i])
            if len(fc):
                fparts.append(fc[:, ::-1] if flip else fc)
            if len(vi):
                vw = recon._transform_pts(vi, trans_mat)
                vparts.append(vw)
                pending.append(vw)
                n_pending += len(vw)
        while n_pending >= group_rows:
            with recon.timed("color_dispatch"):
                parts.append(recon.dispatch_block(take_group(), 4, color_one))

    with IncrementalMarcher3(corner_h, top8_h, sub_q_h, top4_h, refined_np,
                             res, algorithm=recon.opt.marching_algo) as m:
        done_i = int(np.searchsorted(ready_sorted, 0, side="left"))
        march_range(m, 0, done_i)
        for b in range(n_bands):
            with recon.timed("wait_bands"):
                landed[b].wait()
            march_range(m, done_i, int(group_end[b]))
            done_i = int(group_end[b])
        recon.note_march(m.stats())
    if n_pending:
        tail = pending[0] if len(pending) == 1 else np.concatenate(pending)
        with recon.timed("color_dispatch"):
            parts.append(recon.dispatch_block(tail, -(-n_pending // chunk),
                                              color_one))
    verts = np.concatenate(vparts) if vparts \
        else np.zeros((0, 3), np.float32)
    faces = np.concatenate(fparts) if fparts else np.zeros((0, 3), np.int32)
    return verts, faces, ColorJob(parts, len(verts), None)
