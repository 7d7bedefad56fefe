"""Three-level octree field evaluation on the device (port of the
three-phase part of ``recon/grid.py``: stride 8 -> 4 -> 1).

Chunking follows the JAX package exactly, because GroupNorm makes each
query call's point set part of the field's semantics:

- phase 1 pads the ``(n+1)^3`` corners to a multiple of 1024 by repeating
  the last corner (one query call);
- phase 2 queries ``min(8192, K1)`` cells x 27 probes per call, padding
  with the last cell;
- phase 3 queries bands of ``min(4096, K2)`` sub-cells x 64 points,
  padding with the last sub-cell.

Top-K ranking uses a stable descending sort, so ties keep the lower index
first as ``lax.top_k`` does (after budget escalation, zero-activity cells
fill the tail of every top-K).  Lattice index ``i`` maps to NDC
``i * 2/res - 1`` and world = ``calib_inv @ [ndc, 1]``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_SKIP_THRESHOLD = 0.05

QueryFn = Callable[..., torch.Tensor]


def create_grid_transform(resolution: int, b_min=(-1.0, -1.0, -1.0),
                          b_max=(1.0, 1.0, 1.0)) -> np.ndarray:
    """4x4 index -> box affine."""
    b_min = np.asarray(b_min, np.float64)
    b_max = np.asarray(b_max, np.float64)
    mat = np.eye(4)
    for a in range(3):
        mat[a, a] = (b_max[a] - b_min[a]) / resolution
    mat[:3, 3] = b_min
    return mat


def _idx_to_world(idx_xyz: torch.Tensor, resolution: int,
                  calib_inv: torch.Tensor) -> torch.Tensor:
    ndc = idx_xyz.float() * (2.0 / resolution) - 1.0
    rot = calib_inv[:3, :3].float()
    trans = calib_inv[:3, 3].float()
    return ndc @ rot.t() + trans


def _quantize_band(occ: torch.Tensor, band_scale: float = 4.0,
                   pack_bits: int = 4) -> torch.Tensor:
    levels = (1 << pack_bits) - 1
    band = torch.clamp((occ - 0.5) * band_scale + 0.5, 0.0, 1.0)
    return torch.round(band * levels).to(torch.uint8)


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """[B, 2k] uint8 nibbles -> [B, k]: two voxels per byte, low first."""
    q = q.reshape(q.shape[0], -1, 2)
    return q[:, :, 0] | (q[:, :, 1] << 4)


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _lattice(n: int, step: int, device) -> torch.Tensor:
    """[n^3, 3] int64 offsets ``step * (i, j, k)``, ij-indexed."""
    ii = torch.arange(n, device=device) * step
    gx, gy, gz = torch.meshgrid(ii, ii, ii, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad to ``rows`` by repeating the last row."""
    if rows == x.shape[0]:
        return x
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], -1)], dim=0)


def _corner_stack(c: torch.Tensor) -> torch.Tensor:
    """[..., m+1, m+1, m+1] -> [8, ..., m, m, m] cell-corner values."""
    return torch.stack([
        c[..., :-1, :-1, :-1], c[..., :-1, :-1, 1:],
        c[..., :-1, 1:, :-1], c[..., :-1, 1:, 1:],
        c[..., 1:, :-1, :-1], c[..., 1:, :-1, 1:],
        c[..., 1:, 1:, :-1], c[..., 1:, 1:, 1:]], dim=0)


def _three_phase_p1(query_fn, res, factor, K1, pack_bits, band_scale,
                    calib_inv, *query_args):
    """Stride-8 corner lattice -> active-cell ranking."""
    n = res // factor
    n1 = n + 1
    dev = calib_inv.device
    corner_idx = torch.clamp(_lattice(n1, factor, dev), max=res - 1)
    n_corners = n1 ** 3
    n_pad = -(-n_corners // 1024) * 1024
    world = _idx_to_world(_pad_rows(corner_idx, n_pad), res, calib_inv)
    corner_vals = query_fn(world, *query_args)[:n_corners]
    st = _corner_stack(corner_vals.reshape(n1, n1, n1))
    activity = (st.amax(0) - st.amin(0)).reshape(-1)
    top_vals, top8 = _top_k(activity, K1)
    diag = {"kth_activity": top_vals[-1],
            "n_active": (activity > _SKIP_THRESHOLD).sum(),
            "budget_cells": K1}
    cell_base = torch.stack([top8 // (n * n), (top8 // n) % n, top8 % n],
                            dim=-1) * factor
    return (_quantize_band(corner_vals, band_scale, pack_bits), top8,
            cell_base, diag)


def _three_phase_p2(query_fn, res, factor, K2, pack_bits, band_scale,
                    calib_inv, cell_base, *query_args):
    """Stride-4 lattice inside active cells -> sub-cell ranking."""
    K1 = cell_base.shape[0]
    half = factor // 2
    sub_offsets = _lattice(3, half, cell_base.device)            # [27, 3]
    chunk = min(8192, K1)
    n_chunks = -(-K1 // chunk)
    cell_base_p = _pad_rows(cell_base, n_chunks * chunk)
    vals = []
    for i in range(n_chunks):
        bases = cell_base_p[i * chunk:(i + 1) * chunk]
        pts = torch.clamp((bases[:, None, :] + sub_offsets[None])
                          .reshape(-1, 3), max=res - 1)
        vals.append(query_fn(_idx_to_world(pts, res, calib_inv),
                             *query_args).reshape(chunk, 27))
    sub_vals = torch.cat(vals)[:K1]
    st = _corner_stack(sub_vals.reshape(K1, 3, 3, 3))
    sub_act = (st.amax(0) - st.amin(0)).reshape(-1)   # k1*8 + (sx<<2|sy<<1|sz)
    sub_top_vals, top4 = _top_k(sub_act, K2)
    diag = {"kth_subactivity": sub_top_vals[-1],
            "n_active_subcells": (sub_act > _SKIP_THRESHOLD).sum(),
            "budget_subcells": K2}
    loc = top4 % 8
    sub_base = cell_base[top4 // 8] + torch.stack(
        [(loc >> 2) & 1, (loc >> 1) & 1, loc & 1], dim=-1) * half
    return (_quantize_band(sub_vals, band_scale, pack_bits), top4,
            sub_base, diag)


def three_phase_p3_band(query_fn, res, pack_bits, band_scale, calib_inv,
                        bases, *query_args):
    """One band of the dense 4^3 evaluation: ``bases [B, 3]`` ->
    packed ``[B, 32]`` uint8 (two 4-bit voxels per byte)."""
    fine_offsets = _lattice(4, 1, bases.device)                    # [64, 3]
    B = bases.shape[0]
    pts = (bases[:, None, :] + fine_offsets[None]).reshape(-1, 3)
    occ = query_fn(_idx_to_world(pts, res, calib_inv),
                   *query_args).reshape(B, 64)
    q = _quantize_band(occ, band_scale, pack_bits)
    return _pack4(q) if pack_bits == 4 else q


def p3_bands(sub_base: torch.Tensor):
    """Band layout of phase 3: ``(band_sz, n_bands, padded sub_base)``."""
    K2 = sub_base.shape[0]
    band_sz = min(4096, K2)
    n_bands = -(-K2 // band_sz)
    return band_sz, n_bands, _pad_rows(sub_base, n_bands * band_sz)


def eval_grid_three_phase_sparse(query_fn, resolution, calib_inv,
                                 *query_args, factor: int = 8,
                                 budget_cells: int = 12288,
                                 budget_subcells: int = 49152,
                                 pack_bits: int = 4,
                                 band_scale: float = 4.0):
    """All three phases; returns ``(corner_q, top8, sub_q, top4, refined,
    diag)`` on the device (refined ``[K2, 32]`` uint8)."""
    if factor != 8:
        raise ValueError("three-phase evaluation assumes factor=8")
    res = resolution
    n = res // factor
    K1 = min(budget_cells, n ** 3)
    K2 = min(budget_subcells, K1 * 8)
    corner_q, top8, cell_base, d1 = _three_phase_p1(
        query_fn, res, factor, K1, pack_bits, band_scale, calib_inv,
        *query_args)
    sub_q, top4, sub_base, d2 = _three_phase_p2(
        query_fn, res, factor, K2, pack_bits, band_scale, calib_inv,
        cell_base, *query_args)
    band_sz, n_bands, sub_base_p = p3_bands(sub_base)
    refined = torch.cat([
        three_phase_p3_band(query_fn, res, pack_bits, band_scale, calib_inv,
                            sub_base_p[b * band_sz:(b + 1) * band_sz],
                            *query_args)
        for b in range(n_bands)])[:K2]
    return corner_q, top8, sub_q, top4, refined, {**d1, **d2}


def pack_sparse3_head(corner_q, top8, sub_q, top4, diag):
    """Scan inputs + escalation diagnostics as three device arrays:
    uint8 (corner ++ sub lattice), int32 (top8 ++ top4), f32 [6] diag."""
    data = torch.cat([corner_q.reshape(-1), sub_q.reshape(-1)])
    ids = torch.cat([top8.to(torch.int32), top4.to(torch.int32)])
    dev = corner_q.device
    # python numbers become device fills: a host->device copy from
    # pageable memory would wait for the whole queue
    dvec = torch.stack([
        diag[k].float() if isinstance(diag[k], torch.Tensor)
        else torch.full((), float(diag[k]), device=dev)
        for k in ("kth_activity", "n_active", "budget_cells",
                  "kth_subactivity", "n_active_subcells", "budget_subcells")])
    return data, ids, dvec


def diag_from_dvec(dvec: np.ndarray) -> dict:
    d = {"kth_activity": float(dvec[0]), "n_active": int(dvec[1]),
         "budget_cells": int(dvec[2]), "kth_subactivity": float(dvec[3]),
         "n_active_subcells": int(dvec[4]), "budget_subcells": int(dvec[5])}
    d["overflow_cells"] = max(0, d["n_active"] - d["budget_cells"])
    d["overflow_subcells"] = max(
        0, d["n_active_subcells"] - d["budget_subcells"])
    return d


def sparse_scan_cells(corner_vals, top_idx, resolution: int,
                      factor: int = 8, pack_bits: int = 4,
                      band_scale: float = 4.0):
    """Surface-candidate cells from the sparse result alone (host NumPy):
    refined top-K cells + cells whose 8 coarse corners disagree in sign +
    cells whose fill sign differs from a face neighbour's.  Returns
    ``(origins [K', 3] int32 voxel origins, marks [n, n, n] bool)``."""
    res = resolution
    n = res // factor
    n1 = n + 1
    levels = (1 << pack_bits) - 1
    c = ((np.asarray(corner_vals).astype(np.float32) / levels - 0.5)
         / band_scale + 0.5).reshape(n1, n1, n1)
    corners8 = [c[dx:n + dx, dy:n + dy, dz:n + dz]
                for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    s = [q > 0.5 for q in corners8]
    all_in = np.logical_and.reduce(s)
    all_out = np.logical_and.reduce([~q for q in s])
    marks = ~(all_in | all_out)
    v_min = np.minimum.reduce(corners8)
    v_max = np.maximum.reduce(corners8)
    fsign = (0.5 * (v_min + v_max)) > 0.5
    for ax in range(3):
        d = np.diff(fsign, axis=ax) != 0
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, n - 1)
        hi[ax] = slice(1, n)
        marks[tuple(lo)] |= d
        marks[tuple(hi)] |= d
    marks.reshape(-1)[np.asarray(top_idx)] = True
    origins = np.argwhere(marks).astype(np.int32) * factor
    return origins, marks
