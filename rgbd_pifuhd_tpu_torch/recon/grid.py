"""Occupancy-grid evaluation on the device (port of ``recon/grid.py``):
the three-level octree (stride 8 -> 4 -> 1, the main path), the two-level
one (stride 8 -> 1) and the dense lattice, and the host reassembly of the
sparse results into dense volumes.

Chunking follows the JAX package exactly, because GroupNorm makes each
query call's point set part of the field's semantics:

- the stride-8 corner lattice (both octrees) pads the ``(n+1)^3`` corners
  to a multiple of 1024 by repeating the last corner (one query call);
- three-level phase 2 queries ``min(8192, K1)`` cells x 27 probes per
  call, padding with the last cell;
- three-level phase 3 queries bands of ``min(4096, K2)`` sub-cells x 64
  points, padding with the last sub-cell;
- two-level phase 2 queries ``min(512, n^3)`` cells x 512 points per call,
  its budget rounded down to a multiple of that chunk;
- the dense lattice queries one x-slab of ``res^2`` points per call.

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

# the budget diagnostics, in the order of pack_sparse3_head's vector
DIAG_KEYS = ("kth_activity", "n_active", "budget_cells", "kth_subactivity",
             "n_active_subcells", "budget_subcells")


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


def _corner_pass(query_fn, res, factor, K, calib_inv, *query_args):
    """Stride-``factor`` corner lattice -> ``(corner values, v_min,
    v_max, top-K cell ids, cell origins, diag)``."""
    n = res // factor
    n1 = n + 1
    corner_idx = torch.clamp(_lattice(n1, factor, calib_inv.device),
                             max=res - 1)
    n_corners = n1 ** 3
    n_pad = -(-n_corners // 1024) * 1024
    world = _idx_to_world(_pad_rows(corner_idx, n_pad), res, calib_inv)
    corner_vals = query_fn(world, *query_args)[:n_corners]
    st = _corner_stack(corner_vals.reshape(n1, n1, n1))
    v_min, v_max = st.amin(0), st.amax(0)
    activity = (v_max - v_min).reshape(-1)
    top_vals, top = _top_k(activity, K)
    diag = {"kth_activity": top_vals[-1],
            "n_active": (activity > _SKIP_THRESHOLD).sum(),
            "budget_cells": K}
    cell_base = torch.stack([top // (n * n), (top // n) % n, top % n],
                            dim=-1) * factor
    return corner_vals, v_min, v_max, top, cell_base, diag


def _three_phase_p1(query_fn, res, factor, K1, pack_bits, band_scale,
                    calib_inv, *query_args):
    """Stride-8 corner lattice -> active-cell ranking."""
    corner_vals, _, _, top8, cell_base, diag = _corner_pass(
        query_fn, res, factor, K1, calib_inv, *query_args)
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


def eval_grid_dense(query_fn, resolution, calib_inv, *query_args):
    """Every lattice point, one x-slab of ``res^2`` points per query call:
    ``[res, res, res]`` occupancy on the device."""
    res = resolution
    dev = calib_inv.device
    lin = torch.arange(res * res, device=dev)
    yz = torch.stack([lin // res, lin % res], dim=-1)
    vol = torch.empty((res, res * res), dtype=torch.float32, device=dev)
    for i in range(res):
        idx = torch.cat([torch.full_like(lin[:, None], i), yz], dim=-1)
        vol[i] = query_fn(_idx_to_world(idx, res, calib_inv), *query_args)
    return vol.reshape(res, res, res)


def _two_phase_budget(res: int, factor: int, budget_cells: int,
                      cells_per_chunk: int):
    """``(cells per query call, budget)``: the budget clamped to
    ``[chunk, n^3]`` and rounded down to a multiple of the chunk."""
    n3 = (res // factor) ** 3
    chunk = min(cells_per_chunk, n3)
    budget = min(max(budget_cells, chunk), n3)
    return chunk, (budget // chunk) * chunk


def _two_phase_refine(query_fn, res, factor, cell_base, chunk, calib_inv,
                      *query_args):
    """Dense ``factor^3`` blocks of the refined cells, ``chunk`` cells per
    query call: yields ``(points [chunk * f^3, 3], occupancy)``."""
    offsets = _lattice(factor, 1, cell_base.device)
    for i in range(cell_base.shape[0] // chunk):
        bases = cell_base[i * chunk:(i + 1) * chunk]
        pts = (bases[:, None, :] + offsets[None]).reshape(-1, 3)
        yield pts, query_fn(_idx_to_world(pts, res, calib_inv), *query_args)


def eval_grid_two_phase(query_fn, resolution, calib_inv, *query_args,
                        factor: int = 8, budget_cells: int = 49152,
                        cells_per_chunk: int = 512):
    """Two-level evaluation into a dense volume on the device: cells hold
    ``0.5 * (min + max)`` of their corners, the top ``budget_cells`` by
    corner disagreement are evaluated densely.  Returns ``(volume
    [res, res, res], diag)``."""
    res = resolution
    n = res // factor
    chunk, budget = _two_phase_budget(res, factor, budget_cells,
                                      cells_per_chunk)
    _, v_min, v_max, _, cell_base, diag = _corner_pass(
        query_fn, res, factor, budget, calib_inv, *query_args)
    fill = 0.5 * (v_min + v_max)
    vol = fill[:, None, :, None, :, None].expand(
        n, factor, n, factor, n, factor).reshape(-1).clone()
    for pts, occ in _two_phase_refine(query_fn, res, factor, cell_base,
                                      chunk, calib_inv, *query_args):
        vol[(pts[:, 0] * res + pts[:, 1]) * res + pts[:, 2]] = occ
    return vol.reshape(res, res, res), diag


def eval_grid_two_phase_sparse(query_fn, resolution, calib_inv, *query_args,
                               factor: int = 8, budget_cells: int = 12288,
                               cells_per_chunk: int = 512,
                               pack_bits: int = 4, band_scale: float = 4.0):
    """The two-level evaluation as a sparse result on the device:
    ``(corner_q [(n+1)^3] uint8, top_idx [K] int32, refined [K, f^3 / 2]
    uint8 (two 4-bit voxels a byte), diag)``, values band-quantised around
    the 0.5 level (``_quantize_band``)."""
    res = resolution
    chunk, budget = _two_phase_budget(res, factor, budget_cells,
                                      cells_per_chunk)
    corner_vals, _, _, top_idx, cell_base, diag = _corner_pass(
        query_fn, res, factor, budget, calib_inv, *query_args)
    refined = []
    for _, occ in _two_phase_refine(query_fn, res, factor, cell_base, chunk,
                                    calib_inv, *query_args):
        q = _quantize_band(occ.reshape(chunk, -1), band_scale, pack_bits)
        refined.append(_pack4(q) if pack_bits == 4 else q)
    return (_quantize_band(corner_vals, band_scale, pack_bits),
            top_idx.to(torch.int32), torch.cat(refined), diag)


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
        for k in DIAG_KEYS])
    return data, ids, dvec


def diag_from_dvec(dvec) -> dict:
    """The octree's budget diagnostics on the host, one dict for both
    octrees: ``dvec`` is ``pack_sparse3_head``'s vector read back, or a
    two-level phase's diag dict, which has no sub-cells (zeros)."""
    if isinstance(dvec, dict):
        dvec = [dvec.get(k, 0) for k in DIAG_KEYS]
    d = {k: (float if k.startswith("kth") else int)(v)
         for k, v in zip(DIAG_KEYS, dvec)}
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


def _unquantize(q, pack_bits: int = 4, band_scale: float = 4.0):
    levels = (1 << pack_bits) - 1
    return ((np.asarray(q).astype(np.float32) / levels - 0.5) / band_scale
            + 0.5)


def _unpack4(refined: np.ndarray) -> np.ndarray:
    """``[K, w]`` bytes -> ``[K, 2w]`` 4-bit values, low nibble first."""
    refined = np.asarray(refined)
    return np.stack([refined & 0x0F, refined >> 4],
                    axis=-1).reshape(refined.shape[0], -1)


def _fill8(corner_q, n: int, pack_bits: int, band_scale: float):
    """Per-cell fill ``0.5 * (min + max)`` of the dequantised corners."""
    c = _unquantize(corner_q, pack_bits, band_scale).reshape(
        n + 1, n + 1, n + 1)
    st = np.stack([c[dx:n + dx, dy:n + dy, dz:n + dz]
                   for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    return (0.5 * (st.min(axis=0) + st.max(axis=0))).astype(np.float32)


def densify_sparse3_volume(corner_q, top8_idx, sub_q, top4_idx, refined,
                           resolution: int, factor: int = 8,
                           pack_bits: int = 4,
                           band_scale: float = 4.0) -> np.ndarray:
    """Host reassembly of the three-level result into ``[res, res, res]``
    (a test oracle: the marcher reads the sparse arrays directly).  Fill
    rule at every level: ``0.5 * (min + max)`` of the corners."""
    res = resolution
    n = res // factor
    half = factor // 2
    fill8 = _fill8(corner_q, n, pack_bits, band_scale)
    vol = np.broadcast_to(fill8[:, None, :, None, :, None],
                          (n, factor, n, factor, n, factor)).reshape(
        res, res, res).copy()
    top8_idx = np.asarray(top8_idx)
    sub = _unquantize(sub_q, pack_bits, band_scale).reshape(-1, 3, 3, 3)
    st = np.stack([sub[:, dx:2 + dx, dy:2 + dy, dz:2 + dz]
                   for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    fill4 = (0.5 * (st.min(axis=0) + st.max(axis=0))).reshape(-1, 8)
    cbx, cby, cbz = top8_idx // (n * n), (top8_idx // n) % n, top8_idx % n
    v8 = vol.reshape(n, 2, half, n, 2, half, n, 2, half)
    for s in range(8):
        sx, sy, sz = (s >> 2) & 1, (s >> 1) & 1, s & 1
        v8[cbx, sx, :, cby, sy, :, cbz, sz, :] = \
            fill4[:, s][:, None, None, None]
    top4_idx = np.asarray(top4_idx)
    refined = np.asarray(refined)
    if pack_bits == 4:
        refined = _unpack4(refined)
    blocks = _unquantize(refined, pack_bits, band_scale).reshape(
        -1, half, half, half)
    k1, loc = top4_idx // 8, top4_idx % 8
    v8[cbx[k1], (loc >> 2) & 1, :, cby[k1], (loc >> 1) & 1, :,
       cbz[k1], loc & 1, :] = blocks
    return vol


def densify_sparse_volume(corner_vals, top_idx, refined, resolution: int,
                          factor: int = 8, pack_bits: int = 4,
                          band_scale: float = 4.0,
                          scan_marks: np.ndarray | None = None,
                          out: np.ndarray | None = None) -> np.ndarray:
    """Host reassembly of the two-level result into ``[res, res, res]`` f32
    by the native ``densify`` (``native/meshio.cc``).  With ``scan_marks``
    (``sparse_scan_cells``) only the marked cells and their 26 neighbours
    are written, which is all the masked marcher reads; the other voxels
    are left zero.  ``out``: a buffer to reuse across subjects."""
    import ctypes

    from ..native import load_meshio

    res = resolution
    n = res // factor
    fill = _fill8(corner_vals, n, pack_bits, band_scale)
    if scan_marks is None:
        dil = np.ones((n, n, n), dtype=bool)
    else:
        dil = scan_marks.copy()
        for ax in range(3):
            grown = dil.copy()
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(0, n - 1)
            hi[ax] = slice(1, n)
            grown[tuple(lo)] |= dil[tuple(hi)]
            grown[tuple(hi)] |= dil[tuple(lo)]
            dil = grown
    refined = np.asarray(refined)
    if pack_bits == 4:
        refined = _unpack4(refined)
    blocks = np.ascontiguousarray(_unquantize(refined, pack_bits,
                                              band_scale))
    vol = out if out is not None else np.empty((res, res, res), np.float32)
    top = np.ascontiguousarray(np.asarray(top_idx), dtype=np.int32)
    marks = np.ascontiguousarray(dil.astype(np.uint8))
    fp = ctypes.POINTER(ctypes.c_float)
    load_meshio().densify(
        vol.ctypes.data_as(fp), ctypes.c_int64(res),
        np.ascontiguousarray(fill).ctypes.data_as(fp),
        marks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int(factor),
        top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(top)), blocks.ctypes.data_as(fp), 0)
    return vol
