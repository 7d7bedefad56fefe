"""Mesh reconstruction (port of ``recon/pipeline.py``): ``gen_mesh`` (every
``use_color``), the two-slot multi-subject ``gen_mesh_many``, and
``CoarseReconstructor`` (the coarse model alone).

encode (normal nets + both hourglass encoders) -> field evaluation on the
device (``opt.octree_levels`` 3: stride 8 -> 4 -> 1, the main path; 2:
stride 8 -> 1; ``use_octree=False``: every lattice point) -> pull (4-bit
sparse, or the dense f32 volume) -> native marching -> vertex colours ->
OBJ (streamed) or binary PLY, and the montage PNG (input and predicted
normal maps) beside the mesh.  With ``opt.streamed_recon`` (default) the
three-level octree dispatches phase 3 in bands and marches them as they
land (``recon/streamed.py``).  Every octree evaluation runs in one budget
loop (``_budgeted``): an overflowing budget is right-sized and the
evaluation dispatched again.

``color_plan`` reads ``use_color`` (with ``opt.normal_mode``) once a mesh
into what the stages do.  ``use_color`` 0: the field's normals by
``opt.normal_mode``: ``fd`` (four field taps a vertex), ``grad`` (the
negative gradient of the fine field, one query and its backward a vertex,
through ``models.coarse.query_mlp``'s autograd function) or ``mesh``
(geometric vertex normals on the host: no device colour pass, so it leaves
the streamed path).  1: the subject image's colours, in the subject's
world (``calib_world``), one-shot as in the JAX package; 2: those with
largest-component cleanup and back-colour inpainting.  3: PIFu's texture
field (``models.texture``, the reconstructor's ``netC``): its filter runs
on the global image after the encoders, is attached to netG's last stack
once a request, and every vertex is coloured through one fused query a
65,536-vertex chunk, in the blocks the fd pass takes; counters
``color_points`` / ``color_calls``, host seconds ``tex_encode`` /
``tex_dispatch``.  The texture pass runs on the main device, unsharded.

Every field query makes two kernel calls: the coarse level through
``ops.fused_query.fused_gather_mlp`` (it owes ``phi``), the fine level
through the same kernel, or through ``ops.fused_mlp.fused_point_mlp`` when
its MLP is norm-free (``models.coarse.query_mlp``).  Host transfers use
pinned buffers and one CUDA event per transfer (``recon/landing.py``), so
the host marches and writes while the device computes.

With a device ``mesh`` (``parallel``) every field query is sharded over
its point axis and every colour pass over the 65,536-vertex chunk, one
call per shard on the shard's device (``parallel.shard_arg_axis``): fd
normals take GroupNorm's statistics over the shard's four taps, grad
normals differentiate the shard's own sum, as the JAX package's
``shard_map`` does.  ``query_calls`` counts one call a shard.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..models.multires import MultiResPIFu
from ..native import load_meshio
from ..ops import geometry as geom
from ..parallel import replicate, shard_arg_axis, shard_points_query
from ..parallel.mesh import canonical
from ..utils.device import resolve_device
from ..utils.options import Options
from ..utils.png import write_png
from . import grid as grid_mod
from .landing import ColorJob, Landed, to_host
from .marching import (marching_tetrahedra, marching_tetrahedra_sparse,
                       marching_tetrahedra_sparse3)
from .mesh import (compute_vertex_normals, format_faces_block,
                   keep_largest_component, save_ply_with_color)
from .streamed import reconstruct_streamed


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _quantize_colors(vals: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on the device (half to even, as ``jnp.round``)."""
    return torch.round(
        torch.clamp(vals * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


def _dequantize_verts(vq: torch.Tensor, lo: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """uint16 bbox fixed point (held as int32) -> world f32."""
    return vq.float() * scale[None, :] + lo[None, :]


def _normalized(nml: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(nml, dim=-1, keepdim=True)
    return nml / torch.clamp(norm, min=1e-8)


@dataclass(frozen=True)
class ColorPlan:
    """What a mesh's colours ask of the stages (``color_plan``)."""

    # per-vertex colours: "fd" or "grad" normals of the field, "texture"
    # (netC's map encoded), "image" samples (in the subject's world), or
    # "mesh": the mesh's own normals, on the host
    colors: str
    streams: bool       # a three-level octree marches bands as they land
    cleanup: bool       # largest component + back-colour inpainting, from
                        # the projected vertices the device pulls


def color_plan(use_color: int, normal_mode: str) -> ColorPlan:
    """The one reading of ``use_color`` and ``normal_mode``: 0 the field's
    normals by ``normal_mode``, 1 image colours, 2 image colours with
    cleanup, 3 PIFu's texture field."""
    if use_color not in (0, 1, 2, 3):
        raise ValueError(f"unknown use_color {use_color}")
    colors = {0: normal_mode, 3: "texture"}.get(use_color, "image")
    return ColorPlan(colors, streams=colors not in ("image", "mesh"),
                     cleanup=use_color == 2)


class Reconstructor:
    """Two-level mesh reconstruction on one device, or sharded over a
    device ``mesh`` of the same device type (the model copied once to each
    of its devices).  ``sharded_query`` wraps the field query instead of
    the mesh's ``shard_points_query``.  The model is frozen
    (``requires_grad_(False)``): the ``grad`` normals differentiate the
    field with respect to the points only."""

    _COLOR_CHUNK = 65536

    def __init__(self, model: MultiResPIFu, opt: Options, device=None,
                 sharded_query=None, mesh=None, netC=None):
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device.type != self.device.type:
            raise ValueError(f"model is on {p.device}, reconstructor on "
                             f"{self.device}")
        self.model = model.eval().requires_grad_(False)
        self.netC = None if netC is None else \
            netC.eval().requires_grad_(False)
        self.opt = opt
        self.mesh = mesh
        self._replicas: dict = {}
        self._normals, self._img_colors = self._normals_one, \
            self._img_colors_one
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a mesh of {mesh.device_type} devices for "
                                 f"a reconstructor on {self.device}")
            self._replicas = dict(zip(mesh.local_devices,
                                      replicate(mesh, self.model)))
            if sharded_query is None:
                sharded_query = lambda q: shard_points_query(q, mesh)  # noqa: E731
            self._normals = shard_arg_axis(self._normals_one, mesh, 0)
            self._img_colors = shard_arg_axis(self._img_colors_one, mesh, 0)
        self._query = sharded_query(self._query_one) if sharded_query \
            else self._query_one
        self._vol_cache: dict[int, np.ndarray] = {}
        self.last_grid_diag: dict | None = None
        self._esc_budgets: dict[int, dict] = {}
        self.query_calls = 0            # of the newest mesh
        self.total_query_calls = 0      # since construction
        self.points_queried: dict[str, int] = {}
        self.color_points = 0           # vertices the texture field coloured
        self.color_calls = 0            # its fused queries (65,536 rows each)
        self.host_secs: dict[str, float] = {}
        self._phase = "field"

    @contextlib.contextmanager
    def timed(self, name: str, sink: dict | None = None):
        """Accumulate host seconds spent in ``name`` into ``sink``
        (default ``host_secs``)."""
        sink = self.host_secs if sink is None else sink
        t = time.perf_counter()
        try:
            yield
        finally:
            sink[name] = sink.get(name, 0.0) + time.perf_counter() - t

    # ------------------------------------------------------------- query
    def _count(self, n_points: int) -> None:
        self.query_calls += 1
        self.total_query_calls += 1
        self.points_queried[self._phase] = (
            self.points_queried.get(self._phase, 0) + n_points)

    def _model_at(self, device):
        """The model's copy on ``device`` (a mesh's), else the model."""
        return self._replicas.get(canonical(device), self.model)

    def _query_one(self, world_pts, l_feats, g_feats, calib):
        """[M, 3] world points -> [M] fine occupancy (B1 = B2 = 1)."""
        self._count(world_pts.shape[0])
        out = self._model_at(world_pts.device).query(
            l_feats, g_feats, world_pts[None, None], calib[None, None],
            calib[None])
        return out.preds[0, :, 0]

    def encode(self, img_local: torch.Tensor, img_global: torch.Tensor):
        """img_local ``[B2, H, W, C]`` windows, img_global ``[1, Hg, Wg, C]``."""
        g_feats = self.model.filter_global(img_global, last_only=True)
        l_feats = self.model.filter_local(img_local[None], g_feats,
                                          last_only=True)
        return l_feats, g_feats

    def _field_last(self, pts, feats, calib):
        """``[M, 3]`` points -> the fine field of the last stacks, ``[M]``."""
        l_feats, g_feats = feats
        return self._model_at(pts.device).field_last(
            l_feats, g_feats, pts[None, None], calib[None, None],
            calib[None])[0, :, 0]

    def _calc_normal(self, verts, feats, calib):
        """``[M, 3]`` points -> fd unit normals ``[M, 3]``."""
        l_feats, g_feats = feats
        return self._model_at(verts.device).calc_normal(
            l_feats, g_feats, verts[None, None], calib[None, None],
            calib[None])[0]

    def _montage_start(self, data: dict, feats):
        """Queue the montage strip — the global image's RGB and the
        predicted normal maps side by side, quantised to uint8 on the
        device — and its copy to the host; returns ``(host, landed)``."""
        _, g_feats = feats
        panels = [self._tensor(data["img_512"])[0][..., :3]]
        panels += [m[0].float() for m in (g_feats.nml_front,
                                          g_feats.nml_back) if m is not None]
        return to_host(_quantize_colors(torch.cat(panels, dim=1)))

    @staticmethod
    def _write_montage(montage, save_path: str) -> None:
        """The montage PNG beside the mesh (``<mesh stem>.png``)."""
        host, landed = montage
        landed.wait()
        write_png(save_path[:-4] + ".png", host.numpy())

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device, dtype)

    # -------------------------------------------------------------- field
    def budgets(self, res: int):
        """(cells, sub-cells) budgets: escalated ones if this resolution
        escalated before, else the options'."""
        n = res // 8
        esc = self._esc_budgets.setdefault(res, {})
        budget = esc.get("cells") or min(self.opt.num_refine_cells, n ** 3)
        sub = esc.get("subcells") or min(self.opt.num_refine_subcells,
                                         budget * 8)
        return budget, sub

    def escalate(self, res: int, d: dict, budget: int, sub_budget: int):
        """Right-size the budgets to the measured active counts (+5%,
        chunk-quantum rounded; the two-level octree has no sub-cells);
        returns the new pair or None when nothing overflowed."""
        n3 = (res // 8) ** 3
        grew = False
        if d["overflow_cells"] > 0 and budget < n3:
            budget = min(_round_up(int(d["n_active"] * 1.05), 4096), n3)
            grew = True
        cap = budget * 8
        if d["overflow_subcells"] > 0 and sub_budget < cap:
            sub_budget = min(_round_up(int(d["n_active_subcells"] * 1.05),
                                       8192), cap)
            grew = True
        if not grew:
            return None
        subs = (f", sub-cells {d['budget_subcells']}->{sub_budget}"
                if d["budget_subcells"] else "")
        print(f"[recon] escalating refinement budget: cells "
              f"{d['budget_cells']}->{budget}{subs} (active: "
              f"{d['n_active']} cells, {d['n_active_subcells']} sub-cells)")
        self._esc_budgets[res].update(cells=budget, subcells=sub_budget)
        return budget, sub_budget

    def _check_budget(self, d: dict) -> None:
        self.last_grid_diag = d
        if d["overflow_cells"] > 0:
            warnings.warn(f"refinement budget overflow: {d['n_active']} "
                          f"active cells > budget {d['budget_cells']}",
                          RuntimeWarning, stacklevel=3)
        if d["overflow_subcells"] > 0:
            warnings.warn(f"sub-cell refinement budget overflow: "
                          f"{d['n_active_subcells']} active sub-cells > "
                          f"budget {d['budget_subcells']}", RuntimeWarning,
                          stacklevel=3)

    def _budgeted(self, res: int, attempt):
        """The octree budget loop: ``attempt(cells, sub_cells)`` dispatches
        an evaluation at the budgets and returns ``(result, diagnostics)``
        (``grid.diag_from_dvec``); while a budget overflows (and
        ``opt.auto_escalate_budget``), ``escalate`` right-sizes it and the
        evaluation runs again.  Returns the last result."""
        budget, sub_budget = self.budgets(res)
        while True:
            out, d = attempt(budget, sub_budget)
            grown = self.escalate(res, d, budget, sub_budget) \
                if self.opt.auto_escalate_budget else None
            if grown is None:
                break
            budget, sub_budget = grown
        self._check_budget(d)
        return out

    def evaluate_field(self, l_feats, g_feats, calib: torch.Tensor,
                       resolution: int):
        """One-shot octree evaluation in the budget loop; returns the host
        arrays that feed ``extract_mesh``: ``(corner_q, top8, sub_q, top4,
        refined, scan_cells)`` for the three-level octree
        (``opt.octree_levels == 3`` and ``resolution % 8 == 0``), else the
        two-level (stride 8 -> 1) ``(corner_q, top_idx, refined,
        scan_cells)``."""
        res = resolution
        calib_inv = torch.linalg.inv_ex(calib)[0]
        args = (self._query, res, calib_inv, l_feats, g_feats, calib)
        self._phase = "field"
        if self.opt.octree_levels != 3 or res % 8:
            def two_level(budget, _):
                *out, diag = grid_mod.eval_grid_two_phase_sparse(
                    *args, factor=8, budget_cells=budget)
                return out, grid_mod.diag_from_dvec(diag)

            corner, top, refined = self._budgeted(res, two_level)
            corner, top = corner.cpu().numpy(), top.cpu().numpy()
            cells, _ = grid_mod.sparse_scan_cells(corner, top, res)
            return corner, top, np.ascontiguousarray(refined.cpu().numpy()), \
                cells

        def three_level(budget, sub_budget):
            corner, top8, sub_q, top4, refined, diag = \
                grid_mod.eval_grid_three_phase_sparse(
                    *args, budget_cells=budget, budget_subcells=sub_budget)
            data, ids, dvec = grid_mod.pack_sparse3_head(
                corner, top8, sub_q, top4, diag)
            return (data, ids, refined), \
                grid_mod.diag_from_dvec(dvec.cpu().numpy())

        data, ids, refined = self._budgeted(res, three_level)
        n1 = res // 8 + 1
        K1 = self.last_grid_diag["budget_cells"]
        data, ids = data.cpu().numpy(), ids.cpu().numpy()
        corner_h = data[:n1 ** 3]
        sub_q_h = data[n1 ** 3:].reshape(K1, 27)
        top8_h, top4_h = ids[:K1], ids[K1:]
        cells, _ = grid_mod.sparse_scan_cells(corner_h, top8_h, res)
        return (corner_h, top8_h, sub_q_h, top4_h,
                np.ascontiguousarray(refined.cpu().numpy()), cells)

    @staticmethod
    def extract_mesh(field, resolution: int, thresh: float = 0.5,
                     algorithm: str = "mt"):
        """Host marching of ``evaluate_field``'s arrays, by their arity (6:
        three-level, 4: two-level): index-space verts and faces."""
        if len(field) == 6:
            return marching_tetrahedra_sparse3(*field, resolution,
                                               threshold=thresh,
                                               algorithm=algorithm)
        return marching_tetrahedra_sparse(*field, resolution,
                                          threshold=thresh,
                                          algorithm=algorithm)

    def occupancy_volume(self, l_feats, g_feats, calib: torch.Tensor,
                         resolution: int, use_octree: bool = True,
                         budget_cells: int | None = None,
                         sparse_transfer: bool = True):
        """The ``[res, res, res]`` occupancy volume on the host and the
        scan cells (or None).  ``use_octree``: the two-level evaluation,
        pulled sparse and densified on the host (a buffer reused per
        resolution: consume it before the next call), or densified on the
        device (``sparse_transfer=False``); else every lattice point
        (``eval_grid_dense``).  The dense pull lands in a pinned buffer;
        host seconds go to ``field`` (until the device is done) and
        ``pull``."""
        res = resolution
        calib_inv = torch.linalg.inv_ex(calib)[0]
        self._phase = "field"
        if use_octree:
            budget = budget_cells or min(self.opt.num_refine_cells,
                                         (res // 8) ** 3)
            if sparse_transfer:
                corner, top, refined, diag = \
                    grid_mod.eval_grid_two_phase_sparse(
                        self._query, res, calib_inv, l_feats, g_feats, calib,
                        factor=8, budget_cells=budget)
                self._check_budget(grid_mod.diag_from_dvec(diag))
                corner, top = corner.cpu().numpy(), top.cpu().numpy()
                cells, marks = grid_mod.sparse_scan_cells(corner, top, res)
                if res not in self._vol_cache:
                    self._vol_cache[res] = np.empty((res,) * 3, np.float32)
                vol = grid_mod.densify_sparse_volume(
                    corner, top, refined.cpu().numpy(), res, scan_marks=marks,
                    out=self._vol_cache[res])
                return vol, cells
            vol, diag = grid_mod.eval_grid_two_phase(
                self._query, res, calib_inv, l_feats, g_feats, calib,
                factor=8, budget_cells=budget)
            self._check_budget(grid_mod.diag_from_dvec(diag))
        else:
            with self.timed("field"):
                vol = grid_mod.eval_grid_dense(self._query, res, calib_inv,
                                               l_feats, g_feats, calib)
                Landed(vol.device).wait()
            self.last_grid_diag = None
        with self.timed("pull"):
            host, landed = to_host(vol)
            landed.wait()
        return host.numpy(), None

    # ------------------------------------------------------------- world
    @staticmethod
    def _grid_to_world_mat(calib, res: int) -> np.ndarray:
        mat = grid_mod.create_grid_transform(res)
        return np.linalg.inv(np.asarray(calib, np.float64)) @ mat

    @staticmethod
    def _transform_pts(verts_idx: np.ndarray, trans_mat: np.ndarray):
        src = np.ascontiguousarray(verts_idx, np.float32)
        out = np.empty_like(src)
        if len(src):
            m = np.ascontiguousarray(trans_mat[:3, :4], np.float64)
            fp = ctypes.POINTER(ctypes.c_float)
            load_meshio().transform_affine(
                src.ctypes.data_as(fp), ctypes.c_int64(len(src)),
                m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                out.ctypes.data_as(fp), 0)
        return out

    @classmethod
    def _to_world(cls, verts_idx, faces, calib, res: int):
        trans_mat = cls._grid_to_world_mat(calib, res)
        verts = cls._transform_pts(verts_idx, trans_mat)
        if np.linalg.det(trans_mat[:3, :3]) < 0.0:
            faces = faces[:, ::-1]
        return verts, faces

    # ------------------------------------------------------------ colours
    @staticmethod
    def _quantize_u16(verts: np.ndarray, rows_padded: int):
        """[V, 3] -> ([rows_padded, 3] u16 bbox fixed point, lo, scale);
        rows past V stay zero (they dequantise to ``lo``)."""
        V = len(verts)
        vq = np.zeros((rows_padded, 3), np.uint16)
        lo = np.zeros(3, np.float32)
        scale = np.ones(3, np.float32)
        if V:
            src = np.ascontiguousarray(verts, np.float32)
            fp = ctypes.POINTER(ctypes.c_float)
            load_meshio().bbox_quantize_u16(
                src.ctypes.data_as(fp), ctypes.c_int64(V),
                lo.ctypes.data_as(fp), scale.ctypes.data_as(fp),
                vq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 0)
        return vq, lo, scale

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device through a pinned buffer (non-blocking)."""
        host = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _grad_normals(self, verts, feats, calib):
        """Unit negative gradient of the field at ``verts [M, 3]``: one
        query call over the chunk and its backward (GroupNorm pools over
        the chunk, as in the JAX package's ``jax.grad``)."""
        with torch.inference_mode(False), torch.enable_grad():
            pts = verts.clone().requires_grad_()
            (g,) = torch.autograd.grad(
                self._field_last(pts, feats, calib).sum(), pts)
        return _normalized(-g)

    def _normals_one(self, verts, feats, calib):
        """uint8 normal colours of ``verts [M, 3]``: fd (one query call of
        4 taps a vertex) or grad (one query call and its backward), by
        ``opt.normal_mode``."""
        grad = color_plan(0, self.opt.normal_mode).colors == "grad"
        self._count(len(verts) if grad else 4 * len(verts))
        nml = (self._grad_normals(verts, feats, calib) if grad
               else self._calc_normal(verts, feats, calib))
        return _quantize_colors(nml)

    def _chunk_dispatch(self, vq: np.ndarray, lo, scale, color_one):
        """Queue the colours of u16-quantised verts ``vq [k * 65536, 3]``,
        one 65536-vertex chunk at a time: ``color_one(verts [65536, 3])``
        gives a chunk's uint8 colours (``_color_fn``); returns the
        ``ColorJob`` part."""
        chunk = self._COLOR_CHUNK
        vq_d = self._upload(vq.view(np.int16)).to(torch.int32) & 0xFFFF
        lo_d, scale_d = self._upload(lo), self._upload(scale)
        self._phase = "color"
        cols = [color_one(_dequantize_verts(vq_d[j * chunk:(j + 1) * chunk],
                                            lo_d, scale_d))
                for j in range(len(vq) // chunk)]
        return to_host(torch.cat(cols))

    def dispatch_block(self, block: np.ndarray, k: int, color_one):
        """Colour a block of world verts on its own bbox, padded to ``k``
        chunks (the streamed path's per-group dispatch)."""
        vq, lo, scale = self._quantize_u16(block, k * self._COLOR_CHUNK)
        return self._chunk_dispatch(vq, lo, scale, color_one)

    def _color_fn(self, plan: ColorPlan, data: dict, feats, calib, tex):
        """A chunk's colour function for ``plan.colors``: the field's
        normals or the subject image's samples (both sharded over the
        mesh), the texture field's colours from the map ``tex``, or None
        for the mesh's own normals."""
        if plan.colors == "texture":
            return lambda verts: self._tex_colors_one(verts, tex, calib)
        if plan.colors == "image":
            image = self._tensor(data["img"])[0]
            return lambda verts: self._img_colors(verts, image, calib)
        if plan.colors == "mesh":
            return None
        return lambda verts: self._normals(verts, feats, calib)

    def _chunked_parts(self, color_one, verts: np.ndarray) -> list:
        """Quantise all verts on the mesh bbox, pad to K chunks (a multiple
        of 4 above 4) and colour them with ``color_one`` in up to 4 groups
        (``_chunk_dispatch``), each landing in its own pinned buffer: the
        ``ColorJob`` parts."""
        V = len(verts)
        if V == 0:
            return []
        chunk = self._COLOR_CHUNK
        K = max(1, -(-V // chunk))
        if K > 4:
            K = -(-K // 4) * 4
        vq, lo, scale = self._quantize_u16(verts, K * chunk)
        rows = (K // 4 if K > 4 else K) * chunk
        return [self._chunk_dispatch(vq[s:s + rows], lo, scale, color_one)
                for s in range(0, K * chunk, rows)]

    def color_by_normals_start(self, verts: np.ndarray, feats,
                               calib: torch.Tensor) -> ColorJob:
        """Dispatch normal colouring (fd or grad) of all verts."""
        parts = self._chunked_parts(
            lambda v: self._normals(v, feats, calib), verts)
        return ColorJob(parts, len(verts), None)

    def _colors_start(self, plan: ColorPlan, data: dict, feats, calib, tex,
                      verts: np.ndarray, faces: np.ndarray) -> ColorJob:
        """Dispatch the colours of a marched mesh (``_chunked_parts``) and,
        for the cleanup, the copy of its projected vertices; the mesh's own
        normals are left to whoever first reads the job."""
        color_one = self._color_fn(plan, data, feats, calib, tex)
        if color_one is None:
            return ColorJob(lambda: compute_vertex_normals(verts, faces)
                            * 0.5 + 0.5, len(verts), None)
        parts = self._chunked_parts(color_one, verts)
        xyz = None
        if plan.cleanup:
            xyz = to_host(geom.orthogonal(
                self._upload(np.asarray(verts, np.float32))[None],
                calib[None])[0])
        return ColorJob(parts, len(verts), xyz)

    def encode_texture(self, img_global: torch.Tensor, g_feats):
        """netC's filter on the global image's RGB, attached to netG's last
        stack: the ``[h, w, C]`` map the colour queries gather from."""
        if self.netC is None:
            raise ValueError("texture colours need a texture network "
                             "(netC) in the checkpoint")
        return self.netC.attach(self.netC.filter(img_global[..., :3]),
                                g_feats.im_feats[-1])

    def _tex_colors_one(self, verts, tex, calib):
        """uint8 colours of ``verts [M, 3]`` from the texture field: one
        fused query over the chunk (its host side in
        ``host_secs["tex_dispatch"]``)."""
        with self.timed("tex_dispatch"):
            self.color_calls += 1
            return _quantize_colors(self.netC.query(tex, verts, calib))

    @staticmethod
    def _img_colors_one(verts, image, calib):
        """uint8 colours of ``verts [M, 3]``: project, sample the RGB
        channels of ``image [H, W, C]`` bilinearly, quantise."""
        xyz = geom.orthogonal(verts[None], calib[None])
        return _quantize_colors(
            geom.index(image[None], xyz[..., :2])[0][:, :3])

    # -------------------------------------------------------------- export
    @staticmethod
    def _write_obj_streamed(save_path: str, verts: np.ndarray, job,
                            faces_blob) -> None:
        """Vertex lines of colour group g are written while group g+1 is
        still computing; the preformatted face block goes last (and is
        freed here)."""
        lib, buf, ln = faces_blob
        h = lib.obj_open(save_path.encode())
        if not h:
            lib.meshio_free(buf)
            raise OSError(f"cannot open {save_path}")
        vsrc = np.ascontiguousarray(verts, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        ok = True
        try:
            for r0, cols in job.groups():
                c = np.ascontiguousarray(cols, np.float32)
                ok &= lib.obj_append_verts(
                    h, vsrc[r0:].ctypes.data_as(fp), c.ctypes.data_as(fp),
                    ctypes.c_int64(len(c))) == 0
        finally:
            rc = lib.obj_finish(h, buf if ok else None, ln if ok else 0)
            lib.meshio_free(buf)
        if not ok or rc != 0:
            raise OSError(f"OBJ write to {save_path} failed")

    def _export_mesh(self, save_path, verts, faces, job, faces_blob=None):
        """Binary PLY, or the streamed OBJ.  ``job`` is the colour job;
        ``faces_blob`` the preformatted OBJ face block."""
        if save_path.endswith(".ply"):
            save_ply_with_color(save_path, verts, faces, job())
        else:
            self._write_obj_streamed(save_path, verts, job, faces_blob)

    def _host_stage(self, stage, data: dict, save_path: str,
                    sink: dict | None) -> dict:
        """The host tail of a mesh (``gen_mesh_many`` runs it on its
        worker): image colours' world mapping and cleanup, then face
        formatting and the montage while the device computes the colours,
        then the export as they land."""
        verts, faces, montage, job, plan = stage
        if plan.colors == "image":
            with self.timed("finish_host", sink):
                verts, faces, job = self._image_tail(verts, faces, job, data,
                                                     plan.cleanup)
        t0 = time.time()
        faces_blob = None
        if not save_path.endswith(".ply"):
            with self.timed("faces", sink):
                faces_blob = format_faces_block(faces)
        with self.timed("montage", sink):
            self._write_montage(montage, save_path)
        t1 = time.time()
        with self.timed("mesh_write", sink):
            self._export_mesh(save_path, verts, faces, job, faces_blob)
        return {"verts": verts, "faces": faces,
                "finish_phases": {"faces_and_montage": round(t1 - t0, 4),
                                  "color_and_write": round(time.time() - t1,
                                                           4)}}

    @staticmethod
    def _image_tail(verts, faces, job: ColorJob, data: dict, cleanup: bool):
        """Image colours in the subject's world (``calib_world``), as the
        JAX package writes them; ``cleanup`` keeps the largest connected
        component and inpaints back-facing colours from the silhouette
        boundary.  Returns ``(verts, faces, colour job)``."""
        if data.get("calib_world") is not None:
            cw_inv = np.linalg.inv(np.asarray(data["calib_world"],
                                              np.float64))
            verts = verts @ cw_inv[:3, :3].T + cw_inv[:3, 3]
        if cleanup:
            verts, faces, packed = keep_largest_component(
                verts, faces, np.concatenate([job(), job.projected()], 1))
            colors = estimate_back_colors(packed[:, :3], packed[:, 3:6])
            job = ColorJob(lambda: colors, len(verts), None)
        return verts, faces, job

    # --------------------------------------------------------- reconstruct
    def _calibs(self, data):
        calib_np = np.asarray(
            data["calib"].cpu() if isinstance(data["calib"], torch.Tensor)
            else data["calib"], np.float32)
        return self._tensor(calib_np), calib_np

    def _begin(self) -> None:
        self.query_calls = 0
        self.points_queried = {}
        self.color_points = self.color_calls = 0
        self.host_secs = {}

    def _counters(self) -> dict:
        return dict(points_queried=dict(self.points_queried),
                    query_calls=self.query_calls,
                    color_points=self.color_points,
                    color_calls=self.color_calls,
                    host_secs={k: round(v, 4)
                               for k, v in self.host_secs.items()})

    def _encode_subject(self, data: dict, plan: ColorPlan):
        """``(calib, its host copy, feats, montage, texture map or
        None)``; the montage strip is queued right behind the encoders,
        ahead of the field evaluation, so its copy has long landed when the
        host writes it; the texture map (texture colours) right after
        it."""
        calib, calib_np = self._calibs(data)
        with self.timed("encode"):
            img_g = self._tensor(data["img_512"])
            feats = self.encode(self._tensor(data["img"]), img_g)
            montage = self._montage_start(data, feats)
        tex = None
        if plan.colors == "texture":
            with self.timed("tex_encode"):
                tex = self.encode_texture(img_g, feats[1])
        return calib, calib_np, feats, montage, tex

    def _march(self, feats, calib, calib_np, res: int, use_octree: bool):
        """Field evaluation and marching in one shot: the octree field
        (``evaluate_field``, ``extract_mesh``) or the dense volume
        (``occupancy_volume``, ``marching_tetrahedra``); world verts,
        faces."""
        algo = self.opt.marching_algo
        if use_octree:
            field = self.evaluate_field(feats[0], feats[1], calib, res)
            with self.timed("march"):
                verts_idx, faces = self.extract_mesh(field, res,
                                                     algorithm=algo)
        else:
            vol, _ = self.occupancy_volume(feats[0], feats[1], calib, res,
                                           use_octree=False)
            with self.timed("march"):
                verts_idx, faces = marching_tetrahedra(vol, algorithm=algo)
        if len(verts_idx) == 0:
            raise RuntimeError("marching produced an empty mesh")
        return self._to_world(verts_idx, faces, calib_np, res)

    def _device_stage(self, data: dict, res: int, use_octree: bool,
                      use_color: int):
        """Everything of a mesh that launches kernels (and the marching
        between the launches), in the autograd context its colours need:
        ``(verts, faces, montage, colour job, plan)``.  A three-level
        octree streams its bands and colours as it marches where the plan
        allows."""
        plan = color_plan(use_color, self.opt.normal_mode)
        # grad normals' backward cannot save inference tensors (features
        # made under inference_mode), so they take no_grad
        with (torch.no_grad() if plan.colors == "grad"
              else torch.inference_mode()):
            calib, calib_np, feats, montage, tex = self._encode_subject(
                data, plan)
            if (use_octree and plan.streams and self.opt.octree_levels == 3
                    and res % 8 == 0 and self.opt.streamed_recon):
                verts, faces, job = reconstruct_streamed(
                    self, res, calib, calib_np, feats,
                    self._color_fn(plan, data, feats, calib, tex))
                if len(verts) == 0:
                    raise RuntimeError("marching produced an empty mesh")
            else:
                verts, faces = self._march(feats, calib, calib_np, res,
                                           use_octree)
                job = self._colors_start(plan, data, feats, calib, tex,
                                         verts, faces)
        if plan.colors == "texture":
            self.color_points += len(verts)
        return verts, faces, montage, job, plan

    # ------------------------------------------------------------ gen_mesh
    def gen_mesh(self, data: dict, save_path: str, resolution=None,
                 use_octree=None, use_color: int = 0) -> dict:
        """Mesh of one subject, written as OBJ or PLY, coloured as
        ``use_color`` says (``color_plan``).

        ``data``: ``img [B2, H, W, 6]`` local windows, ``img_512
        [1, h, w, 6]`` global image, ``calib [4, 4]`` (NumPy or tensors;
        image colours map to ``calib_world`` when it is given).  Returns
        verts, faces, secs, grid_diag, a ``phases`` breakdown and the
        counters.
        """
        t0 = time.time()
        res = resolution or self.opt.resolution
        self._begin()
        if use_octree is None:
            use_octree = self.opt.use_octree
        stage = self._device_stage(data, res, use_octree, use_color)
        t1 = time.time()
        out = self._host_stage(stage, data, save_path, None)
        t2 = time.time()
        out.update(secs=t2 - t0, grid_diag=self.last_grid_diag,
                   phases={"reconstruct": round(t1 - t0, 4),
                           "color_save": round(t2 - t1, 4)},
                   **self._counters())
        return out

    def gen_mesh_many(self, items, save_paths, use_color: int = 0,
                      resolution: int | None = None,
                      pipeline: bool | None = None) -> list[dict]:
        """Two-slot subject pipeline: subject i's host tail (waiting for
        its colours to land, world mapping and cleanup of image colours,
        face formatting, mesh and montage write) runs on a worker thread
        while subject i+1's device stage (encode, field evaluation,
        marching, colour dispatch) proceeds on the main thread.

        Every kernel launch stays on the main thread and on one stream, in
        the order of the sequential loop; the worker only waits on CUDA
        events and does host work.  So the meshes are those of one
        ``gen_mesh`` call per subject, whatever the timing.  Returns result
        dicts in input order.

        ``pipeline=None`` takes the worker when the host has more than one
        core, else the sequential loop.  ``items`` may be any iterable (a
        generator keeps two subjects in memory); ``save_paths`` a parallel
        iterable of paths or a callable ``data -> path``.  The field is the
        octree's whatever ``opt.use_octree`` says, as in the JAX package.
        """
        res = resolution or self.opt.resolution
        if callable(save_paths):
            pairs = ((d, save_paths(d)) for d in items)
        else:
            pairs = zip(items, save_paths)
        if pipeline is None:
            try:
                n_cores = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                n_cores = os.cpu_count() or 1
            pipeline = n_cores > 1
        if not pipeline:
            return [self.gen_mesh(d, p, res, use_color=use_color)
                    for d, p in pairs]

        def host_stage(stage, data, save_path, t0, diag, counters):
            sink: dict = {}
            out = self._host_stage(stage, data, save_path, sink)
            counters["host_secs"].update(
                {k: round(v, 4) for k, v in sink.items()})
            out.update(secs=time.time() - t0, grid_diag=diag, **counters)
            return out

        results = []
        pending = None
        with ThreadPoolExecutor(max_workers=1) as ex:
            for data, save_path in pairs:
                t0 = time.time()
                self._begin()
                stage = self._device_stage(data, res, True, use_color)
                if pending is not None:
                    results.append(pending.result())
                pending = ex.submit(host_stage, stage, data, save_path, t0,
                                    self.last_grid_diag, self._counters())
            if pending is not None:
                results.append(pending.result())
        return results


def estimate_back_colors(colors: np.ndarray, xyz: np.ndarray,
                         k: int = 10, band: float = 1e-3) -> np.ndarray:
    """Back-face colour inpainting.

    Every vertex with projected z < 0 (back-facing) receives the average
    colour of up to ``k`` nearest-in-y boundary vertices (0 <= z < band) on
    its left (x' < x) and right (x' >= x) sides.  The boundary set is
    y-sorted once and each chunk of back vertices queries only a y-window
    of candidates, so peak temporaries are O(chunk * window).  Boundary
    vertices are ordered by their coordinates (and colour), so a vertex's
    colour does not depend on the order of the vertex array; where no two
    boundary vertices tie, the result is the JAX package's.

    A window is accepted per row and side only when it provably contains
    the k nearest same-side candidates — at least k valid candidates and
    the k-th nearest closer in y than both unclamped window edges; failing
    rows escalate to a 4x window (up to the full boundary set), so the
    result equals the dense computation.
    """
    colors = colors.copy()
    back = np.nonzero(xyz[:, 2] < 0)[0]
    boundary = np.nonzero((xyz[:, 2] >= 0) & (xyz[:, 2] < band))[0]
    if len(back) == 0 or len(boundary) == 0:
        return colors
    # y first, then x, z and the colour: the window's contents, and so
    # which of several equally near candidates argpartition keeps, follow
    # from the vertices themselves and not from the marcher's vertex order
    bxyz, bcol = xyz[boundary], colors[boundary]
    order = np.lexsort((bcol[:, 2], bcol[:, 1], bcol[:, 0], bxyz[:, 2],
                        bxyz[:, 0], bxyz[:, 1]))
    boundary = boundary[order]
    bx = np.ascontiguousarray(xyz[boundary, 0])
    by = np.ascontiguousarray(xyz[boundary, 1])
    bc = colors[boundary].astype(np.float64)
    M = len(boundary)

    def side_avg(px, py, window, rows=None):
        """(sum, cnt, exact) of up-to-k nearest-in-y per side for one
        window size.  px/py: [n]; returns arrays over the n rows."""
        n = len(px)
        W = min(window, M)
        pos = np.searchsorted(by, py)
        lo = np.clip(pos - W // 2, 0, M - W)                  # [n]
        cols = lo[:, None] + np.arange(W)[None, :]            # [n, W]
        wy = by[cols]
        wx = bx[cols]
        dy = np.abs(wy - py[:, None])                         # [n, W]
        # y-distance this window is sure to cover: the nearer of the edges
        # that are not clamped at the array boundary
        edge_lo = np.where(lo > 0, dy[:, 0], np.inf)
        edge_hi = np.where(lo + W < M, dy[:, -1], np.inf)
        safe = np.minimum(edge_lo, edge_hi)                   # [n]
        out_sum = np.zeros((n, 3))
        out_cnt = np.zeros((n,), np.int64)
        exact = np.zeros((n,), bool)
        for left in (True, False):
            m = (wx < px[:, None]) if left else (wx >= px[:, None])
            d = np.where(m, dy, np.inf)
            kk = min(k, W)
            nearest = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            nd = np.take_along_axis(d, nearest, axis=1)       # [n, kk]
            valid = nd < np.inf
            cnt = valid.sum(axis=1)
            kth = np.where(cnt > 0, nd.max(axis=1, initial=0.0,
                                           where=valid), 0.0)
            col = bc[np.take_along_axis(cols, nearest, axis=1)]
            out_sum += (col * valid[..., None]).sum(axis=1)
            out_cnt += cnt
            ok = (W >= M) | ((cnt >= kk) & (kth <= safe))
            exact = ok if left else (exact & ok)
        if rows is None:
            rows = np.arange(n)
        return rows, out_sum, out_cnt, exact

    chunk = 4096
    for s in range(0, len(back), chunk):
        ids = back[s:s + chunk]
        px = np.ascontiguousarray(xyz[ids, 0])
        py = np.ascontiguousarray(xyz[ids, 1])
        rows, acc, cnt, exact = side_avg(px, py, window=8 * k)
        W = 8 * k
        while not exact.all() and W < M:
            W *= 4
            redo = np.nonzero(~exact)[0]
            r2, s2, c2, e2 = side_avg(px[redo], py[redo], W, rows=redo)
            acc[redo], cnt[redo], exact[redo] = s2, c2, e2 | (W >= M)
        ok = cnt > 0
        colors[ids[ok]] = (acc[ok] / cnt[ok, None]).astype(colors.dtype)
    return colors


class CoarseReconstructor(Reconstructor):
    """Single-level reconstruction from the coarse model alone (port of the
    JAX package's ``CoarseReconstructor``): one RGB-D image (``img_512``;
    ``img`` is ignored) -> ``CoarsePIFu`` -> grid -> mesh, on the
    two-level machinery with the fine level absent.  ``model`` is a
    ``CoarsePIFu``."""

    def encode(self, img_local, img_global):
        return None, self.model.filter(img_global, last_only=True)

    def _query_one(self, world_pts, l_feats, g_feats, calib):
        """[M, 3] world points -> [M] occupancy of the last stack."""
        self._count(world_pts.shape[0])
        return self._model_at(world_pts.device).query(
            g_feats, world_pts[None], calib[None]).preds[-1, 0, :, 0]

    def _field_last(self, pts, feats, calib):
        return self._model_at(pts.device).field_last(
            feats[1], pts[None], calib[None])[0, :, 0]

    def _calc_normal(self, verts, feats, calib):
        return self._model_at(verts.device).calc_normal(
            feats[1], verts[None], calib[None])[0]
