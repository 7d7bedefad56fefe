"""Single-subject mesh reconstruction (port of ``recon/pipeline.py``'s main
path, ``Reconstructor.gen_mesh``).

encode (normal nets + both hourglass encoders) -> three-level octree field
evaluation on the device -> 4-bit sparse pull -> native marching ->
fd-normal vertex colours on the device -> streamed OBJ write.  With
``opt.streamed_recon`` (default) phase 3 is dispatched in bands and marched
as they land (``recon/streamed.py``).

Every field query — all octree phases and the four fd taps of the
colouring — goes through ``ops.fused_query.fused_gather_mlp`` twice
(coarse level, fine level).  Host transfers use pinned buffers and one
CUDA event per transfer, so the host marches and writes while the device
computes.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import warnings

import numpy as np
import torch

from ..models.multires import MultiResPIFu
from ..native import load_meshio
from ..utils.device import resolve_device
from ..utils.options import Options
from . import grid as grid_mod
from .marching import marching_tetrahedra_sparse3
from .mesh import format_faces_block


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


class _Landed:
    """Completion marker of work queued on the current stream (a CUDA
    event; on the CPU the work is already done)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record()

    def wait(self) -> None:
        if self._ev is not None:
            self._ev.synchronize()


def _to_host(t: torch.Tensor):
    """Queue a non-blocking copy into a pinned host buffer; returns the
    host tensor and its completion marker."""
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    host.copy_(t, non_blocking=True)
    return host, _Landed(t.device)


class _ColorJob:
    """In-flight fd-normal colouring: ``parts`` are ``(host uint8 [rows, 3],
    landed)`` per dispatched group, in row order.  ``groups()`` yields
    ``(row0, colors f32 [n, 3])`` as each group lands; ``job()`` returns
    all ``[V, 3]`` colours."""

    def __init__(self, parts, V: int):
        self._parts, self._V = parts, V

    def groups(self):
        row = 0
        for host, landed in self._parts:
            landed.wait()
            a = host.numpy().reshape(-1, 3)
            n = min(len(a), self._V - row)
            if n <= 0:
                break
            out = a[:n].astype(np.float32)
            out *= np.float32(1.0 / 255.0)
            yield row, out
            row += n

    def __call__(self) -> np.ndarray:
        cols = [c for _, c in self.groups()]
        if not cols:
            return np.zeros((0, 3), np.float32)
        return cols[0] if len(cols) == 1 else np.concatenate(cols)


class Reconstructor:
    """Two-level mesh reconstruction on one device."""

    _COLOR_CHUNK = 65536

    def __init__(self, model: MultiResPIFu, opt: Options, device=None):
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device.type != self.device.type:
            raise ValueError(f"model is on {p.device}, reconstructor on "
                             f"{self.device}")
        self.model = model.eval()
        self.opt = opt
        self.last_grid_diag: dict | None = None
        self._esc_budgets: dict[int, dict] = {}
        self.query_calls = 0
        self.points_queried: dict[str, int] = {}
        self.host_secs: dict[str, float] = {}
        self._phase = "field"

    @contextlib.contextmanager
    def timed(self, name: str):
        """Accumulate host seconds spent in ``name`` (``host_secs``)."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host_secs[name] = (self.host_secs.get(name, 0.0)
                                    + time.perf_counter() - t)

    # ------------------------------------------------------------- query
    def _count(self, n_points: int) -> None:
        self.query_calls += 1
        self.points_queried[self._phase] = (
            self.points_queried.get(self._phase, 0) + n_points)

    def _query(self, world_pts, l_feats, g_feats, calib):
        """[M, 3] world points -> [M] fine occupancy (B1 = B2 = 1)."""
        self._count(world_pts.shape[0])
        out = self.model.query(l_feats, g_feats, world_pts[None, None],
                               calib[None, None], calib[None])
        return out.preds[0, :, 0]

    def encode(self, img_local: torch.Tensor, img_global: torch.Tensor):
        """img_local ``[B2, H, W, C]`` windows, img_global ``[1, Hg, Wg, C]``."""
        g_feats = self.model.filter_global(img_global, last_only=True)
        l_feats = self.model.filter_local(img_local[None], g_feats,
                                          last_only=True)
        return l_feats, g_feats

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
        budget = esc.get("cells") or min(
            getattr(self.opt, "num_refine_cells", 12288), n ** 3)
        sub = esc.get("subcells") or min(
            getattr(self.opt, "num_refine_subcells", 32768), budget * 8)
        return budget, sub

    def escalate(self, res: int, d: dict, budget: int, sub_budget: int):
        """Right-size the budgets to the measured active counts (+5%,
        chunk-quantum rounded); returns the new pair or None when nothing
        overflowed."""
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
        print(f"[recon] escalating refinement budget: cells "
              f"{d['budget_cells']}->{budget}, sub-cells "
              f"{d['budget_subcells']}->{sub_budget} (active: "
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

    def evaluate_field(self, l_feats, g_feats, calib: torch.Tensor,
                       resolution: int):
        """One-shot three-level evaluation (stride 8 -> 4 -> 1) with budget
        auto-escalation; returns the host arrays ``(corner_q, top8, sub_q,
        top4, refined, scan_cells)`` that feed the marcher."""
        res = resolution
        if getattr(self.opt, "octree_levels", 3) != 3 or res % 8:
            raise ValueError("only the three-level octree (octree_levels=3, "
                             "resolution % 8 == 0) is ported")
        calib_inv = torch.linalg.inv_ex(calib)[0]
        budget, sub_budget = self.budgets(res)
        auto = getattr(self.opt, "auto_escalate_budget", True)
        while True:
            self._phase = "field"
            corner, top8, sub_q, top4, refined, diag = \
                grid_mod.eval_grid_three_phase_sparse(
                    self._query, res, calib_inv, l_feats, g_feats, calib,
                    budget_cells=budget, budget_subcells=sub_budget)
            data, ids, dvec = grid_mod.pack_sparse3_head(
                corner, top8, sub_q, top4, diag)
            d = grid_mod.diag_from_dvec(dvec.cpu().numpy())
            grown = self.escalate(res, d, budget, sub_budget) if auto \
                else None
            if grown is None:
                break
            budget, sub_budget = grown
        self._check_budget(d)
        n1 = res // 8 + 1
        K1 = d["budget_cells"]
        data, ids = data.cpu().numpy(), ids.cpu().numpy()
        corner_h = data[:n1 ** 3]
        sub_q_h = data[n1 ** 3:].reshape(K1, 27)
        top8_h, top4_h = ids[:K1], ids[K1:]
        cells, _ = grid_mod.sparse_scan_cells(corner_h, top8_h, res)
        return (corner_h, top8_h, sub_q_h, top4_h,
                np.ascontiguousarray(refined.cpu().numpy()), cells)

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

    def _normals_dispatch(self, vq: np.ndarray, lo, scale, feats, calib):
        """Queue fd-normal colours of u16-quantised verts ``vq [k * 65536,
        3]`` (one query call per 65536-vertex chunk, 4 taps each); returns
        the ``_ColorJob`` part."""
        chunk = self._COLOR_CHUNK
        l_feats, g_feats = feats
        vq_d = self._upload(vq.view(np.int16)).to(torch.int32) & 0xFFFF
        lo_d, scale_d = self._upload(lo), self._upload(scale)
        cols = []
        for j in range(len(vq) // chunk):
            verts = _dequantize_verts(vq_d[j * chunk:(j + 1) * chunk],
                                      lo_d, scale_d)
            self._phase = "color"
            self._count(4 * chunk)
            nml = self.model.calc_normal(l_feats, g_feats,
                                         verts[None, None],
                                         calib[None, None], calib[None])
            cols.append(_quantize_colors(nml[0]))
        return _to_host(torch.cat(cols))

    def dispatch_block(self, block: np.ndarray, k: int, feats, calib):
        """Colour a block of world verts on its own bbox, padded to ``k``
        chunks (the streamed path's per-group dispatch)."""
        vq, lo, scale = self._quantize_u16(block, k * self._COLOR_CHUNK)
        return self._normals_dispatch(vq, lo, scale, feats, calib)

    def color_by_normals_start(self, verts: np.ndarray, feats,
                               calib: torch.Tensor) -> _ColorJob:
        """Quantise all verts on the mesh bbox, pad to K chunks (a multiple
        of 4 above 4) and dispatch them in up to 4 groups, each landing in
        its own pinned buffer; the job pulls as groups land."""
        V = len(verts)
        if V == 0:
            return _ColorJob([], 0)
        chunk = self._COLOR_CHUNK
        K = max(1, -(-V // chunk))
        if K > 4:
            K = -(-K // 4) * 4
        vq, lo, scale = self._quantize_u16(verts, K * chunk)
        rows = (K // 4 if K > 4 else K) * chunk
        parts = [self._normals_dispatch(vq[s:s + rows], lo, scale, feats,
                                        calib)
                 for s in range(0, K * chunk, rows)]
        return _ColorJob(parts, V)

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

    def _export_mesh(self, save_path, verts, job, faces_blob):
        if save_path.endswith(".ply"):
            lib, buf, _ = faces_blob
            lib.meshio_free(buf)
            raise ValueError("PLY export is not ported yet")
        self._write_obj_streamed(save_path, verts, job, faces_blob)

    def _finish_normals(self, verts, faces, feats, calib, save_path,
                        job=None) -> dict:
        t0 = time.time()
        if job is None:
            job = self.color_by_normals_start(verts, feats, calib)
        with self.timed("faces"):
            faces_blob = format_faces_block(faces)
        t1 = time.time()
        with self.timed("obj_write"):
            self._export_mesh(save_path, verts, job, faces_blob)
        return {"verts": verts, "faces": faces,
                "finish_phases": {"faces": round(t1 - t0, 4),
                                  "color_and_obj": round(time.time() - t1,
                                                         4)}}

    # ------------------------------------------------------------ gen_mesh
    def gen_mesh(self, data: dict, save_path: str, resolution=None,
                 use_octree=None) -> dict:
        """Normal-coloured mesh of one subject, written as OBJ.

        ``data``: ``img [B2, H, W, 6]`` local windows, ``img_512
        [1, h, w, 6]`` global image, ``calib [4, 4]`` (NumPy or tensors).
        Returns verts, faces, secs, grid_diag and a ``phases`` breakdown.
        """
        from .streamed import reconstruct_streamed

        t0 = time.time()
        res = resolution or self.opt.resolution
        use_oct = self.opt.use_octree if use_octree is None else use_octree
        if not use_oct:
            raise ValueError("the dense (non-octree) path is not ported")
        self.query_calls = 0
        self.points_queried = {}
        self.host_secs = {}
        with torch.inference_mode():
            calib_np = np.asarray(
                data["calib"].cpu() if isinstance(data["calib"], torch.Tensor)
                else data["calib"], np.float32)
            calib = self._tensor(calib_np)
            with self.timed("encode"):
                feats = self.encode(self._tensor(data["img"]),
                                    self._tensor(data["img_512"]))
            if (getattr(self.opt, "octree_levels", 3) == 3 and res % 8 == 0
                    and getattr(self.opt, "streamed_recon", True)):
                verts, faces, job, _ = reconstruct_streamed(
                    self, res, calib, calib_np, feats)
            else:
                field = self.evaluate_field(feats[0], feats[1], calib, res)
                verts_idx, faces = marching_tetrahedra_sparse3(
                    *field, res, algorithm=self.opt.marching_algo)
                verts, faces = self._to_world(verts_idx, faces, calib_np,
                                              res)
                job = None
            if len(verts) == 0:
                raise RuntimeError("marching produced an empty mesh")
            t1 = time.time()
            out = self._finish_normals(verts, faces, feats, calib, save_path,
                                       job=job)
        t2 = time.time()
        out.update(secs=t2 - t0, grid_diag=self.last_grid_diag,
                   phases={"reconstruct": round(t1 - t0, 4),
                           "color_save": round(t2 - t1, 4)},
                   points_queried=dict(self.points_queried),
                   query_calls=self.query_calls,
                   host_secs={k: round(v, 4)
                              for k, v in self.host_secs.items()})
        return out
