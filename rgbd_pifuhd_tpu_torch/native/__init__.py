"""Native (C++) host kernels, built with g++ into ``_build/`` on first use.

``marching.cc`` (marching cubes / tetrahedra over dense and sparse fields),
``meshio.cc`` (sparse-volume densify, affine transform, u16 vertex
quantisation, OBJ writer) and ``raster.cc`` (the orthographic z-buffer
rasteriser of the synthetic training trees) are copies of the JAX package's
sources; ``grabcut.cc`` (GrabCut segmentation, where the JAX package calls
OpenCV), ``containment.cc`` (the point-in-mesh parity of
``data/containment.py``, where the JAX package loops in NumPy) and
``imageprep.cc`` (the readers' resize and normalisation of uint8 maps in
one pass, where the JAX package chains NumPy calls) are the port's own;
the last two are built without FMA contraction so their answers are
NumPy's.  A failed build raises: this port has no NumPy fallback for them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_CACHE: dict = {}


def _build_lib(name: str, source: str, extra: tuple = ()) -> str:
    so_path = os.path.join(_BUILD, f"lib{name}.so")
    src = os.path.join(_HERE, source)
    if os.path.exists(so_path) and \
            os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", *extra, src, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"g++ build of {name} failed:\n{r.stderr}")
    os.replace(tmp, so_path)
    return so_path


def build_all() -> None:
    """Build every library (``chip_smoke.py`` times this)."""
    load_marching()
    load_meshio()
    load_raster()
    load_grabcut()
    load_containment()
    load_imageprep()


def load_marching():
    """ctypes handle to the sparse marching kernels (raises on failure)."""
    with _LOCK:
        if "marching" in _CACHE:
            return _CACHE["marching"]
        lib = ctypes.CDLL(_build_lib("marching", "marching.cc"))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i64, ci, cf = ctypes.c_int64, ctypes.c_int, ctypes.c_float
        field3 = [u8p, i32p, i64, u8p, i32p, i64, u8p, i64, ci, i64, ci, cf,
                  cf, i8p, ci, ci]
        out_args = [ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                    ctypes.POINTER(i64),
                    ctypes.POINTER(i32p),
                    ctypes.POINTER(i64)]
        lib.mt_run_sparse3.restype = ci
        lib.mt_run_sparse3.argtypes = field3 + [i32p, i64] + out_args
        # dense volume [X, Y, Z], threshold, case table, mc_cols, threads
        lib.mt_run.restype = ci
        lib.mt_run.argtypes = [ctypes.POINTER(ctypes.c_float), i64, i64, i64,
                               cf, i8p, ci, ci] + out_args
        # two-level field: corner_q, top_idx, K, refined, n, factor, res,
        # pack_bits, band_scale, threshold, case table, mc_cols, threads,
        # then the scan cells
        lib.mt_run_sparse.restype = ci
        lib.mt_run_sparse.argtypes = [u8p, i32p, i64, u8p, i64, ci, i64, ci,
                                      cf, cf, i8p, ci, ci, i32p,
                                      i64] + out_args
        # dense volume [X, Y, Z], threshold, case table, mc_cols, threads,
        # then the scan cells and their factor
        lib.mt_run_cells.restype = ci
        lib.mt_run_cells.argtypes = [ctypes.POINTER(ctypes.c_float), i64,
                                     i64, i64, cf, i8p, ci, ci, i32p, i64,
                                     ci] + out_args
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.mt_pooled_merge_min.restype = i64
        lib.mt_pooled_merge_min.argtypes = []
        # the field, threads, then the first step's vertices a cell
        lib.mt3_begin.restype = ctypes.c_void_p
        lib.mt3_begin.argtypes = field3 + [ctypes.c_double]
        # session, cells, n_cells -> new vertices, base vertex, faces
        lib.mt3_step.restype = ci
        lib.mt3_step.argtypes = [ctypes.c_void_p, i32p, i64,
                                 ctypes.POINTER(i64), ctypes.POINTER(i64),
                                 ctypes.POINTER(i64)]
        lib.mt3_take.restype = ci
        lib.mt3_take.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float), i32p]
        lib.mt3_stats.restype = ci
        lib.mt3_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64),
                                  ctypes.POINTER(ctypes.c_double)]
        lib.mt3_end.argtypes = [ctypes.c_void_p]
        _CACHE["marching"] = lib
        return lib


def load_meshio():
    """ctypes handle to the mesh IO kernels (raises on failure)."""
    with _LOCK:
        if "meshio" in _CACHE:
            return _CACHE["meshio"]
        lib = ctypes.CDLL(_build_lib("meshio", "meshio.cc"))
        fp = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        # vol, res, fill, marks, n, factor, top_idx, K, refined, threads
        lib.densify.argtypes = [fp, i64, fp, ctypes.POINTER(ctypes.c_uint8),
                                i64, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int32), i64, fp,
                                ctypes.c_int]
        lib.transform_affine.argtypes = [
            fp, i64, ctypes.POINTER(ctypes.c_double), fp, ctypes.c_int]
        lib.bbox_quantize_u16.argtypes = [
            fp, i64, fp, fp, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int]
        lib.obj_write.restype = ctypes.c_int
        lib.obj_write.argtypes = [ctypes.c_char_p, fp, fp, i64,
                                  ctypes.POINTER(ctypes.c_int32), i64]
        lib.obj_format_faces.restype = ctypes.c_int
        lib.obj_format_faces.argtypes = [
            ctypes.POINTER(ctypes.c_int32), i64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(i64)]
        lib.obj_open.restype = i64
        lib.obj_open.argtypes = [ctypes.c_char_p]
        lib.obj_append_verts.restype = ctypes.c_int
        lib.obj_append_verts.argtypes = [i64, fp, fp, i64]
        lib.obj_finish.restype = ctypes.c_int
        lib.obj_finish.argtypes = [i64, ctypes.POINTER(ctypes.c_char), i64]
        lib.meshio_free.argtypes = [ctypes.c_void_p]
        _CACHE["meshio"] = lib
        return lib


def load_raster():
    """ctypes handle to the orthographic rasteriser (raises on failure)."""
    with _LOCK:
        if "raster" in _CACHE:
            return _CACHE["raster"]
        lib = ctypes.CDLL(_build_lib("raster", "raster.cc"))
        dp = ctypes.POINTER(ctypes.c_double)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        # px, py, pz, V, vn, vshade, shade_ch, faces, F, size, albedo,
        # light, uvs, face_uvs, tex, th, tw, face_albedo, zbuf, nbuf, rgb,
        # mask, threads
        lib.raster_ortho.restype = ctypes.c_int
        lib.raster_ortho.argtypes = [
            dp, dp, dp, i64, dp, dp, ctypes.c_int, ip, i64, i64, dp, dp, dp,
            ip, fp, i64, i64, dp, fp, fp, fp,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _CACHE["raster"] = lib
        return lib


def load_grabcut():
    """ctypes handle to the GrabCut segmenter (raises on failure)."""
    with _LOCK:
        if "grabcut" in _CACHE:
            return _CACHE["grabcut"]
        lib = ctypes.CDLL(_build_lib("grabcut", "grabcut.cc"))
        ci = ctypes.c_int
        # img, H, W, rect x, y, w, h, iters, mask out
        lib.grabcut_rect.restype = ci
        lib.grabcut_rect.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ci, ci, ci, ci, ci, ctypes.POINTER(ctypes.c_uint8)]
        _CACHE["grabcut"] = lib
        return lib


def load_containment():
    """ctypes handle to the point-in-mesh parity test (raises on
    failure)."""
    with _LOCK:
        if "containment" in _CACHE:
            return _CACHE["containment"]
        lib = ctypes.CDLL(_build_lib("containment", "containment.cc",
                                     ("-ffp-contract=off",)))
        dp = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        # points, n, triangles, bin starts, triangle ids, bb_min, bb_max,
        # cell, grid, out, threads
        lib.contains_points.restype = ctypes.c_int
        lib.contains_points.argtypes = [
            dp, ctypes.c_int64, dp, i64p, i64p, dp, dp, dp, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _CACHE["containment"] = lib
        return lib


def load_imageprep():
    """ctypes handle to the readers' one-pass image preparation (raises on
    failure)."""
    with _LOCK:
        if "imageprep" in _CACHE:
            return _CACHE["imageprep"]
        lib = ctypes.CDLL(_build_lib("imageprep", "imageprep.cc",
                                     ("-ffp-contract=off",)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        fp = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        # src, pixels, channels, out, out channels, channel offset
        lib.prep_same.restype = None
        lib.prep_same.argtypes = [u8p, i64, i64, fp, i64, i64]
        # src, W, C, row taps (y0, y1, by0, by1), h_out, column taps
        # (x0, x1, ax0, ax1), w_out, out, out channels, channel offset
        lib.prep_resized.restype = None
        lib.prep_resized.argtypes = [u8p, i64, i64, i64p, i64p, i32p, i32p,
                                     i64, i64p, i64p, i32p, i32p, i64, fp,
                                     i64, i64]
        _CACHE["imageprep"] = lib
        return lib
