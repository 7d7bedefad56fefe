"""OBJ export (port of ``recon/mesh.py``'s writer): ``v x y z r g b`` lines
and faces with flipped winding ``f v0 v2 v1``, written by the native
``meshio`` library."""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load_meshio


def save_obj_with_color(path: str, verts: np.ndarray, faces: np.ndarray,
                        colors: np.ndarray | None = None) -> None:
    lib = load_meshio()
    v = np.ascontiguousarray(verts, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    c = None if colors is None else np.ascontiguousarray(colors, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.obj_write(
        path.encode(), v.ctypes.data_as(fp),
        None if c is None else c.ctypes.data_as(fp), ctypes.c_int64(len(v)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(f)))
    if rc != 0:
        raise OSError(f"obj_write failed for {path} (rc={rc})")


def format_faces_block(faces: np.ndarray):
    """Pre-format the OBJ face block (flipped winding) into a native text
    buffer while the device still computes vertex colours.  Returns the
    opaque ``(lib, buf, len)`` blob the streamed writer consumes and frees.
    """
    lib = load_meshio()
    f = np.ascontiguousarray(faces, np.int32)
    buf = ctypes.POINTER(ctypes.c_char)()
    ln = ctypes.c_int64()
    rc = lib.obj_format_faces(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(f)), ctypes.byref(buf), ctypes.byref(ln))
    if rc != 0:
        raise RuntimeError(f"obj_format_faces failed (rc={rc})")
    return (lib, buf, ln)
