"""Mesh IO and host-side mesh utilities (port of ``recon/mesh.py``).

- ``save_obj_with_color``: ``v x y z r g b`` lines and faces with flipped
  winding ``f v0 v2 v1``, written by the native ``meshio`` library.
- ``save_ply_with_color`` / ``load_ply``: binary little-endian PLY, uchar
  colours, the same flipped winding.
- ``load_obj``: minimal OBJ reader (the tests read meshes back with it).
- ``connected_components`` / ``keep_largest_component``: vertex labels from
  face connectivity, and the component with the largest extent along an
  axis (the mesh cleaning of the image-colour path).
- ``compute_vertex_normals``: area-weighted vertex normals (the colours of
  ``normal_mode='mesh'``).
- ``load_obj_mtl``: the textured-subject reader of offline rendering
  (UVs, materials, the ``map_Kd`` texture).
- ``save_ply_points`` / ``save_occupancy_samples_ply``: ASCII PLY point
  clouds of sampled points (``cli/debug_vis``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native import load_meshio
from ..utils.imageio import imread_rgb8


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


def save_ply_with_color(path: str, verts: np.ndarray, faces: np.ndarray,
                        colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY: two packed structured arrays go straight
    to the file.  Colours are stored as uchar RGB; the winding is flipped
    as in the OBJ writer."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces)
    V, F = len(v), len(f)
    has_c = colors is not None
    props = ["property float x", "property float y", "property float z"]
    if has_c:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {V}"] + props +
        [f"element face {F}",
         "property list uchar int vertex_indices", "end_header", ""])
    vdt = (np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]) if has_c
           else np.dtype([("xyz", "<f4", 3)]))
    vbuf = np.empty(V, vdt)
    vbuf["xyz"] = v
    if has_c:
        c = np.asarray(colors, np.float32)
        vbuf["rgb"] = np.clip(np.round(c * 255.0), 0, 255).astype(np.uint8)
    fbuf = np.empty(F, np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
    fbuf["n"] = 3
    fbuf["idx"] = f[:, [0, 2, 1]]
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        vbuf.tofile(fh)
        fbuf.tofile(fh)


def load_ply(path: str):
    """Read a PLY written by ``save_ply_with_color``: ``(verts [V, 3] f32,
    faces [F, 3] i32 with the winding flipped back, colors [V, 3] f32 in
    [0, 1] or None)``."""
    with open(path, "rb") as fh:
        V = F = 0
        has_c = False
        while True:
            line = fh.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                V = int(line.split()[-1])
            elif line.startswith("element face"):
                F = int(line.split()[-1])
            elif line == "property uchar red":
                has_c = True
            elif line == "end_header":
                break
        vdt = (np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]) if has_c
               else np.dtype([("xyz", "<f4", 3)]))
        vbuf = np.fromfile(fh, vdt, V)
        fbuf = np.fromfile(fh, np.dtype([("n", "u1"), ("idx", "<i4", 3)]), F)
    colors = (vbuf["rgb"].astype(np.float32) / 255.0) if has_c else None
    return (vbuf["xyz"].astype(np.float32),
            fbuf["idx"][:, [0, 2, 1]].astype(np.int32), colors)


def load_obj(path: str):
    """Minimal OBJ reader -> ``(verts [V, 3], faces [F, 3], colors or
    None)``: ``v`` lines with optional rgb, ``f`` lines with ``/vt/vn``
    suffixes, quads fan-triangulated."""
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vals = [float(x) for x in parts[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    colors.append(vals[3:6])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int32).reshape(-1, 3),
            np.asarray(colors, dtype=np.float32) if colors else None)


def connected_components(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """Vertex labels ``[V]`` from face connectivity: every vertex gets the
    smallest vertex index of its component.  Whole-array min-label hooking
    with pointer jumping (the JAX package walks a union-find face by face
    in Python and labels a component by its root; the partition is the
    same)."""
    parent = np.arange(n_verts, dtype=np.int64)
    f = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    a = np.concatenate([f[:, 0], f[:, 0]])
    b = np.concatenate([f[:, 1], f[:, 2]])
    while True:
        pa, pb = parent[a], parent[b]
        lo, hi = np.minimum(pa, pb), np.maximum(pa, pb)
        sel = lo != hi
        if not sel.any():
            return parent
        np.minimum.at(parent, hi[sel], lo[sel])
        while True:
            pp = parent[parent]
            if np.array_equal(pp, parent):
                break
            parent = pp
        a, b = a[sel], b[sel]


def keep_largest_component(verts: np.ndarray, faces: np.ndarray,
                           colors: np.ndarray | None = None, axis: int = 0):
    """Keep the connected component with the largest extent along ``axis``
    (components of fewer than 3 vertices never win)."""
    labels = connected_components(len(verts), faces)
    roots, inv, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    x = np.asarray(verts)[:, axis]
    lo = np.full(len(roots), np.inf)
    hi = np.full(len(roots), -np.inf)
    np.minimum.at(lo, inv, x)
    np.maximum.at(hi, inv, x)
    extent = np.where(counts >= 3, hi - lo, -1.0)
    keep = inv == int(np.argmax(extent))
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    fmask = keep[faces].all(axis=1)
    new_faces = remap[faces[fmask]].astype(np.int32)
    new_colors = colors[keep] if colors is not None else None
    return verts[keep], new_faces, new_colors


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals ``[V, 3]`` f32: each face's cross
    product (twice its area) summed into its three vertices in f64 with
    ``np.bincount``, then normalised with a 1e-12 floor."""
    v0 = verts[faces[:, 0]]
    fn = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    normals = np.zeros((len(verts), 3), dtype=np.float64)
    idx = faces.reshape(-1)
    for c in range(3):
        w = np.broadcast_to(fn[:, c:c + 1], (len(fn), 3)).reshape(-1)
        normals[:, c] = np.bincount(idx, weights=w, minlength=len(verts))
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def load_obj_mtl(path: str):
    """OBJ reader with UV / material support (the textured-subject loader):
    ``vt`` texture coordinates, ``mtllib`` / ``usemtl`` switches and the
    referenced ``.mtl`` files (``newmtl`` / ``Kd`` / ``map_Kd``; file names
    are the rest of the line and may hold spaces).  Returns a dict:

        verts       [V, 3] float32
        faces       [F, 3] int32 (quads and polygons fan-triangulated,
                    negative indices resolved)
        uvs         [T, 2] float32, or None when the OBJ has no ``vt``
        face_uvs    [F, 3] int32 indices into uvs; -1 = no UVs
        face_albedo [F, 3] float64 flat ``Kd`` per face (default 0.8 /
                    0.65 / 0.55)
        texture     [th, tw, 3] float32 RGB in [0, 1], or None: the first
                    material's ``map_Kd`` (in ``newmtl`` order) that reads
                    as ``cv2.imread`` reads it (``utils.imageio``); faces of
                    other materials fall back to their ``Kd``.

    A texture in a format OpenCV reads but this package does not decode
    raises ``ValueError`` naming the format.
    """
    obj_dir = os.path.dirname(os.path.abspath(path))
    default_kd = (0.8, 0.65, 0.55)
    materials: dict[str, dict] = {}

    def parse_mtl(mtl_path: str) -> None:
        if not os.path.exists(mtl_path):
            return
        cur = None
        with open(mtl_path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl":
                    cur = parts[1] if len(parts) > 1 else ""
                    materials.setdefault(cur, {"Kd": default_kd,
                                               "map_Kd": None})
                elif parts[0] == "Kd" and cur is not None:
                    materials[cur]["Kd"] = tuple(
                        float(x) for x in parts[1:4])
                elif (parts[0] == "map_Kd" and cur is not None
                      and len(parts) > 1):
                    materials[cur]["map_Kd"] = os.path.join(
                        obj_dir, line.split(None, 1)[1].strip())

    verts, uvs, faces, face_uvs, face_mats = [], [], [], [], []
    cur_mat = None
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "mtllib" and len(parts) > 1:
                parse_mtl(os.path.join(obj_dir,
                                       line.split(None, 1)[1].strip()))
            elif tag == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else None
            elif tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "f":
                vi, ti = [], []
                for p in parts[1:]:
                    comps = p.split("/")
                    i = int(comps[0])
                    vi.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comps) > 1 and comps[1]:
                        j = int(comps[1])
                        ti.append(j - 1 if j > 0 else len(uvs) + j)
                    else:
                        ti.append(-1)
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    face_uvs.append([ti[0], ti[k], ti[k + 1]])
                    face_mats.append(cur_mat)

    texture = None
    tex_mat = None
    for name, m in materials.items():
        if m["map_Kd"] and os.path.exists(m["map_Kd"]):
            img = imread_rgb8(m["map_Kd"])
            if img is not None:
                texture = img.astype(np.float32) / 255.0
                tex_mat = name
                break

    F = len(faces)
    face_albedo = np.empty((F, 3), np.float64)
    fuv = np.asarray(face_uvs, np.int32).reshape(F, 3)
    for i, mat in enumerate(face_mats):
        face_albedo[i] = materials.get(mat, {}).get("Kd", default_kd)
        if texture is not None and mat != tex_mat:
            fuv[i] = -1
    return {
        "verts": np.asarray(verts, np.float32),
        "faces": np.asarray(faces, np.int32).reshape(F, 3),
        "uvs": np.asarray(uvs, np.float32) if uvs else None,
        "face_uvs": fuv,
        "face_albedo": face_albedo,
        "texture": texture,
    }


def save_ply_points(path: str, points: np.ndarray,
                    colors: np.ndarray | None = None) -> None:
    """ASCII PLY point cloud (a debugging aid): ``x y z`` with 4 decimals,
    and uchar ``red green blue`` (``clip(colors * 255)`` truncated) when
    colours are given."""
    points = np.asarray(points, dtype=np.float64)
    has_c = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if has_c:
            c255 = np.clip(np.asarray(colors) * 255, 0, 255).astype(int)
            for p, c in zip(points, c255):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def save_occupancy_samples_ply(path: str, points: np.ndarray,
                               prob: np.ndarray) -> None:
    """Occupancy samples as a PLY: red inside (prob > 0.5), green
    outside."""
    prob = np.asarray(prob).reshape(-1)
    colors = np.stack(
        [prob > 0.5, prob <= 0.5, np.zeros_like(prob)], axis=1
    ).astype(np.float64)
    save_ply_points(path, points, colors)
