"""Synthetic capsule subject (a NumPy copy of the parts of
``rgbd_pifuhd_tpu/data/synthetic.py`` the port's smoke run needs): analytic
meshes, height normalisation and placement, and the vectorised NumPy
orthographic rasteriser.

Conventions: ``calib`` maps world -> NDC ([-1, 1], y up); pixels follow the
grid_sample convention (align_corners): u=-1 -> col 0, v=-1 -> row 0.
"""

from __future__ import annotations

import numpy as np


def make_icosphere(subdiv: int = 3, radius: float = 1.0):
    """Icosphere verts/faces via repeated subdivision of an icosahedron."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdiv):
        edge_mid: dict = {}
        new_faces = []
        vlist = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts * radius, faces


def make_capsule(height: float = 2.0, radius: float = 0.5, subdiv: int = 3):
    """Capsule: icosphere split at the equator and extruded along y."""
    v, f = make_icosphere(subdiv, radius)
    v = v.copy()
    v[:, 1] += np.where(v[:, 1] > 0, height / 2, -height / 2)
    return v, f


def normalize_mesh_height(verts: np.ndarray, target: float = 180.0):
    """Center and scale so the y-extent is ``target`` world units."""
    vmin, vmax = verts.min(axis=0), verts.max(axis=0)
    up = max(vmax[1] - vmin[1], 1e-9)
    center = (vmax + vmin) / 2
    return (verts - center) * (target / up)


# World position every synthetic subject is placed at (roughly the
# reference's training box: z around -430, TrainDataset.py B_MIN/B_MAX).
SUBJECT_CENTER = np.array([-128.0, 100.0, -434.0])


def rotation_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


# ------------------------------------------------------------ rasterizer
def _vertex_normals(verts: np.ndarray, faces: np.ndarray,
                    ndc: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals in view (NDC) space."""
    v0, v1, v2 = (ndc[faces[:, 0]], ndc[faces[:, 1]], ndc[faces[:, 2]])
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    vn = np.zeros_like(verts, dtype=np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    return vn


def rasterize_ortho(verts: np.ndarray, faces: np.ndarray, size: int,
                           calib: np.ndarray, albedo=(0.8, 0.65, 0.55),
                           vert_shade: np.ndarray | None = None,
                           uvs: np.ndarray | None = None,
                           face_uvs: np.ndarray | None = None,
                           texture: np.ndarray | None = None,
                           face_albedo: np.ndarray | None = None):
    """Vectorized NumPy orthographic z-buffer rasterizer.

    ``calib`` maps world -> NDC ([-1, 1], y up); pixels follow the
    grid_sample convention (align_corners): u=-1 -> col 0, v=-1 -> row 0.

    Two passes, no per-face Python loop (the reference renders through an
    OpenGL FBO, traindata/render_data.py:147-288; this is the CPU-native
    equivalent sized for its real workloads — a 100k-face subject at
    1024^2 rasterizes in well under a second):

    1. visibility — faces are bucketed by bbox pixel count; per bucket the
       candidate pixels of ALL faces are enumerated with one broadcast,
       barycentric-tested, and scattered into the z-buffer as packed
       ``(quantized z << 32) | face_id`` int64 via ``np.minimum.at`` —
       an atomic-min depth test, exactly GL's depth-buffer semantics.
    2. attributes — for each covered pixel, the winning face's barycentric
       coordinates are recomputed once; normals (and optional per-vertex
       shading) interpolate vectorized over covered pixels only.

    Args:
        vert_shade: optional ``[V]`` or ``[V, 3]`` per-vertex shading
            multiplier (e.g. PRT diffuse), barycentrically interpolated.

    Returns dict with rgb [H,W,3] float[0,1], mask [H,W] bool,
    zbuf [H,W] float (NDC z, +inf where empty), normal [H,W,3] view-space.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    ndc = verts @ calib[:3, :3].T + calib[:3, 3]
    px = (ndc[:, 0] + 1.0) * 0.5 * (size - 1)
    py = (ndc[:, 1] + 1.0) * 0.5 * (size - 1)
    pz = ndc[:, 2]
    vn = _vertex_normals(verts, faces, ndc)

    zbuf = np.full((size, size), np.inf)
    nbuf = np.zeros((size, size, 3))
    rgb = np.ones((size, size, 3))
    mask = np.zeros((size, size), dtype=bool)
    albedo = np.asarray(albedo, np.float64)
    light = np.array([0.3, 0.6, -0.8])
    light /= np.linalg.norm(light)

    # per-face screen coords and edge-function setup
    fx = px[faces]                                      # [F, 3]
    fy = py[faces]
    fz = pz[faces]
    d = ((fy[:, 1] - fy[:, 2]) * (fx[:, 0] - fx[:, 2])
         + (fx[:, 2] - fx[:, 1]) * (fy[:, 0] - fy[:, 2]))
    x0 = np.clip(np.floor(fx.min(1)).astype(np.int64), 0, size - 1)
    x1 = np.clip(np.ceil(fx.max(1)).astype(np.int64), 0, size - 1)
    y0 = np.clip(np.floor(fy.min(1)).astype(np.int64), 0, size - 1)
    y1 = np.clip(np.ceil(fy.max(1)).astype(np.int64), 0, size - 1)
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    keep = (np.abs(d) > 1e-12) & (np.ceil(fx.max(1)) >= 0) \
        & (np.floor(fx.min(1)) <= size - 1) \
        & (np.ceil(fy.max(1)) >= 0) & (np.floor(fy.min(1)) <= size - 1)

    # pack z into the high 32 bits for an atomic-min depth+id test
    zmin = float(pz.min())
    zspan = max(float(pz.max()) - zmin, 1e-12)

    def zq(z):
        q = (z - zmin) / zspan * float(2 ** 31 - 4)
        return np.clip(q, 0, 2 ** 31 - 2).astype(np.int64)

    packed = np.full(size * size, np.iinfo(np.int64).max, np.int64)
    area = (w * h).astype(np.int64)
    face_ids = np.arange(len(faces), dtype=np.int64)

    # bucket faces by candidate-pixel count to keep broadcasts tight
    bounds = [4, 16, 64, 256, 1024, 4096]
    while bounds[-1] < size * size:
        bounds.append(bounds[-1] * 4)
    lo = 0
    for cap in bounds:
        sel = np.nonzero(keep & (area > lo) & (area <= cap))[0]
        lo = cap
        if sel.size == 0:
            continue
        offs = np.arange(cap, dtype=np.int64)
        ws = w[sel][:, None]
        gx = x0[sel][:, None] + offs[None, :] % ws     # [Fb, cap]
        gy = y0[sel][:, None] + offs[None, :] // ws
        valid = gy <= y1[sel][:, None]
        gxf = gx.astype(np.float64)
        gyf = gy.astype(np.float64)
        X = fx[sel]
        Y = fy[sel]
        dd = d[sel][:, None]
        w0 = ((Y[:, 1:2] - Y[:, 2:3]) * (gxf - X[:, 2:3])
              + (X[:, 2:3] - X[:, 1:2]) * (gyf - Y[:, 2:3])) / dd
        w1 = ((Y[:, 2:3] - Y[:, 0:1]) * (gxf - X[:, 2:3])
              + (X[:, 0:1] - X[:, 2:3]) * (gyf - Y[:, 2:3])) / dd
        w2 = 1.0 - w0 - w1
        inside = valid & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        Z = fz[sel]
        z = w0 * Z[:, 0:1] + w1 * Z[:, 1:2] + w2 * Z[:, 2:3]
        pix = (gy * size + gx)[inside]
        val = (zq(z[inside]) << 32) | np.broadcast_to(
            face_ids[sel][:, None], inside.shape)[inside]
        np.minimum.at(packed, pix, val)

    covered = np.nonzero(packed != np.iinfo(np.int64).max)[0]
    if covered.size == 0:
        return {"rgb": rgb, "mask": mask, "zbuf": zbuf, "normal": nbuf}

    # pass 2: attribute interpolation for winning (pixel, face) pairs
    fid = (packed[covered] & 0xFFFFFFFF).astype(np.int64)
    cy = (covered // size).astype(np.float64)
    cx = (covered % size).astype(np.float64)
    X = fx[fid]
    Y = fy[fid]
    dd = d[fid]
    w0 = ((Y[:, 1] - Y[:, 2]) * (cx - X[:, 2])
          + (X[:, 2] - X[:, 1]) * (cy - Y[:, 2])) / dd
    w1 = ((Y[:, 2] - Y[:, 0]) * (cx - X[:, 2])
          + (X[:, 0] - X[:, 2]) * (cy - Y[:, 2])) / dd
    w2 = 1.0 - w0 - w1
    tri = faces[fid]                                    # [P, 3]
    z = (w0 * pz[tri[:, 0]] + w1 * pz[tri[:, 1]] + w2 * pz[tri[:, 2]])
    n = (w0[:, None] * vn[tri[:, 0]] + w1[:, None] * vn[tri[:, 1]]
         + w2[:, None] * vn[tri[:, 2]])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    shade = np.clip(np.abs(n @ light), 0.15, 1.0)[:, None]
    alb = np.broadcast_to(albedo, (len(fid), 3)).copy()
    if face_albedo is not None:
        alb = np.asarray(face_albedo, np.float64)[fid]
    if texture is not None and uvs is not None and face_uvs is not None:
        fuv = np.asarray(face_uvs, np.int64)[fid]          # [P, 3]
        textured = (fuv >= 0).all(axis=1)
        if textured.any():
            tex = np.asarray(texture, np.float64)
            th, tw = tex.shape[:2]
            uvt = np.asarray(uvs, np.float64)
            fu = fuv[textured]
            u = (w0[textured] * uvt[fu[:, 0], 0]
                 + w1[textured] * uvt[fu[:, 1], 0]
                 + w2[textured] * uvt[fu[:, 2], 0])
            vv = (w0[textured] * uvt[fu[:, 0], 1]
                  + w1[textured] * uvt[fu[:, 1], 1]
                  + w2[textured] * uvt[fu[:, 2], 1])
            u -= np.floor(u)                               # repeat wrap
            vv -= np.floor(vv)
            fx_ = u * (tw - 1)
            fy_ = (1.0 - vv) * (th - 1)                    # vt is y-up
            ix = np.clip(fx_.astype(np.int64), 0, max(tw - 2, 0))
            iy = np.clip(fy_.astype(np.int64), 0, max(th - 2, 0))
            du = (fx_ - ix)[:, None]
            dv = (fy_ - iy)[:, None]
            x2 = np.minimum(ix + 1, tw - 1)
            y2 = np.minimum(iy + 1, th - 1)
            alb[textured] = ((1 - dv) * ((1 - du) * tex[iy, ix]
                                         + du * tex[iy, x2])
                             + dv * ((1 - du) * tex[y2, ix]
                                     + du * tex[y2, x2]))
    col = alb * shade
    if vert_shade is not None:
        vs = np.asarray(vert_shade, np.float64)
        if vs.ndim == 1:
            vs = vs[:, None]
        s = (w0[:, None] * vs[tri[:, 0]] + w1[:, None] * vs[tri[:, 1]]
             + w2[:, None] * vs[tri[:, 2]])
        col = np.clip(col * s, 0.0, 1.0)

    yy = covered // size
    xx = covered % size
    zbuf[yy, xx] = z
    nbuf[yy, xx] = n
    rgb[yy, xx] = col
    mask[yy, xx] = True
    return {"rgb": rgb, "mask": mask, "zbuf": zbuf, "normal": nbuf}


def capsule_calib(size: int, load_size: int, yaw: float = 0.0
                  ) -> np.ndarray:
    """World -> NDC calib of the capsule subject at ``yaw``, as the JAX
    package's dataset generator builds it (``ortho_ratio = 0.2 * 1024 /
    size``, ``uv = 1 / (load_size // 2)``)."""
    ortho_ratio = 0.2 * (1024 / size)
    R = rotation_y(yaw)
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = R
    extrinsic[:3, 3:4] = -(R @ SUBJECT_CENTER).reshape(3, 1)
    s = 1.0 / ortho_ratio
    intr = np.diag([s, -s, s, 1.0])
    uv = np.diag([1.0 / (load_size // 2)] * 3 + [1.0])
    return uv @ intr @ extrinsic


def capsule_subject(size: int = 512):
    """The capsule (``make_capsule(1.6, 0.55, 3)``, 180 units tall, at
    ``SUBJECT_CENTER``) rendered at ``size``^2, yaw 0.  Returns ``(rgbd
    [size, size, 6] f32 in [-1, 1], calib [4, 4] f32, verts, faces)``:
    RGB, then the depth map normalised as the dataset generator does
    (``1 - z_norm`` on the silhouette, 0 off it) in all three channels."""
    v, f = make_capsule(1.6, 0.55, 3)
    v = normalize_mesh_height(v, 180.0) + SUBJECT_CENTER
    calib = capsule_calib(size, size)
    out = rasterize_ortho(v, f, size, calib)
    z, m = out["zbuf"], out["mask"]
    zn = np.zeros_like(z)
    if m.any():
        zmin, zmax = z[m].min(), z[m].max()
        zn[m] = (z[m] - zmin) / max(zmax - zmin, 1e-9)
    depth = np.where(m, 1.0 - zn, 0.0)
    rgbd = np.concatenate([out["rgb"], np.repeat(depth[:, :, None], 3, 2)],
                          axis=-1)
    return ((rgbd * 2.0 - 1.0).astype(np.float32), calib.astype(np.float32),
            v, f)
