"""Isosurface extraction (port of ``recon/marching.py``) over the
three-level sparse field (the main path), the two-level sparse field and a
dense volume.

The case tables are DERIVED at import time exactly as in the JAX package
(marching tetrahedra: 6 tets per cube; marching cubes: a watertight
per-face disambiguation rule), then handed to the native kernel
(``native/marching.cc``), which does the marching: without the native
library the loader raises.  The kernel's threads emit vertices in an order
that changes from run to run: compare meshes as vertex and triangle sets.

``marching_cubes_numpy`` (a loop over every cube) and
``marching_tetrahedra_cells`` (the masked scan over given cells) are plain
NumPy references over the same tables: the independent oracle of the
native kernel in the tests.  No path calls them.
"""

from __future__ import annotations

import numpy as np

# Cube corners (dx, dy, dz), indices 0-7.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)

# Six positively-oriented tetrahedra sharing the 0-6 diagonal.
_TETS = np.array(
    [
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
        [0, 5, 1, 6],
    ],
    dtype=np.int64,
)

# Tet edges: index into this list identifies a (local vertex, local vertex)
# pair within one tetrahedron.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _derive_case_table() -> list[np.ndarray]:
    """Build the 16-case triangle table with provably correct orientation.

    For each inside-mask over the 4 tet vertices, list triangles as triples
    of tet-edge indices.  Orientation: triangle normals must point from the
    inside region toward the outside region, tested geometrically on a
    canonical positively-oriented tetrahedron.
    """
    # canonical positively-oriented tet (matches _TETS orientation)
    P = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    edge_of = {tuple(sorted(e)): i for i, e in enumerate(_TET_EDGES.tolist())}

    def orient(tri_edges, inside):
        """Flip triangle if its normal points toward the inside region."""
        mid = np.array([(P[a] + P[b]) / 2 for a, b in
                        (_TET_EDGES[e] for e in tri_edges)])
        n = np.cross(mid[1] - mid[0], mid[2] - mid[0])
        c_in = P[list(inside)].mean(axis=0)
        c_out = P[[i for i in range(4) if i not in inside]].mean(axis=0)
        if np.dot(n, c_out - c_in) < 0:
            return [tri_edges[0], tri_edges[2], tri_edges[1]]
        return list(tri_edges)

    table = []
    for mask in range(16):
        inside = {i for i in range(4) if mask & (1 << i)}
        outside = [i for i in range(4) if i not in inside]
        tris: list[list[int]] = []
        if len(inside) == 1:
            (a,) = inside
            es = [edge_of[tuple(sorted((a, o)))] for o in outside]
            tris.append(orient(es, inside))
        elif len(inside) == 3:
            (o,) = outside
            es = [edge_of[tuple(sorted((o, i)))] for i in sorted(inside)]
            tris.append(orient(es, inside))
        elif len(inside) == 2:
            a, b = sorted(inside)
            c1, c2 = outside
            # quad cycle: (a,c1) (a,c2) (b,c2) (b,c1)
            q = [
                edge_of[tuple(sorted((a, c1)))],
                edge_of[tuple(sorted((a, c2)))],
                edge_of[tuple(sorted((b, c2)))],
                edge_of[tuple(sorted((b, c1)))],
            ]
            tris.append(orient([q[0], q[1], q[2]], inside))
            tris.append(orient([q[0], q[2], q[3]], inside))
        table.append(
            np.array(tris, dtype=np.int64).reshape(-1, 3)
            if tris
            else np.zeros((0, 3), dtype=np.int64)
        )
    return table


_CASE_TABLE = _derive_case_table()


def _case_table_packed() -> np.ndarray:
    """[16, 6] int8, -1 padded — shared with the C++ kernel."""
    packed = -np.ones((16, 6), dtype=np.int8)
    for c, tris in enumerate(_CASE_TABLE):
        flat = tris.reshape(-1)
        packed[c, : len(flat)] = flat
    return packed


# ---------------------------------------------------------------------------
# Marching CUBES (the reference's own algorithm family, mesh_util.py:84 via
# skimage): ~2x fewer vertices/triangles than tetrahedra for the same
# surface, which halves everything downstream (dedup, coloring, IO).
#
# The 256-case table is DERIVED at import time — like the tet table above,
# no magic constants — with a FIXED per-face disambiguation rule: on an
# ambiguous face (two diagonally-opposite inside corners) the cut edges
# always pair so the two inside corners are enclosed SEPARATELY.  Because
# the rule depends only on the face's four corner states, the two cubes
# sharing any face derive the SAME polyline across it, so the mesh is
# watertight by construction (classic Lorensen-Cline tables are not; the
# Lewiner/MC33 machinery exists to fix that — this rule is the simpler
# consistent choice, trading exact trilinear topology in ambiguous
# interiors for guaranteed crack-freeness).

# cube edges (corner-index pairs, canonical order shared with the C++ kernel)
_MC_EDGES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.int64)

# faces as cyclic corner walks (consecutive entries are cube edges)
_MC_FACES = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
             (3, 2, 6, 7), (0, 3, 7, 4), (1, 2, 6, 5))


def _derive_mc_table() -> list[list[list[int]]]:
    """[256] list of LOOPS (each an oriented cyclic list of cube-edge ids).

    Loops — not pre-triangulated triangles — because triangulation choice
    matters for watertightness: a fan chord between two cut edges of the
    same face lies IN that face's plane, and the neighboring cube fans
    differently (measured: 1-2 boundary edges per ~1800 faces on random
    fields).  Consumers triangulate a 3-loop directly and longer loops
    through the loop CENTROID (an interior point), so every generated
    edge is either a prescribed face-crossing segment (shared exactly
    with the neighbor) or strictly cube-interior — watertight by
    construction.
    """
    edge_of = {tuple(sorted(e)): i for i, e in enumerate(_MC_EDGES.tolist())}
    adj = {i: [] for i in range(8)}
    for a, b in _MC_EDGES.tolist():
        adj[a].append(b)
        adj[b].append(a)
    pos = _CORNERS.astype(np.float64)

    table: list[list[list[int]]] = []
    for mask in range(256):
        inset = {i for i in range(8) if mask >> i & 1}
        # connected components of inside corners (cube-edge adjacency)
        comps, seen = [], set()
        for c in sorted(inset):
            if c in seen:
                continue
            comp, stack = set(), [c]
            while stack:
                u = stack.pop()
                if u in comp:
                    continue
                comp.add(u)
                stack += [v for v in adj[u] if v in inset and v not in comp]
            seen |= comp
            comps.append(comp)

        loops_out: list[list[int]] = []
        for comp in comps:
            cut = [i for i, (a, b) in enumerate(_MC_EDGES.tolist())
                   if (a in comp) != (b in comp)]
            cutset = set(cut)
            # pair cut edges per face: the two delimiters of each maximal
            # cyclic run of comp-corners pair up (diagonal corners on an
            # ambiguous face form two runs -> enclosed separately)
            pair: dict[int, list[int]] = {e: [] for e in cut}
            for f in _MC_FACES:
                states = [f[k] in comp for k in range(4)]
                if not any(states) or all(states):
                    continue
                for k in range(4):
                    if states[k] and not states[k - 1]:  # run starts at k
                        m = k
                        while states[(m + 1) % 4]:
                            m = (m + 1) % 4
                        e1 = edge_of[tuple(sorted((f[k - 1], f[k])))]
                        e2 = edge_of[tuple(sorted((f[m], f[(m + 1) % 4])))]
                        if e1 in cutset and e2 in cutset:
                            pair[e1].append(e2)
                            pair[e2].append(e1)
            # traverse closed loops (each cut edge has exactly 2 partners)
            visited: set[int] = set()
            for e0 in cut:
                if e0 in visited:
                    continue
                loop = [e0]
                visited.add(e0)
                prev, cur = None, e0
                while True:
                    nxt = next(x for x in pair[cur] if x != prev)
                    if nxt == e0:
                        break
                    loop.append(nxt)
                    visited.add(nxt)
                    prev, cur = cur, nxt
                # orient: Newell normal must point from inside to outside
                mids = np.array([(pos[_MC_EDGES[e][0]]
                                  + pos[_MC_EDGES[e][1]]) / 2 for e in loop])
                nrm = np.zeros(3)
                for i in range(len(mids)):
                    a, b = mids[i], mids[(i + 1) % len(mids)]
                    nrm += np.cross(a, b)
                ins_pts = np.array([
                    pos[a] if a in comp else pos[b]
                    for e in loop for a, b in [_MC_EDGES[e].tolist()]])
                out_pts = np.array([
                    pos[b] if a in comp else pos[a]
                    for e in loop for a, b in [_MC_EDGES[e].tolist()]])
                if np.dot(nrm, out_pts.mean(0) - ins_pts.mean(0)) < 0:
                    loop.reverse()
                loops_out.append(loop)
        table.append(_triangulate_loops(loops_out))
    return table


# face sets per cube edge (chord-safety test: a chord between two cut
# edges sharing a cube face lies IN that face's plane)
_FACES_OF_EDGE = None


def _faces_of_edge():
    global _FACES_OF_EDGE
    if _FACES_OF_EDGE is None:
        edge_of = {tuple(sorted(e)): i
                   for i, e in enumerate(_MC_EDGES.tolist())}
        foe = [set() for _ in range(12)]
        for fi, f in enumerate(_MC_FACES):
            for k in range(4):
                foe[edge_of[tuple(sorted((f[k], f[(k + 1) % 4])))]].add(fi)
        _FACES_OF_EDGE = foe
    return _FACES_OF_EDGE


def _triangulate_loops(loops: list[list[int]]) -> list[list[int]]:
    """Split each loop into 3-loops (triangles) when a fan whose chords
    are all strictly cube-interior exists; otherwise keep the full loop
    for centroid triangulation at consume time."""
    foe = _faces_of_edge()
    out: list[list[int]] = []
    for loop in loops:
        L = len(loop)
        if L == 3:
            out.append(loop)
            continue
        fanned = False
        for k in range(L):
            rot = loop[k:] + loop[:k]
            chords = [(rot[0], rot[j]) for j in range(2, L - 1)]
            if all(not (foe[a] & foe[b]) for a, b in chords):
                out += [[rot[0], rot[j], rot[j + 1]]
                        for j in range(1, L - 1)]
                fanned = True
                break
        if not fanned:
            out.append(loop)
    return out


_MC_CASE_TABLE = _derive_mc_table()
# Every derived loop fans into interior-chord triangles (verified at
# import below), so the packed form is flat triangle triples like the
# tet table — the C++ kernel consumes both through one code path.
assert all(len(l) == 3 for loops in _MC_CASE_TABLE for l in loops), \
    "MC derivation produced a non-fannable loop; update the packing"
_MC_COLS = max(len(loops) for loops in _MC_CASE_TABLE) * 3


def _mc_table_packed() -> np.ndarray:
    """[256, _MC_COLS] int8 triangle edge-id triples, -1 padded — shared
    with the C++ kernel."""
    packed = -np.ones((256, _MC_COLS), dtype=np.int8)
    for c, loops in enumerate(_MC_CASE_TABLE):
        row = [e for loop in loops for e in loop]
        packed[c, : len(row)] = row
    return packed


_PACKED_CACHE: dict = {}


def _packed_table(algorithm: str):
    """(packed case table, mc_cols) for the C++ kernel: mc_cols == 0
    selects marching tetrahedra, > 0 the marching-cubes table width.
    The tables are compile-time constants — packed once per process."""
    if algorithm not in _PACKED_CACHE:
        if algorithm == "mc":
            t = np.ascontiguousarray(_mc_table_packed())
            _PACKED_CACHE[algorithm] = (t, int(t.shape[1]))
        else:
            t = np.ascontiguousarray(_case_table_packed())
            _PACKED_CACHE[algorithm] = (t, 0)
    return _PACKED_CACHE[algorithm]


def _as_ptrs(corner_q, top8_idx, sub_q, top4_idx, refined, algorithm):
    """Contiguous copies of the field arrays + the packed case table."""
    return (np.ascontiguousarray(corner_q, dtype=np.uint8).reshape(-1),
            np.ascontiguousarray(top8_idx, dtype=np.int32).reshape(-1),
            np.ascontiguousarray(sub_q, dtype=np.uint8),
            np.ascontiguousarray(top4_idx, dtype=np.int32).reshape(-1),
            np.ascontiguousarray(refined, dtype=np.uint8),
            _packed_table(algorithm)[0])


def _field_args(keep, resolution, factor, pack_bits, band_scale, threshold,
                mc_cols, n_threads=0):
    import ctypes

    cq, t8, sq, t4, rf, table = keep
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return [cq.ctypes.data_as(u8p),
            t8.ctypes.data_as(i32p), ctypes.c_int64(len(t8)),
            sq.ctypes.data_as(u8p),
            t4.ctypes.data_as(i32p), ctypes.c_int64(len(t4)),
            rf.ctypes.data_as(u8p),
            ctypes.c_int64(resolution // factor), ctypes.c_int(factor),
            ctypes.c_int64(resolution), ctypes.c_int(pack_bits),
            ctypes.c_float(band_scale), ctypes.c_float(threshold),
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int(mc_cols), ctypes.c_int(n_threads)]


def _take_mesh(lib, rc: int, what: str, vp, nv, fp, nf):
    """Copy the kernel's output arrays and free them."""
    if rc != 0:
        raise RuntimeError(f"{what} failed (rc={rc})")
    verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
        if nv.value else np.zeros((0, 3), np.float32)
    faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() \
        if nf.value else np.zeros((0, 3), np.int32)
    lib.mt_free(vp)
    lib.mt_free(fp)
    return verts, faces


def _out_args():
    import ctypes

    return (ctypes.POINTER(ctypes.c_float)(), ctypes.c_int64(),
            ctypes.POINTER(ctypes.c_int32)(), ctypes.c_int64())


def marching_tetrahedra(volume: np.ndarray, threshold: float = 0.5,
                        algorithm: str = "mt"):
    """Surface of a dense ``[X, Y, Z]`` field at ``threshold``: index-space
    ``verts [V, 3]`` f32 and ``faces [F, 3]`` int32 (native ``mt_run``)."""
    import ctypes
    from ..native import load_marching

    lib = load_marching()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    table, mc_cols = _packed_table(algorithm)
    vp, nv, fp, nf = _out_args()
    rc = lib.mt_run(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *[ctypes.c_int64(d) for d in vol.shape], ctypes.c_float(threshold),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int(mc_cols), 0, ctypes.byref(vp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf))
    return _take_mesh(lib, rc, "mt_run", vp, nv, fp, nf)


def marching_tetrahedra_sparse(corner_q, top_idx, refined, cell_origins,
                               resolution: int, factor: int = 8,
                               pack_bits: int = 4, band_scale: float = 4.0,
                               threshold: float = 0.5,
                               algorithm: str = "mt"):
    """Surface of the two-level sparse result read directly (native
    ``mt_run_sparse``): refined cells through their dequantised blocks,
    the others as their corners' fill; ``cell_origins`` from
    ``sparse_scan_cells``."""
    import ctypes
    from ..native import load_marching

    lib = load_marching()
    corner_q = np.ascontiguousarray(corner_q, dtype=np.uint8).reshape(-1)
    top_idx = np.ascontiguousarray(top_idx, dtype=np.int32).reshape(-1)
    refined = np.ascontiguousarray(refined, dtype=np.uint8)
    cells = np.ascontiguousarray(cell_origins, dtype=np.int32)
    table, mc_cols = _packed_table(algorithm)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    vp, nv, fp, nf = _out_args()
    rc = lib.mt_run_sparse(
        corner_q.ctypes.data_as(u8p), top_idx.ctypes.data_as(i32p),
        ctypes.c_int64(len(top_idx)), refined.ctypes.data_as(u8p),
        ctypes.c_int64(resolution // factor), ctypes.c_int(factor),
        ctypes.c_int64(resolution), ctypes.c_int(pack_bits),
        ctypes.c_float(band_scale), ctypes.c_float(threshold),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int(mc_cols), 0, cells.ctypes.data_as(i32p),
        ctypes.c_int64(len(cells)), ctypes.byref(vp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf))
    return _take_mesh(lib, rc, "mt_run_sparse", vp, nv, fp, nf)


def marching_tetrahedra_sparse3(
    corner_q, top8_idx, sub_q, top4_idx, refined, cell_origins,
    resolution: int, factor: int = 8, pack_bits: int = 4,
    band_scale: float = 4.0, threshold: float = 0.5, algorithm: str = "mt",
):
    """One-shot surface extraction from the three-phase sparse result:
    index-space ``verts [V, 3]`` f32 and ``faces [F, 3]`` int32."""
    import ctypes
    from ..native import load_marching

    lib = load_marching()
    keep = _as_ptrs(corner_q, top8_idx, sub_q, top4_idx, refined, algorithm)
    cells = np.ascontiguousarray(cell_origins, dtype=np.int32)
    vp, nv, fp, nf = _out_args()
    rc = lib.mt_run_sparse3(
        *_field_args(keep, resolution, factor, pack_bits, band_scale,
                     threshold, _packed_table(algorithm)[1]),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(cells)),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp),
        ctypes.byref(nf))
    return _take_mesh(lib, rc, "mt_run_sparse3", vp, nv, fp, nf)


# IncrementalMarcher3.stats()'s counts, in mt3_stats's order
_MT3_COUNTS = ("steps", "verts_local", "verts_new", "verts_resolved",
               "map_grows", "map_resizes", "merges_pooled")


class IncrementalMarcher3:
    """Slab-incremental marching over the three-phase sparse field (the
    native ``mt3_begin/step/take/end`` session): feeding the scan cells in
    any order and any number of slabs yields the one-shot mesh up to vertex
    order.  ``step`` returns ``(new_verts, faces)``: the vertices this slab
    appended (index space) and faces in global vertex indices.  The field
    arrays must stay alive (they are held here) and ``refined`` may be
    filled in later, before the cells that read it are stepped.

    ``n_threads`` (0: one a core) scan and merge each step; ``first_per_
    cell`` (0: the native default) is the thread-local vertices a scan cell
    the first step sizes its maps for (later steps take five times the
    session's own mean, if that is more)."""

    def __init__(self, corner_q, top8_idx, sub_q, top4_idx, refined,
                 resolution: int, factor: int = 8, pack_bits: int = 4,
                 band_scale: float = 4.0, threshold: float = 0.5,
                 algorithm: str = "mt", n_threads: int = 0,
                 first_per_cell: float = 0.0):
        import ctypes
        from ..native import load_marching

        self._lib = load_marching()
        if not (isinstance(refined, np.ndarray) and refined.dtype == np.uint8
                and refined.flags.c_contiguous):
            raise ValueError("refined must be a C-contiguous uint8 array "
                             "(the session reads it in place)")
        self._keep = _as_ptrs(corner_q, top8_idx, sub_q, top4_idx, refined,
                              algorithm)
        self._sess = self._lib.mt3_begin(
            *_field_args(self._keep, resolution, factor, pack_bits,
                         band_scale, threshold, _packed_table(algorithm)[1],
                         n_threads),
            ctypes.c_double(first_per_cell))
        if not self._sess:
            raise RuntimeError("mt3_begin failed")
        self.total_verts = 0

    def step(self, cell_origins: np.ndarray):
        import ctypes

        cells = np.ascontiguousarray(cell_origins, dtype=np.int32)
        nv, base, nf = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        rc = self._lib.mt3_step(
            self._sess, cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(cells)), ctypes.byref(nv), ctypes.byref(base),
            ctypes.byref(nf))
        if rc != 0:
            raise RuntimeError(f"mt3_step failed (rc={rc})")
        # the merge writes the step's output straight into these arrays
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        rc = self._lib.mt3_take(
            self._sess, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"mt3_take failed (rc={rc})")
        self.total_verts = base.value + nv.value
        return verts, faces

    def stats(self) -> dict:
        """The session's counters over its steps (``_MT3_COUNTS``) and the
        wall seconds of its scans and merges (``scan_s``, ``merge_s``)."""
        import ctypes

        counts = (ctypes.c_int64 * len(_MT3_COUNTS))()
        secs = (ctypes.c_double * 2)()
        rc = self._lib.mt3_stats(self._sess, counts, secs)
        if rc != 0:
            raise RuntimeError(f"mt3_stats failed (rc={rc})")
        return dict(zip(_MT3_COUNTS, counts), scan_s=secs[0],
                    merge_s=secs[1])

    def close(self):
        if getattr(self, "_sess", None):
            self._lib.mt3_end(self._sess)
            self._sess = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# NumPy references (the tests' oracle of native/marching.cc)
def marching_cubes_numpy(volume: np.ndarray, threshold: float = 0.5):
    """Marching cubes over a dense volume, one cube at a time, with the
    derived table: index-space ``verts [V, 3]`` f32 and ``faces [F, 3]``
    int32, one vertex per lattice edge (interpolated from the edge's
    lower-id corner: the fraction in the volume's dtype, the position in
    float64)."""
    X, Y, Z = volume.shape
    verts: list = []
    vmap: dict = {}
    faces: list = []

    def edge_vert(x, y, z, e):
        a, b = _MC_EDGES[e]
        pa = (x + _CORNERS[a][0], y + _CORNERS[a][1], z + _CORNERS[a][2])
        pb = (x + _CORNERS[b][0], y + _CORNERS[b][1], z + _CORNERS[b][2])
        key = (pa, pb) if pa <= pb else (pb, pa)
        if key not in vmap:
            # from the sorted pair, so both cubes sharing the edge agree
            p = np.asarray(key[0], np.float64)
            q = np.asarray(key[1], np.float64)
            va, vb = volume[key[0]], volume[key[1]]
            t = 0.5 if vb == va else (threshold - va) / (vb - va)
            t = min(max(t, 0.0), 1.0)
            vmap[key] = len(verts)
            verts.append(p + t * (q - p))
        return vmap[key]

    for x in range(X - 1):
        for y in range(Y - 1):
            for z in range(Z - 1):
                c = np.array([volume[x + dx, y + dy, z + dz]
                              for dx, dy, dz in _CORNERS])
                mask = int(((c > threshold) << np.arange(8)).sum())
                for tri in _MC_CASE_TABLE[mask]:   # every loop a triangle
                    vid = [edge_vert(x, y, z, e) for e in tri]
                    if len(set(vid)) == 3:
                        faces.append(vid)
    if not verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _cells_mask(shape, cell_origins: np.ndarray, factor: int) -> np.ndarray:
    """Cubes the native masked scan visits: per cell origin ``o``, the
    cubes ``max(o - 1, 0) .. min(o + factor - 1, n - 1)`` on each axis."""
    n = np.asarray(shape) - 1
    mask = np.zeros(tuple(n), bool)
    for o in np.asarray(cell_origins, np.int64).reshape(-1, 3):
        lo = np.maximum(o - 1, 0)
        hi = np.minimum(o + factor - 1, n - 1) + 1
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    return mask


def marching_tetrahedra_cells(volume: np.ndarray, cell_origins: np.ndarray,
                              factor: int = 8, threshold: float = 0.5,
                              algorithm: str = "mt"):
    """The masked extraction in NumPy: only the cubes inside (or one cube
    before) the given cells, ``algorithm`` ``mt`` or ``mc``.  Index-space
    ``verts [V, 3]`` f32 and ``faces [F, 3]`` int32; vertices keyed by
    lattice edge, interpolated in float64, degenerate faces dropped.

    Args:
        cell_origins: ``[K, 3]`` voxel origins of the cells to scan.
    """
    vol = np.asarray(volume, np.float32)
    X, Y, Z = vol.shape
    flat = vol.reshape(-1)
    inside = flat > threshold
    ins3 = inside.reshape(X, Y, Z)
    any_in = np.zeros((X - 1, Y - 1, Z - 1), bool)
    all_in = np.ones_like(any_in)
    for dx, dy, dz in _CORNERS:
        c = ins3[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        any_in |= c
        all_in &= c
    cubes = any_in & ~all_in & _cells_mask(vol.shape, cell_origins, factor)
    mx, my, mz = np.nonzero(cubes)
    offs = (_CORNERS[:, 0] * Y + _CORNERS[:, 1]) * Z + _CORNERS[:, 2]
    cids = ((mx * Y + my) * Z + mz)[:, None] + offs[None, :]   # [n, 8]
    cins = inside[cids].astype(np.int64)
    if algorithm == "mc":
        units = [(cids, cins @ (1 << np.arange(8)), _MC_CASE_TABLE,
                  _MC_EDGES)]
    else:
        units = [(cids[:, tv], cins[:, tv] @ (1 << np.arange(4)),
                  _CASE_TABLE, _TET_EDGES) for tv in _TETS]
    keys = []
    for ids, case_of, table, edges in units:
        for case in np.unique(case_of):
            tris = np.asarray(table[case], np.int64).reshape(-1, 3)
            if not len(tris):
                continue
            sel = ids[case_of == case]                      # [n, corners]
            a, b = sel[:, edges[tris, 0]], sel[:, edges[tris, 1]]
            keys.append(np.stack([np.minimum(a, b), np.maximum(a, b)],
                                 -1).reshape(-1, 2))        # [n * t * 3, 2]
    if not keys:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    uniq, inv = np.unique(np.concatenate(keys), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    va, vb = flat[uniq[:, 0]].astype(np.float64), flat[uniq[:, 1]].astype(
        np.float64)
    t = np.clip((threshold - va) / (vb - va), 0.0, 1.0)

    def unflatten(i):
        return np.stack([i // (Y * Z), (i // Z) % Y, i % Z], 1).astype(
            np.float64)

    pa, pb = unflatten(uniq[:, 0]), unflatten(uniq[:, 1])
    verts = (pa + t[:, None] * (pb - pa)).astype(np.float32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]
