// Native marching tetrahedra: the host-side isosurface kernel.
//
// Same algorithm as recon/marching.py (6 positively-oriented tets per cube,
// case table passed in from Python so both paths share one derivation).
// Replaces the reference's skimage Cython marching-cubes dependency
// (reference mesh_util.py:84) with a dependency-free C++ kernel.
//
// Exposed as a C ABI for ctypes.  Parallelized over x-slabs with per-thread
// buffers; vertex dedup via a per-thread open-addressing hash on the global
// lattice-edge key, with a final cross-thread merge.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

namespace {

struct Vec3 {
  float x, y, z;
};

// open-addressing hash map: edge key (uint64) -> vertex index (int32)
struct EdgeMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit EdgeMap(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  void grow() {
    EdgeMap bigger(keys.size());
    for (size_t i = 0; i < keys.size(); ++i) {
      if (keys[i] != UINT64_MAX) bigger.insert_raw(keys[i], vals[i]);
    }
    keys.swap(bigger.keys);
    vals.swap(bigger.vals);
    mask = bigger.mask;
  }

  void insert_raw(uint64_t k, int32_t v) {
    uint64_t h = (k * 0x9E3779B97F4A7C15ull) & mask;
    while (keys[h] != UINT64_MAX) h = (h + 1) & mask;
    keys[h] = k;
    vals[h] = v;
  }

  size_t count = 0;

  // returns existing value, or -1 with the slot reserved for `put`
  int32_t find(uint64_t k) const {
    uint64_t h = (k * 0x9E3779B97F4A7C15ull) & mask;
    while (keys[h] != UINT64_MAX) {
      if (keys[h] == k) return vals[h];
      h = (h + 1) & mask;
    }
    return -1;
  }

  void put(uint64_t k, int32_t v) {
    if (2 * (count + 1) > keys.size()) grow();
    insert_raw(k, v);
    ++count;
  }
};

struct ThreadOut {
  std::vector<Vec3> verts;
  std::vector<uint64_t> vert_keys;  // edge key per vertex (for merge)
  std::vector<int32_t> faces;       // thread-local vertex indices
};

const int kTets[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};
// cube edges for the marching-cubes table (recon/marching.py _MC_EDGES)
const int kMCEdges[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0},
                             {4, 5}, {5, 6}, {6, 7}, {7, 4},
                             {0, 4}, {1, 5}, {2, 6}, {3, 7}};

// Scalar-field views: each exposes value3(x, y, z) + the lattice shape so
// process_cube is written once and instantiated per storage layout.

// dense res^3 (or X*Y*Z) float volume
struct DenseField {
  const float* vol;
  int64_t Y, Z, YZ;
  inline float value3(int64_t x, int64_t y, int64_t z) const {
    return vol[x * YZ + y * Z + z];
  }
};

// sparse two-phase result (grid.py eval_grid_two_phase_sparse): quantized
// corner-lattice fill per cell + packed quantized refined blocks.  Voxel
// reads dequantize through a (levels+1)-entry LUT — the dense volume is
// never materialized.
struct SparseField {
  const uint8_t* refined;   // [K, f3/per_byte] packed
  const int32_t* block_of;  // [n^3] cell -> refined row (or -1)
  const float* fill;        // [n^3] per-cell corner-interp fill
  const float* lut;         // [levels+1] dequantization table
  int64_t n, res, YZ;       // YZ = res*res (lattice is res^3)
  int64_t Y, Z;             // = res, res (id decode parity with DenseField)
  int fshift;               // log2(factor)
  int64_t fmask;            // factor-1
  int64_t f, f3, packed_w;
  bool nibble;              // 4-bit packing (two voxels/byte)

  inline float value3(int64_t x, int64_t y, int64_t z) const {
    const int64_t cx = x >> fshift, cy = y >> fshift, cz = z >> fshift;
    const int64_t cell = (cx * n + cy) * n + cz;
    const int32_t bi = block_of[cell];
    if (bi < 0) return fill[cell];
    const int64_t li =
        (((x & fmask) * f) + (y & fmask)) * f + (z & fmask);
    if (nibble) {
      const uint8_t b = refined[bi * packed_w + (li >> 1)];
      return lut[(li & 1) ? (b >> 4) : (b & 0x0F)];
    }
    return lut[refined[bi * f3 + li]];
  }
};

// three-level sparse result (grid.py eval_grid_three_phase_sparse):
// stride-8 fill -> stride-4 fill inside active cells -> packed 4^3 blocks.
struct SparseField3 {
  const uint8_t* refined;    // [K2, 64/per_byte] packed
  const int32_t* block_of8;  // [n^3] cell -> k1 row (or -1)
  const int32_t* block_of4;  // [K1*8] (k1*8+loc) -> refined row (or -1)
  const float* fill8;        // [n^3]
  const float* fill4;        // [K1*8]
  const float* lut;          // [levels+1]
  int64_t n;
  int64_t Y, Z, YZ;          // global lattice (res)
  int64_t packed_w;
  bool nibble;

  inline float value3(int64_t x, int64_t y, int64_t z) const {
    const int64_t cx = x >> 3, cy = y >> 3, cz = z >> 3;
    const int64_t cell = (cx * n + cy) * n + cz;
    const int32_t k1 = block_of8[cell];
    if (k1 < 0) return fill8[cell];
    const int64_t loc =
        (((x >> 2) & 1) << 2) | (((y >> 2) & 1) << 1) | ((z >> 2) & 1);
    const int32_t bi = block_of4[(int64_t)k1 * 8 + loc];
    if (bi < 0) return fill4[(int64_t)k1 * 8 + loc];
    const int64_t li = (((x & 3) * 4) + (y & 3)) * 4 + (z & 3);
    if (nibble) {
      const uint8_t b = refined[bi * packed_w + (li >> 1)];
      return lut[(li & 1) ? (b >> 4) : (b & 0x0F)];
    }
    return lut[refined[bi * 64 + li]];
  }
};

// cell-local cache over any field: the cube scan reads every voxel up to
// 8 times; staging one cell's voxels (plus a 1-voxel apron) into an
// L1-resident tile turns those repeats into array loads.
struct ScratchField {
  const float* scratch;
  int64_t ox, oy, oz;    // tile origin in lattice coords
  int64_t dy, dz;        // tile strides
  int64_t Y, Z, YZ;      // global lattice (for vertex ids in process_cube)
  inline float value3(int64_t x, int64_t y, int64_t z) const {
    return scratch[(x - ox) * dy + (y - oy) * dz + (z - oz)];
  }
};

// process one cube at (x, y, z): emit triangles into `out`, dedup via `map`.
// mc_cols == 0: marching TETRAHEDRA (case_table [16, 6], tet-edge ids).
// mc_cols  > 0: marching CUBES (case_table [256, mc_cols], cube-edge ids —
//               recon/marching.py _mc_table_packed, watertight by
//               construction; ~3x fewer verts/tris than tetrahedra).
template <typename Field>
static inline void process_cube(
    const Field& fld, float thresh,
    const int8_t* case_table, int mc_cols, int64_t x, int64_t y, int64_t z,
    ThreadOut& out, EdgeMap& map) {
  const int64_t YZ = fld.YZ, Y = fld.Y, Z = fld.Z;
  const int64_t base = x * YZ + y * Z + z;
  int64_t ids[8];
  ids[0] = base;
  ids[1] = base + YZ;
  ids[2] = base + YZ + Z;
  ids[3] = base + Z;
  ids[4] = base + 1;
  ids[5] = base + YZ + 1;
  ids[6] = base + YZ + Z + 1;
  ids[7] = base + Z + 1;
  float vals[8];
  bool ins[8];
  int sum = 0;
  // corner order matches ids[]: (kCorner with x-major id arithmetic)
  vals[0] = fld.value3(x, y, z);
  vals[1] = fld.value3(x + 1, y, z);
  vals[2] = fld.value3(x + 1, y + 1, z);
  vals[3] = fld.value3(x, y + 1, z);
  vals[4] = fld.value3(x, y, z + 1);
  vals[5] = fld.value3(x + 1, y, z + 1);
  vals[6] = fld.value3(x + 1, y + 1, z + 1);
  vals[7] = fld.value3(x, y + 1, z + 1);
  for (int i = 0; i < 8; ++i) {
    ins[i] = vals[i] > thresh;
    sum += ins[i];
  }
  if (sum == 0 || sum == 8) return;

  // shared vertex emission: global-lattice-edge dedup + interpolation
  auto edge_vert = [&](int la, int lb) -> int32_t {
    if (ids[la] > ids[lb]) { int tmp = la; la = lb; lb = tmp; }
    const int64_t a = ids[la], b = ids[lb];
    const uint64_t key = ((uint64_t)a << 32) | (uint64_t)(uint32_t)b;
    int32_t found = map.find(key);
    if (found < 0) {
      const float va = vals[la];
      const float vb = vals[lb];
      float tt = (vb - va) != 0.f ? (thresh - va) / (vb - va) : 0.5f;
      if (tt < 0.f) tt = 0.f;
      if (tt > 1.f) tt = 1.f;
      const float ax_ = (float)(a / YZ), ay_ = (float)((a / Z) % Y),
                  az_ = (float)(a % Z);
      const float bx_ = (float)(b / YZ), by_ = (float)((b / Z) % Y),
                  bz_ = (float)(b % Z);
      Vec3 v{ax_ + tt * (bx_ - ax_), ay_ + tt * (by_ - ay_),
             az_ + tt * (bz_ - az_)};
      out.verts.push_back(v);
      out.vert_keys.push_back(key);
      found = (int32_t)(out.verts.size() - 1);
      map.put(key, found);
    }
    return found;
  };
  auto emit = [&](int32_t v0, int32_t v1, int32_t v2) {
    if (v0 != v1 && v1 != v2 && v0 != v2) {
      out.faces.push_back(v0);
      out.faces.push_back(v1);
      out.faces.push_back(v2);
    }
  };

  if (mc_cols > 0) {  // marching cubes
    int c = 0;
    for (int i = 0; i < 8; ++i) c |= ins[i] ? (1 << i) : 0;
    const int8_t* row = case_table + (int64_t)c * mc_cols;
    for (int k = 0; k + 2 < mc_cols && row[k] >= 0; k += 3) {
      const int e0 = row[k], e1 = row[k + 1], e2 = row[k + 2];
      emit(edge_vert(kMCEdges[e0][0], kMCEdges[e0][1]),
           edge_vert(kMCEdges[e1][0], kMCEdges[e1][1]),
           edge_vert(kMCEdges[e2][0], kMCEdges[e2][1]));
    }
    return;
  }

  for (int tet = 0; tet < 6; ++tet) {  // marching tetrahedra
    const int* tv = kTets[tet];
    const int c = (ins[tv[0]] ? 1 : 0) | (ins[tv[1]] ? 2 : 0) |
                  (ins[tv[2]] ? 4 : 0) | (ins[tv[3]] ? 8 : 0);
    if (c == 0 || c == 15) continue;
    const int8_t* row = case_table + c * 6;
    for (int tri = 0; tri < 2; ++tri) {
      if (row[tri * 3] < 0) break;
      int32_t vid[3];
      for (int k = 0; k < 3; ++k) {
        const int e = row[tri * 3 + k];
        vid[k] = edge_vert(tv[kTetEdges[e][0]], tv[kTetEdges[e][1]]);
      }
      emit(vid[0], vid[1], vid[2]);
    }
  }
}

// cross-thread merge with global edge-key dedup
static void merge_outputs(std::vector<ThreadOut>& outs,
                          float** verts_out, int64_t* n_verts,
                          int32_t** faces_out, int64_t* n_faces) {
  if (outs.size() == 1) {
    // single worker: its map already deduplicated — straight copy-out
    ThreadOut& o = outs[0];
    *n_verts = (int64_t)o.verts.size();
    *n_faces = (int64_t)(o.faces.size() / 3);
    *verts_out = (float*)std::malloc(o.verts.size() * sizeof(Vec3));
    std::memcpy(*verts_out, o.verts.data(), o.verts.size() * sizeof(Vec3));
    *faces_out = (int32_t*)std::malloc(o.faces.size() * sizeof(int32_t));
    std::memcpy(*faces_out, o.faces.data(),
                o.faces.size() * sizeof(int32_t));
    return;
  }
  size_t total_v = 0, total_f = 0;
  for (auto& o : outs) {
    total_v += o.verts.size();
    total_f += o.faces.size();
  }
  EdgeMap gmap(total_v + 64);
  std::vector<Vec3> verts;
  verts.reserve(total_v);
  std::vector<int32_t> faces;
  faces.reserve(total_f);
  for (auto& o : outs) {
    std::vector<int32_t> remap(o.verts.size());
    for (size_t i = 0; i < o.verts.size(); ++i) {
      int32_t found = gmap.find(o.vert_keys[i]);
      if (found < 0) {
        verts.push_back(o.verts[i]);
        found = (int32_t)(verts.size() - 1);
        gmap.put(o.vert_keys[i], found);
      }
      remap[i] = found;
    }
    for (size_t i = 0; i < o.faces.size(); ++i)
      faces.push_back(remap[o.faces[i]]);
  }
  *n_verts = (int64_t)verts.size();
  *n_faces = (int64_t)(faces.size() / 3);
  *verts_out = (float*)std::malloc(verts.size() * sizeof(Vec3));
  std::memcpy(*verts_out, verts.data(), verts.size() * sizeof(Vec3));
  *faces_out = (int32_t*)std::malloc(faces.size() * sizeof(int32_t));
  std::memcpy(*faces_out, faces.data(), faces.size() * sizeof(int32_t));
}

// Masked cube scan over a cell list with a caller-owned visited bitmap and
// per-cell L1 tiles; per-thread outputs are appended to `outs`.  Shared by
// the one-shot sparse kernels (run_masked_scan) and the incremental
// session API (mt3_step), whose bitmap persists across calls.
template <typename Field>
static void scan_cells_into(const Field& fld, int64_t res, int factor,
                            float thresh, const int8_t* case_table,
                            int mc_cols, int n_threads,
                            const int32_t* cells,
                            int64_t n_cells, unsigned char* vis,
                            std::vector<ThreadOut>& outs) {
  const int64_t ncx = res - 1, ncy = res - 1, ncz = res - 1;
  std::vector<std::thread> threads;

  const bool single = n_threads == 1;
  auto worker = [&](int t) {
    ThreadOut& out = outs[t];
    EdgeMap map(1 << 14);
    const int64_t side = factor + 2;
    std::vector<float> tile(side * side * side);
    const int64_t c0 = n_cells * t / n_threads;
    const int64_t c1 = n_cells * (t + 1) / n_threads;
    for (int64_t ci = c0; ci < c1; ++ci) {
      const int64_t bx = cells[ci * 3 + 0];
      const int64_t by = cells[ci * 3 + 1];
      const int64_t bz = cells[ci * 3 + 2];
      const int64_t x0 = bx > 0 ? bx - 1 : 0;
      const int64_t y0 = by > 0 ? by - 1 : 0;
      const int64_t z0 = bz > 0 ? bz - 1 : 0;
      const int64_t x1 = bx + factor - 1 < ncx ? bx + factor - 1 : ncx - 1;
      const int64_t y1 = by + factor - 1 < ncy ? by + factor - 1 : ncy - 1;
      const int64_t z1 = bz + factor - 1 < ncz ? bz + factor - 1 : ncz - 1;
      // stage the cell + apron (cubes read voxels x0..x1+1 etc.),
      // tracking min/max for the cell-level early-out
      const int64_t ex = x1 + 1, ey = y1 + 1, ez = z1 + 1;
      const int64_t ddz = ez - z0 + 1, ddy = (ey - y0 + 1) * ddz;
      float mn = 2.f, mx = -1.f;
      for (int64_t x = x0; x <= ex; ++x)
        for (int64_t y = y0; y <= ey; ++y) {
          float* row = tile.data() + (x - x0) * ddy + (y - y0) * ddz;
          for (int64_t z = z0; z <= ez; ++z) {
            const float v = fld.value3(x, y, z);
            row[z - z0] = v;
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
          }
        }
      // whole tile on one side of the threshold: no cube here can emit a
      // triangle, and skipping the visited marks is safe (any overlapping
      // scan of these cubes also finds uniform corners and emits nothing)
      if (mn > thresh || mx <= thresh) continue;
      const ScratchField sf{tile.data(), x0, y0, z0, ddy, ddz,
                            res, res, res * res};
      for (int64_t x = x0; x <= x1; ++x)
        for (int64_t y = y0; y <= y1; ++y)
          for (int64_t z = z0; z <= z1; ++z) {
            const int64_t cid = (x * ncy + y) * ncz + z;
            const unsigned char bit = (unsigned char)(1u << (cid & 7));
            unsigned char prev;
            if (single) {  // no other writer: skip the lock-prefixed RMW
              prev = vis[cid >> 3];
              vis[cid >> 3] = (unsigned char)(prev | bit);
            } else {
              prev = __atomic_fetch_or(&vis[cid >> 3], bit,
                                       __ATOMIC_RELAXED);
            }
            if (prev & bit) continue;
            process_cube(sf, thresh, case_table, mc_cols, x, y, z, out,
                         map);
          }
    }
  };

  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
}

// One-shot entry: fresh visited bitmap, cross-thread merge, malloc'd output.
template <typename Field>
static void run_masked_scan(const Field& fld, int64_t res, int factor,
                            float thresh, const int8_t* case_table,
                            int mc_cols, int n_threads,
                            const int32_t* cells,
                            int64_t n_cells, float** verts_out,
                            int64_t* n_verts, int32_t** faces_out,
                            int64_t* n_faces) {
  const int64_t n_cubes = (res - 1) * (res - 1) * (res - 1);
  std::vector<unsigned char> visited((n_cubes + 7) / 8, 0);
  std::vector<ThreadOut> outs(n_threads);
  scan_cells_into(fld, res, factor, thresh, case_table, mc_cols, n_threads,
                  cells, n_cells, visited.data(), outs);
  merge_outputs(outs, verts_out, n_verts, faces_out, n_faces);
}

// Owning storage for the derived SparseField3 lookup arrays (the big
// packed inputs stay caller-owned).
struct Sparse3Data {
  std::vector<float> lut, fill8, fill4;
  std::vector<int32_t> block_of8, block_of4;
};

static void build_sparse3_data(const uint8_t* corner_q,
                               const int32_t* top8_idx, int64_t K1,
                               const uint8_t* sub_q,
                               const int32_t* top4_idx, int64_t K2,
                               int64_t n, int pack_bits, float band_scale,
                               int n_threads, Sparse3Data& d) {
  const int levels = (1 << pack_bits) - 1;
  d.lut.resize(levels + 1);
  for (int q = 0; q <= levels; ++q)
    d.lut[q] = ((float)q / (float)levels - 0.5f) / band_scale + 0.5f;

  const int64_t n3 = n * n * n;
  const int64_t n1 = n + 1;
  d.block_of8.assign(n3, -1);
  for (int64_t k = 0; k < K1; ++k) d.block_of8[top8_idx[k]] = (int32_t)k;
  d.block_of4.assign(K1 * 8, -1);
  for (int64_t k = 0; k < K2; ++k) d.block_of4[top4_idx[k]] = (int32_t)k;

  // fill8 from the stride-8 corner lattice
  d.fill8.resize(n3);
  {
    std::vector<std::thread> ths;
    const int nt = n_threads;
    auto fw = [&](int t) {
      const int64_t c0 = n3 * t / nt, c1 = n3 * (t + 1) / nt;
      for (int64_t cidx = c0; cidx < c1; ++cidx) {
        const int64_t cx = cidx / (n * n), cy = (cidx / n) % n,
                      cz = cidx % n;
        float mn = 2.f, mx = -1.f;
        for (int dx = 0; dx < 2; ++dx)
          for (int dy = 0; dy < 2; ++dy)
            for (int dz = 0; dz < 2; ++dz) {
              const float v =
                  d.lut[corner_q[((cx + dx) * n1 + (cy + dy)) * n1
                                 + (cz + dz)]];
              mn = v < mn ? v : mn;
              mx = v > mx ? v : mx;
            }
        d.fill8[cidx] = 0.5f * (mn + mx);
      }
    };
    for (int t = 0; t < nt; ++t) ths.emplace_back(fw, t);
    for (auto& th : ths) th.join();
  }

  // fill4 from each active cell's 3x3x3 stride-4 lattice (sub_q [K1, 27])
  d.fill4.resize(K1 * 8);
  for (int64_t k = 0; k < K1; ++k) {
    const uint8_t* s = sub_q + k * 27;
    for (int loc = 0; loc < 8; ++loc) {
      const int sx = (loc >> 2) & 1, sy = (loc >> 1) & 1, sz = loc & 1;
      float mn = 2.f, mx = -1.f;
      for (int dx = 0; dx < 2; ++dx)
        for (int dy = 0; dy < 2; ++dy)
          for (int dz = 0; dz < 2; ++dz) {
            const float v =
                d.lut[s[((sx + dx) * 3 + (sy + dy)) * 3 + (sz + dz)]];
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
          }
      d.fill4[k * 8 + loc] = 0.5f * (mn + mx);
    }
  }
}

// Incremental marching session over the three-phase sparse field: the
// visited bitmap and the edge-key -> GLOBAL-vertex-index map persist
// across step calls, so marching the cell list in slabs yields exactly
// the one-shot mesh (same dedup, same indices) while the caller overlaps
// device work (vertex coloring) with the next slab's host scan.
struct MT3Session {
  Sparse3Data data;
  SparseField3 fld;
  const uint8_t* refined;  // caller-owned; must outlive the session
  int64_t res;
  int factor;
  float thresh;
  std::vector<int8_t> case_table;
  int mc_cols;
  int n_threads;
  std::vector<unsigned char> visited;
  EdgeMap gmap{1 << 15};
  int64_t total_verts = 0;
};

}  // namespace

extern "C" {

// case_table: int8[16*6]; triangle edge ids, -1 padded (2 tris max/case).
// Returns 0 on success.  Caller frees *verts_out / *faces_out with mt_free.
int mt_run(const float* vol, int64_t X, int64_t Y, int64_t Z, float thresh,
           const int8_t* case_table, int mc_cols, int n_threads,
           float** verts_out, int64_t* n_verts, int32_t** faces_out,
           int64_t* n_faces) {
  const int64_t YZ = Y * Z;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  const int64_t nx = X - 1;
  if (n_threads > nx) n_threads = (int)nx;

  std::vector<ThreadOut> outs(n_threads);
  std::vector<std::thread> threads;
  const DenseField fld{vol, Y, Z, YZ};

  auto worker = [&](int t) {
    ThreadOut& out = outs[t];
    EdgeMap map(1 << 16);
    const int64_t x0 = nx * t / n_threads;
    const int64_t x1 = nx * (t + 1) / n_threads;

    for (int64_t x = x0; x < x1; ++x)
      for (int64_t y = 0; y < Y - 1; ++y)
        for (int64_t z = 0; z < Z - 1; ++z)
          process_cube(fld, thresh, case_table, mc_cols, x, y, z, out,
                       map);
  };

  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();

  merge_outputs(outs, verts_out, n_verts, faces_out, n_faces);
  return 0;
}

// Masked variant: process only the cubes of the given cells (voxel-origin
// triples, each covering factor^3 voxels) plus a one-cube overlap on the
// low side of each axis so crossings on cell borders into fill regions are
// caught.  A shared visited bitmap (atomic fetch-or) prevents duplicate
// cube emission when overlapping ranges collide across cells/threads.
int mt_run_cells(const float* vol, int64_t X, int64_t Y, int64_t Z,
                 float thresh, const int8_t* case_table, int mc_cols,
                 int n_threads,
                 const int32_t* cells, int64_t n_cells, int factor,
                 float** verts_out, int64_t* n_verts, int32_t** faces_out,
                 int64_t* n_faces) {
  const int64_t YZ = Y * Z;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if ((int64_t)n_threads > n_cells) n_threads = (int)(n_cells > 0 ? n_cells : 1);

  const int64_t ncx = X - 1, ncy = Y - 1, ncz = Z - 1;
  const int64_t n_cubes = ncx * ncy * ncz;
  std::vector<unsigned char> visited((n_cubes + 7) / 8, 0);
  unsigned char* vis = visited.data();

  std::vector<ThreadOut> outs(n_threads);
  std::vector<std::thread> threads;
  const DenseField fld{vol, Y, Z, YZ};

  auto worker = [&](int t) {
    ThreadOut& out = outs[t];
    EdgeMap map(1 << 14);
    const int64_t c0 = n_cells * t / n_threads;
    const int64_t c1 = n_cells * (t + 1) / n_threads;
    for (int64_t ci = c0; ci < c1; ++ci) {
      const int64_t bx = cells[ci * 3 + 0];
      const int64_t by = cells[ci * 3 + 1];
      const int64_t bz = cells[ci * 3 + 2];
      const int64_t x0 = bx > 0 ? bx - 1 : 0;
      const int64_t y0 = by > 0 ? by - 1 : 0;
      const int64_t z0 = bz > 0 ? bz - 1 : 0;
      const int64_t x1 = bx + factor - 1 < ncx ? bx + factor - 1 : ncx - 1;
      const int64_t y1 = by + factor - 1 < ncy ? by + factor - 1 : ncy - 1;
      const int64_t z1 = bz + factor - 1 < ncz ? bz + factor - 1 : ncz - 1;
      for (int64_t x = x0; x <= x1; ++x)
        for (int64_t y = y0; y <= y1; ++y)
          for (int64_t z = z0; z <= z1; ++z) {
            const int64_t cid = (x * ncy + y) * ncz + z;
            const unsigned char bit = (unsigned char)(1u << (cid & 7));
            const unsigned char prev =
                __atomic_fetch_or(&vis[cid >> 3], bit, __ATOMIC_RELAXED);
            if (prev & bit) continue;  // already claimed
            process_cube(fld, thresh, case_table, mc_cols, x, y, z, out,
                       map);
          }
    }
  };

  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();

  merge_outputs(outs, verts_out, n_verts, faces_out, n_faces);
  return 0;
}

// Sparse-direct variant: extract the surface STRAIGHT from the quantized
// two-phase result (grid.py eval_grid_two_phase_sparse) — the dense res^3
// volume (536 MB at 512^3) is never materialized.  Voxel reads go through
// SparseField: refined top-K cells read packed 4/8-bit blocks via a
// dequantization LUT; all other cells read their constant corner-interp
// fill.  Produces the identical mesh to densify + mt_run_cells.
//
// corner_q: [(n+1)^3] uint8 quantized corner lattice
// top_idx:  [K] int32 refined cell linear ids
// refined:  [K, f^3 / (8/pack_bits)] uint8 packed blocks
// cells:    [n_cells, 3] int32 voxel origins of cells worth scanning
int mt_run_sparse(const uint8_t* corner_q, const int32_t* top_idx,
                  int64_t K, const uint8_t* refined,
                  int64_t n, int factor, int64_t res,
                  int pack_bits, float band_scale, float thresh,
                  const int8_t* case_table, int mc_cols, int n_threads,
                  const int32_t* cells, int64_t n_cells,
                  float** verts_out, int64_t* n_verts, int32_t** faces_out,
                  int64_t* n_faces) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if ((int64_t)n_threads > n_cells) n_threads = (int)(n_cells > 0 ? n_cells : 1);

  // --- precompute: dequant LUT, cell->block map, per-cell fill ---------
  const int levels = (1 << pack_bits) - 1;
  std::vector<float> lut(levels + 1);
  for (int q = 0; q <= levels; ++q)
    lut[q] = ((float)q / (float)levels - 0.5f) / band_scale + 0.5f;

  const int64_t n3 = n * n * n;
  std::vector<int32_t> block_of(n3, -1);
  for (int64_t k = 0; k < K; ++k) block_of[top_idx[k]] = (int32_t)k;

  const int64_t n1 = n + 1;
  std::vector<float> fill(n3);
  {
    std::vector<std::thread> ths;
    const int nt = n_threads;
    auto fw = [&](int t) {
      const int64_t c0 = n3 * t / nt, c1 = n3 * (t + 1) / nt;
      for (int64_t c = c0; c < c1; ++c) {
        const int64_t cx = c / (n * n), cy = (c / n) % n, cz = c % n;
        float mn = 2.f, mx = -1.f;
        for (int dx = 0; dx < 2; ++dx)
          for (int dy = 0; dy < 2; ++dy)
            for (int dz = 0; dz < 2; ++dz) {
              const float v = lut[corner_q[((cx + dx) * n1 + (cy + dy)) * n1
                                           + (cz + dz)]];
              mn = v < mn ? v : mn;
              mx = v > mx ? v : mx;
            }
        fill[c] = 0.5f * (mn + mx);
      }
    };
    for (int t = 0; t < nt; ++t) ths.emplace_back(fw, t);
    for (auto& th : ths) th.join();
  }

  int fshift = 0;
  while ((1 << fshift) < factor) ++fshift;
  const int per_byte = 8 / pack_bits;
  const int64_t f3 = (int64_t)factor * factor * factor;
  const SparseField fld{
      refined, block_of.data(), fill.data(), lut.data(),
      n, res, res * res, res, res,
      fshift, (int64_t)factor - 1,
      (int64_t)factor, f3, f3 / per_byte, per_byte == 2};

  run_masked_scan(fld, res, factor, thresh, case_table, mc_cols,
                  n_threads, cells, n_cells, verts_out, n_verts,
                  faces_out, n_faces);
  return 0;
}

// Three-level variant: surface straight from the stride-8/4/1 sparse
// result.  Same masked scan; the field accessor resolves each voxel
// through fill8 -> fill4 -> packed block.
int mt_run_sparse3(const uint8_t* corner_q, const int32_t* top8_idx,
                   int64_t K1, const uint8_t* sub_q,
                   const int32_t* top4_idx, int64_t K2,
                   const uint8_t* refined,
                   int64_t n, int factor, int64_t res,
                   int pack_bits, float band_scale, float thresh,
                   const int8_t* case_table, int mc_cols, int n_threads,
                   const int32_t* cells, int64_t n_cells,
                   float** verts_out, int64_t* n_verts, int32_t** faces_out,
                   int64_t* n_faces) {
  if (factor != 8) return 2;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if ((int64_t)n_threads > n_cells)
    n_threads = (int)(n_cells > 0 ? n_cells : 1);

  Sparse3Data d;
  build_sparse3_data(corner_q, top8_idx, K1, sub_q, top4_idx, K2, n,
                     pack_bits, band_scale, n_threads, d);
  const int per_byte = 8 / pack_bits;
  const SparseField3 fld{
      refined, d.block_of8.data(), d.block_of4.data(), d.fill8.data(),
      d.fill4.data(), d.lut.data(), n, res, res, res * res,
      (int64_t)(64 / per_byte), per_byte == 2};

  run_masked_scan(fld, res, factor, thresh, case_table, mc_cols,
                  n_threads, cells, n_cells, verts_out, n_verts,
                  faces_out, n_faces);
  return 0;
}

// ---- incremental session API (slab-pipelined marching + coloring) ----
// mt3_begin builds the field views once; mt3_step marches one slab of the
// cell list and returns only the NEW vertices it appended (faces carry
// GLOBAL vertex indices, so concatenating every step's outputs reproduces
// the one-shot mt_run_sparse3 mesh exactly).  The packed inputs
// (refined + the arrays referenced by Sparse3Data's build) are read during
// begin/step and must stay alive until mt3_end.
void* mt3_begin(const uint8_t* corner_q, const int32_t* top8_idx,
                int64_t K1, const uint8_t* sub_q, const int32_t* top4_idx,
                int64_t K2, const uint8_t* refined, int64_t n, int factor,
                int64_t res, int pack_bits, float band_scale, float thresh,
                const int8_t* case_table, int mc_cols, int n_threads) {
  if (factor != 8) return nullptr;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  MT3Session* s = new MT3Session();
  build_sparse3_data(corner_q, top8_idx, K1, sub_q, top4_idx, K2, n,
                     pack_bits, band_scale, n_threads, s->data);
  const int per_byte = 8 / pack_bits;
  s->fld = SparseField3{
      refined, s->data.block_of8.data(), s->data.block_of4.data(),
      s->data.fill8.data(), s->data.fill4.data(), s->data.lut.data(), n,
      res, res, res * res, (int64_t)(64 / per_byte), per_byte == 2};
  s->refined = refined;
  s->res = res;
  s->factor = factor;
  s->thresh = thresh;
  const size_t tbl = mc_cols > 0 ? (size_t)256 * mc_cols : (size_t)16 * 6;
  s->case_table.assign(case_table, case_table + tbl);
  s->mc_cols = mc_cols;
  s->n_threads = n_threads;
  const int64_t n_cubes = (res - 1) * (res - 1) * (res - 1);
  s->visited.assign((n_cubes + 7) / 8, 0);
  return s;
}

int mt3_step(void* sess, const int32_t* cells, int64_t n_cells,
             float** new_verts, int64_t* n_new_verts, int64_t* base_vert,
             int32_t** faces_out, int64_t* n_faces) {
  MT3Session* s = (MT3Session*)sess;
  if (!s) return 1;
  int nt = s->n_threads;
  if ((int64_t)nt > n_cells) nt = (int)(n_cells > 0 ? n_cells : 1);
  std::vector<ThreadOut> outs(nt);
  scan_cells_into(s->fld, s->res, s->factor, s->thresh,
                  s->case_table.data(), s->mc_cols, nt, cells, n_cells,
                  s->visited.data(), outs);
  // merge this step's thread outputs through the SESSION-global edge map:
  // verts already seen in an earlier step (shared slab-boundary edges)
  // resolve to their existing global index; new ones are appended.
  *base_vert = s->total_verts;
  std::vector<Vec3> verts;
  std::vector<int32_t> faces;
  for (auto& o : outs) {
    std::vector<int32_t> remap(o.verts.size());
    for (size_t i = 0; i < o.verts.size(); ++i) {
      int32_t found = s->gmap.find(o.vert_keys[i]);
      if (found < 0) {
        verts.push_back(o.verts[i]);
        found = (int32_t)(s->total_verts + (int64_t)verts.size() - 1);
        s->gmap.put(o.vert_keys[i], found);
      }
      remap[i] = found;
    }
    for (size_t i = 0; i < o.faces.size(); ++i)
      faces.push_back(remap[o.faces[i]]);
  }
  s->total_verts += (int64_t)verts.size();
  *n_new_verts = (int64_t)verts.size();
  *n_faces = (int64_t)(faces.size() / 3);
  *new_verts = (float*)std::malloc(
      verts.size() * sizeof(Vec3) > 0 ? verts.size() * sizeof(Vec3) : 1);
  std::memcpy(*new_verts, verts.data(), verts.size() * sizeof(Vec3));
  *faces_out = (int32_t*)std::malloc(
      faces.size() * sizeof(int32_t) > 0 ? faces.size() * sizeof(int32_t)
                                         : 1);
  std::memcpy(*faces_out, faces.data(), faces.size() * sizeof(int32_t));
  return 0;
}

void mt3_end(void* sess) { delete (MT3Session*)sess; }

void mt_free(void* p) { std::free(p); }

}  // extern "C"
