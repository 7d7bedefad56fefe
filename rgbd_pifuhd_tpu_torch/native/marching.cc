// Native marching tetrahedra: the host-side isosurface kernel.
//
// Same algorithm as recon/marching.py (6 positively-oriented tets per cube,
// case table passed in from Python so both paths share one derivation).
// Replaces the reference's skimage Cython marching-cubes dependency
// (reference mesh_util.py:84) with a dependency-free C++ kernel.
//
// Exposed as a C ABI for ctypes.  Work runs on a pool of threads: the scan
// splits the cubes (x-slabs or cell ranges) over the workers, each with its
// own buffers and its own open-addressing hash on the global lattice-edge
// key; the vertex merge across workers is sharded by the key's hash, one
// shard map per thread, and writes vertices and faces in the order of a
// serial merge (worker by worker, each worker's vertices in their order).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline uint64_t edge_hash(uint64_t k) { return k * 0x9E3779B97F4A7C15ull; }

// Fewer thread-local vertices than this in a step: the merge's phases run
// on the calling thread (waking the pool costs more than they take).
constexpr int64_t kPooledMergeMin = 1 << 14;
// Thread-local vertices per scan cell a session's first step expects.
constexpr int kFirstVertsPerCell = 32;

// Open-addressing map: edge key -> vertex index, key and value in one
// 16-byte slot (a probe reads one cache line).  The home slot is taken from
// the hash's top bits below the `skip` bits that pick a key's shard.  A slot
// is live while its epoch is the map's: `clear` empties the map by moving
// to the next epoch, whatever its size.
struct Slot {
  uint64_t key;
  int32_t val;
  uint32_t epoch;  // 0: never filled
};

struct EdgeMap {
  std::vector<Slot> slots;
  uint64_t mask = 0;
  int shift = 64;
  int skip = 0;
  uint32_t epoch = 1;
  size_t count = 0;
  int64_t grows = 0;    // doublings while inserting (the sizing fell short)
  int64_t resizes = 0;  // rehashes by reserve (sized before inserting)

  explicit EdgeMap(int skip_bits = 0) : skip(skip_bits) { reset(0); }

  // empty, with room for `expected` keys at most half full
  void reset(size_t expected) {
    int bits = 6;
    while (((size_t)1 << bits) < 2 * expected) ++bits;
    slots.assign((size_t)1 << bits, Slot{0, -1, 0});
    mask = ((uint64_t)1 << bits) - 1;
    shift = 64 - bits;
    epoch = 1;
    count = 0;
  }

  // empty, with room for `expected` keys: a new epoch if they fit
  void clear(size_t expected) {
    if (2 * expected > slots.size() || epoch == UINT32_MAX) {
      reset(expected);
      return;
    }
    ++epoch;
    count = 0;
  }

  bool live(const Slot* sl) const { return sl->epoch == epoch; }

  // the slot holding `key` (live), or the free slot where it belongs
  Slot* probe(uint64_t key, uint64_t h) {
    uint64_t i = (h << skip) >> shift;
    while (slots[i].epoch == epoch && slots[i].key != key) i = (i + 1) & mask;
    return &slots[i];
  }

  // fill the free slot `probe` returned; the caller reserved room
  void place(Slot* sl, uint64_t key, int32_t val) {
    *sl = Slot{key, val, epoch};
    ++count;
  }

  // fill, doubling the map once it is half full
  void insert(Slot* sl, uint64_t key, int32_t val) {
    place(sl, key, val);
    if (2 * count > slots.size()) {
      rehash(slots.size());
      ++grows;
    }
  }

  // room for `n` keys without a rehash while inserting
  void reserve(size_t n) {
    if (2 * n <= slots.size()) return;
    rehash(n);
    ++resizes;
  }

  void rehash(size_t expected) {
    std::vector<Slot> old;
    old.swap(slots);
    const uint32_t e = epoch;
    const size_t n = count;
    reset(expected > n ? expected : n);
    count = n;
    for (const Slot& s : old)
      if (s.epoch == e) *probe(s.key, edge_hash(s.key)) = {s.key, s.val, epoch};
  }
};

// One scan worker's output.  The buffers and the map persist across a
// session's steps (cleared, their capacity kept).
struct ThreadOut {
  std::vector<Vec3> verts;
  std::vector<uint64_t> keys;    // edge key per vertex (for the merge)
  std::vector<int32_t> faces;    // thread-local vertex indices
  std::vector<std::vector<int32_t>> by_shard;  // vertex ids per shard
  std::vector<int32_t> remap;    // vertex id -> merged index
  EdgeMap map;                   // thread-local dedup
  int shard_bits = 0;

  void begin(int bits, size_t expected_verts) {
    verts.clear();
    keys.clear();
    faces.clear();
    shard_bits = bits;
    by_shard.resize((size_t)1 << bits);
    for (auto& v : by_shard) v.clear();
    map.clear(expected_verts);
    map.grows = 0;
  }

  int shard_of(uint64_t h) const {
    return shard_bits ? (int)(h >> (64 - shard_bits)) : 0;
  }
};

// Fixed threads parked on a condition variable between jobs; the calling
// thread works too.  run(n, fn) calls fn(0) .. fn(n-1), each on whichever
// thread claims it, and returns when all have returned.
class Pool {
 public:
  explicit Pool(int n_threads) {
    for (int i = 1; i < n_threads; ++i)
      threads_.emplace_back([this] { loop(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    wake_.notify_all();
    for (auto& t : threads_) t.join();
  }

  int size() const { return (int)threads_.size() + 1; }

  // pooled == false (or one task): fn runs on the caller, in order
  void run(int n, const std::function<void(int)>& fn, bool pooled = true) {
    if (!pooled || n <= 1 || threads_.empty()) {
      for (int i = 0; i < n; ++i) fn(i);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &fn;
      n_ = n;
      next_.store(0, std::memory_order_relaxed);
      busy_ = (int)threads_.size();
      ++gen_;
    }
    wake_.notify_all();
    drain();
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [this] { return busy_ == 0; });
    job_ = nullptr;
  }

 private:
  void drain() {
    for (int i; (i = next_.fetch_add(1, std::memory_order_relaxed)) < n_;)
      (*job_)(i);
  }

  void loop() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return stop_ || gen_ != seen; });
      if (stop_) return;
      seen = gen_;
      lk.unlock();
      drain();
      lk.lock();
      if (--busy_ == 0) done_.notify_one();
    }
  }

  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable wake_, done_;
  const std::function<void(int)>* job_ = nullptr;
  int n_ = 0;
  std::atomic<int> next_{0};
  int busy_ = 0;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

int default_threads(int n_threads) {
  if (n_threads > 0) return n_threads;
  n_threads = (int)std::thread::hardware_concurrency();
  return n_threads > 0 ? n_threads : 1;
}

// log2 of the shard count: the least power of two >= n_threads, <= 64
int shard_bits_for(int n_threads) {
  int b = 0;
  while (b < 6 && (1 << b) < n_threads) ++b;
  return b;
}

// The sharded vertex merge.  Shard s's map holds the keys whose hash's top
// bits are s, with their merged vertex index; the maps persist across a
// session's steps, so a key seen in an earlier step resolves to its index.
//   resolve (phase A, a task per shard): every worker's vertices of the
//     shard, worker by worker, against the shard's map.  The first
//     occurrence of a new key owns it; later ones point at it.
//   write (phase B1, a task per worker): owners take the next indices in
//     worker order and write their vertex; (phase B2, a task per shard and
//     per worker) shards store their owners' indices in the map, workers
//     resolve their other vertices and write their faces.
struct VertexMerge {
  static constexpr int32_t kOwner = INT32_MIN;

  struct Fresh {
    int32_t t, i;  // the owner: worker, vertex id
    size_t slot;   // its slot in the shard's map
  };

  int shard_bits;
  std::vector<EdgeMap> shards;
  std::vector<std::vector<Fresh>> fresh;  // per shard: the step's new keys
  std::vector<int64_t> owned;             // [shard][worker] owner counts
  std::vector<int64_t> wbase, face_off;   // per worker
  int64_t total = 0;                      // vertices of earlier steps
  int64_t n_local = 0, n_new = 0, n_faces = 0;
  int nt = 0;
  bool pooled = false;

  explicit VertexMerge(int n_threads)
      : shard_bits(shard_bits_for(n_threads)),
        shards((size_t)1 << shard_bits, EdgeMap(shard_bits)),
        fresh((size_t)1 << shard_bits) {}

  int n_shards() const { return (int)shards.size(); }

  void resolve(Pool& pool, std::vector<ThreadOut>& outs, int n_workers) {
    nt = n_workers;
    const int S = n_shards();
    n_local = n_faces = 0;
    face_off.assign(nt, 0);
    for (int t = 0; t < nt; ++t) {
      face_off[t] = n_faces;
      n_local += (int64_t)outs[t].verts.size();
      n_faces += (int64_t)outs[t].faces.size() / 3;
    }
    pooled = n_local >= kPooledMergeMin && pool.size() > 1;
    owned.assign((size_t)S * nt, 0);
    pool.run(S, [&](int s) {
      EdgeMap& m = shards[s];
      size_t upper = 0;
      for (int t = 0; t < nt; ++t) upper += outs[t].by_shard[s].size();
      m.reserve(m.count + upper);  // no rehash below: slots stay put
      std::vector<Fresh>& fr = fresh[s];
      fr.clear();
      int64_t* own = owned.data() + (size_t)s * nt;
      for (int t = 0; t < nt; ++t) {
        ThreadOut& o = outs[t];
        for (const int32_t i : o.by_shard[s]) {
          const uint64_t key = o.keys[i];
          Slot* sl = m.probe(key, edge_hash(key));
          if (m.live(sl)) {  // an earlier step's index, or ~owner
            o.remap[i] = sl->val;
            continue;
          }
          m.place(sl, key, ~(int32_t)fr.size());
          fr.push_back({t, i, (size_t)(sl - m.slots.data())});
          o.remap[i] = kOwner;
          ++own[t];
        }
      }
    }, pooled);
    wbase.assign(nt, 0);
    n_new = 0;
    for (int t = 0; t < nt; ++t) {
      wbase[t] = total + n_new;
      for (int s = 0; s < S; ++s) n_new += owned[(size_t)s * nt + t];
    }
  }

  // verts: [n_new] of this step; faces: [n_faces, 3] merged indices
  void write(Pool& pool, std::vector<ThreadOut>& outs, Vec3* verts,
             int32_t* faces) {
    const int S = n_shards();
    pool.run(nt, [&](int t) {
      ThreadOut& o = outs[t];
      int64_t g = wbase[t];
      for (size_t i = 0; i < o.verts.size(); ++i) {
        if (o.remap[i] != kOwner) continue;
        verts[g - total] = o.verts[i];
        o.remap[i] = (int32_t)g++;
      }
    }, pooled);
    pool.run(S > nt ? S : nt, [&](int j) {
      if (j < S) {
        EdgeMap& m = shards[j];
        for (const Fresh& f : fresh[j])
          m.slots[f.slot].val = outs[f.t].remap[f.i];
      }
      if (j < nt) {
        ThreadOut& o = outs[j];
        for (size_t i = 0; i < o.verts.size(); ++i) {
          const int32_t r = o.remap[i];
          if (r >= 0) continue;
          const Fresh& f = fresh[o.shard_of(edge_hash(o.keys[i]))][~r];
          o.remap[i] = outs[f.t].remap[f.i];
        }
        int32_t* dst = faces + 3 * face_off[j];
        for (size_t k = 0; k < o.faces.size(); ++k)
          dst[k] = o.remap[o.faces[k]];
      }
    }, pooled);
    total += n_new;
  }

  int64_t map_resizes() const {
    int64_t n = 0;
    for (const EdgeMap& m : shards) n += m.resizes;
    return n;
  }
};

const int kTets[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
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

// process one cube at (x, y, z): emit triangles into `out`, dedup through
// its map.
// mc_cols == 0: marching TETRAHEDRA (case_table [16, 6], tet-edge ids).
// mc_cols  > 0: marching CUBES (case_table [256, mc_cols], cube-edge ids —
//               recon/marching.py _mc_table_packed, watertight by
//               construction; ~3x fewer verts/tris than tetrahedra).
template <typename Field>
static inline void process_cube(
    const Field& fld, float thresh,
    const int8_t* case_table, int mc_cols, int64_t x, int64_t y, int64_t z,
    ThreadOut& out) {
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
    const uint64_t h = edge_hash(key);
    Slot* sl = out.map.probe(key, h);
    if (out.map.live(sl)) return sl->val;
    const float va = vals[la];
    const float vb = vals[lb];
    float tt = (vb - va) != 0.f ? (thresh - va) / (vb - va) : 0.5f;
    if (tt < 0.f) tt = 0.f;
    if (tt > 1.f) tt = 1.f;
    const float ax_ = (float)(a / YZ), ay_ = (float)((a / Z) % Y),
                az_ = (float)(a % Z);
    const float bx_ = (float)(b / YZ), by_ = (float)((b / Z) % Y),
                bz_ = (float)(b % Z);
    const int32_t id = (int32_t)out.verts.size();
    out.verts.push_back(Vec3{ax_ + tt * (bx_ - ax_), ay_ + tt * (by_ - ay_),
                             az_ + tt * (bz_ - az_)});
    out.keys.push_back(key);
    out.by_shard[out.shard_of(h)].push_back(id);
    out.map.insert(sl, key, id);
    return id;
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

// Masked cube scan over a cell list with a caller-owned visited bitmap and
// per-cell L1 tiles on an X*Y*Z lattice: worker t scans its range of the
// list into outs[t], its map sized for `per_cell` vertices a cell.  Shared
// by the one-shot masked kernels (run_masked_scan) and the incremental
// session API (mt3_step), whose bitmap persists across calls.
template <typename Field>
static void scan_cells_into(const Field& fld, int64_t X, int64_t Y,
                            int64_t Z, int factor, float thresh,
                            const int8_t* case_table, int mc_cols,
                            Pool& pool, int n_threads, int shard_bits,
                            double per_cell, const int32_t* cells,
                            int64_t n_cells, unsigned char* vis,
                            std::vector<ThreadOut>& outs) {
  const int64_t ncx = X - 1, ncy = Y - 1, ncz = Z - 1;
  const bool single = n_threads == 1;
  pool.run(n_threads, [&](int t) {
    ThreadOut& out = outs[t];
    const int64_t c0 = n_cells * t / n_threads;
    const int64_t c1 = n_cells * (t + 1) / n_threads;
    out.begin(shard_bits, (size_t)(per_cell * (double)(c1 - c0)) + 64);
    const int64_t side = factor + 2;
    std::vector<float> tile(side * side * side);
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
                            Y, Z, Y * Z};
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
            process_cube(sf, thresh, case_table, mc_cols, x, y, z, out);
          }
    }
    out.remap.resize(out.verts.size());
  });
}

// A one-shot merge's output: malloc'd arrays the caller frees (mt_free).
static void merge_to_malloc(Pool& pool, std::vector<ThreadOut>& outs,
                            int n_workers, float** verts_out,
                            int64_t* n_verts, int32_t** faces_out,
                            int64_t* n_faces) {
  VertexMerge merge(n_workers);
  merge.resolve(pool, outs, n_workers);
  *n_verts = merge.n_new;
  *n_faces = merge.n_faces;
  *verts_out = (float*)std::malloc(merge.n_new ? merge.n_new * sizeof(Vec3)
                                               : 1);
  *faces_out = (int32_t*)std::malloc(
      merge.n_faces ? merge.n_faces * 3 * sizeof(int32_t) : 1);
  merge.write(pool, outs, (Vec3*)*verts_out, *faces_out);
}

// One-shot entry: fresh visited bitmap, the sharded merge, malloc'd output.
template <typename Field>
static void run_masked_scan(const Field& fld, int64_t X, int64_t Y,
                            int64_t Z, int factor, float thresh,
                            const int8_t* case_table, int mc_cols,
                            int n_threads, const int32_t* cells,
                            int64_t n_cells, float** verts_out,
                            int64_t* n_verts, int32_t** faces_out,
                            int64_t* n_faces) {
  n_threads = default_threads(n_threads);
  if ((int64_t)n_threads > n_cells)
    n_threads = (int)(n_cells > 0 ? n_cells : 1);
  const int64_t n_cubes = (X - 1) * (Y - 1) * (Z - 1);
  std::vector<unsigned char> visited((n_cubes + 7) / 8, 0);
  Pool pool(n_threads);
  std::vector<ThreadOut> outs(n_threads);
  scan_cells_into(fld, X, Y, Z, factor, thresh, case_table, mc_cols, pool,
                  n_threads, shard_bits_for(n_threads), kFirstVertsPerCell,
                  cells, n_cells, visited.data(), outs);
  merge_to_malloc(pool, outs, n_threads, verts_out, n_verts, faces_out,
                  n_faces);
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

// Counters of a session (mt3_stats), summed over its steps.
enum StatIndex {
  kSteps, kVertsLocal, kVertsNew, kVertsResolved, kMapGrows, kMapResizes,
  kMergesPooled, kNumStats
};

using Clock = std::chrono::steady_clock;

double secs_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

// Incremental marching session over the three-phase sparse field: the
// visited bitmap and the sharded edge-key -> GLOBAL-vertex-index maps
// persist across steps, so marching the cell list in slabs yields exactly
// the one-shot mesh (same dedup, same indices) while the caller overlaps
// device work (vertex coloring) with the next slab's host scan.  The pool
// is started once and parked between the phases of every step.
struct MT3Session {
  Sparse3Data data;
  SparseField3 fld;
  int64_t res;
  int factor;
  float thresh;
  std::vector<int8_t> case_table;
  int mc_cols;
  int n_threads;
  double first_per_cell;
  std::vector<unsigned char> visited;
  Pool pool;
  VertexMerge merge;
  std::vector<ThreadOut> outs;
  int64_t cells_seen = 0;
  bool pending = false;  // a step awaits mt3_take
  int64_t stats[kNumStats] = {};
  double scan_s = 0.0, merge_s = 0.0;

  explicit MT3Session(int n)
      : n_threads(n), pool(n), merge(n), outs(n) {}
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
  n_threads = default_threads(n_threads);
  const int64_t nx = X - 1;
  if (n_threads > nx) n_threads = (int)(nx > 0 ? nx : 1);

  Pool pool(n_threads);
  std::vector<ThreadOut> outs(n_threads);
  const int bits = shard_bits_for(n_threads);
  const DenseField fld{vol, Y, Z, YZ};
  pool.run(n_threads, [&](int t) {
    ThreadOut& out = outs[t];
    out.begin(bits, 1 << 15);
    const int64_t x0 = nx * t / n_threads;
    const int64_t x1 = nx * (t + 1) / n_threads;
    for (int64_t x = x0; x < x1; ++x)
      for (int64_t y = 0; y < Y - 1; ++y)
        for (int64_t z = 0; z < Z - 1; ++z)
          process_cube(fld, thresh, case_table, mc_cols, x, y, z, out);
    out.remap.resize(out.verts.size());
  });
  merge_to_malloc(pool, outs, n_threads, verts_out, n_verts, faces_out,
                  n_faces);
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
  const DenseField fld{vol, Y, Z, Y * Z};
  run_masked_scan(fld, X, Y, Z, factor, thresh, case_table, mc_cols,
                  n_threads, cells, n_cells, verts_out, n_verts, faces_out,
                  n_faces);
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
  const int nt = default_threads(n_threads);

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

  run_masked_scan(fld, res, res, res, factor, thresh, case_table, mc_cols,
                  nt, cells, n_cells, verts_out, n_verts, faces_out,
                  n_faces);
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
  const int nt = default_threads(n_threads);
  Sparse3Data d;
  build_sparse3_data(corner_q, top8_idx, K1, sub_q, top4_idx, K2, n,
                     pack_bits, band_scale, nt, d);
  const int per_byte = 8 / pack_bits;
  const SparseField3 fld{
      refined, d.block_of8.data(), d.block_of4.data(), d.fill8.data(),
      d.fill4.data(), d.lut.data(), n, res, res, res * res,
      (int64_t)(64 / per_byte), per_byte == 2};

  run_masked_scan(fld, res, res, res, factor, thresh, case_table, mc_cols,
                  nt, cells, n_cells, verts_out, n_verts, faces_out,
                  n_faces);
  return 0;
}

// The least thread-local vertex count of a step whose merge runs on the
// pool (fewer: on the calling thread).
int64_t mt_pooled_merge_min() { return kPooledMergeMin; }

// ---- incremental session API (slab-pipelined marching + coloring) ----
// mt3_begin builds the field views once and starts the session's pool;
// mt3_step marches one slab of the cell list and returns the counts of the
// NEW vertices it adds and of its faces, which mt3_take then writes into
// the caller's arrays (faces carry GLOBAL vertex indices, so concatenating
// every step's outputs reproduces the one-shot mt_run_sparse3 mesh
// exactly).  first_per_cell (<= 0: the default) is the thread-local
// vertices a scan cell the first step sizes its maps for; later steps take
// five times the session's own mean, if that is more.  The
// packed inputs (refined + the arrays referenced by Sparse3Data's build)
// are read during begin/step and must stay alive until mt3_end.
void* mt3_begin(const uint8_t* corner_q, const int32_t* top8_idx,
                int64_t K1, const uint8_t* sub_q, const int32_t* top4_idx,
                int64_t K2, const uint8_t* refined, int64_t n, int factor,
                int64_t res, int pack_bits, float band_scale, float thresh,
                const int8_t* case_table, int mc_cols, int n_threads,
                double first_per_cell) {
  if (factor != 8) return nullptr;
  MT3Session* s = new MT3Session(default_threads(n_threads));
  build_sparse3_data(corner_q, top8_idx, K1, sub_q, top4_idx, K2, n,
                     pack_bits, band_scale, s->n_threads, s->data);
  const int per_byte = 8 / pack_bits;
  s->fld = SparseField3{
      refined, s->data.block_of8.data(), s->data.block_of4.data(),
      s->data.fill8.data(), s->data.fill4.data(), s->data.lut.data(), n,
      res, res, res * res, (int64_t)(64 / per_byte), per_byte == 2};
  s->res = res;
  s->factor = factor;
  s->thresh = thresh;
  const size_t tbl = mc_cols > 0 ? (size_t)256 * mc_cols : (size_t)16 * 6;
  s->case_table.assign(case_table, case_table + tbl);
  s->mc_cols = mc_cols;
  s->first_per_cell = first_per_cell > 0 ? first_per_cell
                                         : (double)kFirstVertsPerCell;
  const int64_t n_cubes = (res - 1) * (res - 1) * (res - 1);
  s->visited.assign((n_cubes + 7) / 8, 0);
  return s;
}

int mt3_step(void* sess, const int32_t* cells, int64_t n_cells,
             int64_t* n_new_verts, int64_t* base_vert, int64_t* n_faces) {
  MT3Session* s = (MT3Session*)sess;
  if (!s || s->pending) return 1;
  int nt = s->n_threads;
  if ((int64_t)nt > n_cells) nt = (int)(n_cells > 0 ? n_cells : 1);
  // five times the session's mean so far, and no less than the first
  // step's estimate: the served meshes' last steps run at up to twice the
  // mean (the first step's mostly empty cells pull it down), and a worker's
  // range of cells at up to 2.3 times its step's
  const double mean = s->cells_seen
                          ? (double)s->stats[kVertsLocal] / s->cells_seen
                          : 0.0;
  const double per_cell =
      5.0 * mean > s->first_per_cell ? 5.0 * mean : s->first_per_cell;
  Clock::time_point t0 = Clock::now();
  scan_cells_into(s->fld, s->res, s->res, s->res, s->factor, s->thresh,
                  s->case_table.data(), s->mc_cols, s->pool, nt,
                  s->merge.shard_bits, per_cell, cells, n_cells,
                  s->visited.data(), s->outs);
  s->scan_s += secs_since(t0);
  t0 = Clock::now();
  VertexMerge& m = s->merge;
  const int64_t resizes = m.map_resizes();
  *base_vert = m.total;
  m.resolve(s->pool, s->outs, nt);
  s->merge_s += secs_since(t0);
  s->cells_seen += n_cells;
  s->stats[kSteps] += 1;
  s->stats[kVertsLocal] += m.n_local;
  s->stats[kVertsNew] += m.n_new;
  s->stats[kVertsResolved] += m.n_local - m.n_new;
  for (int t = 0; t < nt; ++t) s->stats[kMapGrows] += s->outs[t].map.grows;
  s->stats[kMapResizes] += m.map_resizes() - resizes;
  s->stats[kMergesPooled] += m.pooled ? 1 : 0;
  *n_new_verts = m.n_new;
  *n_faces = m.n_faces;
  s->pending = true;
  return 0;
}

// verts: float [n_new_verts, 3], faces: int32 [n_faces, 3] of the last step
int mt3_take(void* sess, float* verts, int32_t* faces) {
  MT3Session* s = (MT3Session*)sess;
  if (!s || !s->pending) return 1;
  const Clock::time_point t0 = Clock::now();
  s->merge.write(s->pool, s->outs, (Vec3*)verts, faces);
  s->merge_s += secs_since(t0);
  s->pending = false;
  return 0;
}

// counts: int64 [7] steps, thread-local vertices, new vertices, vertices
// resolved to an existing index, map grows while inserting, shard-map
// resizes before inserting, merges run on the pool; secs: [2] wall seconds
// of the scan and of the merge.
int mt3_stats(void* sess, int64_t* counts, double* secs) {
  const MT3Session* s = (const MT3Session*)sess;
  if (!s) return 1;
  for (int i = 0; i < kNumStats; ++i) counts[i] = s->stats[i];
  secs[0] = s->scan_s;
  secs[1] = s->merge_s;
  return 0;
}

void mt3_end(void* sess) { delete (MT3Session*)sess; }

void mt_free(void* p) { std::free(p); }

}  // extern "C"
