// Native host kernels for volume reassembly and mesh IO.
//
// - densify: rebuild the dense occupancy volume from the sparse two-phase
//   result (recon/grid.py eval_grid_two_phase_sparse).  NumPy's advanced-
//   indexing block writes take 10-25s for this on one core; this loop is
//   memory-bound (~0.1s).
// - obj_write: OBJ export with per-vertex colors and the reference's
//   flipped winding (mesh_util.py:189-198).  Python f-string formatting
//   costs ~8s/Mvert; this is ~0.3s.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// vol: res^3 float32 (preallocated, uninitialized ok)
// fill: n^3 float32 per-cell fill values
// marks: n^3 uint8 (1 = materialize this cell's fill)
// top_idx: [K] int32 linear cell ids; refined: [K, f^3] float32 (unquantized)
void densify(float* vol, int64_t res, const float* fill,
             const uint8_t* marks, int64_t n, int factor,
             const int32_t* top_idx, int64_t K, const float* refined,
             int n_threads) {
  const int64_t f = factor;
  const int64_t res2 = res * res;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  // sequential prefault: scattered first-touch page faults are pathologically
  // slow where page faults are costly; one linear pass maps the buffer cheaply
  std::memset(vol, 0, (size_t)(res * res2) * sizeof(float));

  auto fill_worker = [&](int t, int nt) {
    const int64_t total = n * n * n;
    const int64_t c0 = total * t / nt;
    const int64_t c1 = total * (t + 1) / nt;
    for (int64_t c = c0; c < c1; ++c) {
      if (!marks[c]) continue;
      const int64_t cx = c / (n * n), cy = (c / n) % n, cz = c % n;
      const float v = fill[c];
      const int64_t bx = cx * f, by = cy * f, bz = cz * f;
      for (int64_t x = 0; x < f; ++x)
        for (int64_t y = 0; y < f; ++y) {
          float* row = vol + (bx + x) * res2 + (by + y) * res + bz;
          for (int64_t z = 0; z < f; ++z) row[z] = v;
        }
    }
  };
  auto refined_worker = [&](int t, int nt) {
    const int64_t c0 = K * t / nt;
    const int64_t c1 = K * (t + 1) / nt;
    const int64_t f3 = f * f * f;
    for (int64_t k = c0; k < c1; ++k) {
      const int64_t c = top_idx[k];
      const int64_t cx = c / (n * n), cy = (c / n) % n, cz = c % n;
      const int64_t bx = cx * f, by = cy * f, bz = cz * f;
      const float* src = refined + k * f3;
      for (int64_t x = 0; x < f; ++x)
        for (int64_t y = 0; y < f; ++y) {
          std::memcpy(vol + (bx + x) * res2 + (by + y) * res + bz,
                      src + (x * f + y) * f, f * sizeof(float));
        }
    }
  };

  std::vector<std::thread> ths;
  for (int t = 0; t < n_threads; ++t) ths.emplace_back(fill_worker, t,
                                                       n_threads);
  for (auto& th : ths) th.join();
  ths.clear();
  for (int t = 0; t < n_threads; ++t) ths.emplace_back(refined_worker, t,
                                                       n_threads);
  for (auto& th : ths) th.join();
}

// ---- fast fixed-point/int text formatting (printf %.4f costs ~1us/value;
// these run ~20x faster, and OBJ writing is on the per-mesh critical path)

// append signed value with exactly 4 decimals; returns new cursor
static inline char* fmt_fixed4(char* p, double x) {
  if (x < 0) { *p++ = '-'; x = -x; }
  // round to 4 decimals in integer space
  uint64_t q = (uint64_t)(x * 10000.0 + 0.5);
  uint64_t ip = q / 10000, fp_ = q % 10000;
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + ip % 10); ip /= 10; } while (ip);
  while (n) *p++ = tmp[--n];
  *p++ = '.';
  *p++ = (char)('0' + fp_ / 1000);
  *p++ = (char)('0' + (fp_ / 100) % 10);
  *p++ = (char)('0' + (fp_ / 10) % 10);
  *p++ = (char)('0' + fp_ % 10);
  return p;
}

static inline char* fmt_int(char* p, int64_t v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// out[i] = M[:3,:3] @ pts[i] + M[:3,3], f32 in/out, double 3x4 matrix
// (row-major).  NumPy's equivalent matmul on a fresh multi-MB temp costs
// seconds where page faults are costly; this is one fused cache-friendly pass.
void transform_affine(const float* pts, int64_t n, const double* m,
                      float* out, int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  const double m00 = m[0], m01 = m[1], m02 = m[2], m03 = m[3];
  const double m10 = m[4], m11 = m[5], m12 = m[6], m13 = m[7];
  const double m20 = m[8], m21 = m[9], m22 = m[10], m23 = m[11];
  std::vector<std::thread> ths;
  for (int t = 0; t < n_threads; ++t)
    ths.emplace_back([&, t] {
      const int64_t i0 = n * t / n_threads, i1 = n * (t + 1) / n_threads;
      for (int64_t i = i0; i < i1; ++i) {
        const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
        out[i * 3] = (float)(m00 * x + m01 * y + m02 * z + m03);
        out[i * 3 + 1] = (float)(m10 * x + m11 * y + m12 * z + m13);
        out[i * 3 + 2] = (float)(m20 * x + m21 * y + m22 * z + m23);
      }
    });
  for (auto& th : ths) th.join();
}

// Fused bbox + uint16 fixed-point quantization of vertex positions (the
// host->device side of the coloring chunks, recon/pipeline._chunked).
// NumPy needs 4+ full passes with multi-MB temporaries (min, max,
// subtract, divide, round, cast); this is two cache-friendly passes.
// lo_out/scale_out: float[3]; out: uint16[n*3] (caller-allocated).
void bbox_quantize_u16(const float* verts, int64_t n, float* lo_out,
                       float* scale_out, uint16_t* out, int n_threads) {
  if (n <= 0) return;
  float lo[3] = {verts[0], verts[1], verts[2]};
  float hi[3] = {verts[0], verts[1], verts[2]};
  for (int64_t i = 1; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      const float v = verts[i * 3 + k];
      lo[k] = v < lo[k] ? v : lo[k];
      hi[k] = v > hi[k] ? v : hi[k];
    }
  }
  float inv[3], scale[3];
  for (int k = 0; k < 3; ++k) {
    scale[k] = (hi[k] - lo[k]) / 65535.0f;
    if (scale[k] < 1e-12f) scale[k] = 1e-12f;
    inv[k] = 1.0f / scale[k];
    lo_out[k] = lo[k];
    scale_out[k] = scale[k];
  }
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < n_threads; ++t)
    ths.emplace_back([&, t] {
      const int64_t i0 = n * t / n_threads, i1 = n * (t + 1) / n_threads;
      for (int64_t i = i0; i < i1; ++i)
        for (int k = 0; k < 3; ++k) {
          const float q =
              (verts[i * 3 + k] - lo[k]) * inv[k] + 0.5f;  // round-half-up
          out[i * 3 + k] = (uint16_t)(q < 0.f ? 0.f
                                              : (q > 65535.f ? 65535.f : q));
        }
    });
  for (auto& th : ths) th.join();
}

// OBJ export: v lines (with optional rgb), f lines with flipped winding
// (reference save_obj_mesh_with_color, mesh_util.py:189-198).
// Lines are formatted into per-thread buffers in parallel, then written
// sequentially.  Returns 0 on success.
int obj_write(const char* path, const float* verts, const float* colors,
              int64_t nv, const int32_t* faces, int64_t nf) {
  FILE* fp = std::fopen(path, "w");
  if (!fp) return 1;

  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > 8) n_threads = 8;

  // chunk work: [0, nv) vertex lines then [0, nf) face lines
  const int64_t total = nv + nf;
  std::vector<std::vector<char>> bufs(n_threads);
  auto worker = [&](int t) {
    const int64_t i0 = total * t / n_threads;
    const int64_t i1 = total * (t + 1) / n_threads;
    std::vector<char>& out = bufs[t];
    // worst case ~90 bytes/line
    out.reserve((size_t)(i1 - i0) * 90 + 64);
    char line[192];
    for (int64_t i = i0; i < i1; ++i) {
      char* p = line;
      if (i < nv) {
        const float* v = verts + i * 3;
        *p++ = 'v'; *p++ = ' ';
        p = fmt_fixed4(p, v[0]); *p++ = ' ';
        p = fmt_fixed4(p, v[1]); *p++ = ' ';
        p = fmt_fixed4(p, v[2]);
        if (colors) {
          const float* c = colors + i * 3;
          *p++ = ' ';
          p = fmt_fixed4(p, c[0]); *p++ = ' ';
          p = fmt_fixed4(p, c[1]); *p++ = ' ';
          p = fmt_fixed4(p, c[2]);
        }
      } else {
        const int32_t* f = faces + (i - nv) * 3;
        *p++ = 'f'; *p++ = ' ';
        p = fmt_int(p, (int64_t)f[0] + 1); *p++ = ' ';
        p = fmt_int(p, (int64_t)f[2] + 1); *p++ = ' ';  // flipped winding
        p = fmt_int(p, (int64_t)f[1] + 1);
      }
      *p++ = '\n';
      out.insert(out.end(), line, p);
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < n_threads; ++t) ths.emplace_back(worker, t);
  for (auto& th : ths) th.join();

  for (auto& b : bufs) {
    if (!b.empty() && std::fwrite(b.data(), 1, b.size(), fp) != b.size()) {
      std::fclose(fp);
      return 1;
    }
  }
  std::fclose(fp);
  return 0;
}

// Format the face block ("f a c b\n" lines, flipped winding) into one
// malloc'd text buffer WITHOUT writing it — lets the caller format faces
// while the vertex colors are still being computed on the device; the
// streamed writer (obj_finish) appends it after the last vertex group.
// Free with meshio_free.
int obj_format_faces(const int32_t* faces, int64_t nf, char** out,
                     int64_t* out_len) {
  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  std::vector<std::vector<char>> bufs(n_threads);
  auto worker = [&](int t) {
    const int64_t i0 = nf * t / n_threads;
    const int64_t i1 = nf * (t + 1) / n_threads;
    std::vector<char>& b = bufs[t];
    b.reserve((size_t)(i1 - i0) * 36 + 64);
    char line[96];
    for (int64_t i = i0; i < i1; ++i) {
      const int32_t* f = faces + i * 3;
      char* p = line;
      *p++ = 'f'; *p++ = ' ';
      p = fmt_int(p, (int64_t)f[0] + 1); *p++ = ' ';
      p = fmt_int(p, (int64_t)f[2] + 1); *p++ = ' ';  // flipped winding
      p = fmt_int(p, (int64_t)f[1] + 1);
      *p++ = '\n';
      b.insert(b.end(), line, p);
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < n_threads; ++t) ths.emplace_back(worker, t);
  for (auto& th : ths) th.join();
  size_t total = 0;
  for (auto& b : bufs) total += b.size();
  char* buf = (char*)std::malloc(total ? total : 1);
  if (!buf) return 1;
  size_t off = 0;
  for (auto& b : bufs) {
    std::memcpy(buf + off, b.data(), b.size());
    off += b.size();
  }
  *out = buf;
  *out_len = (int64_t)total;
  return 0;
}

// ---- Streamed OBJ writing -------------------------------------------
// The vertex colors arrive from the device in macro-groups (the color
// MLP taps are dispatched in up to 4 chunks, pipeline._chunked_start);
// these entry points let the caller WRITE group g's vertex lines while
// group g+1 is still in flight over the host link, then append the
// preformatted face block (obj_format_faces).  The handle is an opaque
// FILE* — strictly sequential use from one writer thread.

int64_t obj_open(const char* path) {
  FILE* fp = std::fopen(path, "w");
  return (int64_t)(uintptr_t)fp;  // 0 on failure
}

int obj_append_verts(int64_t handle, const float* verts,
                     const float* colors, int64_t nv) {
  FILE* fp = (FILE*)(uintptr_t)handle;
  if (!fp) return 1;
  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (nv < 65536) n_threads = 1;  // spawn cost beats the win on small runs
  std::vector<std::vector<char>> bufs(n_threads);
  auto worker = [&](int t) {
    const int64_t i0 = nv * t / n_threads;
    const int64_t i1 = nv * (t + 1) / n_threads;
    std::vector<char>& b = bufs[t];
    b.reserve((size_t)(i1 - i0) * 90 + 64);
    char line[192];
    for (int64_t i = i0; i < i1; ++i) {
      const float* v = verts + i * 3;
      char* p = line;
      *p++ = 'v'; *p++ = ' ';
      p = fmt_fixed4(p, v[0]); *p++ = ' ';
      p = fmt_fixed4(p, v[1]); *p++ = ' ';
      p = fmt_fixed4(p, v[2]);
      if (colors) {
        const float* c = colors + i * 3;
        *p++ = ' ';
        p = fmt_fixed4(p, c[0]); *p++ = ' ';
        p = fmt_fixed4(p, c[1]); *p++ = ' ';
        p = fmt_fixed4(p, c[2]);
      }
      *p++ = '\n';
      b.insert(b.end(), line, p);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t) ths.emplace_back(worker, t);
    for (auto& th : ths) th.join();
  }
  for (auto& b : bufs) {
    if (!b.empty() && std::fwrite(b.data(), 1, b.size(), fp) != b.size())
      return 1;
  }
  return 0;
}

int obj_finish(int64_t handle, const char* faces_buf, int64_t faces_len) {
  FILE* fp = (FILE*)(uintptr_t)handle;
  if (!fp) return 1;
  int rc = 0;
  if (faces_buf && faces_len > 0 &&
      std::fwrite(faces_buf, 1, (size_t)faces_len, fp) != (size_t)faces_len)
    rc = 1;
  if (std::fclose(fp) != 0) rc = 1;
  return rc;
}

void meshio_free(void* p) { std::free(p); }

}  // extern "C"
