// Native orthographic z-buffer rasterizer.
//
// Host-side equivalent of the reference's OpenGL FBO render pipeline
// (the reference's traindata/render_data.py:147-288; GL draw + glReadPixels
// readback).  Two passes, parallel over faces then pixels:
//
//   1. visibility — every face's bbox pixels are barycentric-tested and
//      depth-composited into an atomic packed (quantized-z << 32 | face id)
//      buffer via compare-exchange min: exactly GL's depth test.
//   2. attributes — per covered pixel, the winning face's barycentrics are
//      recomputed once; normals (and optional per-vertex shading, e.g. PRT
//      diffuse) interpolate and shade.
//
// A 100k-face subject at 1024^2 runs in tens of milliseconds.  A copy of
// the JAX package's native/raster.cc; in this package it has no NumPy
// fallback (data/synthetic.py raises if it fails).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// px/py: [V] screen-space pixel coords; pz: [V] NDC depth.
// vn: [V*3] vertex normals (view space).  vshade: optional per-vertex
// shading, [V] (shade_ch=1) or [V*3] (shade_ch=3); pass nullptr to skip.
// faces: [F*3] int32.  albedo/light: [3].
// Texture path (all nullable; parity with the reference's per-material
// albedo sampling, traindata prt.fs:24-31):
//   uvs [T*2] (OBJ vt: origin bottom-left), face_uvs [F*3] indices into
//   uvs (-1 = face untextured), tex [th*tw*3] float RGB in [0,1],
//   face_albedo [F*3] per-face flat Kd fallback.
// Outputs (caller-allocated): zbuf [size^2] (filled +inf where empty),
// nbuf [size^2*3], rgb [size^2*3] (filled 1 where empty), mask [size^2].
int raster_ortho(const double* px, const double* py, const double* pz,
                 int64_t V, const double* vn, const double* vshade,
                 int shade_ch, const int32_t* faces, int64_t F, int64_t size,
                 const double* albedo, const double* light,
                 const double* uvs, const int32_t* face_uvs,
                 const float* tex, int64_t th, int64_t tw,
                 const double* face_albedo, float* zbuf,
                 float* nbuf, float* rgb, uint8_t* mask, int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }

  // z -> sortable 31-bit quantization
  double zmin = 1e300, zmax = -1e300;
  for (int64_t i = 0; i < V; ++i) {
    zmin = pz[i] < zmin ? pz[i] : zmin;
    zmax = pz[i] > zmax ? pz[i] : zmax;
  }
  const double zspan = (zmax - zmin) > 1e-12 ? (zmax - zmin) : 1e-12;
  const double zscale = (double)((1u << 31) - 4) / zspan;

  const int64_t npix = size * size;
  std::vector<std::atomic<uint64_t>> packed(npix);
  const uint64_t kEmpty = UINT64_MAX;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t)
      ths.emplace_back([&, t] {
        const int64_t p0 = npix * t / n_threads;
        const int64_t p1 = npix * (t + 1) / n_threads;
        for (int64_t p = p0; p < p1; ++p)
          packed[p].store(kEmpty, std::memory_order_relaxed);
      });
    for (auto& th : ths) th.join();
  }

  // ---- pass 1: parallel over faces, atomic depth-min composite ----------
  auto face_worker = [&](int t) {
    const int64_t f0 = F * t / n_threads;
    const int64_t f1 = F * (t + 1) / n_threads;
    for (int64_t f = f0; f < f1; ++f) {
      const int32_t i0 = faces[f * 3], i1 = faces[f * 3 + 1],
                    i2 = faces[f * 3 + 2];
      const double ax = px[i0], ay = py[i0];
      const double bx = px[i1], by = py[i1];
      const double cx = px[i2], cy = py[i2];
      const double d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
      if (std::fabs(d) < 1e-12) continue;
      const double inv_d = 1.0 / d;
      double xmin = ax < bx ? ax : bx; xmin = xmin < cx ? xmin : cx;
      double xmax = ax > bx ? ax : bx; xmax = xmax > cx ? xmax : cx;
      double ymin = ay < by ? ay : by; ymin = ymin < cy ? ymin : cy;
      double ymax = ay > by ? ay : by; ymax = ymax > cy ? ymax : cy;
      const int64_t x0 = clamp64((int64_t)std::floor(xmin), 0, size - 1);
      const int64_t x1 = clamp64((int64_t)std::ceil(xmax), 0, size - 1);
      const int64_t y0 = clamp64((int64_t)std::floor(ymin), 0, size - 1);
      const int64_t y1 = clamp64((int64_t)std::ceil(ymax), 0, size - 1);
      if (std::ceil(xmax) < 0 || std::floor(xmin) > size - 1 ||
          std::ceil(ymax) < 0 || std::floor(ymin) > size - 1)
        continue;
      const double z0 = pz[i0], z1 = pz[i1], z2 = pz[i2];
      for (int64_t gy = y0; gy <= y1; ++gy) {
        const double gyf = (double)gy;
        for (int64_t gx = x0; gx <= x1; ++gx) {
          const double gxf = (double)gx;
          const double w0 =
              ((by - cy) * (gxf - cx) + (cx - bx) * (gyf - cy)) * inv_d;
          if (w0 < 0.0) continue;
          const double w1 =
              ((cy - ay) * (gxf - cx) + (ax - cx) * (gyf - cy)) * inv_d;
          if (w1 < 0.0) continue;
          const double w2 = 1.0 - w0 - w1;
          if (w2 < 0.0) continue;
          const double z = w0 * z0 + w1 * z1 + w2 * z2;
          double q = (z - zmin) * zscale;
          if (q < 0.0) q = 0.0;
          const uint64_t zq = (uint64_t)q;
          const uint64_t val = (zq << 32) | (uint64_t)(uint32_t)f;
          std::atomic<uint64_t>& slot = packed[gy * size + gx];
          uint64_t cur = slot.load(std::memory_order_relaxed);
          while (val < cur && !slot.compare_exchange_weak(
                                  cur, val, std::memory_order_relaxed)) {
          }
        }
      }
    }
  };
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t) ths.emplace_back(face_worker, t);
    for (auto& th : ths) th.join();
  }

  // ---- pass 2: parallel over pixels, attribute interpolation ------------
  const double lx = light[0], ly = light[1], lz = light[2];
  auto pixel_worker = [&](int t) {
    const int64_t p0 = npix * t / n_threads;
    const int64_t p1 = npix * (t + 1) / n_threads;
    for (int64_t p = p0; p < p1; ++p) {
      const uint64_t val = packed[p].load(std::memory_order_relaxed);
      if (val == kEmpty) {
        zbuf[p] = INFINITY;
        mask[p] = 0;
        rgb[p * 3] = rgb[p * 3 + 1] = rgb[p * 3 + 2] = 1.0f;
        nbuf[p * 3] = nbuf[p * 3 + 1] = nbuf[p * 3 + 2] = 0.0f;
        continue;
      }
      const int64_t f = (int64_t)(val & 0xFFFFFFFFull);
      const int32_t i0 = faces[f * 3], i1 = faces[f * 3 + 1],
                    i2 = faces[f * 3 + 2];
      const double gxf = (double)(p % size);
      const double gyf = (double)(p / size);
      const double ax = px[i0], ay = py[i0];
      const double bx = px[i1], by = py[i1];
      const double cx = px[i2], cy = py[i2];
      const double inv_d =
          1.0 / ((by - cy) * (ax - cx) + (cx - bx) * (ay - cy));
      double w0 = ((by - cy) * (gxf - cx) + (cx - bx) * (gyf - cy)) * inv_d;
      double w1 = ((cy - ay) * (gxf - cx) + (ax - cx) * (gyf - cy)) * inv_d;
      double w2 = 1.0 - w0 - w1;
      zbuf[p] = (float)(w0 * pz[i0] + w1 * pz[i1] + w2 * pz[i2]);
      double nx = w0 * vn[i0 * 3] + w1 * vn[i1 * 3] + w2 * vn[i2 * 3];
      double ny =
          w0 * vn[i0 * 3 + 1] + w1 * vn[i1 * 3 + 1] + w2 * vn[i2 * 3 + 1];
      double nz =
          w0 * vn[i0 * 3 + 2] + w1 * vn[i1 * 3 + 2] + w2 * vn[i2 * 3 + 2];
      const double nl = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (nl > 1e-12) {
        nx /= nl; ny /= nl; nz /= nl;
      }
      nbuf[p * 3] = (float)nx;
      nbuf[p * 3 + 1] = (float)ny;
      nbuf[p * 3 + 2] = (float)nz;
      double shade = std::fabs(nx * lx + ny * ly + nz * lz);
      shade = shade < 0.15 ? 0.15 : (shade > 1.0 ? 1.0 : shade);
      double alb[3] = {albedo[0], albedo[1], albedo[2]};
      if (face_albedo) {
        alb[0] = face_albedo[f * 3];
        alb[1] = face_albedo[f * 3 + 1];
        alb[2] = face_albedo[f * 3 + 2];
      }
      if (tex && uvs && face_uvs) {
        const int32_t t0 = face_uvs[f * 3], t1 = face_uvs[f * 3 + 1],
                      t2 = face_uvs[f * 3 + 2];
        if (t0 >= 0 && t1 >= 0 && t2 >= 0) {
          double u = w0 * uvs[t0 * 2] + w1 * uvs[t1 * 2] + w2 * uvs[t2 * 2];
          double vv = w0 * uvs[t0 * 2 + 1] + w1 * uvs[t1 * 2 + 1] +
                      w2 * uvs[t2 * 2 + 1];
          u -= std::floor(u);                 // GL_REPEAT wrap
          vv -= std::floor(vv);
          // vt origin is bottom-left; image row 0 is the top
          const double fx_ = u * (double)(tw - 1);
          const double fy_ = (1.0 - vv) * (double)(th - 1);
          const int64_t ix = clamp64((int64_t)fx_, 0, tw - 2 > 0 ? tw - 2 : 0);
          const int64_t iy = clamp64((int64_t)fy_, 0, th - 2 > 0 ? th - 2 : 0);
          const double du = fx_ - (double)ix, dv = fy_ - (double)iy;
          const int64_t x2 = tw > 1 ? ix + 1 : ix;
          const int64_t y2 = th > 1 ? iy + 1 : iy;
          for (int c = 0; c < 3; ++c) {
            const double c00 = tex[(iy * tw + ix) * 3 + c];
            const double c01 = tex[(iy * tw + x2) * 3 + c];
            const double c10 = tex[(y2 * tw + ix) * 3 + c];
            const double c11 = tex[(y2 * tw + x2) * 3 + c];
            alb[c] = (1 - dv) * ((1 - du) * c00 + du * c01) +
                     dv * ((1 - du) * c10 + du * c11);
          }
        }
      }
      double col[3] = {alb[0] * shade, alb[1] * shade, alb[2] * shade};
      if (vshade) {
        for (int c = 0; c < 3; ++c) {
          const int sc = shade_ch == 3 ? c : 0;
          const double s = w0 * vshade[i0 * shade_ch + sc] +
                           w1 * vshade[i1 * shade_ch + sc] +
                           w2 * vshade[i2 * shade_ch + sc];
          col[c] *= s;
          col[c] = col[c] < 0.0 ? 0.0 : (col[c] > 1.0 ? 1.0 : col[c]);
        }
      }
      rgb[p * 3] = (float)col[0];
      rgb[p * 3 + 1] = (float)col[1];
      rgb[p * 3 + 2] = (float)col[2];
      mask[p] = 1;
    }
  };
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t) ths.emplace_back(pixel_worker, t);
    for (auto& th : ths) th.join();
  }
  return 0;
}

}  // extern "C"
