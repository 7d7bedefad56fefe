// Watertight point-in-mesh test by +z ray crossing parity over a 2D (x, y)
// grid of triangle bins: the loop of data/containment.py's NumPy
// ``_parity`` in C++.  Every quantity is the same float64 operation in the
// same order as the NumPy expression, and this file is built with
// -ffp-contract=off (no fused multiply-adds), so the answers are the NumPy
// version's bit for bit.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Query {
  const double* pts;      // [n, 3]
  const double* tri;      // [F, 3, 3] (a, b, c corners, xyz)
  const int64_t* start;   // [g * g + 1] offsets into ids
  const int64_t* ids;     // triangle ids, bin after bin
  const double* bb_min;   // [3]
  const double* bb_max;   // [3]
  const double* cell;     // [2]
  int64_t g;
};

bool inside_one(const Query& q, const double* p) {
  for (int k = 0; k < 3; ++k)
    if (!(p[k] >= q.bb_min[k] && p[k] <= q.bb_max[k])) return false;
  // (p - bb_min) / cell truncated toward zero, then clipped to the grid
  int64_t cx = (int64_t)((p[0] - q.bb_min[0]) / q.cell[0]);
  int64_t cy = (int64_t)((p[1] - q.bb_min[1]) / q.cell[1]);
  cx = std::min(std::max(cx, (int64_t)0), q.g - 1);
  cy = std::min(std::max(cy, (int64_t)0), q.g - 1);
  const int64_t key = cx * q.g + cy;
  const double px = p[0], py = p[1], pz = p[2];
  int64_t hits = 0;
  for (int64_t j = q.start[key]; j < q.start[key + 1]; ++j) {
    const double* t = q.tri + q.ids[j] * 9;
    const double ax = t[0], ay = t[1], az = t[2];
    const double bx = t[3], by = t[4], bz = t[5];
    const double cx_ = t[6], cy_ = t[7], cz = t[8];
    double d = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_);
    if (std::fabs(d) < 1e-15) d = 1e-15;
    const double w0 = ((by - cy_) * (px - cx_) + (cx_ - bx) * (py - cy_)) / d;
    const double w1 = ((cy_ - ay) * (px - cx_) + (ax - cx_) * (py - cy_)) / d;
    const double w2 = 1.0 - w0 - w1;
    const bool hit2d = (w0 >= 0) & (w1 >= 0) & (w2 > 0);
    const double zhit = w0 * az + w1 * bz + w2 * cz;
    hits += hit2d & (zhit > pz);
  }
  return hits % 2 == 1;
}

}  // namespace

extern "C" int contains_points(const double* pts, int64_t n,
                               const double* tri, const int64_t* start,
                               const int64_t* ids, const double* bb_min,
                               const double* bb_max, const double* cell,
                               int64_t g, uint8_t* out, int n_threads) {
  const Query q{pts, tri, start, ids, bb_min, bb_max, cell, g};
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  const int64_t per = 2048;  // points a thread at least
  n_threads = (int)std::max<int64_t>(
      1, std::min<int64_t>(n_threads, (n + per - 1) / per));
  auto work = [&](int t) {
    const int64_t i0 = n * t / n_threads, i1 = n * (t + 1) / n_threads;
    for (int64_t i = i0; i < i1; ++i) out[i] = inside_one(q, pts + 3 * i);
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
  return 0;
}
