// The image preparation of the readers in one pass per map: a uint8 HWC
// map resized bilinearly with data/preprocessing.py's ``resize_image``
// (OpenCV's 8-bit fixed-point arithmetic: 11-bit weights, integer row
// sums, ``>> 4``, ``>> 16``, ``+ 2 >> 2``, clip), mapped to [-1, 1] as
// ``normalize_image`` maps it (``v / 255 * 2 - 1`` in float32 when the
// resized map's maximum is above 1.5, else ``v * 2 - 1``), and written
// straight into a float32 HWC output at a channel offset, so an RGB-D pair
// lands interleaved in one 6-channel array.  The tap indices and weights
// come from Python (``preprocessing._taps``).  Built with
// -ffp-contract=off (no fused multiply-adds), so every float is NumPy's
// bit for bit.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Lut {
  float hi[256];  // normalize_image when the map's max is above 1.5
  float lo[256];  // ... and when it is not (the values are then 0 or 1)
  Lut() {
    for (int v = 0; v < 256; ++v) {
      hi[v] = (float)v / 255.0f * 2.0f - 1.0f;
      lo[v] = (float)v * 2.0f - 1.0f;
    }
  }
};

const Lut kLut;

// A map whose values are all 0 or 1 takes normalize_image's other branch:
// rewrite its entries (hi[0] -> lo[0], hi[1] -> lo[1]).
void low_branch(float* out, int64_t n_pix, int64_t out_c, int64_t c_off,
                int64_t C) {
  const float one = kLut.hi[1];
  for (int64_t p = 0; p < n_pix; ++p) {
    float* o = out + p * out_c + c_off;
    for (int64_t c = 0; c < C; ++c)
      o[c] = o[c] == one ? kLut.lo[1] : kLut.lo[0];
  }
}

// Write the uint8 values ``v`` [n_pix, C] as normalize_image's first
// branch into ``o`` [n_pix, out_c] (``o`` at the caller's channel offset);
// return their maximum.  kC > 0 fixes C at compile time.
template <int kC>
int write_hi(const uint8_t* v, int64_t n_pix, int64_t C_rt, float* o,
             int64_t out_c) {
  const int64_t C = kC > 0 ? kC : C_rt;
  int vmax = 0;
  for (int64_t p = 0; p < n_pix; ++p)
    for (int64_t c = 0; c < C; ++c) {
      vmax = std::max(vmax, (int)v[p * C + c]);
      o[p * out_c + c] = kLut.hi[v[p * C + c]];
    }
  return vmax;
}

// Same size: normalise ``src`` [n_pix, C] into ``out`` [n_pix, out_c] at
// channels c_off .. c_off + C.
template <int kC>
void same(const uint8_t* src, int64_t n_pix, int64_t C, float* out,
          int64_t out_c, int64_t c_off) {
  if (write_hi<kC>(src, n_pix, C, out + c_off, out_c) <= 1)
    low_branch(out, n_pix, out_c, c_off, C);
}

// Resize ``src`` [H, W, C] to [h_out, w_out, C] through the row taps
// (y0, y1, by0, by1) and the column taps (x0, x1, ax0, ax1), then
// normalise into ``out`` [h_out, w_out, out_c] at channel c_off.
template <int kC>
void resized(const uint8_t* src, int64_t W, int64_t C_rt, const int64_t* y0,
             const int64_t* y1, const int32_t* by0, const int32_t* by1,
             int64_t h_out, const int64_t* x0, const int64_t* x1,
             const int32_t* ax0, const int32_t* ax1, int64_t w_out,
             float* out, int64_t out_c, int64_t c_off) {
  const int64_t C = kC > 0 ? kC : C_rt;
  const int64_t n = w_out * C;
  // the horizontal sums of two source rows, reused while a row is needed
  std::vector<int32_t> buf[2] = {std::vector<int32_t>(n),
                                 std::vector<int32_t>(n)};
  int64_t held[2] = {-1, -1};
  // the sums of row r, evicting the buffer that does not hold row ``keep``
  auto row = [&](int64_t r, int64_t keep) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (held[k] == r) return buf[k].data();
    const int k = held[0] == keep ? 1 : 0;
    const uint8_t* s = src + r * W * C;
    int32_t* b = buf[k].data();
    for (int64_t x = 0; x < w_out; ++x) {
      const uint8_t* p0 = s + x0[x] * C;
      const uint8_t* p1 = s + x1[x] * C;
      const int32_t a0 = ax0[x], a1 = ax1[x];
      for (int64_t c = 0; c < C; ++c)
        b[x * C + c] = (int32_t)p0[c] * a0 + (int32_t)p1[c] * a1;
    }
    held[k] = r;
    return b;
  };
  std::vector<uint8_t> vrow(n);
  int vmax = 0;
  for (int64_t y = 0; y < h_out; ++y) {
    const int32_t* r0 = row(y0[y], y1[y]);
    const int32_t* r1 = row(y1[y], y0[y]);
    const int32_t b0 = by0[y], b1 = by1[y];
    for (int64_t j = 0; j < n; ++j) {
      const int v = (((b0 * (r0[j] >> 4)) >> 16) +
                     ((b1 * (r1[j] >> 4)) >> 16) + 2) >> 2;
      vrow[j] = (uint8_t)std::min(std::max(v, 0), 255);
    }
    vmax = std::max(vmax, write_hi<kC>(vrow.data(), w_out, C,
                                       out + y * w_out * out_c + c_off,
                                       out_c));
  }
  if (vmax <= 1) low_branch(out, h_out * w_out, out_c, c_off, C);
}

}  // namespace

extern "C" void prep_same(const uint8_t* src, int64_t n_pix, int64_t C,
                          float* out, int64_t out_c, int64_t c_off) {
  if (C == 3)
    same<3>(src, n_pix, C, out, out_c, c_off);
  else
    same<0>(src, n_pix, C, out, out_c, c_off);
}

extern "C" void prep_resized(const uint8_t* src, int64_t W, int64_t C,
                             const int64_t* y0, const int64_t* y1,
                             const int32_t* by0, const int32_t* by1,
                             int64_t h_out, const int64_t* x0,
                             const int64_t* x1, const int32_t* ax0,
                             const int32_t* ax1, int64_t w_out, float* out,
                             int64_t out_c, int64_t c_off) {
  if (C == 3)
    resized<3>(src, W, C, y0, y1, by0, by1, h_out, x0, x1, ax0, ax1, w_out,
               out, out_c, c_off);
  else
    resized<0>(src, W, C, y0, y1, by0, by1, h_out, x0, x1, ax0, ax1, w_out,
               out, out_c, c_off);
}
