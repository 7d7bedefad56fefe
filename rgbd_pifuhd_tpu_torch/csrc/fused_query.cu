// Fused field query for Hopper: bilinear feature gather + PointMLP chain.
//
// Replaces the TPU kernel rgbd_pifuhd_tpu/ops/pallas_query.py
// fused_gather_mlp (pallas_call at :364, body _query_kernel :211-283).
// Per query point: a 4-tap hat-weight bilinear gather from a [H, W, C]
// feature map (grid_sample zeros padding, align_corners=True), concat of
// the `extra` channels, then Dense -> GroupNorm(32) -> leaky_relu(0.01)
// layers with residual concats of the original input, phi captured after
// the merge layer, and a sigmoid head.
//
// What bounds it on an H100: operations.  At the flagship widths a point
// costs ~2.92 MFLOP (coarse 257-1024-512-256-128-1 plus fine
// 272-512-256-128-1); the gather reads 4 taps of a feature map that is
// small (8.4 MB coarse, 2 MB fine) and stays in the 50 MB L2.  So the
// design turns the chain into one tiled GEMM launch per layer over all
// points of the call, bf16 on the tensor cores (mma.sync m16n8k16, f32
// accumulation); the f32 variant (used to check the arithmetic) runs the
// same tiles on FMA units.  Operands move in 16-byte chunks (every K range
// is padded to a multiple of 8 at pack time), and the next K step's chunks
// are loaded into registers while the tensor cores work on the current one.
//
// GroupNorm couples the points of a segment (the whole call on the main
// path, 512-point tiles when compared with the Pallas kernel), which a
// single pass cannot see on a GPU whose blocks run in no order.  So each
// layer's epilogue stores the pre-norm activation and writes its block's
// per-column sum and sum of squares; a small second kernel reduces them per
// (segment, group) in a fixed order (no atomics: the field, and so the
// mesh, is the same on every run); the next layer's prologue applies
// GroupNorm + leaky while moving its A chunks into shared memory.  A
// residual layer reads its A operand as two K ranges (h_prev, then x0), so
// the concat is never materialised.
//
// Rounding follows the JAX main path (models/mlp.py:55-68): a bf16 Dense
// rounds its product to bf16 and adds the bias in bf16; GroupNorm and
// leaky run in f32; the next Dense casts back to bf16; phi is f32.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// Arguments of one layer launch (mirrored by a ctypes.Structure).  Outside
// the anonymous namespace: the extern "C" entry point takes it by pointer.
// K ranges: [0, K1p) reads a1 (K1 real columns, the rest zero padding),
// [K1p, K1p + K2p) reads a2; W rows hold K1p + K2p weights, zero-padded.
struct LayerParams {
  const void* a1;          // [N, lda1] compute dtype: x0 or h_prev
  const void* a2;          // [N, lda2] compute dtype: x0 (residual) or null
  const void* w;           // [M, K1p + K2p] compute dtype
  const float* bias;       // [M] (already rounded to the compute dtype)
  const float* stats_in;   // [n_seg, g_in, 2] of h_prev, or null
  const float* gs_in;      // [K1] GroupNorm scale of h_prev
  const float* gb_in;      // [K1] GroupNorm bias of h_prev
  void* out;               // [N, ldo]: compute dtype, or f32 (last layer)
  float* raw_out;          // [N, M] f32 pre-sigmoid copy, or null
  float* part_out;         // [n_rowblocks, M, 2] column partials, or null
  float* stats_out;        // [n_seg, g_out, 2] (with part_out), or null
  int N, K1, K1p, K2p, M, ldo, lda1, lda2;
  int norm_in;             // 0 none, 1 leaky, 2 GroupNorm + leaky
  int cg_in, g_in, cg_out, g_out;
  int seg_rows, n_seg;
  int last, sigmoid;
};

namespace {

constexpr int BM = 64;         // points per block tile
constexpr int BN = 128;        // output columns per block tile
constexpr int BK = 32;         // K step
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int VEC = 8;         // elements per 16-byte chunk (bf16)
constexpr int A_CH = BM * BK / VEC / NT;   // A chunks per thread (1)
constexpr int B_CH = BN * BK / VEC / NT;   // B chunks per thread (2)
constexpr int TM = BM / 16, TN = BN / 16;  // FMA thread tile (4 x 8)
constexpr int QR = NT / BN;                // row groups of the stats pass
constexpr int MAXK_NORM = 1024;
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : __fmul_rn(kSlope, v);
}

// GroupNorm mean and scale*inv_std of channel c from a stats row.
__device__ __forceinline__ void gn_coeffs(const float* st, float n,
                                          float scale, float* mean,
                                          float* mul) {
  float m = __fdiv_rn(st[0], n);
  float m2 = __fdiv_rn(st[1], n);
  float var = fmaxf(0.f, __fsub_rn(m2, __fmul_rn(m, m)));
  *mean = m;
  *mul = __fmul_rn(__fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps))), scale);
}

// Eight consecutive elements, moved as 16-byte words.
template <typename T> struct __align__(16) Chunk { T e[VEC]; };

template <typename T>
__device__ __forceinline__ void ld_chunk(Chunk<T>& c, const T* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  uint4* d = reinterpret_cast<uint4*>(c.e);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Chunk<T>) / 16); ++i) d[i] = s[i];
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
  uint4* d = reinterpret_cast<uint4*>(c.e);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Chunk<T>) / 16); ++i)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------- gather
// One warp per point, channels across the lanes.  Hat weights exactly as
// pallas_query.gather_rows_weights; taps combined in the order
// (y0,xl) (y0,xl+1) (y1,xl) (y1,xl+1), rounded at each step (no FMA) so
// the plain PyTorch version reproduces it bit for bit.  Writes x0 rows of
// ldx >= C + E elements, the padding zeroed.
template <typename T>
__global__ void __launch_bounds__(NT) gather_kernel(
    const T* __restrict__ feat, int H, int W, int C,
    const float* __restrict__ uv, const float* __restrict__ extra, int E,
    T* __restrict__ x0, int ldx, int N) {
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= N) return;
  const float u = uv[2 * p], v = uv[2 * p + 1];
  const float x = (u + 1.0f) * 0.5f * (float)(W - 1);
  const float y = (v + 1.0f) * 0.5f * (float)(H - 1);
  const float xl = fminf(fmaxf(floorf(x), 0.f), (float)max(W - 2, 0));
  const float yt = fminf(fmaxf(floorf(y), 0.f), (float)max(H - 2, 0));
  const float wxl = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(x, xl))));
  const float wxr = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(x, xl + 1.f))));
  const float wyt = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(y, yt))));
  const float wyb = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(y, yt + 1.f))));
  const float w0 = __fmul_rn(wyt, wxl), w1 = __fmul_rn(wyt, wxr);
  const float w2 = __fmul_rn(wyb, wxl), w3 = __fmul_rn(wyb, wxr);
  const int ix = (int)xl, iy = (int)yt;
  const bool ok_r = ix + 1 < W, ok_b = iy + 1 < H;
  const T* r00 = feat + ((int64_t)iy * W + ix) * C;
  const T* r01 = r00 + C;
  const T* r10 = r00 + (int64_t)W * C;
  const T* r11 = r10 + C;
  T* out = x0 + p * ldx;
  for (int c = lane; c < C; c += 32) {
    const float f00 = to_f(r00[c]);
    const float f01 = ok_r ? to_f(r01[c]) : 0.f;
    const float f10 = ok_b ? to_f(r10[c]) : 0.f;
    const float f11 = (ok_r && ok_b) ? to_f(r11[c]) : 0.f;
    float s = __fadd_rn(__fmul_rn(f00, w0), __fmul_rn(f01, w1));
    s = __fadd_rn(s, __fmul_rn(f10, w2));
    s = __fadd_rn(s, __fmul_rn(f11, w3));
    out[c] = from_f<T>(s);
  }
  for (int e = lane; e < E; e += 32) out[C + e] = from_f<T>(extra[p * E + e]);
  for (int e = C + E + lane; e < ldx; e += 32) out[e] = from_f<T>(0.f);
}

// ---------------------------------------------------------------- layer
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int C_BYTES = BM * (BN + 1) * 4;
constexpr int TILE_F32_BYTES = BK * (BM + 4) * 4 + BK * (BN + 4) * 4;
constexpr int TILE_BF16_BYTES = BM * (BK + 8) * 2 + BN * (BK + 8) * 2;
constexpr int SMEM_BYTES =
    C_BYTES > TILE_F32_BYTES ? C_BYTES : TILE_F32_BYTES;
static_assert(SMEM_BYTES >= TILE_BF16_BYTES, "tile union");
static_assert(A_CH * NT * VEC == BM * BK && B_CH * NT * VEC == BN * BK,
              "chunk split");
static_assert(TM * TN == 32 && QR * BN == NT && QR * BN * 2 <= MAXK_NORM,
              "thread tiles");

// One launch per MLP layer: out = act_in(A) @ W^T + bias over all points.
// MMA=true: bf16 tensor-core tiles; MMA=false: f32 FMA tiles.
template <typename T, bool MMA>
__global__ void __launch_bounds__(NT) layer_kernel(const LayerParams p) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  __shared__ __align__(16) float s_mean[MAXK_NORM];
  __shared__ __align__(16) float s_mul[MAXK_NORM];
  __shared__ __align__(16) float s_add[MAXK_NORM];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int seg = row0 / p.seg_rows;
  const int Kp = p.K1p + p.K2p;
  const T* a1 = static_cast<const T*>(p.a1);
  const T* a2 = static_cast<const T*>(p.a2);
  const T* w = static_cast<const T*>(p.w);

  if (p.norm_in == 2) {
    const float n = (float)p.seg_rows * (float)p.cg_in;
    for (int c = t; c < p.K1; c += NT) {
      const float* st =
          p.stats_in + ((int64_t)seg * p.g_in + c / p.cg_in) * 2;
      gn_coeffs(st, n, p.gs_in[c], &s_mean[c], &s_mul[c]);
      s_add[c] = p.gb_in[c];
    }
  }

  // MMA: warp tile 32x32 (2 x 4 warps); FMA: thread tile 4x8 (16 x 16).
  const int warp = t >> 5, lane = t & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int tx = t & 15, ty = t >> 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  Chunk<T> ra[A_CH], rb[B_CH];
  constexpr int CPR = BK / VEC;    // chunks per tile row

  // start the global loads of one K step into registers
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = t + i * NT, r = c / CPR, gk = k0 + (c % CPR) * VEC;
      const int grow = row0 + r;
      if (grow < p.N && gk < p.K1p)
        ld_chunk(ra[i], a1 + (int64_t)grow * p.lda1 + gk);
      else if (grow < p.N && gk < Kp)
        ld_chunk(ra[i], a2 + (int64_t)grow * p.lda2 + (gk - p.K1p));
      else
        zero_chunk(ra[i]);
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = t + i * NT, n = c / CPR, gk = k0 + (c % CPR) * VEC;
      const int gn = col0 + n;
      if (gn < p.M && gk < Kp)
        ld_chunk(rb[i], w + (int64_t)gn * Kp + gk);
      else
        zero_chunk(rb[i]);
    }
  };

  // registers -> shared memory, applying the previous layer's norm + leaky
  auto store_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = t + i * NT, r = c / CPR, kc = (c % CPR) * VEC;
      const int gk = k0 + kc;
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[j] = to_f(ra[i].e[j]);
        if (gk < p.K1p) {
          const int g = gk + j;
          if (g >= p.K1) {
            v[j] = 0.f;
          } else {
            if (p.norm_in == 2)
              v[j] = __fadd_rn(
                  __fmul_rn(__fsub_rn(v[j], s_mean[g]), s_mul[g]), s_add[g]);
            if (p.norm_in >= 1) v[j] = leaky(v[j]);
          }
        }
      }
      if (MMA) {
        Chunk<bf16> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) o.e[j] = from_f<bf16>(v[j]);
        *reinterpret_cast<uint4*>(
            &reinterpret_cast<bf16(*)[BK + 8]>(smem)[r][kc]) =
            *reinterpret_cast<const uint4*>(o.e);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          reinterpret_cast<float(*)[BM + 4]>(smem)[kc + j][r] = v[j];
      }
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = t + i * NT, n = c / CPR, kc = (c % CPR) * VEC;
      if (MMA) {
        *reinterpret_cast<uint4*>(&reinterpret_cast<bf16(*)[BK + 8]>(
            smem + BM * (BK + 8) * 2)[n][kc]) =
            *reinterpret_cast<const uint4*>(rb[i].e);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          reinterpret_cast<float(*)[BN + 4]>(smem + BK * (BM + 4) * 4)
              [kc + j][n] = to_f(rb[i].e[j]);
      }
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < Kp; k0 += BK) {
    __syncthreads();   // the last step's readers are done (and the norm
                       // coefficients are in place on the first step)
    store_tile(k0);
    __syncthreads();
    if (k0 + BK < Kp) load_tile(k0 + BK);   // in flight during the MMAs
    if (MMA) {
      auto As = reinterpret_cast<const bf16(*)[BK + 8]>(smem);
      auto Bs =
          reinterpret_cast<const bf16(*)[BK + 8]>(smem + BM * (BK + 8) * 2);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + gid;
          const int k = kk + tig * 2;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][k]);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k]);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][k + 8]);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn * 32 + ni * 8 + gid;
          const int k = kk + tig * 2;
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][k]);
          bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][k + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(&acc[(mi * 4 + ni) * 4], af[mi][0], af[mi][1],
                     af[mi][2], af[mi][3], bfr[ni][0], bfr[ni][1]);
      }
    } else {
      auto As = reinterpret_cast<const float(*)[BM + 4]>(smem);
      auto Bs =
          reinterpret_cast<const float(*)[BN + 4]>(smem + BK * (BM + 4) * 4);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i * TN + j] = fmaf(a[i], b[j], acc[i * TN + j]);
      }
    }
  }
  __syncthreads();

  // accumulators -> C tile in shared memory (aliases the operand tiles)
  auto Cs = reinterpret_cast<float(*)[BN + 1]>(smem);
  if (MMA) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wm * 32 + mi * 16 + gid;
        const int c = wn * 32 + ni * 8 + tig * 2;
        const float* a = &acc[(mi * 4 + ni) * 4];
        Cs[r][c] = a[0];
        Cs[r][c + 1] = a[1];
        Cs[r + 8][c] = a[2];
        Cs[r + 8][c + 1] = a[3];
      }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Cs[ty + 16 * i][tx + 16 * j] = acc[i * TN + j];
  }
  __syncthreads();

  // epilogue: bias, rounding, store; the stored value feeds the stats
  for (int it = 0; it < BM * BN / NT; ++it) {
    const int idx = it * NT + t, r = idx / BN, c = idx % BN;
    const int grow = row0 + r, gcol = col0 + c;
    float v = 0.f;
    if (grow < p.N && gcol < p.M) {
      v = round_to<T>(Cs[r][c]);
      v = round_to<T>(__fadd_rn(v, p.bias[gcol]));
      if (p.last) {
        if (p.raw_out) p.raw_out[(int64_t)grow * p.M + gcol] = v;
        static_cast<float*>(p.out)[(int64_t)grow * p.ldo + gcol] =
            p.sigmoid ? __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))) : v;
      } else {
        static_cast<T*>(p.out)[(int64_t)grow * p.ldo + gcol] = from_f<T>(v);
      }
    }
    Cs[r][c] = v;
  }
  if (p.part_out == nullptr) return;
  __syncthreads();
  // the norm coefficients are spent: their space holds the row-group sums
  auto s_part = reinterpret_cast<float(*)[BN][2]>(s_mean);
  {
    const int c = t % BN, q = t / BN;
    float s = 0.f, ss = 0.f;
    for (int r = q * (BM / QR); r < (q + 1) * (BM / QR); ++r) {
      if (row0 + r < p.N) {
        const float v = Cs[r][c];
        s += v;
        ss += v * v;
      }
    }
    s_part[q][c][0] = s;
    s_part[q][c][1] = ss;
  }
  __syncthreads();
  if (t < BN && col0 + t < p.M) {
    float s = 0.f, ss = 0.f;
    for (int q = 0; q < QR; ++q) {
      s += s_part[q][t][0];
      ss += s_part[q][t][1];
    }
    float* dst = p.part_out + ((int64_t)blockIdx.x * p.M + col0 + t) * 2;
    dst[0] = s;
    dst[1] = ss;
  }
}

// GroupNorm statistics of one (segment, group): the column partials of the
// segment's row blocks, summed in a fixed order.
__global__ void __launch_bounds__(NT) stats_reduce_kernel(
    const float* __restrict__ part, int n_rb, int M, int cg, int G,
    int seg_rows, float* __restrict__ stats) {
  __shared__ float red[2][NT];
  const int t = threadIdx.x;
  const int s = blockIdx.x / G, g = blockIdx.x % G;
  const int rb0 = (int)((int64_t)s * seg_rows / BM);
  const int rb1 =
      min(n_rb, (int)(((int64_t)(s + 1) * seg_rows + BM - 1) / BM));
  const int items = (rb1 - rb0) * cg;
  float a = 0.f, b = 0.f;
  for (int i = t; i < items; i += NT) {
    const float* src =
        part + ((int64_t)(rb0 + i / cg) * M + g * cg + i % cg) * 2;
    a += src[0];
    b += src[1];
  }
  red[0][t] = a;
  red[1][t] = b;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (t < w) {
      red[0][t] += red[0][t + w];
      red[1][t] += red[1][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    stats[((int64_t)s * G + g) * 2] = red[0][0];
    stats[((int64_t)s * G + g) * 2 + 1] = red[1][0];
  }
}

// phi: the merge layer's post-activation output, in f32.
template <typename T>
__global__ void __launch_bounds__(NT) act_kernel(
    const T* __restrict__ h, int ld, int N, int M, int mode,
    const float* __restrict__ stats, const float* __restrict__ gs,
    const float* __restrict__ gb, int cg, int G, int seg_rows,
    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * M) return;
  const int r = (int)(i / M), c = (int)(i % M);
  float v = to_f(h[(int64_t)r * ld + c]);
  if (mode == 2) {
    const float* st = stats + ((int64_t)(r / seg_rows) * G + c / cg) * 2;
    float mean, mul;
    gn_coeffs(st, (float)seg_rows * (float)cg, gs[c], &mean, &mul);
    v = __fadd_rn(__fmul_rn(__fsub_rn(v, mean), mul), gb[c]);
  }
  if (mode >= 1) v = leaky(v);
  out[i] = v;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of feat, x0, h and weights)
int fq_gather(int dtype, const void* feat, int H, int W, int C,
              const float* uv, const float* extra, int E, void* x0, int ldx,
              int N, void* stream) {
  const dim3 grid((unsigned)(((int64_t)N * 32 + NT - 1) / NT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    gather_kernel<bf16><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(feat), H, W, C, uv, extra, E,
        static_cast<bf16*>(x0), ldx, N);
  else
    gather_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(feat), H, W, C, uv, extra, E,
        static_cast<float*>(x0), ldx, N);
  return (int)cudaGetLastError();
}

int fq_layer(int dtype, const LayerParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = (p->N + BM - 1) / BM;
  const dim3 grid((unsigned)n_rb, (unsigned)((p->M + BN - 1) / BN));
  if (dtype == 1)
    layer_kernel<bf16, true><<<grid, NT, 0, s>>>(*p);
  else
    layer_kernel<float, false><<<grid, NT, 0, s>>>(*p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p->part_out == nullptr) return (int)e;
  stats_reduce_kernel<<<(unsigned)(p->n_seg * p->g_out), NT, 0, s>>>(
      p->part_out, n_rb, p->M, p->cg_out, p->g_out, p->seg_rows,
      p->stats_out);
  return (int)cudaGetLastError();
}

int fq_act(int dtype, const void* h, int ld, int N, int M, int mode,
           const float* stats, const float* gs, const float* gb, int cg,
           int G, int seg_rows, float* out, void* stream) {
  const dim3 grid((unsigned)(((int64_t)N * M + NT - 1) / NT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    act_kernel<bf16><<<grid, NT, 0, s>>>(static_cast<const bf16*>(h), ld, N,
                                         M, mode, stats, gs, gb, cg, G,
                                         seg_rows, out);
  else
    act_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(h), ld,
                                          N, M, mode, stats, gs, gb, cg, G,
                                          seg_rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
