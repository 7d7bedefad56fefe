// Fused field query for Hopper: bilinear feature gather + PointMLP chain.
//
// Replaces the TPU kernel rgbd_pifuhd_tpu/ops/pallas_query.py
// fused_gather_mlp (pallas_call at :364, body _query_kernel :211-283).
// Per query point: a 4-tap hat-weight bilinear gather from a [H, W, C]
// feature map (grid_sample zeros padding, align_corners=True), concat of
// the `extra` channels, then Dense -> GroupNorm(32) -> leaky_relu(0.01)
// layers with residual concats of the original input, phi captured after
// the merge layer, and a sigmoid head (the occupancy fields) or a tanh head
// (the texture field's three colour columns).
//
// What bounds it on an H100: operations.  At the flagship widths a point
// costs ~2.92 MFLOP (coarse 257-1024-512-256-128-1 plus fine
// 272-512-256-128-1); the gather reads 4 taps of a feature map that is
// small (8.4 MB coarse, 2 MB fine) and stays in the 50 MB L2.
//
// GroupNorm couples the points of a segment (the whole call on the main
// path, 512-point tiles when compared with the Pallas kernel), which a
// single pass cannot see on a GPU whose blocks run in no order.  So the
// chain is one GEMM launch per layer over all points of the call.  Each
// layer's epilogue stores the pre-norm activation and writes its block's
// per-column sum and sum of squares; a small second kernel reduces them per
// (segment, group) in a fixed order (no atomics: the field, and so the
// mesh, is the same on every run); the next layer applies GroupNorm + leaky
// to its A operand on the way into the product.  A residual layer reads its
// A operand as two K ranges (h_prev, then x0), so the concat is never
// materialised.  The layer after the merge layer, which normalises the
// merge layer's output anyway, also writes those values as f32 phi.
//
// The bf16 layer kernel (layer_wgmma_kernel) is built for the card's tensor
// cores.  One persistent block an SM walks the output tiles of 128 points x
// 256 columns (128 columns for layers no wider), column tile fastest, so
// the column tiles of one row tile run together and each activation comes
// from HBM once.  A producer warpgroup has one thread ask the Tensor Memory
// Accelerator for each stage's operand boxes (64 K values of A and of B,
// 128-byte swizzle, csrc/hopper.cuh; rows past N, columns past a row's end
// and weight rows past M arrive as zeros) into a ring of three stages, and
// it loads the next tile's stages while the consumers are in their
// epilogues.  Two consumer warpgroups of 64 rows each wait on a stage's
// barrier, take A from shared memory by ldmatrix, normalise and activate it
// in registers (one FMA and one max per value, coefficients from shared
// memory), pack it to bf16 and hand it to wgmma (m64n256k16, f32
// accumulators in registers, B by descriptor) as the register operand; the
// next stage's A is prepared while this stage's products are in flight, and
// no barrier in the main loop stops the whole block.  Each consumer
// warpgroup has its own epilogue: round in registers, a padded shared-memory
// tile for 16-byte stores, and the column sums of the stored values over
// its 64 rows.  The one-column head (M = 1) is a dot product per row
// (head_kernel), bound by bytes; the texture field's three-column last
// layer (RGB) takes the same kernel, one dot product per column from the
// one read of the row.  The f32 variant (layer_f32_kernel: FMA
// tiles, used to check the arithmetic and by f32 models) keeps the unfused
// GroupNorm arithmetic.
//
// Rounding follows the JAX main path (models/mlp.py:55-68): a bf16 Dense
// rounds its product to bf16 and adds the bias in bf16; GroupNorm and the
// leaky after it run in f32 (a norm-free layer's leaky in the compute
// dtype); the next Dense casts back to bf16; phi is f32.
//
// Plain C interface for ctypes.  fq_chain enqueues a whole chain (gather,
// layers, statistics) on the stream from one host call and returns the
// first CUDA error with the index of the launch that raised it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/std/type_traits>

#include "hopper.cuh"

// Arguments of the gather launch and of one layer launch, each mirrored by
// a ctypes.Structure field for field.  Outside the anonymous namespace: the
// extern "C" entry points take them by pointer.
struct GatherParams {
  const void* feat;        // [H, W, C] compute dtype
  const float* uv;         // [N, 2]
  const float* extra;      // [N, E]
  void* x0;                // [N, ldx] compute dtype, padding zeroed
  int H, W, C, E, ldx, N;
};

// K ranges: [0, K1p) reads a1 (K1 real columns, the rest zero weights),
// [K1p, K1p + K2p) reads a2; W rows hold K1p + K2p weights, zero-padded.
// kind 0 pads the ranges to 8, kinds 1 and 2 to 64; a row of a1 / a2 holds
// lda1 / lda2 readable values (multiples of 8), columns past them read as 0.
struct LayerParams {
  const void* a1;          // [N, lda1] compute dtype: x0 or h_prev
  const void* a2;          // [N, lda2] compute dtype: x0 (residual) or null
  const void* w;           // [M, K1p + K2p] compute dtype
  const float* bias;       // [M] (already rounded to the compute dtype)
  const float* stats_in;   // [n_seg, g_in, 8, 2] of h_prev, or null
  const float* gs_in;      // [K1] GroupNorm scale of h_prev
  const float* gb_in;      // [K1] GroupNorm bias of h_prev
  void* out;               // [N, ldo]: compute dtype, or f32 (last layer)
  float* raw_out;          // [N, M] f32 pre-activation copy, or null
  float* phi_out;          // [N, K1] f32 activated input (phi), or null
  float* part_out;         // [n_rowblocks, M, 2] column partials, or null
  float* stats_out;        // [n_seg, g_out, 8, 2] (with part_out), or null
  int kind;                // 0 f32 FMA tiles, 1 bf16 wgmma tiles, 2 bf16 head
                           // (M 1 or HEAD_COLS, last layer)
  int N, K1, K1p, K2p, M, ldo, lda1, lda2;
  int norm_in;             // 0 none, 1 leaky, 2 GroupNorm + leaky
  int cg_in, g_in, cg_out, g_out;
  int seg_rows, n_seg;
  int last, sigmoid, tanh; // the last layer's activation: sigmoid, tanh or
                           // none
};

namespace {

constexpr int NT = 256;        // threads per block (8 warps)
constexpr int VEC = 8;         // elements per chunk
constexpr int MAXK_NORM = 1024;
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;
constexpr float kSlopeBf16 = 0.010009765625f;   // 0.01 rounded to bf16

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
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : __fmul_rn(kSlope, v);
}

// leaky_relu of a norm-free bf16 layer's output as JAX computes it: the
// slope is rounded to bf16 first and the product rounded after.
__device__ __forceinline__ float leaky_bf16(float v) {
  return v >= 0.f ? v : round_bf16(__fmul_rn(kSlopeBf16, v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// The last layer's activation.
__device__ __forceinline__ float head_act(const LayerParams& p, float v) {
  return p.sigmoid ? sigmoid(v) : p.tanh ? tanhf(v) : v;
}

// A (segment, group)'s statistics are kept as STATS_SPLIT partial (sum, sum
// of squares) pairs, each over a slice of the segment's rows, so that the
// reduce kernel has enough blocks to fill the card; readers add them in
// order.
constexpr int STATS_SPLIT = 8;

// GroupNorm mean and scale*inv_std of a channel from its group's stats.
__device__ __forceinline__ void gn_coeffs(const float* st, float n,
                                          float scale, float* mean,
                                          float* mul) {
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < STATS_SPLIT; ++i) {
    sum += st[2 * i];
    sq += st[2 * i + 1];
  }
  float m = __fdiv_rn(sum, n);
  float m2 = __fdiv_rn(sq, n);
  float var = fmaxf(0.f, __fsub_rn(m2, __fmul_rn(m, m)));
  *mean = m;
  *mul = __fmul_rn(__fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps))), scale);
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

// ------------------------------------------------------- bf16 wgmma layer
namespace wg {

using namespace hopper;

constexpr int BM = 128;                      // points per block tile
constexpr int WM = 64;                       // rows of one consumer warpgroup
constexpr int BK = TILE_K;                   // K values per ring stage (64)
constexpr int STAGES = 3;                    // ring depth
constexpr int NT_WG = 384;                   // producer + 2 consumer warpgroups
constexpr int A_BYTES = BM * LINE_BYTES;     // 16 KB a stage

// Shared-memory plan of a block for BN output columns: the ring (A then B
// per stage), then each consumer warpgroup's padded C tile.
template <int BN> struct Plan {
  static constexpr int B_BYTES = BN * LINE_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int CS_LD = BN + 8;       // bf16 per row of a C tile
  static constexpr int C_BYTES = WM * CS_LD * 2;
  static constexpr int SMEM_BYTES = RING_BYTES + 2 * C_BYTES + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc_b) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, a0, a1, a2, a3, desc_b);
  else
    wgmma_m64n128k16(d, a0, a1, a2, a3, desc_b);
}

// The previous layer's GroupNorm + leaky (mode 2: y = v * mul + add with
// add = beta - mean * mul, then max(y, 0.01 y)) or a norm-free layer's
// bf16 leaky (mode 1) on a pair of bf16 values; returns the bf16 pair the
// product takes and the f32 values (phi) through y0 / y1.
__device__ __forceinline__ uint32_t act_pair(uint32_t x, int mode, float2 mul,
                                             float2 add, float& y0,
                                             float& y1) {
  y0 = bf16_lo(x);
  y1 = bf16_hi(x);
  if (mode == 2) {
    y0 = fmaf(y0, mul.x, add.x);
    y1 = fmaf(y1, mul.y, add.y);
    y0 = fmaxf(y0, kSlope * y0);
    y1 = fmaxf(y1, kSlope * y1);
  } else {
    y0 = leaky_bf16(y0);
    y1 = leaky_bf16(y1);
  }
  return pack_bf16(y0, y1);
}

// One persistent block an SM walks the output tiles (128 points x BN
// columns, column tile fastest).  Warpgroup 0 produces: one of its threads
// waits for a ring slot to be handed back and asks the TMA for the stage's
// A and B boxes, whose bytes complete the slot's `full` barrier.
// Warpgroups 1 and 2 consume 64 rows each: wait for `full`, make the A
// fragments, start the products, and arrive on `empty` when the stage's
// products are done.  Nothing in the main loop stops the whole block, and
// the producer loads the next tile's stages while the consumers are in
// their epilogues.  The producers hand registers to the consumers
// (setmaxnreg): without that the 168 a thread of a 384-thread block do not
// hold 128 accumulators beside the fragments, and ptxas spills and
// serialises the products.  NORM is p.norm_in, known when the kernel is
// compiled.
template <int NORM, int BN>
__global__ void __launch_bounds__(NT_WG, 1) layer_wgmma_kernel(
    const LayerParams p, const __grid_constant__ CUtensorMap tm_a1,
    const __grid_constant__ CUtensorMap tm_a2,
    const __grid_constant__ CUtensorMap tm_b) {
  using P = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(16) float s_mul[MAXK_NORM];
  __shared__ __align__(16) float s_add[MAXK_NORM];
  __shared__ __align__(16) uint32_t s_bias[2][BN / 2];   // bf16 pairs
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];

  const int t = threadIdx.x;
  const int n_ct = (p.M + BN - 1) / BN;
  const int n_tiles = ((p.N + BM - 1) / BM) * n_ct;
  const int KT1 = p.K1p / BK, KT = (p.K1p + p.K2p) / BK;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);       // the producer thread (+ its bytes)
      mbar_init(&empty_bar[s], 8);      // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (t < 128) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = (tile / n_ct) * BM, col0 = (tile % n_ct) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
          const uint32_t sa = ring + s * P::STAGE_BYTES;
          mbar_arrive_expect_tx(&full_bar[s], P::STAGE_BYTES);
          // rows past N, columns past a row's readable width and weight
          // rows past M arrive as zeros
          if (kt < KT1)
            tma_load_2d(sa, &tm_a1, kt * BK, row0, &full_bar[s]);
          else
            tma_load_2d(sa, &tm_a2, (kt - KT1) * BK, row0, &full_bar[s]);
          tma_load_2d(sa + A_BYTES, &tm_b, kt * BK, col0, &full_bar[s]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int cw = (t >> 7) - 1;            // consumer warpgroup 0 / 1
    const int tw = t & 127, tc = t - 128;   // thread in warpgroup / consumers
    const int warp = tw >> 5, lane = t & 31;
    const int gid = lane >> 2, tig = lane & 3;
    // this thread's rows of the block tile: arow for ldmatrix, r_lo and
    // r_lo + 8 in the fragments and the accumulators
    const int arow = cw * WM + warp * 16 + (lane & 15);
    const int r_lo = cw * WM + warp * 16 + gid;
    bf16* Cs = reinterpret_cast<bf16*>(smem_raw + (ring - raw) +
                                       P::RING_BYTES + cw * P::C_BYTES);
    constexpr int CS_LD = P::CS_LD;
    int it = 0, cur_seg = -1;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int rt = tile / n_ct, ct = tile % n_ct;
      const int row0 = rt * BM, col0 = ct * BN;
      const bool write_phi = p.phi_out != nullptr && ct == 0;

      // this tile's biases (a copy per warpgroup) and, when the segment
      // changes, the previous layer's GroupNorm as y = v * mul + add
      for (int c = 2 * tw; c < BN; c += 256)
        s_bias[cw][c / 2] =
            pack_bf16(col0 + c < p.M ? p.bias[col0 + c] : 0.f,
                      col0 + c + 1 < p.M ? p.bias[col0 + c + 1] : 0.f);
      if (NORM == 2) {
        const int seg = row0 / p.seg_rows;
        if (seg != cur_seg) {
          cur_seg = seg;
          named_barrier(3, 256);      // both warpgroups are past the old ones
          const float n = (float)p.seg_rows * (float)p.cg_in;
#pragma unroll
          for (int i = 0; i < MAXK_NORM / 256; ++i) {
            const int c = tc + i * 256;
            if (c < p.K1p) {
              float mul = 0.f, add = 0.f;
              if (c < p.K1) {
                float mean;
                gn_coeffs(
                    p.stats_in +
                      ((int64_t)seg * p.g_in + c / p.cg_in) * 2 * STATS_SPLIT, n,
                    p.gs_in[c], &mean, &mul);
                add = fmaf(-mean, mul, p.gb_in[c]);
              }
              s_mul[c] = mul;
              s_add[c] = add;
            }
          }
          named_barrier(3, 256);
        }
      }

      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      // A fragments of stage kt (ring slot s) into a[16], activated.  The
      // phi stores are a variant of their own: a branch per value would
      // split the arithmetic into blocks the compiler cannot interleave.
      auto activate = [&](int kt, uint32_t(&a)[16], auto with_phi) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = kt * BK + kk * 16 + 2 * tig;
          float2 m0 = make_float2(0.f, 0.f), d0 = m0, m1 = m0, d1 = m0;
          if (NORM == 2) {
            m0 = *reinterpret_cast<const float2*>(&s_mul[k]);
            d0 = *reinterpret_cast<const float2*>(&s_add[k]);
            m1 = *reinterpret_cast<const float2*>(&s_mul[k + 8]);
            d1 = *reinterpret_cast<const float2*>(&s_add[k + 8]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {     // (row, k): lo/k, hi/k, lo/k+8, ..
            float y0, y1;
            a[4 * kk + q] = act_pair(a[4 * kk + q], NORM, q < 2 ? m0 : m1,
                                     q < 2 ? d0 : d1, y0, y1);
            if constexpr (decltype(with_phi)::value) {
              const int grow = row0 + r_lo + 8 * (q & 1);
              const int c = k + 8 * (q >> 1);
              if (grow < p.N) {
                float* dst = p.phi_out + (int64_t)grow * p.K1 + c;
                if (c + 1 < p.K1 && (p.K1 & 1) == 0) {
                  *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
                } else {
                  if (c < p.K1) dst[0] = y0;
                  if (c + 1 < p.K1) dst[1] = y1;
                }
              }
            }
          }
        }
      };
      auto load_frags = [&](int kt, int s, uint32_t(&a)[16]) {
        const uint32_t sa = ring + s * P::STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                      sa + swz128(arow, 2 * kk + (lane >> 4)));
        if (NORM != 0 && kt < KT1) {
          if (write_phi)
            activate(kt, a, cuda::std::true_type{});
          else
            activate(kt, a, cuda::std::false_type{});
        }
      };

      // The next stage's A is awaited and prepared while this stage's
      // products are in flight; a stage is handed back once they are done.
      uint32_t a_cur[16], a_next[16] = {};
      mbar_wait(&full_bar[it % STAGES], (it / STAGES) & 1);
      load_frags(0, it % STAGES, a_cur);
      fence_regs(a_cur);
      // not unrolled: unrolled by two, nvcc 12.8 renamed the two fragment
      // sets across the products in flight and the sums came out wrong
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t sb = ring + s * P::STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_tile<BN>(acc, a_cur[4 * kk], a_cur[4 * kk + 1],
                         a_cur[4 * kk + 2], a_cur[4 * kk + 3],
                         desc_k128(sb) + 2 * kk);
        wgmma_commit();
        if (kt + 1 < KT) {
          const int s1 = (it + 1) % STAGES;
          mbar_wait(&full_bar[s1], ((it + 1) / STAGES) & 1);
          load_frags(kt + 1, s1, a_next);
          fence_regs(a_next);   // made here, while the products are in flight
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty_bar[s]);
#pragma unroll
        for (int i = 0; i < 16; ++i) a_cur[i] = a_next[i];
      }
      fence_regs(acc);

      // epilogue of this warpgroup's 64 rows: product rounded to bf16, bias
      // added in bf16 (a bf16 add rounds the exact sum once, as the f32 add
      // of two bf16 values rounded to bf16 does)
      named_barrier(1 + cw, 128);   // the biases are in place, the last
                                    // tile's C tile has been read
      // The three variants are separate loops: the common one (a tile
      // inside the matrix) stays a few instructions a value, and the code
      // of the others is not threaded through it.
      const bool inner = row0 + BM <= p.N && col0 + BN <= p.M;
      const int rl = r_lo - cw * WM;        // row in this warpgroup's C tile
      auto value = [&](int j, int h) {      // bf16 pair (row r_lo + 8 h)
        const __nv_bfloat162 v2 = __hadd2(
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]),
            *reinterpret_cast<const __nv_bfloat162*>(&s_bias[cw][4 * j + tig]));
        return *reinterpret_cast<const uint32_t*>(&v2);
      };
      if (p.last) {
        // the last layer: f32 straight to global memory, its activation
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t u = value(j, h);
            const float v[2] = {bf16_lo(u), bf16_hi(u)};
            const int grow = row0 + r_lo + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gcol = col0 + 8 * j + 2 * tig + e;
              if (grow < p.N && gcol < p.M) {
                if (p.raw_out) p.raw_out[(int64_t)grow * p.M + gcol] = v[e];
                static_cast<float*>(p.out)[(int64_t)grow * p.ldo + gcol] =
                    head_act(p, v[e]);
              }
            }
          }
        }
      } else if (inner) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(
                &Cs[(rl + 8 * h) * CS_LD + 8 * j + 2 * tig]) = value(j, h);
      } else {
        // zeros outside the matrix: they pad the stored rows and leave the
        // column sums alone
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * tig;
          const uint32_t keep = (col0 + c < p.M ? 0xFFFFu : 0u) |
                                (col0 + c + 1 < p.M ? 0xFFFF0000u : 0u);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(&Cs[(rl + 8 * h) * CS_LD + c]) =
                row0 + r_lo + 8 * h < p.N ? value(j, h) & keep : 0u;
        }
      }
      named_barrier(1 + cw, 128);   // the C tile is whole, the biases spent
      if (p.last) continue;
      bf16* out = static_cast<bf16*>(p.out);
      const int wrow0 = row0 + cw * WM;
#pragma unroll
      for (int i = 0; i < WM * BN / VEC / 128; ++i) {
        const int id = tw + i * 128, r = id / (BN / VEC),
                  c = (id % (BN / VEC)) * VEC;
        if (wrow0 + r < p.N && col0 + c < p.ldo)
          *reinterpret_cast<uint4*>(out + (int64_t)(wrow0 + r) * p.ldo + col0 +
                                    c) =
              *reinterpret_cast<const uint4*>(&Cs[r * CS_LD + c]);
      }
      if (p.part_out == nullptr || wrow0 >= p.N) continue;
      // column sums of the stored values over this warpgroup's 64 rows, in
      // row order: one row block of the partials, no other thread involved
      constexpr int CPT = BN / 128;         // columns a thread sums
      float sum[CPT], sq[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e) sum[e] = sq[e] = 0.f;
#pragma unroll 16
      for (int r = 0; r < WM; ++r) {
        float v[CPT];
        if constexpr (CPT == 2) {
          const uint32_t u =
              *reinterpret_cast<const uint32_t*>(&Cs[r * CS_LD + 2 * tw]);
          v[0] = bf16_lo(u);
          v[1] = bf16_hi(u);
        } else {
          v[0] = __bfloat162float(Cs[r * CS_LD + tw]);
        }
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          sum[e] += v[e];
          sq[e] = fmaf(v[e], v[e], sq[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const int gcol = col0 + tw * CPT + e;
        if (gcol < p.M)
          *reinterpret_cast<float2*>(
              p.part_out + ((int64_t)(2 * rt + cw) * p.M + gcol) * 2) =
              make_float2(sum[e], sq[e]);
      }
    }
  }
}

// The head (the last layer, M = NC columns: the occupancy fields' one, the
// texture field's HEAD_COLS): NC dot products per row from one read of it,
// with the same prologue, half a warp per row (its 16 lanes cover a
// 128-wide row in one 16-byte load each), 32 rows a block.  Bound by the
// bytes of its A rows.
constexpr int HEAD_ROWS = 32;
constexpr int HEAD_COLS = 3;

template <int NC>
__global__ void __launch_bounds__(NT) head_kernel(const LayerParams p) {
  __shared__ __align__(16) float s_mul[MAXK_NORM];
  __shared__ __align__(16) float s_add[MAXK_NORM];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * HEAD_ROWS;
  const bf16* w = static_cast<const bf16*>(p.w);
  const int ldw = p.K1p + p.K2p;        // a column's weights
  if (p.norm_in == 2) {
    const int seg = row0 / p.seg_rows;
    const float n = (float)p.seg_rows * (float)p.cg_in;
    for (int c = t; c < p.K1; c += NT) {
      float mean, mul;
      gn_coeffs(p.stats_in +
                      ((int64_t)seg * p.g_in + c / p.cg_in) * 2 * STATS_SPLIT, n,
                p.gs_in[c], &mean, &mul);
      s_mul[c] = mul;
      s_add[c] = fmaf(-mean, mul, p.gb_in[c]);
    }
    __syncthreads();
  }
  constexpr int ROWS_PER_WARP = HEAD_ROWS / (NT / 32);
  const int half = lane >> 4, hl = lane & 15;
  for (int i = 0; i < ROWS_PER_WARP; i += 2) {
    const int row = row0 + warp * ROWS_PER_WARP + i + half;
    const bool live = row < p.N;        // the shuffles below need every lane
    float sum[NC];
#pragma unroll
    for (int o = 0; o < NC; ++o) sum[o] = 0.f;
    const bf16* a = static_cast<const bf16*>(p.a1) + (int64_t)row * p.lda1;
    for (int k = hl * VEC; live && k < p.lda1; k += 16 * VEC) {
      const uint4 av = *reinterpret_cast<const uint4*>(a + k);
      const uint32_t ax[4] = {av.x, av.y, av.z, av.w};
      uint32_t wx[NC][4];
#pragma unroll
      for (int o = 0; o < NC; ++o) {
        const uint4 wv = *reinterpret_cast<const uint4*>(w + o * ldw + k);
        wx[o][0] = wv.x;
        wx[o][1] = wv.y;
        wx[o][2] = wv.z;
        wx[o][3] = wv.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k + 2 * j;
        uint32_t x = ax[j];
        if (p.norm_in != 0) {
          float2 m = make_float2(0.f, 0.f), d = m;
          if (p.norm_in == 2 && c < p.K1) {
            m = make_float2(s_mul[c], c + 1 < p.K1 ? s_mul[c + 1] : 0.f);
            d = make_float2(s_add[c], c + 1 < p.K1 ? s_add[c + 1] : 0.f);
          }
          float y0, y1;
          x = act_pair(x, p.norm_in, m, d, y0, y1);
          if (p.phi_out != nullptr) {
            float* dst = p.phi_out + (int64_t)row * p.K1 + c;
            if (c < p.K1) dst[0] = y0;
            if (c + 1 < p.K1) dst[1] = y1;
          }
        }
#pragma unroll
        for (int o = 0; o < NC; ++o) {
          sum[o] = fmaf(bf16_lo(x), bf16_lo(wx[o][j]), sum[o]);
          sum[o] = fmaf(bf16_hi(x), bf16_hi(wx[o][j]), sum[o]);
        }
      }
    }
    if (p.K2p) {
      const bf16* b = static_cast<const bf16*>(p.a2) + (int64_t)row * p.lda2;
      for (int k = hl * VEC; live && k < p.lda2; k += 16 * VEC) {
        const uint4 av = *reinterpret_cast<const uint4*>(b + k);
        const uint32_t ax[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int o = 0; o < NC; ++o) {
          const uint4 wv =
              *reinterpret_cast<const uint4*>(w + o * ldw + p.K1p + k);
          const uint32_t wx[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sum[o] = fmaf(bf16_lo(ax[j]), bf16_lo(wx[j]), sum[o]);
            sum[o] = fmaf(bf16_hi(ax[j]), bf16_hi(wx[j]), sum[o]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NC; ++o) {
#pragma unroll
      for (int s = 8; s > 0; s >>= 1)
        sum[o] += __shfl_xor_sync(0xFFFFFFFFu, sum[o], s);
    }
    if (live && hl == 0) {
#pragma unroll
      for (int o = 0; o < NC; ++o) {
        const float v = round_bf16(__fadd_rn(round_bf16(sum[o]), p.bias[o]));
        if (p.raw_out) p.raw_out[(int64_t)row * NC + o] = v;
        static_cast<float*>(p.out)[(int64_t)row * p.ldo + o] = head_act(p, v);
      }
    }
  }
}

}  // namespace wg

// -------------------------------------------------------- f32 FMA layer
namespace f32 {

constexpr int BM = 64;         // points per block tile
constexpr int BN = 128;        // output columns per block tile
constexpr int BK = 32;         // K step
constexpr int A_CH = BM * BK / VEC / NT;   // A chunks per thread (1)
constexpr int B_CH = BN * BK / VEC / NT;   // B chunks per thread (2)
constexpr int TM = BM / 16, TN = BN / 16;  // thread tile (4 x 8)
constexpr int QR = NT / BN;                // row groups of the stats pass
constexpr int C_BYTES = BM * (BN + 1) * 4;
constexpr int TILE_BYTES = BK * (BM + 4) * 4 + BK * (BN + 4) * 4;
constexpr int SMEM_BYTES = C_BYTES > TILE_BYTES ? C_BYTES : TILE_BYTES;
static_assert(A_CH * NT * VEC == BM * BK && B_CH * NT * VEC == BN * BK,
              "chunk split");
static_assert(TM * TN == 32 && QR * BN == NT && QR * BN * 2 <= MAXK_NORM,
              "thread tiles");

// Eight consecutive floats, moved as 16-byte words.
struct __align__(16) Chunk { float e[VEC]; };

__device__ __forceinline__ void ld_chunk(Chunk& c, const float* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  uint4* d = reinterpret_cast<uint4*>(c.e);
  d[0] = s[0];
  d[1] = s[1];
}

__device__ __forceinline__ void zero_chunk(Chunk& c) {
  uint4* d = reinterpret_cast<uint4*>(c.e);
  d[0] = d[1] = make_uint4(0u, 0u, 0u, 0u);
}

// out = act_in(A) @ W^T + bias over all points, FMA tiles; the next K
// step's chunks are loaded into registers while this one is multiplied.
__global__ void __launch_bounds__(NT) layer_f32_kernel(const LayerParams p) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  __shared__ __align__(16) float s_mean[MAXK_NORM];
  __shared__ __align__(16) float s_mul[MAXK_NORM];
  __shared__ __align__(16) float s_add[MAXK_NORM];

  const int t = threadIdx.x;
  const int n_ct = (p.M + BN - 1) / BN;
  const int rt = blockIdx.x / n_ct, ct = blockIdx.x % n_ct;
  const int row0 = rt * BM, col0 = ct * BN;
  const int seg = row0 / p.seg_rows;
  const int Kp = p.K1p + p.K2p;
  const float* a1 = static_cast<const float*>(p.a1);
  const float* a2 = static_cast<const float*>(p.a2);
  const float* w = static_cast<const float*>(p.w);
  const bool write_phi = p.phi_out != nullptr && ct == 0;

  if (p.norm_in == 2) {
    const float n = (float)p.seg_rows * (float)p.cg_in;
    for (int c = t; c < p.K1; c += NT) {
      const float* st =
          p.stats_in +
                      ((int64_t)seg * p.g_in + c / p.cg_in) * 2 * STATS_SPLIT;
      gn_coeffs(st, n, p.gs_in[c], &s_mean[c], &s_mul[c]);
      s_add[c] = p.gb_in[c];
    }
  }

  const int tx = t & 15, ty = t >> 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  Chunk ra[A_CH], rb[B_CH];
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
      const int gk = k0 + kc, grow = row0 + r;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = ra[i].e[j];
        if (gk < p.K1p) {
          const int g = gk + j;
          if (g >= p.K1) {
            v = 0.f;
          } else if (p.norm_in != 0) {
            if (p.norm_in == 2)
              v = leaky(__fadd_rn(
                  __fmul_rn(__fsub_rn(v, s_mean[g]), s_mul[g]), s_add[g]));
            else
              v = leaky(v);
            if (write_phi && grow < p.N)
              p.phi_out[(int64_t)grow * p.K1 + g] = v;
          }
        }
        reinterpret_cast<float(*)[BM + 4]>(smem)[kc + j][r] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = t + i * NT, n = c / CPR, kc = (c % CPR) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        reinterpret_cast<float(*)[BN + 4]>(smem + BK * (BM + 4) * 4)
            [kc + j][n] = rb[i].e[j];
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < Kp; k0 += BK) {
    __syncthreads();   // the last step's readers are done (and the norm
                       // coefficients are in place on the first step)
    store_tile(k0);
    __syncthreads();
    if (k0 + BK < Kp) load_tile(k0 + BK);   // in flight during the FMAs
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
  __syncthreads();

  // accumulators -> C tile in shared memory (aliases the operand tiles)
  auto Cs = reinterpret_cast<float(*)[BN + 1]>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      Cs[ty + 16 * i][tx + 16 * j] = acc[i * TN + j];
  __syncthreads();

  // epilogue: bias, store; the stored value feeds the stats
  for (int it = 0; it < BM * BN / NT; ++it) {
    const int idx = it * NT + t, r = idx / BN, c = idx % BN;
    const int grow = row0 + r, gcol = col0 + c;
    float v = 0.f;
    if (grow < p.N && gcol < p.M) {
      v = __fadd_rn(Cs[r][c], p.bias[gcol]);
      if (p.last) {
        if (p.raw_out) p.raw_out[(int64_t)grow * p.M + gcol] = v;
        static_cast<float*>(p.out)[(int64_t)grow * p.ldo + gcol] =
            head_act(p, v);
      } else {
        static_cast<float*>(p.out)[(int64_t)grow * p.ldo + gcol] = v;
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
    float* dst = p.part_out + ((int64_t)rt * p.M + col0 + t) * 2;
    dst[0] = s;
    dst[1] = ss;
  }
}

}  // namespace f32

// GroupNorm statistics of one (segment, group, slice): the column partials
// of the slice's row blocks (bm rows each), summed in a fixed order.  A
// slice is a STATS_SPLIT-th of the segment's row blocks, 8 at least.
__global__ void __launch_bounds__(NT) stats_reduce_kernel(
    const float* __restrict__ part, int n_rb, int bm, int M, int cg, int G,
    int seg_rows, float* __restrict__ stats) {
  __shared__ float red[2][NT];
  const int t = threadIdx.x;
  const int sp = blockIdx.x % STATS_SPLIT, sg = blockIdx.x / STATS_SPLIT;
  const int s = sg / G, g = sg % G;
  const int seg0 = (int)((int64_t)s * seg_rows / bm);
  const int seg1 =
      min(n_rb, (int)(((int64_t)(s + 1) * seg_rows + bm - 1) / bm));
  const int slice = max(8, (seg1 - seg0 + STATS_SPLIT - 1) / STATS_SPLIT);
  const int rb0 = min(seg1, seg0 + sp * slice);
  const int rb1 = min(seg1, rb0 + slice);
  const int items = (rb1 - rb0) * cg;
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int i = t; i < items; i += NT) {
    const float2 v = *reinterpret_cast<const float2*>(
        part + ((int64_t)(rb0 + i / cg) * M + g * cg + i % cg) * 2);
    a += v.x;
    b += v.y;
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
    stats[(int64_t)blockIdx.x * 2] = red[0][0];
    stats[(int64_t)blockIdx.x * 2 + 1] = red[1][0];
  }
}

cudaError_t launch_gather(int dtype, const GatherParams& g, cudaStream_t s) {
  const dim3 grid((unsigned)(((int64_t)g.N * 32 + NT - 1) / NT));
  if (dtype == 1)
    gather_kernel<bf16><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(g.feat), g.H, g.W, g.C, g.uv, g.extra, g.E,
        static_cast<bf16*>(g.x0), g.ldx, g.N);
  else
    gather_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(g.feat), g.H, g.W, g.C, g.uv, g.extra, g.E,
        static_cast<float*>(g.x0), g.ldx, g.N);
  return cudaGetLastError();
}

// Number of SMs of the current device (one persistent block each).
int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return v;
  }();
  return n;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the build
// links no libcuda).
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// Tensor map of a row-major bf16 matrix [rows, cols] with `ld` elements a
// row: boxes of box_rows x 64 elements in the 128-byte swizzle, zeros
// outside the matrix.
bool make_map(CUtensorMap* m, const void* base, int cols, int rows, int ld,
              int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)wg::BK, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return encode_tiled() != nullptr &&
         encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dim, stride, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NORM, int BN>
cudaError_t launch_wgmma_bn(const LayerParams& p, cudaStream_t s) {
  constexpr int smem = wg::Plan<BN>::SMEM_BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg::layer_wgmma_kernel<NORM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (sm_count() <= 0) return cudaErrorInvalidDevice;
  const int n_tiles =
      ((p.N + wg::BM - 1) / wg::BM) * ((p.M + BN - 1) / BN);
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  CUtensorMap tm_a1, tm_a2, tm_b;
  const bool res = p.K2p != 0;
  if (!make_map(&tm_a1, p.a1, p.lda1, p.N, p.lda1, wg::BM) ||
      !make_map(&tm_a2, res ? p.a2 : p.a1, res ? p.lda2 : p.lda1, p.N,
                res ? p.lda2 : p.lda1, wg::BM) ||
      !make_map(&tm_b, p.w, p.K1p + p.K2p, p.M, p.K1p + p.K2p, BN))
    return cudaErrorInvalidValue;
  wg::layer_wgmma_kernel<NORM, BN>
      <<<grid, wg::NT_WG, smem, s>>>(p, tm_a1, tm_a2, tm_b);
  return cudaSuccess;
}

// 256 columns a tile where the layer is wider than 128, else 128.
template <int NORM>
cudaError_t launch_wgmma(const LayerParams& p, cudaStream_t s) {
  return p.M > 128 ? launch_wgmma_bn<NORM, 256>(p, s)
                   : launch_wgmma_bn<NORM, 128>(p, s);
}

// One layer: its kernel by `kind`, then the statistics reduce it feeds.
cudaError_t launch_layer(int dtype, const LayerParams& p, cudaStream_t s) {
  if ((p.kind == 0) != (dtype == 0) || p.kind < 0 || p.kind > 2 ||
      (p.kind == 2 && !((p.M == 1 || p.M == wg::HEAD_COLS) && p.last)) ||
      p.norm_in < 0 ||
      p.norm_in > 2)
    return cudaErrorInvalidValue;
  int bm = f32::BM;
  if (p.kind == 0) {
    const unsigned n_rb = (p.N + f32::BM - 1) / f32::BM;
    const unsigned n_ct = (p.M + f32::BN - 1) / f32::BN;
    f32::layer_f32_kernel<<<n_rb * n_ct, NT, 0, s>>>(p);
  } else if (p.kind == 1) {
    bm = wg::WM;
    const cudaError_t e = p.norm_in == 0   ? launch_wgmma<0>(p, s)
                          : p.norm_in == 1 ? launch_wgmma<1>(p, s)
                                           : launch_wgmma<2>(p, s);
    if (e != cudaSuccess) return e;
  } else {
    const unsigned grid = (p.N + wg::HEAD_ROWS - 1) / wg::HEAD_ROWS;
    if (p.M == 1)
      wg::head_kernel<1><<<grid, NT, 0, s>>>(p);
    else
      wg::head_kernel<wg::HEAD_COLS><<<grid, NT, 0, s>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.part_out == nullptr) return e;
  stats_reduce_kernel<<<(unsigned)(p.n_seg * p.g_out * STATS_SPLIT), NT, 0,
                        s>>>(
      p.part_out, (p.N + bm - 1) / bm, bm, p.M, p.cg_out, p.g_out, p.seg_rows,
      p.stats_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// What the Python side must agree on: 0 sizeof(GatherParams), 1
// sizeof(LayerParams), 2 / 3 rows per row block of the statistics partials
// of the f32 / bf16 layer kernel, 4 the bf16 kernels' K padding, 5 the rows
// of a bf16 block tile (what a GroupNorm segment must be a multiple of), 6
// the partial pairs a (segment, group) entry of the statistics holds, 7 the
// columns of the head kernel's wider variant.
int fq_abi(int which) {
  switch (which) {
    case 0: return (int)sizeof(GatherParams);
    case 1: return (int)sizeof(LayerParams);
    case 2: return f32::BM;
    case 3: return wg::WM;
    case 5: return wg::BM;
    case 6: return STATS_SPLIT;
    case 4: return wg::BK;
    case 7: return wg::HEAD_COLS;
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (of feat, x0, h and weights)
int fq_gather(int dtype, const GatherParams* g, void* stream) {
  return (int)launch_gather(dtype, *g, static_cast<cudaStream_t>(stream));
}

// Launch `which` of a chain alone: 0 the gather, i + 1 layer i (with its
// statistics reduce).  For timing one launch; fq_chain runs them all.
int fq_launch(int dtype, const GatherParams* g, const LayerParams* layers,
              int n_layers, int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which < 0 || which > n_layers) return (int)cudaErrorInvalidValue;
  if (which == 0) return (int)launch_gather(dtype, *g, s);
  return (int)launch_layer(dtype, layers[which - 1], s);
}

// The whole chain on the stream.  Returns the first CUDA error; *failed_at
// is then the index of the launch that raised it (as fq_launch counts).
int fq_chain(int dtype, const GatherParams* g, const LayerParams* layers,
             int n_layers, void* stream, int* failed_at) {
  for (int i = 0; i <= n_layers; ++i) {
    const int rc = fq_launch(dtype, g, layers, n_layers, i, stream);
    if (rc != 0) {
      *failed_at = i;
      return rc;
    }
  }
  return 0;
}

}  // extern "C"
