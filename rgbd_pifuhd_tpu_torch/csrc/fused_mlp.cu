// Fused per-point MLP for Hopper: the whole norm-free PointMLP chain in one
// launch.
//
// Replaces the TPU kernel rgbd_pifuhd_tpu/ops/pallas_mlp.py fused_point_mlp
// (pallas_call at :136, body :105-124).  Per point: x0 [C0] runs through
// Dense layers, leaky_relu(0.01) between them, a residual layer reading
// concat(h, x0), and an optional sigmoid head; only [N, C_out] is written.
// The TPU version pads every width to 128 lanes and sizes its block to the
// VMEM budget; neither is carried over.
//
// What bounds it on an H100: operations (0.41 M MAC per point at the fine
// widths 272-512-256-128-1, 1.05 M at the coarse widths
// 257-1024-512-256-128-1; x0 is read once, 2 * C0 bytes per point), and,
// if nothing is done about it, the weights: every tile of points needs the
// whole chain's weights (0.82 MB fine, 2.1 MB coarse, bf16) from L2.
//
// bf16 (chain_kernel).  One persistent block an SM walks tiles of BM points
// (128, or 64 where a layer is too wide for 128 rows of activations) and
// keeps the tile's activations in shared memory for the whole chain, in the
// K-major 128-byte-swizzled layout that a wgmma descriptor reads: each layer
// takes its A operand from there by descriptor (wgmma "SS"), with no
// per-value work between the layers' products.  x0 is not kept: the K ranges
// that read it (layer 0, the residual ranges) stream x0 boxes through a
// ring.  A producer warpgroup asks the TMA for every box: 64-wide K slices
// of a layer's weights (at most 128 output columns) and of x0, into two
// rings of stages behind `full` / `empty` mbarriers (rows past N, columns
// past C0 and weight rows past M arrive as zeros).  Two consumer
// warpgroups run wgmma, one product group in flight behind the one being
// issued; at BM = 128 each owns 64 rows and every column, at BM = 64 both
// own the 64 rows and split the columns.  A layer keeps its
// whole output in registers (at most 128 accumulators a thread, in one to
// four passes over the columns), and once both warpgroups are past their
// last product, its epilogue (bias, rounding, leaky) writes the output over
// the layer's own input; layer 0, whose input is x0, may run in column
// groups, each written as it ends.  The epilogue works on bf16 pairs: with
// 8 consumer warps, f32 steps one value at a time cost more than the
// products of the narrow layers.  The last layer writes f32 (sigmoid) to
// device memory; a one-column head is a layer with eight columns, seven of
// them zero weights.
//
// Blocks run as clusters of 1, 2 or 4 on separate point tiles, in step: each
// weight box is loaded once by one block of the cluster (in turn) with
// .multicast::cluster into the same stage of every block's ring, so L2
// serves each weight byte once per cluster.  A stage is reused only when the
// consumers of every block of the cluster have released it: each consumer
// warp arrives on that stage's `empty` barrier in every block.  The plan
// takes clusters of 1 unless asked: on the H100 the blocks' waiting for each
// other at every stage cost more than the shared L2 reads saved.
//
// x0 boxes have a ring of their own, filled by a second producer thread: in
// the weights' ring they would wait behind its stages, and the producer
// could run only a stage or so ahead of the consumers.
//
// The host plan (ops/fused_mlp.py plan_wgmma) fixes the tile rows, the
// cluster, the columns of each pass and the shared-memory layout: the
// activations at offset 0, then the x0 ring, then the weights' ring, each
// region 1024-byte aligned.  This file checks the plan and builds the
// tensor maps.
//
// f32 (mlp_kernel): a block owns BM points (64, 32 or 16), keeps x0 and the
// two newest activations in shared memory and runs FMA tiles over weight
// tiles streamed from L2 in 16-byte chunks.  It checks the arithmetic and
// carries f32 models (bench_tiny).
//
// Rounding follows flax's PointMLP(dtype=bf16): the product is rounded to
// bf16, the bias is added in bf16, leaky_relu runs in bf16 (the slope 0.01
// itself rounded to bf16), the sigmoid in f32.  f32 stays f32 throughout.
// No atomics: two launches on the same input give the same bits.
//
// Plain C interface for ctypes: fm_forward (f32) and fm_wg_forward (bf16)
// return cudaGetLastError(), or a negative code for arguments or a plan they
// refuse; fm_abi reports what the Python side must agree on.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

constexpr int MAX_LAYERS = 8;

// Arguments of one f32 launch (mirrored by a ctypes.Structure).  Outside the
// anonymous namespace: the extern "C" entry points take it by pointer.
struct MlpParams {
  const void* x;                  // [N, ldx] f32, C0 real columns
  float* out;                     // [N, M[last]] f32
  const void* w[MAX_LAYERS];      // [M, K1p + K2p] f32, zero-padded
  const float* bias[MAX_LAYERS];  // [M]
  int M[MAX_LAYERS];              // output width of each layer
  int res[MAX_LAYERS];            // 1: the layer reads concat(h, x0)
  int K1p[MAX_LAYERS];            // filled by fm_forward: padded width of h
  int K2p[MAX_LAYERS];            // filled by fm_forward: padded x0 range or 0
  int n_layers, N, C0, ldx, sigmoid;
  int ldx_s, ldh0, ldh1;          // filled by fm_forward: smem row strides
};

// Arguments and plan of one bf16 launch (mirrored by a ctypes.Structure and
// filled by ops/fused_mlp.py plan_wgmma).
struct WgParams {
  const void* x;                  // [N, ldx] bf16, C0 real columns
  float* out;                     // [N, M[last]] f32
  const void* w[MAX_LAYERS];      // [M, 64 (KT1 + KT2)] bf16, K ranges
                                  // zero-padded to 64
  const float* bias[MAX_LAYERS];  // [P * cp * CN]: rounded to bf16, zero
                                  // past M
  int M[MAX_LAYERS];              // output width of each layer
  int KT1[MAX_LAYERS];            // 64-wide K steps of x0 (layer 0) or h
  int KT2[MAX_LAYERS];            // 64-wide K steps of the residual x0, or 0
  int CN[MAX_LAYERS];             // columns of a consumer warpgroup a pass
  int P[MAX_LAYERS];              // passes over the layer's columns
  int G[MAX_LAYERS];              // passes whose accumulators are held at once
  int n_layers, N, C0, ldx, sigmoid;
  int bm, cluster;
  int stages, stage_bytes, ring_off;   // the weight ring
  int xstages, xring_off;              // the x0 ring (stages of bm x 64)
  int smem_bytes;
};

namespace {

constexpr float kSlope = 0.01f;
constexpr float kSlopeBf16 = 0.010009765625f;   // 0.01 rounded to bf16


__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// ------------------------------------------------------------ f32 FMA path
namespace f32 {

constexpr int BN = 128;        // output columns per tile
constexpr int BK = 64;         // K step
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int VEC = 8;         // elements per chunk
constexpr int B_CH = BN * BK / VEC / NT;   // W chunks per thread (4)
constexpr int SMEM_MAX = 227 * 1024;
constexpr int WT_BYTES = BK * (BN + 4) * 4;   // W tile [BK][BN + 4]

__host__ __device__ constexpr int r8(int n) { return (n + 7) / 8 * 8; }

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

template <int BM>
__global__ void __launch_bounds__(NT) mlp_kernel(const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* hb0 = xs + BM * p.ldx_s;
  float* hb1 = hb0 + BM * p.ldh0;
  unsigned char* wt = reinterpret_cast<unsigned char*>(hb1 + BM * p.ldh1);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BM;

  // ---- x0 tile: C0 real columns, the rest of each row zero
  {
    const float* xg = static_cast<const float*>(p.x);
    const bool vec_ok = (p.ldx % VEC == 0) &&
        (reinterpret_cast<uintptr_t>(xg) % sizeof(Chunk) == 0);
    const int cpr = p.ldx_s / VEC;
    for (int idx = t; idx < BM * cpr; idx += NT) {
      const int r = idx / cpr, c0 = (idx - r * cpr) * VEC;
      const int gr = row0 + r;
      Chunk ch;
      if (gr < p.N && vec_ok && c0 + VEC <= p.C0) {
        ld_chunk(ch, xg + (int64_t)gr * p.ldx + c0);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          ch.e[j] = (gr < p.N && c0 + j < p.C0)
                        ? xg[(int64_t)gr * p.ldx + c0 + j]
                        : 0.f;
      }
      *reinterpret_cast<Chunk*>(xs + r * p.ldx_s + c0) = ch;
    }
  }
  __syncthreads();

  constexpr int TM = BM / 16, TN = BN / 16;   // thread tile TM x 8
  const int tx = t & 15, ty = t >> 4;
  constexpr int CPR = BK / VEC;    // chunks per W tile row

  const float* hin = xs;
  int ldin = p.ldx_s;
  for (int li = 0; li < p.n_layers; ++li) {
    const int M = p.M[li], Mp = r8(M);
    const int K1p = p.K1p[li], Kp = K1p + p.K2p[li];
    const bool last = li == p.n_layers - 1;
    float* hout = (li & 1) ? hb1 : hb0;
    const int ldout = (li & 1) ? p.ldh1 : p.ldh0;
    const float* w = static_cast<const float*>(p.w[li]);
    const float* bias = p.bias[li];

    for (int col0 = 0; col0 < M; col0 += BN) {
      float acc[TM * TN];
#pragma unroll
      for (int i = 0; i < TM * TN; ++i) acc[i] = 0.f;
      Chunk rb[B_CH];

      auto load_w = [&](int k0) {
#pragma unroll
        for (int i = 0; i < B_CH; ++i) {
          const int c = t + i * NT, n = c / CPR, gk = k0 + (c % CPR) * VEC;
          if (col0 + n < M && gk < Kp)
            ld_chunk(rb[i], w + (int64_t)(col0 + n) * Kp + gk);
          else
            zero_chunk(rb[i]);
        }
      };
      auto store_w = [&]() {
#pragma unroll
        for (int i = 0; i < B_CH; ++i) {
          const int c = t + i * NT, n = c / CPR, kc = (c % CPR) * VEC;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            reinterpret_cast<float(*)[BN + 4]>(wt)[kc + j][n] = rb[i].e[j];
        }
      };
      // source of the 8 columns [kh, kh + 8) of the layer's A operand
      auto a_src = [&](int kh, int* ld) -> const float* {
        if (kh < K1p) {
          *ld = ldin;
          return hin + kh;
        }
        if (kh < Kp) {
          *ld = p.ldx_s;
          return xs + (kh - K1p);
        }
        return nullptr;
      };

      load_w(0);
      for (int k0 = 0; k0 < Kp; k0 += BK) {
        __syncthreads();   // the last step's readers are done
        store_w();
        __syncthreads();
        if (k0 + BK < Kp) load_w(k0 + BK);   // in flight during the FMAs
        auto Bs = reinterpret_cast<const float(*)[BN + 4]>(wt);
#pragma unroll
        for (int k8 = 0; k8 < BK; k8 += VEC) {
          int ld = 0;
          const float* s = a_src(k0 + k8, &ld);
          if (s == nullptr) break;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = s[(ty + 16 * i) * ld + j];
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) b[jj] = Bs[k8 + j][tx + 16 * jj];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int jj = 0; jj < TN; ++jj)
                acc[i * TN + jj] = fmaf(a[i], b[jj], acc[i * TN + jj]);
          }
        }
      }

      // epilogue from the registers: bias, leaky (or the head)
      auto finish = [&](float v, int r, int c) {
        v = __fadd_rn(v, c < M ? bias[c] : 0.f);
        if (last) {
          const int gr = row0 + r;
          if (gr < p.N && c < M)
            p.out[(int64_t)gr * M + c] = p.sigmoid ? sigmoid(v) : v;
        } else if (c < Mp) {
          // columns [M, Mp) hold exact zeros: the next layer's K padding
          hout[r * ldout + c] = v >= 0.f ? v : __fmul_rn(kSlope, v);
        }
      };
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          finish(acc[i * TN + jj], ty + 16 * i, col0 + tx + 16 * jj);
    }
    __syncthreads();   // hout is complete before the next layer reads it
    hin = hout;
    ldin = ldout;
  }
}

// Row stride of a resident [BM][width] activation.
int row_stride(int width) { return r8(width) + 8; }

template <int BM>
int launch(const MlpParams& p, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mlp_kernel<BM><<<(unsigned)((p.N + BM - 1) / BM), NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a block of `bm` points takes for this chain.
// Fills the derived fields of *p.
int64_t plan(MlpParams* p, int bm) {
  p->ldx_s = row_stride(p->C0);
  p->ldh0 = p->ldh1 = 0;
  for (int i = 0; i < p->n_layers; ++i) {
    p->K1p[i] = r8(i == 0 ? p->C0 : p->M[i - 1]);
    p->K2p[i] = p->res[i] ? r8(p->C0) : 0;
    if (i == p->n_layers - 1) break;
    int& ld = (i & 1) ? p->ldh1 : p->ldh0;
    const int need = row_stride(p->M[i]);
    if (need > ld) ld = need;
  }
  return (int64_t)bm * (p->ldx_s + p->ldh0 + p->ldh1) * 4 + WT_BYTES;
}

}  // namespace f32

// ----------------------------------------------------------- bf16 wgmma path
namespace wg {

using namespace hopper;

constexpr int NT = 384;            // producer + two consumer warpgroups
constexpr int MAX_STAGES = 8;
// dynamic shared memory a plan may ask for: the block's 232,448 bytes less
// room for the static barriers
constexpr int SMEM_PLAN_MAX = 232448 - 1024;

// The tensor maps of one launch: x0 (boxes of 64 K x BM rows) and each
// layer's weights (boxes of 64 K x the layer's stage columns).
struct Maps {
  CUtensorMap x;
  CUtensorMap w[MAX_LAYERS];
};

// Hands weight stage s back: one arrival from each consumer warp on the
// stage's `empty` barrier in every block of the cluster, lane r signalling
// the block of rank r.
__device__ __forceinline__ void release_w(uint64_t* empty_bar, int s, int cs,
                                          int lane) {
  if (cs == 1) {
    if (lane == 0) mbar_arrive(&empty_bar[s]);
  } else if (lane < cs) {
    mbar_arrive_cluster(&empty_bar[s], lane);
  }
}

// The next item of a ring: item i fills slot i % stages, in phase
// (i / stages) & 1, counted without division.
struct Cursor {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The block's two rings: weight stages (filled for the whole cluster) and
// x0 stages (this block's own rows), each with its `full` / `empty`
// barriers and the cursor of the next item.
struct Rings {
  uint32_t w, x;                 // shared addresses of stage 0
  uint64_t *w_full, *w_empty, *x_full, *x_empty;
  Cursor cw, cx;
};

// One layer of the current tile for one consumer warpgroup: the products of
// every pass group, each followed by its epilogue.  CN = columns of this
// warpgroup a pass (CP = 2 / (BM / 64) warpgroups split a pass's columns);
// GM = passes whose accumulators it holds at once (128 a thread at most).
template <int BM, int CN>
__device__ __forceinline__ void consume_layer(
    const WgParams& p, int l, int row0, Rings& r, uint32_t a_base,
    unsigned char* a_ptr, int rg, int cp, int warp, int lane) {
  constexpr int CP = 2 / (BM / 64);
  constexpr int GM = 256 / CN < 4 ? 256 / CN : 4;
  constexpr int NA = CN / 2;
  const int S = p.stages, SX = p.xstages, CS = p.cluster;
  const int KT1 = p.KT1[l], KT = KT1 + p.KT2[l], P = p.P[l], G = p.G[l];
  const int M = p.M[l];
  const bool last = l == p.n_layers - 1;
  const float* bias = p.bias[l];
  // this warpgroup's 64 rows inside a K block of a tile (BM rows x 128 B)
  const uint32_t wg_rows = (uint32_t)rg * 64 * LINE_BYTES;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = rg * 64 + warp * 16 + gid;     // tile row of acc[.][4j]

  for (int g0 = 0; g0 < P; g0 += G) {
    const int np = min(G, P - g0);
    float acc[GM][NA];
#pragma unroll
    for (int q = 0; q < GM; ++q)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[q][i] = 0.f;

    // One product group (a weight stage) stays in flight: once the next
    // one is issued, the one before it is waited for and its stages handed
    // back (the x0 stage of a K step after the step's last group).  Each
    // ring has two stages at least, so the stage awaited is never one this
    // warpgroup still holds.
    int rel_w = -1, rel_x = -1;     // slots to hand back, or -1
    auto retire = [&]() {
      if (rel_w >= 0) release_w(r.w_empty, rel_w, CS, lane);
      if (rel_x >= 0 && lane == 0) mbar_arrive(&r.x_empty[rel_x]);
      rel_w = rel_x = -1;
    };
#pragma unroll 1
    for (int k = 0; k < KT; ++k) {
      // A: an x0 box from its ring, or K block k of the resident activations
      uint32_t a_addr;
      int xs = -1;
      if (l == 0 || k >= KT1) {
        xs = r.cx.slot;
        mbar_wait(&r.x_full[xs], r.cx.phase);
        r.cx.next(SX);
        a_addr = r.x + xs * (BM * LINE_BYTES) + wg_rows;
      } else {
        a_addr = a_base + k * (BM * LINE_BYTES) + wg_rows;
      }
      const uint64_t da = desc_k128(a_addr);
#pragma unroll
      for (int q = 0; q < GM; ++q) {
        if (q < np) {
          const int s = r.cw.slot;
          mbar_wait(&r.w_full[s], r.cw.phase);
          r.cw.next(S);
          const uint64_t db = desc_k128(r.w + s * p.stage_bytes +
                                        cp * CN * LINE_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<CN>(acc[q], da + 2 * kk, db + 2 * kk);
          wgmma_commit();
          wgmma_wait<1>();
          retire();
          rel_w = s;
          rel_x = q == np - 1 ? xs : -1;
        }
      }
    }
    wgmma_wait<0>();
    retire();
#pragma unroll
    for (int q = 0; q < GM; ++q) fence_regs(acc[q]);

    if (last) {
      // f32 straight to device memory, sigmoid head
      float* out = p.out;
#pragma unroll
      for (int q = 0; q < GM; ++q) {
        if (q >= np) break;
        const int cb = (g0 + q) * CP * CN + cp * CN;
#pragma unroll
        for (int j = 0; j < CN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = cb + 8 * j + 2 * tig + e;
              const int gr = row0 + r_lo + 8 * h;
              if (gr < p.N && c < M) {
                float v = round_bf16(acc[q][4 * j + 2 * h + e]);
                v = round_bf16(__fadd_rn(v, bias[c]));
                out[(int64_t)gr * M + c] = p.sigmoid ? sigmoid(v) : v;
              }
            }
      }
      continue;
    }
    // The hidden layer's output goes over the resident activations: both
    // consumer warpgroups are past their last product of this layer (and of
    // the previous tile's last layer) before either writes.
    // Pairs of values in bf16x2 arithmetic, each step rounded once as the
    // f32 steps of the last layer round: the product to bf16, the bias add
    // (the exact sum of two bf16 values, rounded), and leaky as
    // max(v, slope * v) with the product rounded (for v < 0 that product
    // lies above v, for v >= 0 below).
    named_barrier(1, 256);
    const __nv_bfloat162 slope2 = __float2bfloat162_rn(kSlopeBf16);
#pragma unroll
    for (int q = 0; q < GM; ++q) {
      if (q >= np) break;
      const int cb = (g0 + q) * CP * CN + cp * CN;
#pragma unroll
      for (int j = 0; j < CN / 8; ++j) {
        const int c = cb + 8 * j + 2 * tig;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(bb.x, bb.y);
        // K block c / 64, 16-byte chunk (c % 64) / 8 of its 128-byte row,
        // swizzled by the row (row % 8 = gid); columns past M hold zeros
        // (zero weights, zero bias): the next layer's K padding
        unsigned char* at = a_ptr + (c >> 6) * (BM * LINE_BYTES) +
                            r_lo * LINE_BYTES +
                            ((((c & 63) >> 3) ^ gid) << 4) + 4 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 v = __hadd2(
              __floats2bfloat162_rn(acc[q][4 * j + 2 * h],
                                    acc[q][4 * j + 2 * h + 1]),
              b2);
          v = __hmax2(v, __hmul2(v, slope2));
          *reinterpret_cast<__nv_bfloat162*>(at + 8 * h * LINE_BYTES) = v;
        }
      }
    }
    fence_proxy_async();      // the stores, before wgmma reads them
    named_barrier(1, 256);    // the whole output is in place
  }
}

template <int BM>
__global__ void __launch_bounds__(NT, 1) chain_kernel(
    const __grid_constant__ WgParams p, const __grid_constant__ Maps maps) {
  constexpr int CP = 2 / (BM / 64);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t w_full[MAX_STAGES], w_empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t x_full[MAX_STAGES], x_empty[MAX_STAGES];

  const int t = threadIdx.x;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_base = (raw + 1023u) & ~1023u;
  unsigned char* a_ptr = smem_raw + (a_base - raw);
  Rings r = {a_base + p.ring_off, a_base + p.xring_off, w_full, w_empty,
             x_full, x_empty, Cursor(), Cursor()};
  const int S = p.stages, SX = p.xstages, CS = p.cluster;
  const int rank = (int)cluster_rank();
  const int T = (p.N + BM - 1) / BM;           // point tiles
  const int ci = blockIdx.x / CS, ncl = gridDim.x / CS;

  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&w_full[s], 1);        // this block's weight producer + bytes
      mbar_init(&w_empty[s], 8 * CS);  // every consumer warp of the cluster
    }
    for (int s = 0; s < SX; ++s) {
      mbar_init(&x_full[s], 1);        // this block's x0 producer + bytes
      mbar_init(&x_empty[s], 8);       // this block's consumer warps
    }
    mbar_init_fence();
  }
  cluster_sync();

  // The cluster's blocks take tiles (ci + i * ncl) * CS + rank in step: a
  // block whose tile lies past N runs on zero rows and stores nothing, so
  // that every block walks the same sequence of weight stages.
  if (t < 128) {
    // ----------------------------------------------------------- producers
    // thread 0 fills the weight ring, thread 32 the x0 ring; each walks the
    // whole sequence and takes its own items
    setmaxnreg_dec<40>();
    if (t == 0 || t == 32) {
      const bool wp = t == 0;
      int iw = 0;                   // weight items issued: the loader is
                                    // block iw % CS of the cluster
      for (int tg = ci; tg * CS < T; tg += ncl) {
        const int row0 = (tg * CS + rank) * BM;
        for (int l = 0; l < p.n_layers; ++l) {
          const int KT1 = p.KT1[l], KT = KT1 + p.KT2[l], P = p.P[l];
          const int G = p.G[l], SC = CP * p.CN[l];
          for (int g0 = 0; g0 < P; g0 += G) {
            const int np = min(G, P - g0);
            for (int k = 0; k < KT; ++k) {
              if (!wp) {
                if (l == 0 || k >= KT1) {
                  const int s = r.cx.slot;
                  mbar_wait(&x_empty[s], r.cx.phase ^ 1);
                  mbar_arrive_expect_tx(&x_full[s], BM * LINE_BYTES);
                  tma_load_2d(r.x + s * (BM * LINE_BYTES), &maps.x,
                              (l == 0 ? k : k - KT1) * TILE_K, row0,
                              &x_full[s]);
                  r.cx.next(SX);
                }
                continue;
              }
              for (int q = 0; q < np; ++q, r.cw.next(S), ++iw) {
                const int s = r.cw.slot;
                mbar_wait(&w_empty[s], r.cw.phase ^ 1);
                mbar_arrive_expect_tx(&w_full[s], SC * LINE_BYTES);
                const uint32_t dst = r.w + s * p.stage_bytes;
                if (CS == 1)
                  tma_load_2d(dst, &maps.w[l], k * TILE_K, (g0 + q) * SC,
                              &w_full[s]);
                else if (iw % CS == rank)
                  tma_load_2d_multicast(dst, &maps.w[l], k * TILE_K,
                                        (g0 + q) * SC, &w_full[s],
                                        (uint16_t)((1u << CS) - 1u));
              }
            }
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    constexpr int RW = BM / 64;
    const int cw = (t >> 7) - 1;
    const int rg = cw % RW, cp = cw / RW;
    const int warp = (t & 127) >> 5, lane = t & 31;
    for (int tg = ci; tg * CS < T; tg += ncl) {
      const int row0 = (tg * CS + rank) * BM;
      for (int l = 0; l < p.n_layers; ++l) {
#define FM_LAYER(cn) \
  consume_layer<BM, cn>(p, l, row0, r, a_base, a_ptr, rg, cp, warp, lane)
        switch (p.CN[l]) {
          case 128: FM_LAYER(128); break;
          case 64: FM_LAYER(64); break;
          case 32: FM_LAYER(32); break;
          case 16: FM_LAYER(16); break;
          default: FM_LAYER(8); break;
        }
#undef FM_LAYER
      }
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while its peers may still reach it
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
  const cuuint32_t box[2] = {(cuuint32_t)TILE_K, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return encode_tiled() != nullptr &&
         encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dim, stride, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan's invariants (ops/fused_mlp.py plan_wgmma makes them hold).
bool plan_ok(const WgParams& p) {
  const int cp = 2 / (p.bm / 64);
  const int x_bytes = p.bm * LINE_BYTES;
  if ((p.bm != 64 && p.bm != 128) ||
      (p.cluster != 1 && p.cluster != 2 && p.cluster != 4) ||
      p.stages < 2 || p.stages > MAX_STAGES || p.xstages < 2 ||
      p.xstages > MAX_STAGES || p.n_layers < 1 ||
      p.n_layers > MAX_LAYERS || p.N < 1 || p.C0 < 1 || p.ldx < p.C0 ||
      (p.ldx * 2) % 16 != 0 || reinterpret_cast<uintptr_t>(p.x) % 16 != 0 ||
      p.stage_bytes % 1024 != 0 || p.xring_off % 1024 != 0 ||
      p.ring_off != p.xring_off + p.xstages * x_bytes ||
      p.smem_bytes < p.ring_off + p.stages * p.stage_bytes + 1024 ||
      p.smem_bytes > SMEM_PLAN_MAX)
    return false;
  const int a_cols = p.xring_off / (p.bm * 2);   // resident activations
  for (int l = 0; l < p.n_layers; ++l) {
    const int cn = p.CN[l], sc = cp * cn;
    const int gm = 256 / cn < 4 ? 256 / cn : 4;
    const bool last = l == p.n_layers - 1;
    if ((cn & (cn - 1)) != 0 || cn < 8 || sc > 128 || p.P[l] < 1 ||
        p.G[l] < 1 || p.G[l] > gm || (l > 0 && p.P[l] > p.G[l]) ||
        p.M[l] < 1 || p.P[l] * sc < p.M[l] || p.KT1[l] < 1 ||
        p.KT2[l] < 0 || sc * LINE_BYTES > p.stage_bytes ||
        (!last && (sc % 64 != 0 || p.P[l] * sc > a_cols)) ||
        (l > 0 && p.KT1[l] * 64 > a_cols))
      return false;
  }
  return true;
}

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

template <int BM>
int launch(const WgParams& p, cudaStream_t s) {
  constexpr int CP = 2 / (BM / 64);
  Maps maps;
  if (!make_map(&maps.x, p.x, p.C0, p.N, p.ldx, BM)) return -4;
  for (int l = 0; l < p.n_layers; ++l) {
    const int kw = (p.KT1[l] + p.KT2[l]) * TILE_K;
    if (!make_map(&maps.w[l], p.w[l], kw, p.M[l], kw, CP * p.CN[l]))
      return -4;
  }
  cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)p.smem_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as fit on the card at once (one block an SM), fewer
  // when there are fewer tiles
  cfg.gridDim = dim3((unsigned)(p.cluster * (sm_count() / p.cluster)));
  // asked once per (tile rows, cluster, shared memory)
  static int known[3][3] = {};
  int* slot = known[p.cluster >> 1];
  int max_clusters = slot[1];
  if (slot[0] != p.smem_bytes) {
    e = cudaOccupancyMaxActiveClusters(&max_clusters, chain_kernel<BM>, &cfg);
    if (e != cudaSuccess) return (int)e;
    slot[0] = p.smem_bytes;
    slot[1] = max_clusters;
  }
  if (max_clusters < 1) return -5;
  const int tiles = (p.N + BM - 1) / BM;
  const int need = (tiles + p.cluster - 1) / p.cluster;
  cfg.gridDim =
      dim3((unsigned)(p.cluster * (need < max_clusters ? need : max_clusters)));
  e = cudaLaunchKernelEx(&cfg, chain_kernel<BM>, p, maps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// What the Python side must agree on: 0 sizeof(MlpParams), 1
// sizeof(WgParams), 2 MAX_LAYERS, 3 the ring stages a plan may ask for, 4
// the dynamic shared memory a plan may ask for.
int fm_abi(int which) {
  switch (which) {
    case 0: return (int)sizeof(MlpParams);
    case 1: return (int)sizeof(WgParams);
    case 2: return MAX_LAYERS;
    case 3: return wg::MAX_STAGES;
    case 4: return wg::SMEM_PLAN_MAX;
    default: return -1;
  }
}

// f32 chain.  block: points per thread block (64, 32 or 16), or 0 for the
// largest whose tiles leave room for two blocks on an SM, else the largest
// that fits; *block_used reports the choice.  -1: no tile fits.
int fm_forward(const MlpParams* params, int block, int* block_used,
               void* stream) {
  MlpParams p = *params;
  if (p.n_layers < 1 || p.n_layers > MAX_LAYERS || p.N < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cands[3] = {64, 32, 16};
  for (int pass = 0; pass < 2; ++pass) {
    const int64_t limit = pass == 0 ? f32::SMEM_MAX / 2 : f32::SMEM_MAX;
    for (int i = 0; i < 3; ++i) {
      const int bm = cands[i];
      if (block != 0 && block != bm) continue;
      const int64_t smem = f32::plan(&p, bm);
      if (smem > limit) continue;
      if (block_used) *block_used = bm;
      if (bm == 64) return f32::launch<64>(p, smem, s);
      if (bm == 32) return f32::launch<32>(p, smem, s);
      return f32::launch<16>(p, smem, s);
    }
  }
  return -1;
}

// bf16 chain on the plan in *params.  -3: the plan breaks an invariant;
// -4: a tensor map could not be made; -5: no cluster fits on the card.
int fm_wg_forward(const WgParams* params, void* stream) {
  const WgParams& p = *params;
  if (!wg::plan_ok(p)) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.bm == 128 ? wg::launch<128>(p, s) : wg::launch<64>(p, s);
}

}  // extern "C"
