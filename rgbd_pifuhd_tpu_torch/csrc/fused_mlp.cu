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
// What bounds it on an H100: operations (0.41 MMAC per point at the fine
// widths 272-512-256-128-1, 1.05 MMAC at the coarse widths
// 257-1024-512-256-128-1; x0 is read once, 2 * C0 bytes per point).  One
// launch per Dense layer would send every [N, C] activation through HBM;
// here a thread block owns a tile of BM points and keeps x0 and the two
// newest activations in shared memory for the whole chain:
//
//   x0 tile   [BM][ldx_s]          loaded once from global memory
//   hb0, hb1  [BM][ldh0], [BM][ldh1]   ping-pong: layer i writes hb(i & 1)
//   W tile    [BN][BK] of the current layer, streamed from global / L2 in
//             16-byte chunks, the next K step loaded into registers while
//             the current one is multiplied
//
// BM is the largest of 64, 32 (and 16 for f32) whose tiles leave room for a
// second block on the SM (half of the 227 KB a block may take), else the
// largest that fits at all: 32 at the fine widths (two blocks an SM), 32 at
// the coarse widths, whose 1024-wide layer allows only one (bf16).
// bf16 products run on the tensor cores (mma.sync m16n8k16, f32
// accumulation) with the A fragments read (ldmatrix) straight from the
// resident activations; the f32 variant runs the same tiles on FMA units.  A
// residual layer reads its A operand as two K ranges (h, then x0); every K
// range is padded to 8 at pack time, and the two 8-wide halves of an MMA's
// K step may come from different ranges, so the concat is never built.
//
// Rounding follows flax's PointMLP(dtype=bf16): the product is rounded to
// bf16, the bias is added in bf16, leaky_relu runs in bf16 (the slope 0.01
// itself rounded to bf16), the sigmoid in f32.  f32 stays f32 throughout.
// No atomics: two launches on the same input give the same bits.
//
// Plain C interface for ctypes; fm_forward returns cudaGetLastError() (or
// -1 when no tile size fits shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int MAX_LAYERS = 8;

// Arguments of one launch (mirrored by a ctypes.Structure).  Outside the
// anonymous namespace: the extern "C" entry point takes it by pointer.
struct MlpParams {
  const void* x;                  // [N, ldx] compute dtype, C0 real columns
  float* out;                     // [N, M[last]] f32
  const void* w[MAX_LAYERS];      // [M, K1p + K2p] compute dtype, zero-padded
  const float* bias[MAX_LAYERS];  // [M] (already rounded to the compute dtype)
  int M[MAX_LAYERS];              // output width of each layer
  int res[MAX_LAYERS];            // 1: the layer reads concat(h, x0)
  int K1p[MAX_LAYERS];            // filled by fm_forward: padded width of h
  int K2p[MAX_LAYERS];            // filled by fm_forward: padded x0 range or 0
  int n_layers, N, C0, ldx, sigmoid;
  int ldx_s, ldh0, ldh1;          // filled by fm_forward: smem row strides
};

namespace {

constexpr int BN = 128;        // output columns per tile
constexpr int BK = 64;         // K step
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int VEC = 8;         // elements per chunk
constexpr int B_CH = BN * BK / VEC / NT;   // W chunks per thread (4)
constexpr int SMEM_MAX = 227 * 1024;
constexpr float kSlope = 0.01f;
constexpr float kSlopeBf16 = 0.010009765625f;   // 0.01 rounded to bf16

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int r8(int n) { return (n + 7) / 8 * 8; }

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

template <typename T> __device__ __forceinline__ float leaky(float v);
template <> __device__ __forceinline__ float leaky<float>(float v) {
  return v >= 0.f ? v : __fmul_rn(kSlope, v);
}
template <> __device__ __forceinline__ float leaky<bf16>(float v) {
  return v >= 0.f ? v : round_to<bf16>(__fmul_rn(kSlopeBf16, v));
}

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

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 address matrix i); register i holds matrix i in the
// layout mma.sync takes its operands in.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// W tile: bf16 [BN][BK + 8] (B fragments read along K), f32 [BK][BN + 4].
constexpr int WT_BF16_BYTES = BN * (BK + 8) * 2;
constexpr int WT_F32_BYTES = BK * (BN + 4) * 4;

template <typename T, bool MMA, int BM>
__global__ void __launch_bounds__(NT) mlp_kernel(const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* hb0 = xs + BM * p.ldx_s;
  T* hb1 = hb0 + BM * p.ldh0;
  unsigned char* wt = reinterpret_cast<unsigned char*>(hb1 + BM * p.ldh1);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // ---- x0 tile: C0 real columns, the rest of each row zero
  {
    const T* xg = static_cast<const T*>(p.x);
    const bool vec_ok = (p.ldx % VEC == 0) &&
        (reinterpret_cast<uintptr_t>(xg) % sizeof(Chunk<T>) == 0);
    const int cpr = p.ldx_s / VEC;
    for (int idx = t; idx < BM * cpr; idx += NT) {
      const int r = idx / cpr, c0 = (idx - r * cpr) * VEC;
      const int gr = row0 + r;
      Chunk<T> ch;
      if (gr < p.N && vec_ok && c0 + VEC <= p.C0) {
        ld_chunk(ch, xg + (int64_t)gr * p.ldx + c0);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          ch.e[j] = (gr < p.N && c0 + j < p.C0)
                        ? xg[(int64_t)gr * p.ldx + c0 + j]
                        : from_f<T>(0.f);
      }
      *reinterpret_cast<Chunk<T>*>(xs + r * p.ldx_s + c0) = ch;
    }
  }
  __syncthreads();

  // MMA: warp tile 32 x WTN (WM x WN warps); FMA: thread tile TM x 8.
  constexpr int WM = BM >= 32 ? BM / 32 : 1;
  constexpr int WN = 8 / WM;
  constexpr int WTN = BN / WN;
  constexpr int NI = WTN / 8;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int NACC = MMA ? 2 * NI * 4 : TM * TN;
  const int wm = warp % WM, wn = warp / WM;
  const int tx = t & 15, ty = t >> 4;
  constexpr int CPR = BK / VEC;    // chunks per W tile row

  const T* hin = xs;
  int ldin = p.ldx_s;
  for (int li = 0; li < p.n_layers; ++li) {
    const int M = p.M[li], Mp = r8(M);
    const int K1p = p.K1p[li], Kp = K1p + p.K2p[li];
    const bool last = li == p.n_layers - 1;
    T* hout = (li & 1) ? hb1 : hb0;
    const int ldout = (li & 1) ? p.ldh1 : p.ldh0;
    const T* w = static_cast<const T*>(p.w[li]);
    const float* bias = p.bias[li];

    for (int col0 = 0; col0 < M; col0 += BN) {
      float acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      Chunk<T> rb[B_CH];

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
          if (MMA) {
            *reinterpret_cast<uint4*>(
                &reinterpret_cast<bf16(*)[BK + 8]>(wt)[n][kc]) =
                *reinterpret_cast<const uint4*>(rb[i].e);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              reinterpret_cast<float(*)[BN + 4]>(wt)[kc + j][n] =
                  to_f(rb[i].e[j]);
          }
        }
      };
      // source of the 8 columns [kh, kh + 8) of the layer's A operand
      auto a_src = [&](int kh, int* ld) -> const T* {
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
        if (k0 + BK < Kp) load_w(k0 + BK);   // in flight during the MMAs
        if constexpr (MMA) {
          auto Bs = reinterpret_cast<const bf16(*)[BK + 8]>(wt);
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            int ld0 = 0, ld1 = 0;
            const bf16* s0 =
                reinterpret_cast<const bf16*>(a_src(k0 + kk, &ld0));
            const bf16* s1 =
                reinterpret_cast<const bf16*>(a_src(k0 + kk + 8, &ld1));
            if (s0 == nullptr) break;   // past Kp: the W tile is zero too
            uint32_t af[2][4], bfr[NI][2];
            // A: lanes 0-15 address rows 0-15 of the first 8 columns,
            // lanes 16-31 the same rows of the second 8 (maybe another
            // source, or past Kp: loaded from the first and zeroed)
            const bf16* sa = (lane < 16 || s1 == nullptr) ? s0 : s1;
            const int lda = (lane < 16 || s1 == nullptr) ? ld0 : ld1;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              ldmatrix_x4(af[mi],
                          sa + (wm * 32 + mi * 16 + (lane & 15)) * lda);
              if (s1 == nullptr) af[mi][2] = af[mi][3] = 0u;
            }
            // B: two 8-column blocks of W per load, both K halves
#pragma unroll
            for (int ni = 0; ni < NI; ni += 2) {
              uint32_t r[4];
              ldmatrix_x4(r, &Bs[wn * WTN + ni * 8 + (lane >> 4) * 8
                                 + (lane & 7)][kk + ((lane >> 3) & 1) * 8]);
              bfr[ni][0] = r[0];
              bfr[ni][1] = r[1];
              bfr[ni + 1][0] = r[2];
              bfr[ni + 1][1] = r[3];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni)
                mma_bf16(&acc[(mi * NI + ni) * 4], af[mi][0], af[mi][1],
                         af[mi][2], af[mi][3], bfr[ni][0], bfr[ni][1]);
          }
        } else {
          auto Bs = reinterpret_cast<const float(*)[BN + 4]>(wt);
#pragma unroll
          for (int k8 = 0; k8 < BK; k8 += VEC) {
            int ld = 0;
            const T* s = a_src(k0 + k8, &ld);
            if (s == nullptr) break;
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              float a[TM], b[TN];
#pragma unroll
              for (int i = 0; i < TM; ++i)
                a[i] = to_f(s[(ty + 16 * i) * ld + j]);
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
      }

      // epilogue from the registers: bias, rounding, leaky (or the head)
      auto finish = [&](float v, int r, int c) {
        v = round_to<T>(v);
        v = round_to<T>(__fadd_rn(v, c < M ? bias[c] : 0.f));
        if (last) {
          const int gr = row0 + r;
          if (gr < p.N && c < M)
            p.out[(int64_t)gr * M + c] =
                p.sigmoid ? __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))) : v;
        } else if (c < Mp) {
          // columns [M, Mp) hold exact zeros: the next layer's K padding
          hout[r * ldout + c] = from_f<T>(leaky<T>(v));
        }
      };
      if constexpr (MMA) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int r = wm * 32 + mi * 16 + gid;
            const int c = col0 + wn * WTN + ni * 8 + tig * 2;
            const float* a = &acc[(mi * NI + ni) * 4];
            finish(a[0], r, c);
            finish(a[1], r, c + 1);
            finish(a[2], r + 8, c);
            finish(a[3], r + 8, c + 1);
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            finish(acc[i * TN + jj], ty + 16 * i, col0 + tx + 16 * jj);
      }
    }
    __syncthreads();   // hout is complete before the next layer reads it
    hin = hout;
    ldin = ldout;
  }
}

// Row stride of a resident [BM][width] activation: bf16 rows land 4 banks
// apart (stride = 8 mod 64 elements), so the 8 rows x 4 words of an A
// fragment read hit 32 different banks.
int row_stride(int width, bool is_bf16) {
  return is_bf16 ? (width + 63) / 64 * 64 + 8 : r8(width) + 8;
}

template <typename T, bool MMA, int BM>
int launch(const MlpParams& p, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_kernel<T, MMA, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  mlp_kernel<T, MMA, BM><<<(unsigned)((p.N + BM - 1) / BM), NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of `bm` points takes for this chain.
// Fills the derived fields of *p.
int64_t fm_plan(int dtype, MlpParams* p, int bm) {
  const bool is_bf16 = dtype == 1;
  p->ldx_s = row_stride(p->C0, is_bf16);
  p->ldh0 = p->ldh1 = 0;
  for (int i = 0; i < p->n_layers; ++i) {
    p->K1p[i] = r8(i == 0 ? p->C0 : p->M[i - 1]);
    p->K2p[i] = p->res[i] ? r8(p->C0) : 0;
    if (i == p->n_layers - 1) break;
    int& ld = (i & 1) ? p->ldh1 : p->ldh0;
    const int need = row_stride(p->M[i], is_bf16);
    if (need > ld) ld = need;
  }
  const int64_t elt = is_bf16 ? 2 : 4;
  return (int64_t)bm * (p->ldx_s + p->ldh0 + p->ldh1) * elt +
         (is_bf16 ? WT_BF16_BYTES : WT_F32_BYTES);
}

// dtype: 0 = float32, 1 = bfloat16 (of x and the weights).  block: points
// per thread block (64, 32, or 16 for f32), or 0 for the choice above.
// *block_used reports the choice.
int fm_forward(int dtype, const MlpParams* params, int block,
               int* block_used, void* stream) {
  MlpParams p = *params;
  if (p.n_layers < 1 || p.n_layers > MAX_LAYERS || p.N < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cands[3] = {64, 32, 16};
  // first a tile that leaves room for two blocks on an SM (one block of 8
  // warps alone waits out every barrier and L2 load), then any that fits
  for (int pass = 0; pass < 2; ++pass) {
    const int64_t limit = pass == 0 ? SMEM_MAX / 2 : SMEM_MAX;
    for (int i = 0; i < 3; ++i) {
      const int bm = cands[i];
      if (block != 0 && block != bm) continue;
      if (dtype == 1 && bm == 16) continue;
      const int64_t smem = fm_plan(dtype, &p, bm);
      if (smem > limit) continue;
      if (block_used) *block_used = bm;
      if (dtype == 1) {
        if (bm == 64) return launch<bf16, true, 64>(p, smem, s);
        return launch<bf16, true, 32>(p, smem, s);
      }
      if (bm == 64) return launch<float, false, 64>(p, smem, s);
      if (bm == 32) return launch<float, false, 32>(p, smem, s);
      return launch<float, false, 16>(p, smem, s);
    }
  }
  return -1;
}

}  // extern "C"
