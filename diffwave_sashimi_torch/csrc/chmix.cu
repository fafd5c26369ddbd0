// Fused position-wise channel-mixing branches of the DiffWave block.
//
// Replaces four TPU kernels of diffwave_sashimi_tpu/ops/chmix.py:
//   _glu_kernel (mix_glu_res):  out = res + a * sigmoid(g),  [a; g] = W y + b
//   _ff_kernel  (ln_ff_res):    out = x + W2 gelu(W1 TLN(x) + b1) + b2
//                               [+ skip]
//                               and, optionally, the channel mean and var of
//                               out per position (the next block's norm1).
//   _glu_bwd_kernel (_glu_train_bwd) and _ff_bwd_kernel (_ff_train_bwd):
//                               their backward passes, below the forwards.
// Activations are the flat (B, H, L) layout; the matmuls contract the
// channel axis H for every position.
//
// What bounds them on the H100: each is a channel GEMM of 2 * 2H * H * B * L
// (GLU) or twice that (FF) fp32 flops against one read and one write of
// the activations: ~H/3 flops per byte, past the fp32 CUDA-core balance
// (67 TFLOP/s : 3.35 TB/s = 20) at every tier (H >= 128), so they are
// compute bound, and the inner product must not be bound by shared memory.
//
// Design: one block of 256 threads per (batch, P positions), P = 16384 / H
// (128, 64, 32 at H = 128, 256, 512), so the block's input tile (H x P)
// and, for FF, its (2H x P) hidden activation stay in shared memory (192 KB)
// and each residual branch costs one read and one write of the
// activations.  Past H 512 the wider tiles would not fit one block, so the
// plan halves P until they do (16 for FF and the GLU backward, 8 for the FF
// backward at H 1024, F 2048).  Weights stream through a transposed (TK x
// TM) shared tile, TM = 16384 / P rows, prefetched into registers one
// k-step ahead.  Each thread keeps an 8 x 8 register tile (rows {r, r +
// TM/2} x 4, positions 8 consecutive), fed by four 16-byte shared loads
// per 64 FMAs.  One block per SM: two GLU blocks per SM and a 16-deep FF
// k-tile were both measured slower on the step.  The FF kernel computes
// the LayerNorm statistics of its input and of its output itself.  GELU
// uses erff, the sigmoid expf: the strict f32 path.
//
// The host computes every kernel's positions a block P and its bytes of
// shared memory (ops/chmix.py: glu_plan, ff_plan, glu_bwd_plan, ff_bwd_plan
// and, for the tensor-core kernels below, glu_bf16_plan and ff_bf16_plan),
// and refuses widths whose tiles do not fit one block before it launches;
// the kernels take both as given.
//
// Kernel 3f, FF's bf16 form (ln_ff_res_tc_kernel), multiplies on the
// tensor cores instead (mma.sync m16n8k16, bf16 operands, f32 sums;
// mma_bf16.cuh).  Its products of bf16 values are exact in f32, so it
// computes the terms of JAX's fast=True kernel (_bmm) and only sums them
// in another order.  What bounds it: 4 F H B L operations at the bf16
// tensor-core rate take less time than one read of x and skip and one
// write of out (8.5 us against 15 us at SC09's top tier), so the bound is
// bytes; but every block also reads both weight matrices whole from L2,
// once per P positions, which bounded the deep tiers, and runs its phases
// one after another.  Design: the weights are rounded to bf16 once a call
// into the wrapper's scratch (round_weights_kernel), halving those reads
// (rounding them as they load instead, with no extra launch, ties at H 128
// and is 20-37% slower at H 256 and 512, chip_smoke.py's
// weights_in_kernel_ms); one block of 8 warps per (batch, P positions), P
// = 16384 / H (128, 64, 32; 64 at H 512 when the grid fills two waves; 16
// past H 512, where GEMM 2's warps take 8 m-tiles each);
// the input tile, then TLN(x) rounded to bf16, and the GELU output stay in
// shared memory as bf16 (rows padded so that ldmatrix reads them without
// bank conflicts), so two blocks share an SM below H 512 at F = 2H.
// ops/chmix.py::ff_bf16_plan picks P and computes the block's shared
// memory bytes, which the kernel takes as given.  The LN statistics are
// taken in f32 as the tile is loaded, 16 bytes a thread.  Each warp takes
// 16-row m-tiles of a weight over all P positions: its A fragments come
// straight from L2 (4-byte loads, one k-step ahead), so each weight entry
// is read once a block and no weight tile is staged or synchronised; B
// fragments come from the shared tiles by ldmatrix.trans.  GEMM 2's f32
// result (+ b2) is staged in the GELU tile's region, then the residual
// adds, the bf16 store and the output's statistics run 16 bytes a thread,
// coalesced; the statistics are summed in a fixed order (no float
// atomics).  Kernel 3, the f32 form, keeps its fp32 FMAs: its 1e-4 bar
// rules out TF32.
//
// Kernel 2f, the GLU's bf16 form (glu_res_tc_kernel), is one channel GEMM
// of 4 H^2 B L operations with a register-local epilogue, on the tensor
// cores as 3f's GEMMs are, and for the same reason bound by bytes (one read
// of y and res and one write of out: 15 us at SC09's top tier against 4 us
// of products).  Design, 3f's: W rounded to bf16 once a call into a scratch
// (round_weights_kernel); one block of 8 warps per (batch, P positions);
// the y tile in shared memory as bf16, loaded 16 bytes a thread, rows
// padded for ldmatrix.trans.  Each warp takes value m-tiles [o, o + 16 MV)
// together with their gate m-tiles [H + o, H + o + 16 MV) over all P
// positions, so a and g of one (o, p) meet in one thread's registers, where
// bias, sigmoid and product are formed; A fragments come from L2 one
// k-step ahead, with no weight tile and no barrier in the k-loop.  The
// gated f32 product is staged in shared memory, then res is added and out
// stored 16 bytes a thread, coalesced.  MV P = 128 keeps 128 sums a
// thread; past 128 MV value rows the warps take the rows in passes, so any
// H that is a multiple of 16 up to 1024 fits one block.  Kernel 2, the f32
// form, keeps its fp32 FMAs: its 1e-4 bar rules out bf16 products.

#include <cuda_runtime.h>

#include "activations.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace dwst_act;

constexpr int NT = 256;        // threads per block
constexpr int TK = 8;          // contraction tile

template <int P>
struct Tile {
  static constexpr int PG = P / 8;          // position groups of 8
  static constexpr int RG = NT / PG;        // row groups of 4 (+4 paired)
  static constexpr int TM = RG * 8;         // weight rows per chunk
  static constexpr int LDT = TM + 4;        // padded transposed row
  static constexpr int NPRE = TM * 2 / NT;  // float4 prefetches per thread
};

// Global row of local weight row lr in [0, TM), or -1 past the matrix:
// rows [0, TM/2) map to ra + lr, rows [TM/2, TM) to rb + lr - TM/2, each
// valid below lim.  The GLU pairs value row o with gate row H + o.
struct RowMap {
  int ra, rb, lim_a, lim_b, half;
  __device__ int operator()(int lr) const {
    if (lr < half) return ra + lr < lim_a ? ra + lr : -1;
    const int g = rb + lr - half;
    return g < lim_b ? g : -1;
  }
};

// acc[r][j] = sum_k A[row(r), k] * Bs[k * P + pg * 8 + j] for the thread's
// rows r < 4 -> local rg * 4 + r, r >= 4 -> TM/2 + rg * 4 + r - 4.
// A is (rows x K) row-major with K % TK == 0; Bs is K x P.  RW rounds A's
// entries to bf16 as they are loaded (the bf16 path's weights).
template <int P, bool RW = false>
__device__ void gemm_chunk(const float* __restrict__ A, int K, RowMap map,
                           const float* Bs, float* AsT, float acc[8][8]) {
  using T = Tile<P>;
  const int tid = threadIdx.x;
  const int pg = tid % T::PG, rg = tid / T::PG;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;

  float4 pre[T::NPRE];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < T::NPRE; ++q) {
      const int idx = tid + q * NT;           // (row, half) pairs
      const int g = map(idx >> 1);
      pre[q] = g >= 0 ? *reinterpret_cast<const float4*>(
                            A + (size_t)g * K + k0 + 4 * (idx & 1))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();                          // AsT free, Bs complete
#pragma unroll
    for (int q = 0; q < T::NPRE; ++q) {
      const int idx = tid + q * NT;
      const int lr = idx >> 1, k = 4 * (idx & 1);
      if (RW)
        pre[q] = make_float4(round_bf16(pre[q].x), round_bf16(pre[q].y),
                             round_bf16(pre[q].z), round_bf16(pre[q].w));
      AsT[(k + 0) * T::LDT + lr] = pre[q].x;
      AsT[(k + 1) * T::LDT + lr] = pre[q].y;
      AsT[(k + 2) * T::LDT + lr] = pre[q].z;
      AsT[(k + 3) * T::LDT + lr] = pre[q].w;
    }
    __syncthreads();
    if (k0 + TK < K) fetch(k0 + TK);          // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float* at = AsT + kk * T::LDT;
      const float4 a0 = *reinterpret_cast<const float4*>(at + rg * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(at + T::TM / 2 + rg * 4);
      const float* bt = Bs + (size_t)(k0 + kk) * P + pg * 8;
      const float4 b0 = *reinterpret_cast<const float4*>(bt);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
    }
  }
}

// Thread's local row for accumulator row r.
template <int P>
__device__ __forceinline__ int local_row(int r) {
  using T = Tile<P>;
  const int rg = threadIdx.x / T::PG;
  return r < 4 ? rg * 4 + r : T::TM / 2 + rg * 4 + r - 4;
}

// xs[h * P + p] = x[b, h, t0 + p] (0 past L), h < H.
template <int P, typename IO = float>
__device__ void load_tile(const IO* __restrict__ x, float* xs, int b,
                          int H, int L, int t0) {
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int h = idx / P, p = idx % P, t = t0 + p;
    xs[idx] = t < L ? to_f(x[((size_t)b * H + h) * L + t]) : 0.0f;
  }
}

// Per-position channel mean and E[x^2] - mean^2 of xs[0:H, :].
template <int P>
__device__ void column_stats(const float* xs, int H, float* red,
                             float* mean_s, float* var_s) {
  constexpr int PARTS = NT / P;
  const int tid = threadIdx.x, p = tid % P, part = tid / P;
  float s1 = 0.0f, s2 = 0.0f;
  for (int h = part; h < H; h += PARTS) {
    const float v = xs[h * P + p];
    s1 += v;
    s2 += v * v;
  }
  red[tid] = s1;
  red[NT + tid] = s2;
  __syncthreads();
  if (tid < P) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int q = 0; q < PARTS; ++q) {
      t1 += red[q * P + tid];
      t2 += red[NT + q * P + tid];
    }
    const float mean = t1 / (float)H;
    mean_s[tid] = mean;
    var_s[tid] = t2 / (float)H - mean * mean;
  }
  __syncthreads();
}

// Kernel 2 (f32; kernel 2f is glu_res_tc_kernel below).
template <int P>
__global__ void __launch_bounds__(NT, 1)
glu_res_kernel(const float* __restrict__ y, const float* __restrict__ res,
               const float* __restrict__ W, const float* __restrict__ bias,
               float* __restrict__ out, int H, int L) {
  using T = Tile<P>;
  extern __shared__ float4 sh4[];
  float* ys = reinterpret_cast<float*>(sh4);     // H x P
  float* AsT = ys + H * P;                        // TK x LDT
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int pg = threadIdx.x % T::PG;
  load_tile<P>(y, ys, b, H, L, t0);
  for (int o0 = 0; o0 < H; o0 += T::TM / 2) {
    float acc[8][8];
    gemm_chunk<P>(W, H, RowMap{o0, H + o0, H, 2 * H, T::TM / 2}, ys, AsT,
                  acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = o0 + local_row<P>(r);
      if (o >= H) continue;
      const float ba = bias[o], bg = bias[H + o];
      const size_t row = ((size_t)b * H + o) * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + pg * 8 + j;
        if (t >= L) continue;
        const float g = acc[r + 4][j] + bg;
        out[row + t] = res[row + t] + (acc[r][j] + ba) / (1.0f + expf(-g));
      }
    }
  }
}

// Kernel 3 (f32; kernel 3f is ln_ff_res_tc_kernel below).
template <int P>
__global__ void __launch_bounds__(NT, 1)
ln_ff_res_kernel(const float* __restrict__ x, const float* __restrict__ skip,
                 const float* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ W2, const float* __restrict__ b2,
                 const float* __restrict__ m_ptr,
                 const float* __restrict__ s_ptr, float* __restrict__ out,
                 float* __restrict__ mean_out, float* __restrict__ var_out,
                 int H, int F, int L) {
  using T = Tile<P>;
  extern __shared__ float4 sh4[];
  float* xs = reinterpret_cast<float*>(sh4);     // H x P: TLN(x), later out
  float* zs = xs + H * P;                         // F x P: gelu(W1 xn + b1)
  float* AsT = zs + F * P;                        // TK x LDT
  float* red = AsT + TK * T::LDT;                 // 2 * NT
  float* mean_s = red + 2 * NT;                   // P
  float* var_s = mean_s + P;                      // P
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, pg = tid % T::PG;

  load_tile<P>(x, xs, b, H, L, t0);
  __syncthreads();
  column_stats<P>(xs, H, red, mean_s, var_s);

  // TransposedLN: (s / std) * (x - mean + m), population std, no eps
  const float m = *m_ptr, s = *s_ptr;
  for (int idx = tid; idx < H * P; idx += NT) {
    const int p = idx % P;
    xs[idx] = s * rsqrtf(var_s[p]) * (xs[idx] - mean_s[p] + m);
  }

  for (int f0 = 0; f0 < F; f0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P>(W1, H, RowMap{f0, f0 + T::TM / 2, F, F, T::TM / 2}, xs,
                      AsT, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = f0 + local_row<P>(r);
      if (f >= F) continue;
      const float bf = b1[f];
      float* zr = zs + f * P + pg * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) zr[j] = gelu_erf(acc[r][j] + bf);
    }
  }

  for (int h0 = 0; h0 < H; h0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P>(W2, F, RowMap{h0, h0 + T::TM / 2, H, H, T::TM / 2}, zs,
                  AsT, acc);
    // xs is free: every thread passed gemm_chunk's barriers after GEMM1
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + local_row<P>(r);
      if (h >= H) continue;
      const float bh = b2[h];
      const size_t row = ((size_t)b * H + h) * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = pg * 8 + j, t = t0 + p;
        float v = 0.0f;
        if (t < L) {
          v = x[row + t] + acc[r][j] + bh;
          if (skip != nullptr) v += skip[row + t];
          out[row + t] = v;
        }
        xs[h * P + p] = v;
      }
    }
  }

  if (mean_out != nullptr) {
    __syncthreads();
    column_stats<P>(xs, H, red, mean_s, var_s);
    if (tid < P && t0 + tid < L) {
      mean_out[(size_t)b * L + t0 + tid] = mean_s[tid];
      var_out[(size_t)b * L + t0 + tid] = var_s[tid];
    }
  }
}

// Kernel 3f's tiles: P positions a block; in GEMM 1 a warp takes MT1
// m-tiles (16 MT1 hidden channels) over all P positions at a time, in GEMM 2
// each warp one set of MT2 m-tiles (16 MT2 >= H / 8 output channels), so
// that its accumulators hold until every warp has read the GELU tile; bf16
// rows padded to LD elements so that ldmatrix's eight rows fall on distinct
// banks, the f32 output tile's to LO.
constexpr int NWARPS = NT / 32;

template <int P>
struct TcTile {
  static constexpr int MT1 = P >= 128 ? 1 : 2;
  static constexpr int N8 = P / 8;          // n-tiles, and 8-position chunks
  static constexpr int LD = P + 8;
  static constexpr int LO = P + 8;
  static constexpr int RED = 2 * NWARPS * P;   // per-warp f32 sums
};

__device__ __forceinline__ void unpack8(uint4 r, float f[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  return make_uint4(dwst_mma::pack_bf16x2(f[0], f[1]),
                    dwst_mma::pack_bf16x2(f[2], f[3]),
                    dwst_mma::pack_bf16x2(f[4], f[5]),
                    dwst_mma::pack_bf16x2(f[6], f[7]));
}

// s[0:8] summed over the lanes of this warp that hold the same 8-position
// chunk c (lane % (P / 8)), in a fixed order, written to row[c:c + 8] by
// the first of them.  Every warp covers all P / 8 chunks.
template <int P>
__device__ __forceinline__ void chunk_sums(float s[8], float* row, int c) {
#pragma unroll
  for (int o = P / 8; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] += __shfl_xor_sync(0xffffffffu, s[e], o);
  if ((threadIdx.x & 31) < P / 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) row[c + e] = s[e];
  }
}

// Kernel 3f (bf16 x, skip and out; f32 biases, m, s and statistics) on the
// tensor cores: xn = bf16(TLN(x)) and z = bf16(gelu_fast(W1b xn + b1)) as
// bf16 tiles in shared memory, W1b and W2b the weights rounded to bf16 (WT
// bf16: by round_weights_kernel; WT float: as their fragments load); W2b z
// + b2 staged as an f32 tile, then out = x + that [+ skip] stored bf16 and
// its per-position statistics taken in f32.  Dynamic shared memory, laid
// out as below and sized by ops/chmix.py::ff_bf16_plan (the one place its
// bytes are computed): 18 P floats of sums and statistics, the H-row bf16
// input tile, then one region that holds the F-row bf16 GELU tile and
// later the H-row f32 output tile, as large as the larger of the two.
// Each thread moves 8 consecutive positions (16 bytes) of its rows when
// vec (L % 8 == 0, 16-byte aligned tensors).  H <= 128 MT2, so MT2 8 at
// P 16 takes H up to 1024 (with 8 P x MT2 sums a thread).  Two blocks
// share an SM where P MT2 = 128 (96 KB of tiles at H = 128 MT2), one
// where the wider P of a long sequence at H 512 doubles the tiles and
// GEMM 2's accumulators.
template <int P, int MT2, typename WT>
__global__ void __launch_bounds__(NT, P * MT2 >= 256 || MT2 >= 8 ? 1 : 2)
ln_ff_res_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ skip,
                    const WT* __restrict__ W1, const float* __restrict__ b1,
                    const WT* __restrict__ W2,
                    const float* __restrict__ b2,
                    const float* __restrict__ m_ptr,
                    const float* __restrict__ s_ptr,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ mean_out, float* __restrict__ var_out,
                    int H, int F, int L, bool vec) {
  using T = TcTile<P>;
  using bf = __nv_bfloat16;
  constexpr int N8 = T::N8, LD = T::LD, LO = T::LO;
  extern __shared__ float4 sh4[];
  float* red = reinterpret_cast<float*>(sh4);     // RED: per-warp sums
  float* mean_s = red + T::RED;                   // P
  float* rstd_s = mean_s + P;                     // P (0 past L)
  bf* xs = reinterpret_cast<bf*>(rstd_s + P);     // H x LD: x, then xn
  bf* zs = xs + H * LD;                           // F x LD: GELU output
  float* os = reinterpret_cast<float*>(zs);       // H x LO: W2b z + b2
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's chunk of 8 positions, and its first row and row step
  const int c = tid % N8 * 8, t = t0 + c, h0 = tid / N8;
  constexpr int HS = NT / N8;
  float* red1 = red + warp * P;
  float* red2 = red + (NWARPS + warp) * P;

  // the x tile as loaded (0 past L), and its per-position channel sums
  {
    float s1[8] = {}, s2[8] = {};
    for (int h = h0; h < H; h += HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      float v[8];
      if (vec && t + 8 <= L) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + at)), v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = t + j < L ? __bfloat162float(x[at + j]) : 0.0f;
      }
      *reinterpret_cast<uint4*>(xs + h * LD + c) = pack8(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
    chunk_sums<P>(s1, red1, c);
    chunk_sums<P>(s2, red2, c);
  }
  __syncthreads();
  if (tid < P) {           // mean and E[x^2] - mean^2, f32
    float t1 = 0.0f, t2 = 0.0f;
    for (int w = 0; w < NWARPS; ++w) {
      t1 += red[w * P + tid];
      t2 += red[(NWARPS + w) * P + tid];
    }
    const float mean = t1 / (float)H;
    mean_s[tid] = mean;
    rstd_s[tid] = t0 + tid < L ? rsqrtf(t2 / (float)H - mean * mean) : 0.0f;
  }
  __syncthreads();

  // TransposedLN in place: (s / std) * (x - mean + m), population std, no
  // eps, rounded to bf16 (0 past L)
  {
    const float m = *m_ptr, s = *s_ptr;
    float a[8], mu[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = s * rstd_s[c + j];
      mu[j] = mean_s[c + j];
    }
    for (int h = h0; h < H; h += HS) {
      uint4* e = reinterpret_cast<uint4*>(xs + h * LD + c);
      float v[8];
      unpack8(*e, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = a[j] * (v[j] - mu[j] + m);
      *e = pack8(v);
    }
  }
  __syncthreads();

  // GEMM 1: z = bf16(gelu_fast(W1b xn + b1)), F x P
  for (int u = warp; u * 16 * T::MT1 < F; u += NWARPS) {
    constexpr int MT = T::MT1;
    const int r0 = u * 16 * MT;
    float acc[MT][N8][4];
    dwst_mma::warp_gemm<MT, N8>(W1, F, H, r0, xs, LD, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f = r0 + 16 * mt + g + 8 * hh;
        if (f >= F) continue;
        const float bias = b1[f];
        uint32_t* zr = reinterpret_cast<uint32_t*>(zs + f * LD + 2 * tq);
#pragma unroll
        for (int j = 0; j < N8; ++j)
          zr[4 * j] = dwst_mma::pack_bf16x2(
              gelu_fast(acc[mt][j][2 * hh] + bias),
              gelu_fast(acc[mt][j][2 * hh + 1] + bias));
      }
  }
  __syncthreads();

  // GEMM 2: W2b z + b2, H x P, into the f32 tile over the GELU tile once
  // every warp has read it
  {
    constexpr int MT = MT2;
    const int r0 = warp * 16 * MT;
    float acc[MT][N8][4];
    if (r0 < H) dwst_mma::warp_gemm<MT, N8>(W2, H, F, r0, zs, LD, acc);
    __syncthreads();
    if (r0 < H) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = r0 + 16 * mt + g + 8 * hh;
          if (h >= H) continue;
          const float bias = b2[h];
          float* orow = os + h * LO + 2 * tq;
#pragma unroll
          for (int j = 0; j < N8; ++j)
            *reinterpret_cast<float2*>(orow + 8 * j) =
                make_float2(acc[mt][j][2 * hh] + bias,
                            acc[mt][j][2 * hh + 1] + bias);
        }
    }
  }
  __syncthreads();

  // out = x + (W2b z + b2) [+ skip] in f32, stored bf16, and the f32
  // output's per-position sums
  const bool stats = mean_out != nullptr;
  {
    float s1[8] = {}, s2[8] = {};
    for (int h = h0; h < H; h += HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      const float4 o0 = *reinterpret_cast<const float4*>(os + h * LO + c);
      const float4 o1 = *reinterpret_cast<const float4*>(os + h * LO + c + 4);
      float v[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      if (vec && t + 8 <= L) {
        float r[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + at)), r);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += r[j];
        if (skip != nullptr) {
          unpack8(__ldg(reinterpret_cast<const uint4*>(skip + at)), r);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += r[j];
        }
        *reinterpret_cast<uint4*>(out + at) = pack8(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t + j >= L) {
            v[j] = 0.0f;
            continue;
          }
          v[j] += __bfloat162float(x[at + j]);
          if (skip != nullptr) v[j] += __bfloat162float(skip[at + j]);
          out[at + j] = __float2bfloat16_rn(v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
    if (stats) {
      chunk_sums<P>(s1, red1, c);
      chunk_sums<P>(s2, red2, c);
    }
  }
  if (stats) {
    __syncthreads();
    if (tid < P && t0 + tid < L) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int w = 0; w < NWARPS; ++w) {
        t1 += red[w * P + tid];
        t2 += red[(NWARPS + w) * P + tid];
      }
      const float mean = t1 / (float)H;
      mean_out[(size_t)b * L + t0 + tid] = mean;
      var_out[(size_t)b * L + t0 + tid] = t2 / (float)H - mean * mean;
    }
  }
}

// Kernel 2f's tiles: P positions a block; each warp takes MV value m-tiles
// and their MV gate m-tiles over all P positions at a time (MV P = 128: 128
// f32 sums a thread), so one pass of the 8 warps covers ROWS = 128 MV value
// rows, each thread moving RPT = 8 rows of 8 positions in and out; bf16
// rows padded to LD elements as 3f's, the staged f32 rows to LO.
template <int P>
struct GluTile {
  static constexpr int MV = 128 / P;
  static constexpr int N8 = P / 8;
  static constexpr int LD = P + 8;
  static constexpr int LO = P + 8;
  static constexpr int ROWS = NWARPS * 16 * MV;
  static constexpr int HS = NT / N8;        // row step of a thread
  static constexpr int RPT = ROWS / HS;
};

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// by L2 only); commit closes a group, wait<n> waits for all but the last n.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Kernel 2f (bf16 y, res and out; Wb = W rounded to bf16 by
// round_weights_kernel; f32 bias) on the tensor cores: out = res + (Wa y +
// ba) sigmoid(Wg y + bg), [Wa; Wg] = Wb, the sums, bias, sigmoid and
// residual add in f32 and the result rounded once.  Dynamic shared memory,
// sized by ops/chmix.py::glu_bf16_plan: the H-row bf16 y tile, then for
// R = min(H, ROWS) rows of one pass the f32 gated product, staged for the
// epilogue, and the bf16 res rows.  When vec (L % 8 == 0, 16-byte aligned
// tensors) each thread moves 8 consecutive positions (16 bytes) of its
// rows: y and the first pass's res arrive by cp.async in two groups, so
// res loads while the product is computed, and each later pass's res is
// fetched while its product is; else element by element from device
// memory.
template <int P>
__global__ void __launch_bounds__(NT, 1)
glu_res_tc_kernel(const __nv_bfloat16* __restrict__ y,
                  const __nv_bfloat16* __restrict__ res,
                  const __nv_bfloat16* __restrict__ Wb,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int L, bool vec) {
  using T = GluTile<P>;
  using bf = __nv_bfloat16;
  constexpr int N8 = T::N8, LD = T::LD, LO = T::LO, MV = T::MV, HS = T::HS;
  extern __shared__ float4 sh4[];
  const int R = min(H, T::ROWS);
  bf* ys = reinterpret_cast<bf*>(sh4);                        // H x LD
  float* os = reinterpret_cast<float*>(ys + (size_t)H * LD);  // R x LO
  bf* rs = reinterpret_cast<bf*>(os + (size_t)R * LO);        // R x LD
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's chunk of 8 positions, and its first row
  const int c = tid % N8 * 8, t = t0 + c, h0 = tid / N8;
  const bool in = t < L;            // with vec: all 8 positions are
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // rows [p0, p0 + R) of res into rs, asynchronously (vec only)
  auto fetch_res = [&](int p0) {
#pragma unroll
    for (int i = 0; i < T::RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= R || p0 + h >= H) continue;
      if (in)
        cp_async16(rs + h * LD + c, res + ((size_t)b * H + p0 + h) * L + t);
    }
    cp_async_commit();
  };

  // the y tile (0 past L)
  if (vec) {
    for (int h = h0; h < H; h += HS) {
      bf* dst = ys + h * LD + c;
      if (in)
        cp_async16(dst, y + ((size_t)b * H + h) * L + t);
      else
        *reinterpret_cast<uint4*>(dst) = zero;
    }
    cp_async_commit();
    fetch_res(0);
    cp_async_wait<1>();             // y has landed; res may still be loading
  } else {
    for (int h = h0; h < H; h += HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = t + j < L ? __bfloat162float(y[at + j]) : 0.0f;
      *reinterpret_cast<uint4*>(ys + h * LD + c) = pack8(f);
    }
  }
  __syncthreads();

  for (int p0 = 0; p0 < H; p0 += T::ROWS) {
    if (vec && p0 > 0) fetch_res(p0);   // rs is free: see the barrier below
    // value rows [r0, r0 + 16 MV) and gate rows H + the same, over all P
    // positions; value rows past H (a partial last m-tile group) are
    // computed from gate rows and dropped
    const int r0 = p0 + warp * 16 * MV;
    if (r0 < H) {
      float acc[2 * MV][N8][4];
      dwst_mma::warp_gemm<2 * MV, N8, bf, MV>(Wb, 2 * H, H, r0, ys, LD, acc,
                                              H);
#pragma unroll
      for (int mt = 0; mt < MV; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = r0 + 16 * mt + g + 8 * hh;
          if (o >= H) continue;
          const float ba = bias[o], bg = bias[H + o];
          float* orow = os + (o - p0) * LO + 2 * tq;
#pragma unroll
          for (int j = 0; j < N8; ++j) {
            const float a0 = acc[mt][j][2 * hh] + ba;
            const float a1 = acc[mt][j][2 * hh + 1] + ba;
            const float g0 = acc[MV + mt][j][2 * hh] + bg;
            const float g1 = acc[MV + mt][j][2 * hh + 1] + bg;
            *reinterpret_cast<float2*>(orow + 8 * j) =
                make_float2(__fdividef(a0, 1.0f + __expf(-g0)),
                            __fdividef(a1, 1.0f + __expf(-g1)));
          }
        }
    }
    if (vec) cp_async_wait<0>();
    __syncthreads();

    // out = res + the staged product, in f32, stored bf16
#pragma unroll
    for (int i = 0; i < T::RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= R || p0 + h >= H) continue;
      const size_t at = ((size_t)b * H + p0 + h) * L + t;
      const float4 o0 = *reinterpret_cast<const float4*>(os + h * LO + c);
      const float4 o1 = *reinterpret_cast<const float4*>(os + h * LO + c + 4);
      float v[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      if (vec) {
        if (!in) continue;
        float r[8];
        unpack8(*reinterpret_cast<const uint4*>(rs + h * LD + c), r);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += r[j];
        *reinterpret_cast<uint4*>(out + at) = pack8(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t + j < L)
            out[at + j] =
                __float2bfloat16_rn(__bfloat162float(res[at + j]) + v[j]);
      }
    }
    __syncthreads();                 // os and rs are free for the next pass
  }
}

// ---------------------------------------------------------------------------
// Backward passes (kernels 6 and 7).
//
// What bounds them: the same channel GEMMs as the forwards, three per
// position for GLU (z, dy, dW) and five for FF (z, dh, dxn, dW1, dW2), so
// they are fp32-compute bound like the forwards.
//
// Design: a per-position pass reuses the forward's block layout and
// register-tiled gemm_chunk: it recomputes z from the saved input, forms
// dz in shared memory, contracts it back to the input gradient, and
// writes the operands of the weight gradients (dz, and for FF the
// normalised input and the GELU output) to device memory.  The weight
// gradients contract over all B * L positions (64000 at the top tier), so
// a second kernel computes them as split-K partials, one per 2048
// positions of one batch row, 64 x 64 output tiles of 4 x 4 per thread,
// with the bias gradients as row sums of the same tiles; a third sums the
// partials in a fixed order.  No float atomics: a run repeats bit for
// bit.  FF's scalar gradients dm and ds are per-block partials summed the
// same way.
//
// Kernels 6f and 7f, the bf16 path's backward passes (the TPU kernels with
// fast=True), are the same code templated on the activations' type, as
// 2f is: y or x, g and the input gradient are bf16, and, as JAX's
// _bmm does, both operands of every per-position product are rounded to
// bf16 (the weights as they are loaded; xn and dz in shared memory) with
// f32 sums.  The weight gradients contract the unrounded f32 operands (as
// JAX's _bmmc does): the dz, xn and GELU-output scratch stays f32 and the
// split-K kernels read it, and the bf16 g or y, in f32.  7f's GELU and its
// derivative are gelu_fast and gelu_fast_grad.

// GLU backward, per position tile (P as the forward): z = W y + b
// recomputed, da = g sig(gate), dgate = g a sig (1 - sig), dy = W^T dz.
// IO: the activations' type (kernel 6f: bf16, W and the shared-memory dz
// rounded to bf16 for their products; the dz written out stays f32).
template <int P, typename IO>
__global__ void __launch_bounds__(NT, 1)
glu_res_bwd_kernel(const IO* __restrict__ y, const IO* __restrict__ g,
                   const float* __restrict__ W, const float* __restrict__ Wt,
                   const float* __restrict__ bias, IO* __restrict__ dy,
                   float* __restrict__ dz, int H, int L) {
  constexpr bool BF = sizeof(IO) == 2;
  using T = Tile<P>;
  extern __shared__ float4 sh4[];
  float* ys = reinterpret_cast<float*>(sh4);     // H x P
  float* dzs = ys + H * P;                        // 2H x P
  float* AsT = dzs + 2 * H * P;                   // TK x LDT
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int pg = threadIdx.x % T::PG;
  load_tile<P>(y, ys, b, H, L, t0);
  for (int o0 = 0; o0 < H; o0 += T::TM / 2) {
    float acc[8][8];
    gemm_chunk<P, BF>(W, H, RowMap{o0, H + o0, H, 2 * H, T::TM / 2}, ys, AsT,
                      acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = o0 + local_row<P>(r);
      if (o >= H) continue;
      const float ba = bias[o], bg = bias[H + o];
      const size_t grow = ((size_t)b * H + o) * L;
      const size_t arow = ((size_t)b * 2 * H + o) * L;
      const size_t hrow = arow + (size_t)H * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = pg * 8 + j, t = t0 + p;
        const float gv = t < L ? to_f(g[grow + t]) : 0.0f;
        const float a = acc[r][j] + ba;
        const float sig = 1.0f / (1.0f + expf(-(acc[r + 4][j] + bg)));
        const float da = gv * sig, dgate = gv * a * sig * (1.0f - sig);
        dzs[o * P + p] = BF ? round_bf16(da) : da;
        dzs[(H + o) * P + p] = BF ? round_bf16(dgate) : dgate;
        if (t < L) {
          dz[arow + t] = da;
          dz[hrow + t] = dgate;
        }
      }
    }
  }
  for (int h0 = 0; h0 < H; h0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P, BF>(Wt, 2 * H, RowMap{h0, h0 + T::TM / 2, H, H, T::TM / 2},
                      dzs, AsT, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + local_row<P>(r);
      if (h >= H) continue;
      const size_t row = ((size_t)b * H + h) * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + pg * 8 + j;
        if (t < L) dy[row + t] = from_f<IO>(acc[r][j]);
      }
    }
  }
}

__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

// FF backward, per position tile of P = 8192 / H positions (half the
// forward's: x, g, and the F-row dh/dz tile share the shared memory; 8 at
// H 1024, F 2048), the
// algebra of the JAX kernel: var = E[x^2] - mean^2, r = s rstd,
//   dxn = W1^T (gelu'(z) . W2^T g),  S1 = mean_h dxn,
//   S2 = mean_h dxn (xc + m),  dx = g + r (dxn - S1) - r rstd^2 xc S2,
//   dm = sum dxn r,  ds = sum dxn rstd (xc + m).
// Writes dx, xn = TLN(x), hact = gelu(z), dz, and (dm, ds) of the block.
// IO: the activations' type (kernel 7f: bf16 x, g and dx; the weights, and
// xn and dz in shared memory, rounded to bf16 for their products; the xn,
// hact and dz written out stay f32; gelu_fast and gelu_fast_grad).
template <int P, typename IO>
__global__ void __launch_bounds__(NT, 1)
ln_ff_res_bwd_kernel(const IO* __restrict__ x, const IO* __restrict__ g,
                     const float* __restrict__ W1, const float* __restrict__ b1,
                     const float* __restrict__ W1t,
                     const float* __restrict__ W2t,
                     const float* __restrict__ m_ptr,
                     const float* __restrict__ s_ptr, IO* __restrict__ dx,
                     float* __restrict__ xn, float* __restrict__ hact,
                     float* __restrict__ dz, float* __restrict__ stat_part,
                     int H, int F, int L) {
  constexpr bool BF = sizeof(IO) == 2;
  using T = Tile<P>;
  constexpr int PARTS = NT / P;
  extern __shared__ float4 sh4[];
  float* xs = reinterpret_cast<float*>(sh4);     // H x P: x, then xn
  float* gs = xs + H * P;                         // H x P: g, then dxn
  float* hs = gs + H * P;                         // F x P: dh, then dz
  float* AsT = hs + F * P;                        // TK x LDT
  float* red = AsT + TK * T::LDT;                 // 2 * NT
  float* mean_s = red + 2 * NT;                   // P
  float* rstd_s = mean_s + P;                     // P (0 past L)
  float* s1_s = rstd_s + P;                       // P
  float* s2_s = s1_s + P;                         // P
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, pg = tid % T::PG;
  const float m = *m_ptr, s = *s_ptr;

  load_tile<P>(x, xs, b, H, L, t0);
  load_tile<P>(g, gs, b, H, L, t0);
  __syncthreads();
  column_stats<P>(xs, H, red, mean_s, rstd_s);
  if (tid < P) rstd_s[tid] = t0 + tid < L ? rsqrtf(rstd_s[tid]) : 0.0f;
  __syncthreads();
  for (int idx = tid; idx < H * P; idx += NT) {
    const int h = idx / P, p = idx % P, t = t0 + p;
    const float v = s * rstd_s[p] * (xs[idx] - mean_s[p] + m);
    xs[idx] = BF ? round_bf16(v) : v;
    if (t < L) xn[((size_t)b * H + h) * L + t] = v;
  }

  // dh = W2^T g into hs
  for (int f0 = 0; f0 < F; f0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P, BF>(W2t, H, RowMap{f0, f0 + T::TM / 2, F, F, T::TM / 2}, gs,
                      AsT, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = f0 + local_row<P>(r);
      if (f >= F) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) hs[f * P + pg * 8 + j] = acc[r][j];
    }
  }
  // z = W1 xn + b1; dz = gelu'(z) dh in place of dh
  for (int f0 = 0; f0 < F; f0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P, BF>(W1, H, RowMap{f0, f0 + T::TM / 2, F, F, T::TM / 2}, xs,
                      AsT, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = f0 + local_row<P>(r);
      if (f >= F) continue;
      const float bf = b1[f];
      const size_t row = ((size_t)b * F + f) * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = pg * 8 + j, t = t0 + p;
        const float zz = acc[r][j] + bf;
        const float d =
            (BF ? gelu_fast_grad(zz) : gelu_erf_grad(zz)) * hs[f * P + p];
        hs[f * P + p] = BF ? round_bf16(d) : d;
        if (t < L) {
          hact[row + t] = BF ? gelu_fast(zz) : gelu_erf(zz);
          dz[row + t] = d;
        }
      }
    }
  }
  // dxn = W1^T dz into gs (g is no longer read from shared memory)
  for (int h0 = 0; h0 < H; h0 += T::TM) {
    float acc[8][8];
    gemm_chunk<P, BF>(W1t, F, RowMap{h0, h0 + T::TM / 2, H, H, T::TM / 2}, hs,
                      AsT, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + local_row<P>(r);
      if (h >= H) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) gs[h * P + pg * 8 + j] = acc[r][j];
    }
  }
  __syncthreads();

  // S1, S2 per position; xc + m re-read from x
  {
    const int p = tid % P, part = tid / P, t = t0 + p;
    float a1 = 0.0f, a2 = 0.0f;
    if (t < L) {
      for (int h = part; h < H; h += PARTS) {
        const float v = gs[h * P + p];
        a1 += v;
        a2 += v * (to_f(x[((size_t)b * H + h) * L + t]) - mean_s[p] + m);
      }
    }
    red[tid] = a1;
    red[NT + tid] = a2;
    __syncthreads();
    if (tid < P) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int q = 0; q < PARTS; ++q) {
        t1 += red[q * P + tid];
        t2 += red[NT + q * P + tid];
      }
      s1_s[tid] = t1 / (float)H;
      s2_s[tid] = t2 / (float)H;
    }
    __syncthreads();
  }

  // dx, and this thread's share of dm and ds
  float dm = 0.0f, ds = 0.0f;
  for (int idx = tid; idx < H * P; idx += NT) {
    const int h = idx / P, p = idx % P, t = t0 + p;
    if (t >= L) continue;
    const size_t at = ((size_t)b * H + h) * L + t;
    const float rstd = rstd_s[p], r = s * rstd;
    const float xc = to_f(x[at]) - mean_s[p];
    const float v = gs[idx];
    dx[at] = from_f<IO>(to_f(g[at]) + r * (v - s1_s[p])
                        - r * rstd * rstd * xc * s2_s[p]);
    dm += v * r;
    ds += v * rstd * (xc + m);
  }
  __syncthreads();                 // red is reused
  red[tid] = dm;
  red[NT + tid] = ds;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {   // fixed-order tree
    if (tid < w) {
      red[tid] += red[tid + w];
      red[NT + tid] += red[NT + tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    stat_part[2 * blk] = red[0];
    stat_part[2 * blk + 1] = red[NT];
  }
}

constexpr int WB = 64;   // weight-gradient output tile (WB x WB)
constexpr int WK = 16;   // positions per k-step

// part[s] = (X Y^T over split s, then the row sums of X over split s):
// X (B, M, L), Y (B, N, L), each f32 or bf16 (read into f32); split s = b *
// nsb + j covers positions [j tc, min(L, (j + 1) tc)) of batch row b.  Row
// sums come from the blocks of the first column tile.
template <typename TX, typename TY>
__global__ void __launch_bounds__(256)
wgrad_kernel(const TX* __restrict__ X, const TY* __restrict__ Y,
             float* __restrict__ part, int M, int N, int L, int tc, int nsb) {
  __shared__ float Xs[WK][WB + 4];
  __shared__ float Ys[WK][WB + 4];
  const int n0 = blockIdx.x * WB, m0 = blockIdx.y * WB, sp = blockIdx.z;
  const int b = sp / nsb, ta = (sp % nsb) * tc;
  const int tb = min(L, ta + tc);
  const TX* Xb = X + (size_t)b * M * L;
  const TY* Yb = Y + (size_t)b * N * L;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const bool rows = blockIdx.x == 0 && tn == 0;
  float acc[4][4] = {}, rs[4] = {};
  for (int t = ta; t < tb; t += WK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * 256, r = idx >> 4, k = idx & 15;
      const int tt = t + k;
      Xs[k][r] = (m0 + r < M && tt < tb)
                     ? to_f(Xb[(size_t)(m0 + r) * L + tt]) : 0.0f;
      Ys[k][r] = (n0 + r < N && tt < tb)
                     ? to_f(Yb[(size_t)(n0 + r) * L + tt]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = Xs[k][tm * 4 + i];
        bv[i] = Ys[k][tn * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rows) rs[i] += av[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)sp * ((size_t)M * N + M);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + tm * 4 + i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tn * 4 + j;
      if (nn < N) out[(size_t)mm * N + nn] = acc[i][j];
    }
    if (rows) out[(size_t)M * N + mm] = rs[i];
  }
}

// out[i] = sum over s of part[s * size + i], in order of s.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int S,
                                     int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * size + i];
  out[i] = acc;
}

int reduce_splits(const float* part, float* out, int S, int size,
                  cudaStream_t stream) {
  reduce_splits_kernel<<<(size + 255) / 256, 256, 0, stream>>>(part, out, S,
                                                               size);
  return (int)cudaGetLastError();
}

// The weight and bias gradient sum over all B * L positions of
// X Y^T (M x N) and of X's rows: partials, then their fixed-order sum.
template <typename TX, typename TY>
int weight_grad(const TX* X, const TY* Y, float* part, float* grads, int B,
                int M, int N, int L, int tc, cudaStream_t stream) {
  const int nsb = (L + tc - 1) / tc;
  dim3 grid((N + WB - 1) / WB, (M + WB - 1) / WB, B * nsb);
  wgrad_kernel<<<grid, 256, 0, stream>>>(X, Y, part, M, N, L, tc, nsb);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return reduce_splits(part, grads, B * nsb, M * N + M, stream);
}


// The fp32 kernels below launch at P positions a block on smem bytes of
// dynamic shared memory, both from ops/chmix.py's plan of each kernel; P is
// one the kernel is built for, else the launch is refused.
template <typename IO>
int glu_res_bwd_launch(const IO* y, const IO* g, const float* W,
                       const float* Wt, const float* bias, IO* dy, float* dz,
                       int B, int H, int L, int P, int smem,
                       cudaStream_t stream) {
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(y, g, W, Wt, bias,
                                                           dy, dz, H, L);
    return (int)cudaGetLastError();
  };
  switch (P) {
    case 128: return run(glu_res_bwd_kernel<128, IO>);
    case 64: return run(glu_res_bwd_kernel<64, IO>);
    case 32: return run(glu_res_bwd_kernel<32, IO>);
    case 16: return run(glu_res_bwd_kernel<16, IO>);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename IO>
int ln_ff_res_bwd_launch(const IO* x, const IO* g, const float* W1,
                         const float* b1, const float* W1t, const float* W2t,
                         const float* m, const float* s, IO* dx, float* xn,
                         float* hact, float* dz, float* stat_part, int B,
                         int H, int F, int L, int P, int smem,
                         cudaStream_t stream) {
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
        x, g, W1, b1, W1t, W2t, m, s, dx, xn, hact, dz, stat_part, H, F, L);
    return (int)cudaGetLastError();
  };
  switch (P) {
    case 64: return run(ln_ff_res_bwd_kernel<64, IO>);
    case 32: return run(ln_ff_res_bwd_kernel<32, IO>);
    case 16: return run(ln_ff_res_bwd_kernel<16, IO>);
    case 8: return run(ln_ff_res_bwd_kernel<8, IO>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int glu_res(const float* y, const float* res, const float* W, const float* b,
            float* out, int B, int H, int L, int P, int smem,
            cudaStream_t stream) {
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(y, res, W, b, out,
                                                           H, L);
    return (int)cudaGetLastError();
  };
  if (H % TK) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 128: return run(glu_res_kernel<128>);
    case 64: return run(glu_res_kernel<64>);
    case 32: return run(glu_res_kernel<32>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ln_ff_res(const float* x, const float* skip, const float* W1,
              const float* b1, const float* W2, const float* b2,
              const float* m, const float* s, float* out, float* mean,
              float* var, int B, int H, int F, int L, int P, int smem,
              cudaStream_t stream) {
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
        x, skip, W1, b1, W2, b2, m, s, out, mean, var, H, F, L);
    return (int)cudaGetLastError();
  };
  if (H % TK || F % TK) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 128: return run(ln_ff_res_kernel<128>);
    case 64: return run(ln_ff_res_kernel<64>);
    case 32: return run(ln_ff_res_kernel<32>);
    case 16: return run(ln_ff_res_kernel<16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wb[0:n] = bf16(W1[0:n]), wb[n:2n] = bf16(W2[0:n]), n % 4 == 0.  K (2 or
// 3, the kernel whose call launches it) only names the instance, so that a
// trace tells 2f's pass from 3f's.
template <int K>
__global__ void round_weights_kernel(const float4* __restrict__ W1,
                                     const float4* __restrict__ W2,
                                     uint2* __restrict__ wb, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n4) return;
  const float4 v = i < n4 ? W1[i] : W2[i - n4];
  wb[i] = make_uint2(dwst_mma::pack_bf16x2(v.x, v.y),
                     dwst_mma::pack_bf16x2(v.z, v.w));
}

template <int K>
int round_weights(const float* W1, const float* W2, __nv_bfloat16* wb,
                  int n, cudaStream_t stream) {
  const int n4 = n / 4;
  round_weights_kernel<K><<<(2 * n4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(W1), reinterpret_cast<const float4*>(W2),
      reinterpret_cast<uint2*>(wb), n4);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Kernel 3f on smem bytes of dynamic shared memory a block: with a
// scratch wb (2 F H bf16 entries), the weights rounded to bf16 into it,
// then the tensor-core kernel reading them; with wb null, the kernel
// reading the f32 weights and rounding them as they load.
template <int P, int MT2>
int launch_ff_tc(const __nv_bfloat16* x, const __nv_bfloat16* skip,
                 const float* W1, const float* b1, const float* W2,
                 const float* b2, const float* m, const float* s,
                 __nv_bfloat16* out, float* mean, float* var,
                 __nv_bfloat16* wb, int B, int H, int F, int L, int smem,
                 cudaStream_t stream) {
  const bool vec = L % 8 == 0 && aligned16(x) && aligned16(skip) &&
                   aligned16(out);
  const dim3 grid((L + P - 1) / P, B);
  auto run = [&](auto kernel, auto w1, auto w2) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, NT, smem, stream>>>(x, skip, w1, b1, w2, b2, m, s, out,
                                       mean, var, H, F, L, vec);
    return (int)cudaGetLastError();
  };
  if (wb == nullptr)
    return run(ln_ff_res_tc_kernel<P, MT2, float>, W1, W2);
  const int e = round_weights<3>(W1, W2, wb, F * H, stream);
  if (e) return e;
  return run(ln_ff_res_tc_kernel<P, MT2, __nv_bfloat16>,
             static_cast<const __nv_bfloat16*>(wb),
             static_cast<const __nv_bfloat16*>(wb + (size_t)F * H));
}

// Kernel 2f on smem bytes of dynamic shared memory a block: W (2H x H)
// rounded to bf16 into the scratch wb, then the tensor-core kernel.
template <int P>
int launch_glu_tc(const __nv_bfloat16* y, const __nv_bfloat16* res,
                  const float* W, const float* b, __nv_bfloat16* out,
                  __nv_bfloat16* wb, int B, int H, int L, int smem,
                  cudaStream_t stream) {
  int e = round_weights<2>(W, W + (size_t)H * H, wb, H * H, stream);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(glu_res_tc_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  const bool vec = L % 8 == 0 && aligned16(y) && aligned16(res) &&
                   aligned16(out);
  glu_res_tc_kernel<P><<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      y, res, wb, b, out, H, L, vec);
  return (int)cudaGetLastError();
}

// Kernel 6 or 6f: the per-position pass, then dW and db from dz and y.
template <typename IO>
int glu_res_bwd(const IO* y, const IO* g, const float* W, const float* Wt,
                const float* b, IO* dy, float* dz, float* part, float* grads,
                int B, int H, int L, int tc, int P, int smem,
                cudaStream_t stream) {
  if (H % TK || tc <= 0) return (int)cudaErrorInvalidValue;
  const int e = glu_res_bwd_launch(y, g, W, Wt, b, dy, dz, B, H, L, P, smem,
                                   stream);
  if (e) return e;
  return weight_grad(dz, y, part, grads, B, 2 * H, H, L, tc, stream);
}

// Kernel 7 or 7f: the per-position pass, the (dm, ds) sum, then dW1, db1
// from dz and xn, dW2, db2 from g and the GELU output.
template <typename IO>
int ln_ff_res_bwd(const IO* x, const IO* g, const float* W1, const float* b1,
                  const float* W1t, const float* W2t, const float* m,
                  const float* s, IO* dx, float* xn, float* hact, float* dz,
                  float* stat_part, float* dms, float* part1, float* grads1,
                  float* part2, float* grads2, int B, int H, int F, int L,
                  int tc, int P, int smem, cudaStream_t stream) {
  if (H % TK || F % TK || tc <= 0) return (int)cudaErrorInvalidValue;
  int e = ln_ff_res_bwd_launch(x, g, W1, b1, W1t, W2t, m, s, dx, xn, hact,
                               dz, stat_part, B, H, F, L, P, smem, stream);
  if (e) return e;
  const int nblocks = (L + P - 1) / P * B;
  if ((e = reduce_splits(stat_part, dms, nblocks, 2, stream))) return e;
  if ((e = weight_grad(dz, xn, part1, grads1, B, F, H, L, tc, stream)))
    return e;
  return weight_grad(g, hact, part2, grads2, B, H, F, L, tc, stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

// Every entry below takes P (positions a block) and smem (bytes of shared
// memory a block) from the kernel's plan in ops/chmix.py.

extern "C" int dwst_glu_res(const float* y, const float* res, const float* W,
                            const float* b, float* out, int B, int H, int L,
                            int P, int smem, cudaStream_t stream) {
  return glu_res(y, res, W, b, out, B, H, L, P, smem, stream);
}

// Kernel 2f: y, res and out bf16; wb a scratch for W rounded to bf16 (2 H H
// entries); P 128, 64 or 32; H a multiple of 16 up to 1024.
extern "C" int dwst_glu_res_bf16(const void* y, const void* res,
                                 const float* W, const float* b, void* out,
                                 void* wb, int B, int H, int L, int P,
                                 int smem, cudaStream_t stream) {
  if (H <= 0 || H % 16 || H > 1024) return (int)cudaErrorInvalidValue;
  const auto* yb = static_cast<const bf16*>(y);
  const auto* rb = static_cast<const bf16*>(res);
  auto* ob = static_cast<bf16*>(out);
  auto* w = static_cast<bf16*>(wb);
  switch (P) {
    case 128: return launch_glu_tc<128>(yb, rb, W, b, ob, w, B, H, L, smem,
                                        stream);
    case 64: return launch_glu_tc<64>(yb, rb, W, b, ob, w, B, H, L, smem,
                                      stream);
    case 32: return launch_glu_tc<32>(yb, rb, W, b, ob, w, B, H, L, smem,
                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dwst_ln_ff_res(const float* x, const float* skip,
                              const float* W1, const float* b1,
                              const float* W2, const float* b2,
                              const float* m, const float* s, float* out,
                              float* mean, float* var, int B, int H, int F,
                              int L, int P, int smem, cudaStream_t stream) {
  return ln_ff_res(x, skip, W1, b1, W2, b2, m, s, out, mean, var, B, H, F, L,
                   P, smem, stream);
}

// Kernel 3f: x, skip and out bf16; mean and var f32; wb a scratch for the
// weights rounded to bf16 (2 F H entries), or null to round them in the
// kernel; P 128 for H <= 128, 64 for H <= 256, 32 or 64 for H <= 512, 16
// for H <= 1024; H and F multiples of 16.
extern "C" int dwst_ln_ff_res_bf16(const void* x, const void* skip,
                                   const float* W1, const float* b1,
                                   const float* W2, const float* b2,
                                   const float* m, const float* s, void* out,
                                   float* mean, float* var, void* wb, int B,
                                   int H, int F, int L, int P, int smem,
                                   cudaStream_t stream) {
  if (H % 16 || F % 16 || H > 1024) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* sb = static_cast<const bf16*>(skip);
  auto* ob = static_cast<bf16*>(out);
  auto* w = static_cast<bf16*>(wb);
  if (P == 128 && H <= 128)
    return launch_ff_tc<128, 1>(xb, sb, W1, b1, W2, b2, m, s, ob, mean, var,
                                w, B, H, F, L, smem, stream);
  if (P == 64 && H <= 256)
    return launch_ff_tc<64, 2>(xb, sb, W1, b1, W2, b2, m, s, ob, mean, var, w,
                               B, H, F, L, smem, stream);
  if (P == 64)
    return launch_ff_tc<64, 4>(xb, sb, W1, b1, W2, b2, m, s, ob, mean, var, w,
                               B, H, F, L, smem, stream);
  if (P == 32 && H <= 512)
    return launch_ff_tc<32, 4>(xb, sb, W1, b1, W2, b2, m, s, ob, mean, var, w,
                               B, H, F, L, smem, stream);
  if (P == 16)
    return launch_ff_tc<16, 8>(xb, sb, W1, b1, W2, b2, m, s, ob, mean, var, w,
                               B, H, F, L, smem, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dwst_glu_res_bwd(const float* y, const float* g, const float* W,
                                const float* Wt, const float* b, float* dy,
                                float* dz, float* part, float* grads, int B,
                                int H, int L, int tc, int P, int smem,
                                cudaStream_t stream) {
  return glu_res_bwd(y, g, W, Wt, b, dy, dz, part, grads, B, H, L, tc, P,
                     smem, stream);
}

// Kernel 6f: y, g and dy bf16; dz, part and grads f32.
extern "C" int dwst_glu_res_bwd_bf16(const void* y, const void* g,
                                     const float* W, const float* Wt,
                                     const float* b, void* dy, float* dz,
                                     float* part, float* grads, int B, int H,
                                     int L, int tc, int P, int smem,
                                     cudaStream_t stream) {
  return glu_res_bwd(static_cast<const bf16*>(y), static_cast<const bf16*>(g),
                     W, Wt, b, static_cast<bf16*>(dy), dz, part, grads, B, H,
                     L, tc, P, smem, stream);
}

extern "C" int dwst_ln_ff_res_bwd(
    const float* x, const float* g, const float* W1, const float* b1,
    const float* W1t, const float* W2t, const float* m, const float* s,
    float* dx, float* xn, float* hact, float* dz, float* stat_part,
    float* dms, float* part1, float* grads1, float* part2, float* grads2,
    int B, int H, int F, int L, int tc, int P, int smem,
    cudaStream_t stream) {
  return ln_ff_res_bwd(x, g, W1, b1, W1t, W2t, m, s, dx, xn, hact, dz,
                       stat_part, dms, part1, grads1, part2, grads2, B, H, F,
                       L, tc, P, smem, stream);
}

// Kernel 7f: x, g and dx bf16; the scratch and the gradients f32.
extern "C" int dwst_ln_ff_res_bwd_bf16(
    const void* x, const void* g, const float* W1, const float* b1,
    const float* W1t, const float* W2t, const float* m, const float* s,
    void* dx, float* xn, float* hact, float* dz, float* stat_part,
    float* dms, float* part1, float* grads1, float* part2, float* grads2,
    int B, int H, int F, int L, int tc, int P, int smem,
    cudaStream_t stream) {
  return ln_ff_res_bwd(static_cast<const bf16*>(x),
                       static_cast<const bf16*>(g), W1, b1, W1t, W2t, m, s,
                       static_cast<bf16*>(dx), xn, hact, dz, stat_part, dms,
                       part1, grads1, part2, grads2, B, H, F, L, tc, P, smem,
                       stream);
}
