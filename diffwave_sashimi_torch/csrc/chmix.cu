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
// The f32 forms (kernels 2, 3, 6, 7) multiply on the tensor cores at f32
// accuracy, in 3xTF32 (below): each f32 operand split into tf32 hi and lo
// parts, a product taken as three tensor-core products with f32 sums
// (mma_tf32.cuh).  The sigmoid uses expf, GELU erff: the strict f32 path.
//
// The host computes every kernel's positions a block P and its bytes of
// shared memory (ops/chmix.py: glu_tf32_plan, ff_tf32_plan,
// glu_bwd_tf32_plan, ff_bwd_plan and, for the tensor-core kernels below, glu_bf16_plan,
// ff_bf16_plan, glu_bwd_bf16_plan and ff_bwd_bf16_plan; wgrad_plan for the
// weight gradients' splits), and refuses widths whose tiles do not fit one
// block before it launches; the kernels take both as given.
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
// atomics).  Kernel 3, the f32 form (ln_ff_res_tf32_kernel below), takes
// its products on the tensor cores too, in 3xTF32: its 1e-4 bar rules out
// one TF32 product, and three, an f32 operand split into tf32 hi and lo
// parts, keep f32 accuracy (mma_tf32.cuh).
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
// form (glu_res_tf32_kernel below), pairs its value and gate m-tiles the
// same way but multiplies in 3xTF32: its 1e-4 bar rules out bf16 products,
// and an f32 operand split into two tf32 parts keeps f32 accuracy.
//
// The backward passes' bf16 forms, kernels 6f (glu_res_bwd_tc_kernel) and
// 7f (ln_ff_res_bwd_tc_kernel), multiply on the tensor cores too, bound by
// bytes as the forwards are: their weights rounded to bf16 and transposed
// once a call into a scratch in mma fragment order
// (round_weights_t_kernel<6> and <7>), A fragments read from L2 with no
// weight tile, the bf16 activation tiles by cp.async, and 6f's value and
// gate m-tiles paired in one warp as 2f's, so that its dz is formed in
// registers; their weight gradients contract the f32 scratch on the fp32
// FMAs (wgrad_kernel).  Of the f32 forms, kernel 7 takes its three
// per-position products in 3xTF32 (ln_ff_res_bwd_tf32_kernel), as kernel
// 3 takes its two (ln_ff_res_tf32_kernel), and kernel 6 its two
// (glu_res_bwd_tf32_kernel, with 6f's value/gate pairing): an f32 operand
// split into two tf32 parts and a product taken as three tensor-core
// products with f32 sums keeps f32 accuracy (mma_tf32.cuh).  Both
// backward passes contract their weight gradients on the fp32 FMAs
// (wgrad_kernel).

#include <cuda_runtime.h>

#include "activations.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace dwst_act;
using dwst_mma::aligned16;
using dwst_async::cp_async16;
using dwst_async::cp_async_commit;
using dwst_async::cp_async_wait;
using dwst_mma::pack8;
using dwst_mma::unpack8;

constexpr int NT = 256;        // threads per block

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
// they are compute bound like the forwards.
//
// Design: a per-position pass (kernels 6's and 7's are below, on the
// tensor cores) recomputes z from the saved input, forms dz in registers
// and shared memory, contracts it back to the input gradient, and writes
// the operands of the weight gradients
// (dz, and for FF the normalised input and the GELU output) to device
// memory.  FF's scalar gradients dm and ds are per-block partials summed
// in a fixed order.
//
// The weight gradients (wgrad_kernel, shared by 6, 6f, 7 and 7f) contract
// over all B * L positions (64000 at the top tier): 2 M N B L fp32
// operations of a GEMM whose two operands are both position-contiguous
// rows.  JAX's _bmmc contracts f32 operands and kernels 6 and 7 are held
// to 1e-4, which rules out one TF32 product; a 3xTF32 form of this
// kernel (three tensor-core products, f32 accuracy) ran no faster than
// the FMAs at these shapes on the H100 and was not kept.
// Design: a tiled SGEMM.  Each block takes a 128 x 128 output tile (8 x 8
// sums a thread, rows and columns 16 apart so that a warp's shared loads
// hit 4 and 8 rows on distinct banks) over one split of one batch row's
// positions; 32-position k-tiles of both operands arrive in shared memory
// by cp.async, double-buffered, rows kept position-contiguous and read as
// 4 positions a load.  The bias gradients are row sums of the same X
// tiles (in the first column of blocks).  ops/chmix.py::wgrad_plan picks
// the positions a split so that the grid fills at least two waves of one
// block an SM with little tail; the split-K partials are summed in a
// fixed order by reduce_splits_kernel.  No float atomics: a run repeats
// bit for bit.
//
// Kernel 6f, the GLU backward's bf16 form, and kernel 7f, the FF
// backward's, multiply on the tensor cores (glu_res_bwd_tc_kernel below,
// ln_ff_res_bwd_tc_kernel below kernel 7).

// Kernel 6f (bf16 y, g and dy; f32 bias and dz scratch), the GLU backward
// on the tensor cores.  It replaces diffwave_sashimi_tpu/ops/chmix.py:414
// _glu_bwd_kernel with fast=True: as JAX's _bmm does, both operands of its
// two per-position products (z = W y, dy = W^T dz) are rounded to bf16 and
// their products summed in f32; bias, sigmoid (expf and an IEEE division,
// as kernel 6) and dz are f32; dz goes out unrounded for the weight
// gradient (JAX's _bmmc, wgrad_kernel), dy rounded to bf16.
//
// What bounds it: 8 H^2 B L operations at the bf16 tensor-core rate (8.5
// us at SC09's top tier) take less time than its bytes (y and g read, dy
// and the f32 dz scratch written: 34 us), so the bound is bytes; every
// block also reads the bf16 W and W^T whole from L2, once per P
// positions.  Design, 2f's and 7f's: round_weights_t_kernel<6> rounds W
// and W^T to bf16 once a call into a scratch in mma fragment order, so that
// A fragments come from L2 one 16-byte load a lane into a ring of registers
// (mma_bf16.cuh::warp_gemm_ring), with no weight tile and no barrier in the
// k-loop; one block of 8 warps per (batch, P positions), P from
// ops/chmix.py::glu_bwd_bf16_plan, which also computes the block's shared
// memory (the kernel takes both as given).  The bf16 y and g tiles arrive
// by cp.async, each thread's rows all in flight at once, rows padded for
// ldmatrix.trans; g lands in the first H rows of the 2H-row dz tile.  In
// GEMM 1 each warp takes MV value m-tiles with their MV gate m-tiles over
// all P positions, so a and gate meet in one thread's registers, where
// bias, sigmoid, da and dgate are formed: g is read from the dz tile at the
// thread's own positions and overwritten there by bf16(da) (no other thread
// reads those entries), bf16(dgate) goes to row H + o, and both go out in
// f32, four lanes filling a 32-byte sector.  Past 128 MV value rows the
// warps take the rows in passes.  After one barrier, GEMM 2: each warp
// takes MT2 m-tiles of dy over all P positions, K = 2H from the dz tile;
// bf16(dy) is staged over the y tile, free since the barrier, then stored
// 16 bytes a thread, coalesced.  So any H that is a multiple of 16 up to
// 1024 fits one block.
template <int P>
struct GluBwdTile {
  static constexpr int MV = 128 / P < 4 ? 128 / P : 4;  // GEMM 1 pairs
  static constexpr int MT2 = 128 / P;      // GEMM 2 m-tiles: 64 sums
  static constexpr int N8 = P / 8;         // n-tiles, and 8-position chunks
  static constexpr int LD = P + 8;         // bf16 rows
  static constexpr int ROWS = NWARPS * 16 * MV;   // value rows a pass
  static constexpr int HS = NT / N8;       // row step of a thread
  // k-steps the A fragments load ahead: 2 while the ring stays small
  static constexpr int AHEAD1 = MV == 1 ? 2 : 1;
  static constexpr int AHEAD2 = MT2 <= 2 ? 2 : 1;
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
glu_res_bwd_tc_kernel(const __nv_bfloat16* __restrict__ y,
                      const __nv_bfloat16* __restrict__ g,
                      const uint4* __restrict__ Wf,
                      const uint4* __restrict__ Wtf,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ dy,
                      float* __restrict__ dz, int H, int L, bool vec) {
  using T = GluBwdTile<P>;
  using bf = __nv_bfloat16;
  constexpr int N8 = T::N8, LD = T::LD, MV = T::MV, HS = T::HS;
  extern __shared__ float4 sh4[];
  bf* ys = reinterpret_cast<bf*>(sh4);     // H x LD: y, then bf16(dy)
  bf* zs = ys + (size_t)H * LD;            // 2H x LD: g, then bf16(dz)
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int Ht = H / 16;
  // this thread's chunk of 8 positions (with vec all in or all past L),
  // and its rows h0 + i HS
  const int c = tid % N8 * 8, t = t0 + c, h0 = tid / N8;

  // the y and g tiles (0 past L): with vec all of this thread's rows in
  // flight at once by cp.async
  if (vec) {
    for (int h = h0; h < H; h += HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      if (t < L) {
        cp_async16(ys + h * LD + c, y + at);
        cp_async16(zs + h * LD + c, g + at);
      } else {
        *reinterpret_cast<uint4*>(ys + h * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(zs + h * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int h = h0; h < H; h += HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      float v[8], w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = t + j < L ? __bfloat162float(y[at + j]) : 0.0f;
        w[j] = t + j < L ? __bfloat162float(g[at + j]) : 0.0f;
      }
      *reinterpret_cast<uint4*>(ys + h * LD + c) = pack8(v);
      *reinterpret_cast<uint4*>(zs + h * LD + c) = pack8(w);
    }
  }
  __syncthreads();

  // GEMM 1: value rows [r0, r0 + 16 MV) and gate rows H + the same of z =
  // Wb y over all P positions; value rows past H (a partial last group)
  // are computed from gate rows and dropped
  for (int p0 = 0; p0 < H; p0 += T::ROWS) {
    const int r0 = p0 + warp * 16 * MV;
    if (r0 >= H) continue;
    float acc[2 * MV][N8][4];
    dwst_mma::warp_gemm_ring<2 * MV, N8, T::AHEAD1, MV>(Wf, 2 * Ht, Ht,
                                                        r0 / 16, ys, LD, acc,
                                                        Ht);
#pragma unroll
    for (int mt = 0; mt < MV; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = r0 + 16 * mt + gq + 8 * hh;
        if (o >= H) continue;
        const float ba = bias[o], bg = bias[H + o];
        uint32_t* ar = reinterpret_cast<uint32_t*>(zs + o * LD + 2 * tq);
        uint32_t* hr =
            reinterpret_cast<uint32_t*>(zs + (H + o) * LD + 2 * tq);
        float* arow = dz + ((size_t)b * 2 * H + o) * L;
        float* hrow = arow + (size_t)H * L;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int tt = t0 + 8 * j + 2 * tq;
          const float2 gv =
              __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(ar + 4 * j));
          const float gs[2] = {gv.x, gv.y};
          float da[2], dg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[mt][j][2 * hh + e] + ba;
            const float sig =
                1.0f / (1.0f + expf(-(acc[MV + mt][j][2 * hh + e] + bg)));
            da[e] = gs[e] * sig;
            dg[e] = gs[e] * a * sig * (1.0f - sig);
          }
          ar[4 * j] = dwst_mma::pack_bf16x2(da[0], da[1]);
          hr[4 * j] = dwst_mma::pack_bf16x2(dg[0], dg[1]);
          if (vec) {             // L even: both positions in or both out
            if (tt < L) {
              *reinterpret_cast<float2*>(arow + tt) = make_float2(da[0], da[1]);
              *reinterpret_cast<float2*>(hrow + tt) = make_float2(dg[0], dg[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (tt + e < L) {
                arow[tt + e] = da[e];
                hrow[tt + e] = dg[e];
              }
          }
        }
      }
  }
  __syncthreads();

  // GEMM 2: dy = Wb^T bf16(dz), H x P, K = 2H; bf16(dy) into the y tile,
  // which no warp reads past the barrier above
  {
    constexpr int MT = T::MT2;
    for (int u = warp; u * 16 * MT < H; u += NWARPS) {
      const int r0 = u * 16 * MT;
      float acc[MT][N8][4];
      dwst_mma::warp_gemm_ring<MT, N8, T::AHEAD2>(Wtf, Ht, 2 * Ht, r0 / 16,
                                                  zs, LD, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = r0 + 16 * mt + gq + 8 * hh;
          if (h >= H) continue;
          uint32_t* dr = reinterpret_cast<uint32_t*>(ys + h * LD + 2 * tq);
#pragma unroll
          for (int j = 0; j < N8; ++j)
            dr[4 * j] = dwst_mma::pack_bf16x2(acc[mt][j][2 * hh],
                                              acc[mt][j][2 * hh + 1]);
        }
    }
  }
  __syncthreads();

  // dy out, 16 bytes a thread (element by element without vec)
  for (int h = h0; h < H; h += HS) {
    const size_t at = ((size_t)b * H + h) * L + t;
    const bf* src = ys + h * LD + c;
    if (vec) {
      if (t < L)
        *reinterpret_cast<uint4*>(dy + at) =
            *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (t + j < L) dy[at + j] = src[j];
    }
  }
}

__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

// Kernel 7 (f32; kernel 7f is ln_ff_res_bwd_tc_kernel below), on the
// tensor cores at f32 accuracy.  It replaces diffwave_sashimi_tpu/ops/
// chmix.py:362 _ff_bwd_kernel with fast=False: JAX's three per-position
// products (_bmm at HIGHEST precision: dh = W2^T g, z = W1 xn, dxn = W1^T
// dz) in 3xTF32 (mma_tf32.cuh), the rest with kernel 7's f32 algebra: the
// LN statistics (var = E[x^2] - mean^2), exact GELU (erff) and its
// derivative, S1, S2, dx and (dm, ds).  Writes dx, xn = TLN(x), hact =
// gelu(z), dz, and (dm, ds) of the block; the weight gradients contract
// the f32 xn, hact and dz on the fp32 FMAs (wgrad_kernel).
//
// What bounds it: three products of 2 F H B L operations each, three tf32
// products apiece at the dense TF32 rate (495 T/s: 0.076 ms at SC09's top
// tier), and its bytes (x and g read, dx and the xn, GELU-output and dz
// scratch written: 0.08 ms) bound it alike; every block
// also reads three split weight matrices (8 bytes an entry) from L2, once
// per P positions.  Design, 7f's with f32 tiles: split_weights_tf32_kernel
// splits W1, W1^T and W2^T into tf32 hi and lo parts once a call, into a
// scratch in fragment order, so that A fragments come from L2 two 16-byte
// loads a lane, one k-step ahead (warp_gemm_3xtf32), with no weight tile
// and no barrier in the k-loop; one block of 8 warps per (batch, P
// positions), P and the shared-memory bytes from ops/chmix.py::
// ff_bwd_plan (the kernel takes both as given).  The f32 x and g tiles
// arrive by cp.async, rows padded to LD floats (LD % 32 of 8 or 24: a B
// fragment's 32 loads on distinct banks), and B values are split as they
// load.  xn replaces x in its tile.  Each warp takes MT m-tiles of F for
// dh, then z, so both meet in its registers, where dz and the GELU output
// form; both go out in f32 and dz into an F-row tile.  After one barrier
// each warp takes MT m-tiles of H for dxn = W1^T dz, stored over xn.
// Then S1, S2, dx (x re-read) and the block's (dm, ds), in a fixed order
// (no float atomics): a run repeats bit for bit.  H and F are multiples
// of 8 (the mma k-step); m-tiles past F or H are the scratch's zero rows.
template <int P>
struct Tf32Tile {
  static constexpr int N8 = P / 8;             // n-tiles
  static constexpr int LD = P == 8 ? 8 : P + 8;   // f32 rows
  static constexpr int MT = 128 / P < 4 ? 128 / P : 4;   // m-tiles a warp
  static constexpr int C4 = P / 4;             // 16-byte chunks a row
  static constexpr int HS = NT / C4;           // row step of a thread
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
ln_ff_res_bwd_tf32_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          const uint4* __restrict__ W1f,
                          const uint4* __restrict__ W1tf,
                          const uint4* __restrict__ W2tf,
                          const float* __restrict__ b1,
                          const float* __restrict__ m_ptr,
                          const float* __restrict__ s_ptr,
                          float* __restrict__ dx, float* __restrict__ xn,
                          float* __restrict__ hact, float* __restrict__ dz,
                          float* __restrict__ stat_part, int H, int F, int L,
                          bool vec) {
  using T = Tf32Tile<P>;
  constexpr int LD = T::LD, N8 = T::N8, MT = T::MT, PARTS = NT / P;
  extern __shared__ float4 sh4[];
  float* red = reinterpret_cast<float*>(sh4);     // 2 NT: partial sums
  float* mean_s = red + 2 * NT;                   // P
  float* rstd_s = mean_s + P;                     // P (0 past L)
  float* s1_s = rstd_s + P;                       // P
  float* s2_s = s1_s + P;                         // P
  float* xs = s2_s + P;                           // H x LD: x, xn, dxn
  float* gs = xs + H * LD;                        // H x LD: g
  float* zs = gs + H * LD;                        // F x LD: dz
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // the thread's position and part of the channels in the column passes
  const int p = tid % P, part = tid / P;
  const float m = *m_ptr, s = *s_ptr;

  // the x and g tiles (0 past L), 16 bytes a thread by cp.async with vec
  {
    const int c = tid % T::C4 * 4, t = t0 + c;
    for (int h = tid / T::C4; h < H; h += T::HS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      float* xd = xs + h * LD + c;
      float* gd = gs + h * LD + c;
      if (vec && t < L) {          // L % 4 == 0: the chunk is all in
        cp_async16(xd, x + at);
        cp_async16(gd, g + at);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xd[e] = t + e < L ? x[at + e] : 0.0f;
          gd[e] = t + e < L ? g[at + e] : 0.0f;
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // mean and E[x^2] - mean^2 per position, f32, in a fixed order
  {
    float s1 = 0.0f, s2 = 0.0f;
    for (int h = part; h < H; h += PARTS) {
      const float v = xs[h * LD + p];
      s1 += v;
      s2 += v * v;
    }
    red[tid] = s1;
    red[NT + tid] = s2;
  }
  __syncthreads();
  if (tid < P) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int q = 0; q < PARTS; ++q) {
      t1 += red[q * P + tid];
      t2 += red[NT + q * P + tid];
    }
    const float mean = t1 / (float)H;
    mean_s[tid] = mean;
    rstd_s[tid] = t0 + tid < L ? rsqrtf(t2 / (float)H - mean * mean) : 0.0f;
  }
  __syncthreads();

  // xn = s rstd (x - mean + m), in place of x and out to the scratch
  for (int idx = tid; idx < H * P; idx += NT) {
    const int h = idx / P, q = idx % P, t = t0 + q;
    const float v = s * rstd_s[q] * (xs[h * LD + q] - mean_s[q] + m);
    xs[h * LD + q] = v;
    if (t < L) xn[((size_t)b * H + h) * L + t] = v;
  }
  __syncthreads();

  // dh = W2^T g and z = W1 xn on the same m-tiles of F; dz = gelu'(z + b1)
  // dh and hact = gelu(z + b1) out in f32, dz into zs
  const int Ft = (F + 15) / 16, Ht = (H + 15) / 16;
  for (int u = warp; u * MT < Ft; u += NWARPS) {
    const int mt0 = u * MT;
    float dh[MT][N8][4], zz[MT][N8][4];
    dwst_tf32::warp_gemm_3xtf32<MT, N8>(W2tf, Ft, H / 8, mt0, gs, LD, dh);
    dwst_tf32::warp_gemm_3xtf32<MT, N8>(W1f, Ft, H / 8, mt0, xs, LD, zz);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f = 16 * (mt0 + mt) + gq + 8 * hh;
        if (f >= F) continue;
        const float bias = b1[f];
        const size_t row = ((size_t)b * F + f) * L;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int q = 8 * j + 2 * tq, tt = t0 + q;
          float d[2], ha[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zv = zz[mt][j][2 * hh + e] + bias;
            ha[e] = gelu_erf(zv);
            d[e] = gelu_erf_grad(zv) * dh[mt][j][2 * hh + e];
          }
          *reinterpret_cast<float2*>(zs + f * LD + q) = make_float2(d[0], d[1]);
          if (vec) {             // L % 4 == 0: both positions in or both out
            if (tt < L) {
              *reinterpret_cast<float2*>(hact + row + tt) =
                  make_float2(ha[0], ha[1]);
              *reinterpret_cast<float2*>(dz + row + tt) =
                  make_float2(d[0], d[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (tt + e < L) {
                hact[row + tt + e] = ha[e];
                dz[row + tt + e] = d[e];
              }
          }
        }
      }
  }
  __syncthreads();

  // dxn = W1^T dz, H x P, over xn (no warp reads xs past the barrier)
  for (int u = warp; u * MT < Ht; u += NWARPS) {
    const int mt0 = u * MT;
    float acc[MT][N8][4];
    dwst_tf32::warp_gemm_3xtf32<MT, N8>(W1tf, Ht, F / 8, mt0, zs, LD, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 16 * (mt0 + mt) + gq + 8 * hh;
        if (h >= H) continue;
#pragma unroll
        for (int j = 0; j < N8; ++j)
          *reinterpret_cast<float2*>(xs + h * LD + 8 * j + 2 * tq) =
              make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
      }
  }
  __syncthreads();

  // S1 = mean_h dxn, S2 = mean_h dxn (xc + m) per position; x re-read
  const int t = t0 + p;
  {
    float a1 = 0.0f, a2 = 0.0f;
    if (t < L) {
      for (int h = part; h < H; h += PARTS) {
        const float v = xs[h * LD + p];
        a1 += v;
        a2 += v * (x[((size_t)b * H + h) * L + t] - mean_s[p] + m);
      }
    }
    red[tid] = a1;
    red[NT + tid] = a2;
  }
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

  // dx = g + r (dxn - S1) - r rstd^2 xc S2, r = s rstd; this thread's share
  // of dm = sum dxn r and ds = sum dxn rstd (xc + m)
  float dm = 0.0f, ds = 0.0f;
  if (t < L) {
    const float rstd = rstd_s[p], r = s * rstd, mu = mean_s[p];
    const float q1 = s1_s[p], q2 = s2_s[p];
    for (int h = part; h < H; h += PARTS) {
      const size_t at = ((size_t)b * H + h) * L + t;
      const float xc = x[at] - mu, v = xs[h * LD + p];
      dx[at] = gs[h * LD + p] + r * (v - q1) - r * rstd * rstd * xc * q2;
      dm += v * r;
      ds += v * rstd * (xc + m);
    }
  }
  red[tid] = dm;                   // the S1, S2 sums were read before
  red[NT + tid] = ds;              // the barrier above
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

// Kernel 3 (f32), on the tensor cores at f32 accuracy.  It replaces
// diffwave_sashimi_tpu/ops/chmix.py:182 _ff_kernel with fast=False: out = x
// + W2 gelu(W1 TLN(x) + b1) + b2 [+ skip] and, optionally, the output's
// channel mean and E[out^2] - mean^2 per position (the next block's
// norm1); its two per-position products (_bmm at HIGHEST precision) in
// 3xTF32 (mma_tf32.cuh), the rest with kernel 3's f32 algebra: the LN
// statistics (population std, no eps, var = E[x^2] - mean^2), the exact
// GELU (erff), the residual adds in kernel 3's order ((x + W2 z) + b2, then
// skip).
//
// What bounds it: two products of 2 F H B L operations each, three tf32
// products apiece at the dense TF32 rate (495 T/s: 0.051 ms at SC09's top
// tier, B4 H128 F256 L16000), against 0.020-0.029 ms of bytes (x and skip
// read, out written); every block also reads both split weight matrices
// (8 bytes an entry, 512 KB at H 128) from L2, once per P positions, so a
// wide P matters.  Design, kernel 7's: split_weights_tf32_kernel<3> splits
// W1 (F x H) and W2 (H x F) into tf32 hi and lo parts once a call, into a
// scratch in fragment order, so that A fragments come from L2 two 16-byte
// loads a lane, AHEAD k-steps ahead into a ring of registers
// (warp_gemm_3xtf32_ring), with no weight tile and no barrier in the
// k-loop; one block of 8 warps per (batch, P positions), built for BLOCKS
// blocks an SM: at two (P 64, where two blocks' tiles fit an SM, H 128),
// each warp takes one m-tile at a time in 128 registers, and the other
// block's warps hide its latencies.  The f32 x tile arrives by cp.async,
// rows padded to LD floats (LD % 32 of 8 or 24: a B fragment's 32 loads on
// distinct banks), the statistics are taken from it, and TLN(x) replaces x
// in it; B values are split as they load.  The hidden rows come in chunks
// of FC: each warp takes MT m-tiles of the chunk for z = W1 TLN(x), adds
// b1 and takes the GELU in registers into an f32 FC-row tile; after a
// barrier each warp takes MT m-tiles of H and adds W2's chunk of columns
// times that tile to its sums, kept over the chunks in an f32 H-row tile
// (in x's tile when one chunk holds F: TLN(x) is then no longer read).
// Chunks let P stay at 16384 / H from H 256 on (64, 32, 16 at H
// 256-1024): the whole F-row tile fits beside the x tile only up to H 256.
// Then out = (x + sums) + b2 [+ skip], 16 bytes a thread, coalesced (x
// re-read), and the output's statistics from the tile.
// ops/chmix.py::ff_tf32_plan picks P, FC and the blocks an SM and computes
// the block's shared-memory bytes; the kernel takes them as given.  Every sum runs in a fixed order (the
// k-steps in order over the chunks, no float atomics): two calls are
// bit-equal.  H and F are multiples of 8 (the mma k-step); m-tiles past F
// or H are the scratch's zero rows.
template <int P, int BLOCKS>
struct FfTf32Tile {
  static constexpr int N8 = P / 8;             // n-tiles
  // m-tiles a warp at once in both products: 16 MT N8 <= 64 sums a
  // thread, MT <= 4; one at two blocks an SM (128 registers a thread)
  static constexpr int MT =
      BLOCKS > 1 || N8 >= 16 ? 1 : (16 / N8 < 4 ? 16 / N8 : 4);
  // k-steps of A fragments in flight ahead of their use (one at four
  // m-tiles a warp, whose ring would not fit 255 registers)
  static constexpr int AHEAD = MT >= 4 ? 1 : 2;
};

template <int P, int BLOCKS>
__global__ void __launch_bounds__(NT, BLOCKS)
ln_ff_res_tf32_kernel(const float* __restrict__ x,
                      const float* __restrict__ skip,
                      const uint4* __restrict__ W1f,
                      const float* __restrict__ b1,
                      const uint4* __restrict__ W2f,
                      const float* __restrict__ b2,
                      const float* __restrict__ m_ptr,
                      const float* __restrict__ s_ptr,
                      float* __restrict__ out, float* __restrict__ mean_out,
                      float* __restrict__ var_out, int H, int F, int L,
                      int FC, bool vec) {
  using T = Tf32Tile<P>;
  using U = FfTf32Tile<P, BLOCKS>;
  constexpr int LD = T::LD, N8 = T::N8, MT = U::MT;
  constexpr int PARTS = NT / P;
  extern __shared__ float4 sh4[];
  float* red = reinterpret_cast<float*>(sh4);     // 2 NT: partial sums
  float* mean_s = red + 2 * NT;                   // P
  float* rstd_s = mean_s + P;                     // P (0 past L)
  float* xs = rstd_s + P;                         // H x LD: x, TLN(x)
  float* zs = xs + H * LD;                        // min(F, FC) x LD: GELU
  float* os = FC < F ? zs + FC * LD : xs;         // H x LD: W2 z, then out
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // the thread's position and part of the channels in the column passes
  const int p = tid % P, part = tid / P;
  // the thread's 16-byte chunk of a row and its first row in the row passes
  const int c = tid % T::C4 * 4, tc = t0 + c, h0 = tid / T::C4;

  // the x tile (0 past L), 16 bytes a thread by cp.async with vec
  for (int h = h0; h < H; h += T::HS) {
    const size_t at = ((size_t)b * H + h) * L + tc;
    float* xd = xs + h * LD + c;
    if (vec && tc < L) {           // L % 4 == 0: the chunk is all in
      cp_async16(xd, x + at);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xd[e] = tc + e < L ? x[at + e] : 0.0f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // mean and E[x^2] - mean^2 per position, f32, in a fixed order
  {
    float s1 = 0.0f, s2 = 0.0f;
    for (int h = part; h < H; h += PARTS) {
      const float v = xs[h * LD + p];
      s1 += v;
      s2 += v * v;
    }
    red[tid] = s1;
    red[NT + tid] = s2;
  }
  __syncthreads();
  if (tid < P) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int q = 0; q < PARTS; ++q) {
      t1 += red[q * P + tid];
      t2 += red[NT + q * P + tid];
    }
    const float mean = t1 / (float)H;
    mean_s[tid] = mean;
    rstd_s[tid] = t0 + tid < L ? rsqrtf(t2 / (float)H - mean * mean) : 0.0f;
  }
  __syncthreads();

  // TransposedLN in place: (s / std) (x - mean + m), population std, no
  // eps (0 past L)
  {
    const float m = *m_ptr, s = *s_ptr;
    for (int idx = tid; idx < H * P; idx += NT) {
      const int h = idx / P, q = idx % P;
      xs[h * LD + q] = s * rstd_s[q] * (xs[h * LD + q] - mean_s[q] + m);
    }
  }
  __syncthreads();

  const int Ft = (F + 15) / 16, Ht = (H + 15) / 16;
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);     // the chunk's rows, a multiple of 8
    if (f0 > 0) __syncthreads();        // every warp has read zs
    // z = W1 TLN(x) + b1 on the chunk's m-tiles; gelu(z) into zs
    for (int u = warp; u * MT < (fc + 15) / 16; u += NWARPS) {
      const int mt0 = f0 / 16 + u * MT;
      float acc[MT][N8][4];
      dwst_tf32::zero_acc<MT, N8>(acc);
      dwst_tf32::warp_gemm_3xtf32_ring<MT, N8, U::AHEAD>(
          W1f, Ft, H / 8, mt0, 0, H / 8, xs, LD, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int f = 16 * (mt0 + mt) + gq + 8 * hh;
          if (f >= f0 + fc) continue;
          const float bias = b1[f];
          float* zr = zs + (f - f0) * LD + 2 * tq;
#pragma unroll
          for (int j = 0; j < N8; ++j)
            *reinterpret_cast<float2*>(zr + 8 * j) =
                make_float2(gelu_erf(acc[mt][j][2 * hh] + bias),
                            gelu_erf(acc[mt][j][2 * hh + 1] + bias));
        }
    }
    __syncthreads();
    // os += W2[:, f0:f0 + fc] gelu(z) on MT m-tiles of H a warp (the same
    // warp's rows at every chunk)
    for (int u = warp; u * MT < Ht; u += NWARPS) {
      const int mt0 = u * MT;
      float acc[MT][N8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = 16 * (mt0 + mt) + gq + 8 * hh;
#pragma unroll
          for (int j = 0; j < N8; ++j) {
            float2 v = make_float2(0.0f, 0.0f);
            if (f0 > 0 && h < H)
              v = *reinterpret_cast<const float2*>(os + h * LD + 8 * j +
                                                   2 * tq);
            acc[mt][j][2 * hh] = v.x;
            acc[mt][j][2 * hh + 1] = v.y;
          }
        }
      dwst_tf32::warp_gemm_3xtf32_ring<MT, N8, U::AHEAD>(
          W2f, Ht, F / 8, mt0, f0 / 8, fc / 8, zs, LD, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = 16 * (mt0 + mt) + gq + 8 * hh;
          if (h >= H) continue;
#pragma unroll
          for (int j = 0; j < N8; ++j)
            *reinterpret_cast<float2*>(os + h * LD + 8 * j + 2 * tq) =
                make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
        }
    }
  }
  __syncthreads();

  // out = (x + W2 z) + b2 [+ skip], 16 bytes a thread; out (0 past L) over
  // the sums for the statistics
  for (int h = h0; h < H; h += T::HS) {
    const size_t at = ((size_t)b * H + h) * L + tc;
    float* o = os + h * LD + c;
    const float bias = b2[h];
    float v[4];
    if (vec && tc < L) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + at));
      v[0] = xv.x + o[0] + bias;
      v[1] = xv.y + o[1] + bias;
      v[2] = xv.z + o[2] + bias;
      v[3] = xv.w + o[3] + bias;
      if (skip != nullptr) {
        const float4 sv = __ldg(reinterpret_cast<const float4*>(skip + at));
        v[0] += sv.x;
        v[1] += sv.y;
        v[2] += sv.z;
        v[3] += sv.w;
      }
      *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.0f;
        if (tc + e < L) {
          v[e] = x[at + e] + o[e] + bias;
          if (skip != nullptr) v[e] += skip[at + e];
          out[at + e] = v[e];
        }
      }
    }
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  }

  if (mean_out != nullptr) {
    __syncthreads();
    float s1 = 0.0f, s2 = 0.0f;
    for (int h = part; h < H; h += PARTS) {
      const float v = os[h * LD + p];
      s1 += v;
      s2 += v * v;
    }
    red[tid] = s1;                 // the x statistics' sums were read
    red[NT + tid] = s2;            // before two barriers
    __syncthreads();
    if (tid < P && t0 + tid < L) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int q = 0; q < PARTS; ++q) {
        t1 += red[q * P + tid];
        t2 += red[NT + q * P + tid];
      }
      const float mean = t1 / (float)H;
      mean_out[(size_t)b * L + t0 + tid] = mean;
      var_out[(size_t)b * L + t0 + tid] = t2 / (float)H - mean * mean;
    }
  }
}

// Kernel 2 (f32), on the tensor cores at f32 accuracy.  It replaces
// diffwave_sashimi_tpu/ops/chmix.py:119 _glu_kernel with fast=False: out =
// res + (Wa y + ba) sigmoid(Wg y + bg), [Wa; Wg] = W (2H x H); its product
// (_bmm at HIGHEST precision) in 3xTF32 (mma_tf32.cuh), the rest in f32 in
// the FMA design's order: out = res + (a + ba) / (1 + expf(-(g + bg))).
//
// What bounds it: 4 H^2 B L operations, three tf32 products apiece at the
// dense TF32 rate (0.025 ms at SC09's top tier, B4 H128 L16000), against
// 0.029 ms of bytes (y and res read, out written): bytes, barely; every
// block also reads the split weight (8 bytes an entry, 256 KB at H 128)
// from L2, once per P positions.  Design, kernel 11's with kernel 2f's
// pairing: split_weights_tf32_kernel<2> splits Wa and Wg (H x H each, zero
// rows to whole m-tiles, so H need only be a multiple of 8) once a call
// into a scratch in fragment order, Wa's Ht = ceil(H / 16) m-tiles then
// Wg's; one block of 8 warps per (batch, P positions), built for BLOCKS
// blocks an SM.  The f32 y tile arrives by cp.async, rows padded to LD
// floats (LD % 32 of 8 or 24: a B fragment's 32 loads on distinct banks).
// Each warp takes MV value m-tiles [mt0, mt0 + MV) together with their
// gate m-tiles [Ht + mt0, ...) over all P positions
// (warp_gemm_3xtf32_ring's groups), so a and g of one (o, p) meet in one
// thread's registers: A fragments from L2 AHEAD k-steps ahead in a ring of
// registers, B values split as they load, no weight tile and no barrier in
// the k-loop.  Each value m-tile's 16 gated rows go through the warp's own
// staging tile, so that res is read and out stored 16 bytes a lane,
// coalesced (element by element when L % 4 != 0 or a tensor is not 16-byte
// aligned); the ragged tail past L is masked.  ops/chmix.py::glu_tf32_plan
// picks P and the blocks an SM and computes the block's shared memory
// (the y tile and the 8 staging tiles), which the kernel takes as given.
// Every sum in a fixed order: two calls are bit-equal.
template <int P, int BLOCKS>
struct GluTf32Tile {
  static constexpr int N8 = P / 8;             // n-tiles
  static constexpr int LD = P == 8 ? 8 : P + 8;
  // value m-tiles a warp at once (each with its gate m-tile): 8 MV N8 <=
  // 64 sums a thread; one at two blocks an SM (128 registers a thread)
  static constexpr int MV = BLOCKS > 1 ? 1 : 2;
  // k-steps of A fragments in flight ahead of their use (one: the ring of
  // four m-tiles at one block, or of two in 128 registers)
  static constexpr int AHEAD = 1;
  static constexpr int C4 = P / 4;             // 16-byte chunks a row
  static constexpr int HS = NT / C4;           // row step of a thread
};

// Kernel 2 (f32 y, res and out; Wf = Wa's and Wg's split tiles; f32
// bias).  Dynamic shared memory, sized by ops/chmix.py::glu_tf32_plan: the
// f32 y tile (H rows), then each warp's 16-row staging tile.  vec: L % 4
// == 0 and y, res and out 16-byte aligned.
template <int P, int BLOCKS>
__global__ void __launch_bounds__(NT, BLOCKS)
glu_res_tf32_kernel(const float* __restrict__ y,
                    const float* __restrict__ res,
                    const uint4* __restrict__ Wf,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int L, bool vec) {
  using T = GluTf32Tile<P, BLOCKS>;
  constexpr int LD = T::LD, N8 = T::N8, MV = T::MV, C4 = T::C4;
  extern __shared__ float4 sh4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* ys = reinterpret_cast<float*>(sh4);          // H x LD: y
  float* st = ys + (size_t)H * LD + warp * 16 * LD;   // the warp's 16 rows
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int Ht = (H + 15) / 16, Kt = H / 8;

  // the y tile (0 past L), 16 bytes a thread by cp.async with vec
  {
    const int c = tid % C4 * 4, tc = t0 + c;
    for (int h = tid / C4; h < H; h += T::HS) {
      const size_t at = ((size_t)b * H + h) * L + tc;
      float* yd = ys + h * LD + c;
      if (vec && tc < L) {           // L % 4 == 0: the chunk is all in
        cp_async16(yd, y + at);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[e] = tc + e < L ? y[at + e] : 0.0f;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  for (int u = warp; u * MV < Ht; u += NWARPS) {
    const int mt0 = u * MV;
    // acc[m < MV]: value m-tile mt0 + m; acc[MV + m]: its gate m-tile
    float acc[2 * MV][N8][4];
    dwst_tf32::zero_acc<2 * MV, N8>(acc);
    dwst_tf32::warp_gemm_3xtf32_ring<2 * MV, N8, T::AHEAD, MV>(
        Wf, 2 * Ht, Kt, mt0, 0, Kt, ys, LD, acc, Ht);
#pragma unroll
    for (int mt = 0; mt < MV; ++mt) {
      const int r0 = 16 * (mt0 + mt);
      if (r0 >= H) break;
      // the m-tile's 16 gated rows into the warp's staging tile
      __syncwarp();                  // the last m-tile's rows are read
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = r0 + gq + 8 * hh;
        if (o >= H) continue;
        const float ba = bias[o], bg = bias[H + o];
        float* sr = st + (gq + 8 * hh) * LD + 2 * tq;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const float g0 = acc[MV + mt][j][2 * hh] + bg;
          const float g1 = acc[MV + mt][j][2 * hh + 1] + bg;
          *reinterpret_cast<float2*>(sr + 8 * j) =
              make_float2((acc[mt][j][2 * hh] + ba) / (1.0f + expf(-g0)),
                          (acc[mt][j][2 * hh + 1] + ba) / (1.0f + expf(-g1)));
        }
      }
      __syncwarp();
      // out = res + the gated rows, 16 bytes a lane, a warp's lanes on
      // consecutive positions
      for (int i = lane; i < 16 * C4; i += 32) {
        const int r = i / C4, cc = i % C4 * 4, o = r0 + r, t = t0 + cc;
        if (o >= H) break;
        const float* sv = st + r * LD + cc;
        const size_t at = ((size_t)b * H + o) * L + t;
        if (vec && t < L) {
          const float4 v = *reinterpret_cast<const float4*>(sv);
          const float4 rv = __ldg(reinterpret_cast<const float4*>(res + at));
          *reinterpret_cast<float4*>(out + at) =
              make_float4(rv.x + v.x, rv.y + v.y, rv.z + v.z, rv.w + v.w);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t + e < L) out[at + e] = res[at + e] + sv[e];
        }
      }
    }
  }
}

// Kernel 6 (f32; kernel 6f is glu_res_bwd_tc_kernel above), the GLU
// backward's per-position pass on the tensor cores at f32 accuracy.  It
// replaces diffwave_sashimi_tpu/ops/chmix.py:414 _glu_bwd_kernel with
// fast=False: z = W y + b recomputed, da = g sig, dgate = g a sig (1 -
// sig) (sig = 1 / (1 + expf(-(zg + bg))), the FMA design's f32 algebra),
// dy = W^T dz; its two products (_bmm at HIGHEST precision) in 3xTF32
// (mma_tf32.cuh).  Writes dy and the f32 dz scratch, which the weight
// gradient contracts on the fp32 FMAs (wgrad_kernel).
//
// What bounds it: two products of 4 H^2 B L operations each, three tf32
// products apiece at the dense TF32 rate (0.051 ms at SC09's top tier, B4
// H128 L16000), against 0.066 ms of bytes (y and g read, dy and the f32 dz
// scratch written); every block also reads W's two split halves and the
// split W^T (8 bytes an entry, 1 MB at H 128) from L2, once per P
// positions.  Design, kernel 2's pairing with 6f's tiles:
// split_weights_tf32_kernel<6> splits W's value half Wa, its gate half Wg
// (each zero-padded to whole m-tiles, so H need only be a multiple of 8)
// and W^T (taken from W by strides: no transpose is copied) once a call,
// into a scratch in fragment order; one block of 8 warps per (batch, P
// positions), built for BLOCKS blocks an SM.  The f32 y tile and the g tile
// arrive by cp.async, rows padded to LD floats (LD % 32 of 8 or 24: a B
// fragment's 32 loads on distinct banks); g lands in the first H rows of
// the 2H-row dz tile.  In the first product each warp takes MV value
// m-tiles with their MV gate m-tiles over all P positions
// (warp_gemm_3xtf32_ring's groups), so a and gate meet in one thread's
// registers, where bias, sigmoid, da and dgate are formed: g is read from
// the dz tile at the thread's own positions and overwritten there by da
// (no other thread reads those entries), dgate goes to row H + o, and both
// go out to the dz scratch, four lanes filling a 32-byte sector.  After one
// barrier, the second product: each warp takes MT2 m-tiles of dy over all
// P positions, K = 2H from the dz tile, and stores them from its
// registers, four lanes filling a sector.  ops/chmix.py::glu_bwd_tf32_plan
// picks P and the blocks an SM and computes the block's shared memory (the
// y and dz tiles), which the kernel takes as given.  Every sum in a fixed
// order: two calls are bit-equal.
template <int P, int BLOCKS>
struct GluBwdTf32Tile {
  static constexpr int N8 = P / 8;             // n-tiles
  static constexpr int LD = P == 8 ? 8 : P + 8;
  // value m-tiles a warp at once in z = W y (each with its gate m-tile):
  // 8 MV N8 <= 64 sums a thread; one at two blocks an SM (128 registers)
  static constexpr int MV = BLOCKS > 1 || N8 >= 8 ? 1 : 2;
  // m-tiles of dy a warp at once: 4 MT2 N8 <= 64 sums a thread, at most 4;
  // one at two blocks an SM
  static constexpr int MT2 = BLOCKS > 1 ? 1 : (16 / N8 < 4 ? 16 / N8 : 4);
  // k-steps of A fragments in flight ahead of their use
  static constexpr int AHEAD1 = 1;
  static constexpr int AHEAD2 = MT2 <= 2 ? 2 : 1;
  static constexpr int C4 = P / 4;             // 16-byte chunks a row
  static constexpr int HS = NT / C4;           // row step of a thread
};

// Kernel 6's pass (f32 y, g, dy and the dz scratch; Wf = Wa's and Wg's
// split tiles, Wtf = W^T's; f32 bias).  Dynamic shared memory, sized by
// ops/chmix.py::glu_bwd_tf32_plan: the y tile (H rows), then the dz tile
// (2H rows).  vec: L % 4 == 0 and y, g, dy and dz 16-byte aligned.
template <int P, int BLOCKS>
__global__ void __launch_bounds__(NT, BLOCKS)
glu_res_bwd_tf32_kernel(const float* __restrict__ y,
                        const float* __restrict__ g,
                        const uint4* __restrict__ Wf,
                        const uint4* __restrict__ Wtf,
                        const float* __restrict__ bias,
                        float* __restrict__ dy, float* __restrict__ dz,
                        int H, int L, bool vec) {
  using T = GluBwdTf32Tile<P, BLOCKS>;
  constexpr int LD = T::LD, N8 = T::N8, MV = T::MV, C4 = T::C4;
  extern __shared__ float4 sh4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* ys = reinterpret_cast<float*>(sh4);   // H x LD: y
  float* zs = ys + (size_t)H * LD;             // 2H x LD: g, then dz
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int Ht = (H + 15) / 16, Kt = H / 8;

  // the y and g tiles (0 past L), 16 bytes a thread by cp.async with vec
  {
    const int c = tid % C4 * 4, tc = t0 + c;
    for (int h = tid / C4; h < H; h += T::HS) {
      const size_t at = ((size_t)b * H + h) * L + tc;
      float* yd = ys + h * LD + c;
      float* gd = zs + h * LD + c;
      if (vec && tc < L) {           // L % 4 == 0: the chunk is all in
        cp_async16(yd, y + at);
        cp_async16(gd, g + at);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yd[e] = tc + e < L ? y[at + e] : 0.0f;
          gd[e] = tc + e < L ? g[at + e] : 0.0f;
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // z = W y: value m-tiles [mt0, mt0 + MV) and their gate m-tiles; da over
  // g in the dz tile's row o, dgate into row H + o, both out to dz
  for (int u = warp; u * MV < Ht; u += NWARPS) {
    const int mt0 = u * MV;
    float acc[2 * MV][N8][4];
    dwst_tf32::zero_acc<2 * MV, N8>(acc);
    dwst_tf32::warp_gemm_3xtf32_ring<2 * MV, N8, T::AHEAD1, MV>(
        Wf, 2 * Ht, Kt, mt0, 0, Kt, ys, LD, acc, Ht);
#pragma unroll
    for (int mt = 0; mt < MV; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = 16 * (mt0 + mt) + gq + 8 * hh;
        if (o >= H) continue;
        const float ba = bias[o], bg = bias[H + o];
        float* ar = zs + o * LD + 2 * tq;
        float* hr = zs + (H + o) * LD + 2 * tq;
        float* arow = dz + ((size_t)b * 2 * H + o) * L;
        float* hrow = arow + (size_t)H * L;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int tt = t0 + 8 * j + 2 * tq;
          const float2 gv = *reinterpret_cast<const float2*>(ar + 8 * j);
          const float gs[2] = {gv.x, gv.y};
          float da[2], dg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[mt][j][2 * hh + e] + ba;
            const float sig =
                1.0f / (1.0f + expf(-(acc[MV + mt][j][2 * hh + e] + bg)));
            da[e] = gs[e] * sig;
            dg[e] = gs[e] * a * sig * (1.0f - sig);
          }
          *reinterpret_cast<float2*>(ar + 8 * j) = make_float2(da[0], da[1]);
          *reinterpret_cast<float2*>(hr + 8 * j) = make_float2(dg[0], dg[1]);
          if (vec) {             // L % 4 == 0: both positions in or both out
            if (tt < L) {
              *reinterpret_cast<float2*>(arow + tt) = make_float2(da[0], da[1]);
              *reinterpret_cast<float2*>(hrow + tt) = make_float2(dg[0], dg[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (tt + e < L) {
                arow[tt + e] = da[e];
                hrow[tt + e] = dg[e];
              }
          }
        }
      }
  }
  __syncthreads();

  // dy = W^T dz, H x P, K = 2H, out from the registers
  {
    constexpr int MT = T::MT2;
    for (int u = warp; u * MT < Ht; u += NWARPS) {
      const int mt0 = u * MT;
      float acc[MT][N8][4];
      dwst_tf32::zero_acc<MT, N8>(acc);
      dwst_tf32::warp_gemm_3xtf32_ring<MT, N8, T::AHEAD2>(
          Wtf, Ht, 2 * Kt, mt0, 0, 2 * Kt, zs, LD, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = 16 * (mt0 + mt) + gq + 8 * hh;
          if (h >= H) continue;
          float* row = dy + ((size_t)b * H + h) * L;
#pragma unroll
          for (int j = 0; j < N8; ++j) {
            const int tt = t0 + 8 * j + 2 * tq;
            if (vec) {
              if (tt < L)
                *reinterpret_cast<float2*>(row + tt) =
                    make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (tt + e < L) row[tt + e] = acc[mt][j][2 * hh + e];
            }
          }
        }
    }
  }
}

// Kernel 7f (bf16 x, g and dx; f32 b1, m, s, scratch and (dm, ds)
// partials), the FF backward on the tensor cores.  It replaces
// diffwave_sashimi_tpu/ops/chmix.py:362 _ff_bwd_kernel with fast=True: as
// JAX's _bmm does, both operands of the three per-position products (dh =
// W2^T g, z = W1 xn, dxn = W1^T dz) are rounded to bf16 and their products
// summed in f32; the xn, GELU-output and dz scratch stays unrounded f32 for
// the weight gradients (JAX's _bmmc); GELU and its derivative are
// gelu_fast and gelu_fast_grad; the LN statistics, S1, S2, dx and (dm, ds)
// are f32, with kernel 7's algebra.
//
// What bounds it: 6 F H B L operations at the bf16 tensor-core rate (13 us
// at SC09's top tier) take less time than its bytes (x and g read, dx, and
// the xn, GELU-output and dz scratch written: 64 us), so the bound is
// bytes; but every block also reads three bf16 weight matrices from L2,
// once per P positions, which bounded the products.  Design, after 3f's:
// round_weights_t_kernel<7> rounds W1 and the transposes W1^T and W2^T to
// bf16 once a call into a scratch, in mma fragment order, so that every
// product reads its A fragments from L2 one 16-byte load a lane, 512
// contiguous bytes a warp (mma_bf16.cuh::warp_gemm_frag, one k-step
// ahead, no weight tile, no barrier in the k-loop); one block
// of 8 warps per (batch, P positions), P the widest of 128 / 64 / 32 / 16
// with H P <= 16384 whose tiles fit (ops/chmix.py::ff_bwd_bf16_plan, which
// also computes the block's shared-memory bytes; the kernel takes both as
// given).  The bf16 x and g tiles arrive in shared memory by cp.async,
// each thread's rows all in flight at once, rows padded for
// ldmatrix.trans; the LN statistics are taken in f32 from the landed tile;
// xn is rounded to bf16 in place of x as the B operand and written
// unrounded to the xn scratch.  Each warp takes the same MT1 m-tiles of F
// for dh and z, so both meet in its registers, where dz = gelu_fast'(z +
// b1) dh and the GELU output form (one polynomial for both); both go out
// in f32 and dz, rounded to bf16, into an F-row shared tile.  After one
// barrier each warp takes MT2 = 128 / P m-tiles of H for dxn = W1^T dz,
// staged in f32 over the dz tile once every warp has read it.  Then S1,
// S2, dx (x re-read once, 16 bytes a thread) and the block's (dm, ds),
// summed in a fixed order: a run repeats bit for bit.
template <int P>
struct BwdTcTile {
  static constexpr int MT1 = P >= 128 ? 1 : 64 / P;  // dh and z m-tiles
  static constexpr int MT2 = 128 / P;      // dxn m-tiles: H <= 128 MT2
  static constexpr int N8 = P / 8;         // n-tiles, and 8-position chunks
  static constexpr int LD = P + 8;         // bf16 rows
  static constexpr int LO = P + 8;         // f32 dxn rows
  static constexpr int HS = NT / N8;       // row step of a thread
  static constexpr int RPT = 8;            // rows a thread: H <= RPT HS
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
ln_ff_res_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        const uint4* __restrict__ W1f,
                        const uint4* __restrict__ W1tf,
                        const uint4* __restrict__ W2tf,
                        const float* __restrict__ b1,
                        const float* __restrict__ m_ptr,
                        const float* __restrict__ s_ptr,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ xn, float* __restrict__ hact,
                        float* __restrict__ dz, float* __restrict__ stat_part,
                        int H, int F, int L, bool vec) {
  using T = BwdTcTile<P>;
  using bf = __nv_bfloat16;
  constexpr int N8 = T::N8, LD = T::LD, LO = T::LO, HS = T::HS;
  constexpr int RPT = T::RPT;
  extern __shared__ float4 sh4[];
  float* red = reinterpret_cast<float*>(sh4);     // 2 NWARPS P: warp sums
  float* mean_s = red + 2 * NWARPS * P;           // P
  float* rstd_s = mean_s + P;                     // P (0 past L)
  float* s1_s = rstd_s + P;                       // P
  float* s2_s = s1_s + P;                         // P
  bf* xs = reinterpret_cast<bf*>(s2_s + P);       // H x LD: x, then bf16(xn)
  bf* gs = xs + H * LD;                           // H x LD: g
  bf* zs = gs + H * LD;                           // F x LD: bf16(dz)
  float* os = reinterpret_cast<float*>(zs);       // H x LO: dxn
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // this thread's chunk of 8 positions, and its rows h0 + i HS, i < RPT
  const int c = tid % N8 * 8, t = t0 + c, h0 = tid / N8;
  const bool full = vec && t + 8 <= L;   // 16-byte loads and stores
  float* red1 = red + warp * P;
  float* red2 = red + (NWARPS + warp) * P;
  const float m = *m_ptr, s = *s_ptr;

  // the x and g tiles (0 past L): with vec all of this thread's rows in
  // flight at once by cp.async; then x's per-position channel sums
  if (vec) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      const size_t at = ((size_t)b * H + h) * L + t;
      if (full) {
        cp_async16(xs + h * LD + c, x + at);
        cp_async16(gs + h * LD + c, g + at);
      } else {
        *reinterpret_cast<uint4*>(xs + h * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(gs + h * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();              // this thread's own chunks have landed
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      const size_t at = ((size_t)b * H + h) * L + t;
      float v[8], w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = t + j < L ? __bfloat162float(x[at + j]) : 0.0f;
        w[j] = t + j < L ? __bfloat162float(g[at + j]) : 0.0f;
      }
      *reinterpret_cast<uint4*>(xs + h * LD + c) = pack8(v);
      *reinterpret_cast<uint4*>(gs + h * LD + c) = pack8(w);
    }
  }
  {
    float s1[8] = {}, s2[8] = {};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xs + h * LD + c), v);
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

  // xn = (s rstd) (x - mean + m): rounded to bf16 in place of x, written
  // unrounded to the xn scratch
  float mu[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mu[j] = mean_s[c + j];
  {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = s * rstd_s[c + j];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      uint4* e = reinterpret_cast<uint4*>(xs + h * LD + c);
      float v[8];
      unpack8(*e, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = a[j] * (v[j] - mu[j] + m);
      *e = pack8(v);
      float* dst = xn + ((size_t)b * H + h) * L + t;
      if (full) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t + j < L) dst[j] = v[j];
      }
    }
  }
  __syncthreads();

  // dh = W2^T g and z = W1 xn on the same m-tiles of F; dz = gelu_fast'(z
  // + b1) dh and hact = gelu_fast(z + b1) out in f32, bf16(dz) into zs
  for (int u = warp; u * 16 * T::MT1 < F; u += NWARPS) {
    constexpr int MT = T::MT1;
    const int r0 = u * 16 * MT;
    float dh[MT][N8][4], zz[MT][N8][4];
    dwst_mma::warp_gemm_frag<MT, N8>(W2tf, F / 16, H / 16, r0 / 16, gs, LD,
                                     dh);
    dwst_mma::warp_gemm_frag<MT, N8>(W1f, F / 16, H / 16, r0 / 16, xs, LD,
                                     zz);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f = r0 + 16 * mt + gq + 8 * hh;
        if (f >= F) continue;
        const float bias = b1[f];
        const size_t row = ((size_t)b * F + f) * L;
        uint32_t* zr = reinterpret_cast<uint32_t*>(zs + f * LD + 2 * tq);
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int tt = t0 + 8 * j + 2 * tq;
          float d[2], ha[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float grad;
            ha[e] = gelu_fast_and_grad(zz[mt][j][2 * hh + e] + bias, &grad);
            d[e] = grad * dh[mt][j][2 * hh + e];
          }
          zr[4 * j] = dwst_mma::pack_bf16x2(d[0], d[1]);
          if (vec) {             // L even: both positions in or both out
            if (tt < L) {
              *reinterpret_cast<float2*>(hact + row + tt) =
                  make_float2(ha[0], ha[1]);
              *reinterpret_cast<float2*>(dz + row + tt) =
                  make_float2(d[0], d[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (tt + e < L) {
                hact[row + tt + e] = ha[e];
                dz[row + tt + e] = d[e];
              }
          }
        }
      }
  }
  __syncthreads();

  // dxn = W1^T dz, H x P, into the f32 tile over zs once every warp has
  // read it
  {
    constexpr int MT = T::MT2;
    const int r0 = warp * 16 * MT;
    float acc[MT][N8][4];
    if (r0 < H)
      dwst_mma::warp_gemm_frag<MT, N8>(W1tf, H / 16, F / 16, r0 / 16, zs, LD,
                                       acc);
    __syncthreads();
    if (r0 < H) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = r0 + 16 * mt + gq + 8 * hh;
          if (h >= H) continue;
          float* orow = os + h * LO + 2 * tq;
#pragma unroll
          for (int j = 0; j < N8; ++j)
            *reinterpret_cast<float2*>(orow + 8 * j) =
                make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
        }
    }
  }
  __syncthreads();

  // S1 = mean_h dxn, S2 = mean_h dxn (xc + m) per position; this thread's
  // x rows re-read, all in flight at once, and kept
  uint4 xr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int h = h0 + i * HS;
    if (h >= H) break;
    const size_t at = ((size_t)b * H + h) * L + t;
    if (full) {
      xr[i] = __ldg(reinterpret_cast<const uint4*>(x + at));
    } else {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = t + j < L ? __bfloat162float(x[at + j]) : 0.0f;
      xr[i] = pack8(v);
    }
  }
  {
    float s1[8] = {}, s2[8] = {};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      float v[8];
      unpack8(xr[i], v);
      const float4 o0 = *reinterpret_cast<const float4*>(os + h * LO + c);
      const float4 o1 = *reinterpret_cast<const float4*>(os + h * LO + c + 4);
      const float d[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += d[j];
        s2[j] += d[j] * (v[j] - mu[j] + m);
      }
    }
    chunk_sums<P>(s1, red1, c);
    chunk_sums<P>(s2, red2, c);
  }
  __syncthreads();
  if (tid < P) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int w = 0; w < NWARPS; ++w) {
      t1 += red[w * P + tid];
      t2 += red[(NWARPS + w) * P + tid];
    }
    s1_s[tid] = t1 / (float)H;
    s2_s[tid] = t2 / (float)H;
  }
  __syncthreads();

  // dx = g + r (dxn - S1) - r rstd^2 xc S2, r = s rstd, stored bf16; this
  // thread's share of dm = sum dxn r and ds = sum dxn rstd (xc + m)
  float dm = 0.0f, ds = 0.0f;
  {
    float rs[8], r[8], q1[8], q2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rs[j] = rstd_s[c + j];
      r[j] = s * rs[j];
      q1[j] = s1_s[c + j];
      q2[j] = s2_s[c + j];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + i * HS;
      if (h >= H) break;
      const size_t at = ((size_t)b * H + h) * L + t;
      float v[8], w[8], out[8];
      unpack8(xr[i], v);
      unpack8(*reinterpret_cast<const uint4*>(gs + h * LD + c), w);
      const float4 o0 = *reinterpret_cast<const float4*>(os + h * LO + c);
      const float4 o1 = *reinterpret_cast<const float4*>(os + h * LO + c + 4);
      const float d[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xc = v[j] - mu[j];
        out[j] = w[j] + r[j] * (d[j] - q1[j])
                 - r[j] * rs[j] * rs[j] * xc * q2[j];
        if (t + j < L) {
          dm += d[j] * r[j];
          ds += d[j] * rs[j] * (xc + m);
        }
      }
      if (full) {
        *reinterpret_cast<uint4*>(dx + at) = pack8(out);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t + j < L) dx[at + j] = __float2bfloat16_rn(out[j]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {      // fixed-order butterfly
    dm += __shfl_xor_sync(0xffffffffu, dm, o);
    ds += __shfl_xor_sync(0xffffffffu, ds, o);
  }
  if (lane == 0) {
    red[warp] = dm;
    red[NWARPS + warp] = ds;
  }
  __syncthreads();
  if (tid == 0) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int w = 0; w < NWARPS; ++w) {
      a1 += red[w];
      a2 += red[NWARPS + w];
    }
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    stat_part[2 * blk] = a1;
    stat_part[2 * blk + 1] = a2;
  }
}

// wb = [bf16(W1) (F x H), bf16(W1)^T (H x F), bf16(W2)^T (F x H)] from W1
// (F x H) and W2 (H x F), each in fragment order (mma_bf16.cuh::
// load_a_frag), once a call: K = 7, kernel 7f's weights; K = 6, kernel
// 6f's, the first two alone (W1 = W, F = 2H; W2 unread), so that a trace
// tells the two instances apart.  Each warp writes one m16k16 tile: its 16
// x 16 source tile (the transposed one for W1^T and W2^T) through shared
// memory, 32 bytes a lane in, 16 bytes a lane out.
template <int K>
__global__ void round_weights_t_kernel(const float* __restrict__ W1,
                                       const float* __restrict__ W2,
                                       uint4* __restrict__ wb, int F, int H) {
  constexpr int JOBS = K == 7 ? 3 : 2;
  __shared__ float tile[NWARPS][16][17];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = F / 16 * (H / 16);          // tiles a matrix
  const int id = blockIdx.x * NWARPS + warp;
  if (id >= JOBS * n) return;
  const int job = id / n, tix = id % n;
  const int Kt = (job == 1 ? F : H) / 16, mt = tix / Kt, kt = tix % Kt;
  // the source rows r0.. and columns c0.. (row stride ld) of A's tile
  const float* src = job == 2 ? W2 : W1;
  const int ld = job == 2 ? F : H;
  const int r0 = 16 * (job == 0 ? mt : kt), c0 = 16 * (job == 0 ? kt : mt);
  const int rr = lane >> 1, cc = (lane & 1) * 8;
  const float* p = src + (size_t)(r0 + rr) * ld + c0 + cc;
  const float4 v0 = *reinterpret_cast<const float4*>(p);
  const float4 v1 = *reinterpret_cast<const float4*>(p + 4);
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) tile[warp][rr][cc + e] = v[e];
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i & 1), k = 2 * t + 8 * (i >> 1);
    a[i] = job == 0 ? dwst_mma::pack_bf16x2(tile[warp][r][k],
                                            tile[warp][r][k + 1])
                    : dwst_mma::pack_bf16x2(tile[warp][k][r],
                                            tile[warp][k + 1][r]);
  }
  wb[((size_t)job * n + tix) * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
}

template <int K>
int round_weights_t(const float* W1, const float* W2, __nv_bfloat16* wb,
                    int F, int H, cudaStream_t stream) {
  const int tiles = (K == 7 ? 3 : 2) * (F / 16) * (H / 16);
  round_weights_t_kernel<K>
      <<<(tiles + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
          W1, W2, reinterpret_cast<uint4*>(wb), F, H);
  return (int)cudaGetLastError();
}

// The weight-gradient GEMM's tiles: a GM x GM output tile a block (8 x 8
// sums a thread), GK positions a stage, WGRAD_STAGES stages in a ring
// (cp.async keeps all but one in flight); staged rows of T keep
// their positions contiguous, padded to LD elements (a row's 16-byte reads
// of 4 positions fall on distinct banks for 8 rows 1 apart), and arrive as
// 16-byte chunks of CH positions.
constexpr int GM = 128;
constexpr int GK = 32;
constexpr int WGRAD_STAGES = 2;

template <typename T>
struct Staged {
  static constexpr int LD = sizeof(T) == 4 ? GK + 4 : GK + 8;
  static constexpr int CH = 16 / sizeof(T);
  static constexpr int CPR = GK / CH;                // chunks a row
  static constexpr int BYTES = GM * LD * sizeof(T);  // one stage
};

template <typename TX, typename TY>
constexpr int wgrad_smem() {
  return WGRAD_STAGES * (Staged<TX>::BYTES + Staged<TY>::BYTES);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One stage of a GM-row tile: dst (GM x LD) from src (row 0 of the tile,
// row stride L), positions [k0, k0 + GK); rows past nrows and positions
// past kend are 0.  With vec (16-byte aligned rows and chunks) each full
// chunk is copied by cp.async, else element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int nrows, int L, int k0,
                                           int kend, bool vec) {
  using S = Staged<T>;
#pragma unroll
  for (int q = 0; q < GM * S::CPR / NT; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int r = idx / S::CPR, k = idx % S::CPR * S::CH;
    T* d = dst + r * S::LD + k;
    const T* p = src + (size_t)r * L + k0 + k;
    if (vec && r < nrows && k0 + k + S::CH <= kend) {
      cp_async16(d, p);
    } else {
#pragma unroll
      for (int e = 0; e < S::CH; ++e)
        d[e] = r < nrows && k0 + k + e < kend ? p[e] : from_f<T>(0.0f);
    }
  }
}

// part[s] = (X Y^T over split s, then the row sums of X over split s):
// X (B, M, L), Y (B, N, L), each f32 or bf16 (summed in f32); split s = b
// nsb + j covers positions [j tc, min(L, (j + 1) tc)) of batch row b.
// Thread (tm, tn) holds rows m0 + tm + 16 i and columns n0 + tn + 16 j; a
// warp spans 4 tm and 8 tn.  Row sums come from the blocks of the first
// column tile, each thread summing half a row's stage.
template <typename TX, typename TY>
__global__ void __launch_bounds__(NT, 1)
wgrad_kernel(const TX* __restrict__ X, const TY* __restrict__ Y,
             float* __restrict__ part, int M, int N, int L, int tc, int nsb,
             bool vec) {
  using SX = Staged<TX>;
  using SY = Staged<TY>;
  constexpr int NS = WGRAD_STAGES;
  extern __shared__ float4 sh4[];
  char* base = reinterpret_cast<char*>(sh4);
  TX* xs = reinterpret_cast<TX*>(base);                    // NS stages
  TY* ys = reinterpret_cast<TY*>(base + NS * SX::BYTES);   // NS stages
  const int n0 = blockIdx.x * GM, m0 = blockIdx.y * GM, sp = blockIdx.z;
  const int b = sp / nsb, ta = (sp % nsb) * tc;
  const int tb = min(L, ta + tc);
  const TX* Xb = X + ((size_t)b * M + m0) * L;
  const TY* Yb = Y + ((size_t)b * N + n0) * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = (warp >> 1) * 4 + (lane >> 3);
  const int tn = (warp & 1) * 8 + (lane & 7);
  const bool rows = blockIdx.x == 0;
  const int nst = (tb - ta + GK - 1) / GK;
  float acc[8][8] = {};
  float rs = 0.0f;
  auto load = [&](int st) {   // a group each call, empty past the split
    if (st < nst) {
      const int k0 = ta + st * GK;
      stage_tile(xs + st % NS * GM * SX::LD, Xb, M - m0, L, k0, tb, vec);
      stage_tile(ys + st % NS * GM * SY::LD, Yb, N - n0, L, k0, tb, vec);
    }
    cp_async_commit();
  };
  for (int st = 0; st < NS - 1; ++st) load(st);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();      // stage st landed; stage st - 1's buffer is free
    load(st + NS - 1);
    const TX* xa = xs + st % NS * GM * SX::LD;
    const TY* yb = ys + st % NS * GM * SY::LD;
#pragma unroll
    for (int k = 0; k < GK; k += 4) {
      float4 a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = load4(xa + (tm + 16 * i) * SX::LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = load4(yb + (tn + 16 * j) * SY::LD + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = fmaf(a[i].x, bv[j].x, acc[i][j]);
          v = fmaf(a[i].y, bv[j].y, v);
          v = fmaf(a[i].z, bv[j].z, v);
          acc[i][j] = fmaf(a[i].w, bv[j].w, v);
        }
    }
    if (rows) {   // row tid / 2, positions (tid % 2) GK / 2 + [0, GK / 2)
      const TX* xr = xa + (tid >> 1) * SX::LD + (tid & 1) * (GK / 2);
#pragma unroll
      for (int k = 0; k < GK / 2; k += 4) {
        const float4 v = load4(xr + k);
        rs += v.x;
        rs += v.y;
        rs += v.z;
        rs += v.w;
      }
    }
  }
  float* out = part + (size_t)sp * ((size_t)M * N + M);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + tm + 16 * i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + tn + 16 * j;
      if (nn < N) out[(size_t)mm * N + nn] = acc[i][j];
    }
  }
  if (rows) {
    const float other = __shfl_xor_sync(0xffffffffu, rs, 1);
    const int mm = m0 + (tid >> 1);
    if (!(tid & 1) && mm < M) out[(size_t)M * N + mm] = rs + other;
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

// The same sum for few outputs over many partials (a pass's (dm, ds) of
// each block): one block an output, each thread summing every NT-th
// partial in order, then a fixed-order tree.
__global__ void reduce_long_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int S, int size) {
  __shared__ float red[NT];
  const int i = blockIdx.x, tid = threadIdx.x;
  float acc = 0.0f;
  for (int s = tid; s < S; s += NT) acc += part[(size_t)s * size + i];
  red[tid] = acc;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[i] = red[0];
}

// The weight and bias gradient sum over all B * L positions of
// X Y^T (M x N) and of X's rows: partials of tc positions (a multiple of
// 8, from ops/chmix.py::wgrad_plan), then their fixed-order sum.
template <typename TX, typename TY>
int weight_grad(const TX* X, const TY* Y, float* part, float* grads, int B,
                int M, int N, int L, int tc, cudaStream_t stream) {
  constexpr int smem = wgrad_smem<TX, TY>();
  const int nsb = (L + tc - 1) / tc;
  const bool vec = (L * sizeof(TX)) % 16 == 0 && (L * sizeof(TY)) % 16 == 0 &&
                   tc % 8 == 0 && aligned16(X) && aligned16(Y);
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<TX, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + GM - 1) / GM, (M + GM - 1) / GM, B * nsb);
  wgrad_kernel<TX, TY><<<grid, NT, smem, stream>>>(X, Y, part, M, N, L, tc,
                                                   nsb, vec);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_splits(part, grads, B * nsb, M * N + M, stream);
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

// Kernel 6's pass on smem bytes of dynamic shared memory a block: Wa, Wg
// and W^T split into the scratch wf (ops/chmix.py::
// glu_bwd_tf32_split_floats floats), then the 3xTF32 pass, built for
// BLOCKS blocks an SM.
template <int P, int BLOCKS>
int launch_glu_bwd_tf32(const float* y, const float* g, const float* W,
                        const float* b, float* dy, float* dz, uint4* wf,
                        int B, int H, int L, int smem, cudaStream_t stream) {
  // Wa (H x H), then Wg (H x H), each zero-padded to whole m-tiles, then
  // W^T (H x 2H), entry (r, k) = W[k][r]
  dwst_tf32::SplitJobs jobs{{{W, nullptr, H, H, H, H, 1},
                             {W + (size_t)H * H, nullptr, H, H, H, H, 1},
                             {W, nullptr, H, H, 2 * H, 1, H}},
                            3};
  int e = dwst_tf32::split_weights_launch<6>(jobs, wf, stream);
  if (e) return e;
  auto kernel = glu_res_bwd_tf32_kernel<P, BLOCKS>;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  const bool vec = L % 4 == 0 && aligned16(y) && aligned16(g) &&
                   aligned16(dy) && aligned16(dz);
  const int n = dwst_tf32::split_tiles(jobs.job[0]) +
                dwst_tf32::split_tiles(jobs.job[1]);
  kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      y, g, wf, wf + (size_t)64 * n, b, dy, dz, H, L, vec);
  return (int)cudaGetLastError();
}

// Kernel 6f's pass on smem bytes of dynamic shared memory a block: W and
// W^T rounded to bf16 into the scratch wb (4 H H entries, fragment order),
// then the tensor-core pass.
template <int P>
int launch_glu_bwd_tc(const __nv_bfloat16* y, const __nv_bfloat16* g,
                      const float* W, const float* b, __nv_bfloat16* dy,
                      float* dz, __nv_bfloat16* wb, int B, int H, int L,
                      int smem, cudaStream_t stream) {
  int e = round_weights_t<6>(W, nullptr, wb, 2 * H, H, stream);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(glu_res_bwd_tc_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  const bool vec = L % 8 == 0 && aligned16(y) && aligned16(g) &&
                   aligned16(dy) && aligned16(dz);
  const uint4* wf = reinterpret_cast<const uint4*>(wb);
  const size_t n = (size_t)2 * H * H / 8;    // uint4s a matrix
  glu_res_bwd_tc_kernel<P><<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      y, g, wf, wf + n, b, dy, dz, H, L, vec);
  return (int)cudaGetLastError();
}

// Kernel 7 or 7f after its per-position pass: the (dm, ds) sum of the pass's
// nblocks partials, then dW1, db1 from dz and xn, dW2, db2 from g and the
// GELU output.
template <typename IO>
int ff_bwd_sums(const IO* g, const float* xn, const float* hact,
                const float* dz, const float* stat_part, float* dms,
                float* part1, float* grads1, float* part2, float* grads2,
                int nblocks, int B, int H, int F, int L, int tc,
                cudaStream_t stream) {
  reduce_long_kernel<<<2, NT, 0, stream>>>(stat_part, dms, nblocks, 2);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if ((e = weight_grad(dz, xn, part1, grads1, B, F, H, L, tc, stream)))
    return e;
  return weight_grad(g, hact, part2, grads2, B, H, F, L, tc, stream);
}

// Kernel 7 on smem bytes of dynamic shared memory a block: W1, W1^T and
// W2^T split into the scratch wf (ops/chmix.py::ff_bwd_split_floats
// floats), then the 3xTF32 pass.
template <int P>
int launch_ff_bwd_tf32(const float* x, const float* g, const float* W1,
                       const float* b1, const float* W2, const float* m,
                       const float* s, float* dx, float* xn, float* hact,
                       float* dz, float* stat_part, uint4* wf, int B, int H,
                       int F, int L, int smem, cudaStream_t stream) {
  // W1 (F x H), W1^T (H x F), W2^T (F x H)
  dwst_tf32::SplitJobs jobs{{{W1, nullptr, F, F, H, H, 1},
                             {W1, nullptr, H, H, F, 1, H},
                             {W2, nullptr, F, F, H, 1, F}},
                            3};
  const int n0 = dwst_tf32::split_tiles(jobs.job[0]);
  const int n1 = dwst_tf32::split_tiles(jobs.job[1]);
  int e = dwst_tf32::split_weights_launch<7>(jobs, wf, stream);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(ln_ff_res_bwd_tf32_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  const bool vec = L % 4 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dx) && aligned16(xn) && aligned16(hact) &&
                   aligned16(dz);
  ln_ff_res_bwd_tf32_kernel<P>
      <<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
          x, g, wf, wf + (size_t)64 * n0, wf + (size_t)64 * (n0 + n1), b1, m,
          s, dx, xn, hact, dz, stat_part, H, F, L, vec);
  return (int)cudaGetLastError();
}

// Kernel 2 on smem bytes of dynamic shared memory a block: Wa and Wg split
// into the scratch wf (ops/chmix.py::glu_tf32_split_floats floats), then
// the 3xTF32 kernel, built for BLOCKS blocks an SM.
template <int P, int BLOCKS>
int launch_glu_tf32(const float* y, const float* res, const float* W,
                    const float* b, float* out, uint4* wf, int B, int H,
                    int L, int smem, cudaStream_t stream) {
  // Wa (H x H), then Wg (H x H), each zero-padded to whole m-tiles
  dwst_tf32::SplitJobs jobs{{{W, nullptr, H, H, H, H, 1},
                             {W + (size_t)H * H, nullptr, H, H, H, H, 1}},
                            2};
  int e = dwst_tf32::split_weights_launch<2>(jobs, wf, stream);
  if (e) return e;
  auto kernel = glu_res_tf32_kernel<P, BLOCKS>;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  const bool vec = L % 4 == 0 && aligned16(y) && aligned16(res) &&
                   aligned16(out);
  kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(y, res, wf, b, out,
                                                         H, L, vec);
  return (int)cudaGetLastError();
}

// Kernel 3 on smem bytes of dynamic shared memory a block: W1 and W2 split
// into the scratch wf (ops/chmix.py::ff_tf32_split_floats floats), then
// the 3xTF32 kernel, FC hidden rows a chunk, built for BLOCKS blocks an SM.
template <int P, int BLOCKS>
int launch_ff_tf32(const float* x, const float* skip, const float* W1,
                   const float* b1, const float* W2, const float* b2,
                   const float* m, const float* s, float* out, float* mean,
                   float* var, uint4* wf, int B, int H, int F, int L, int FC,
                   int smem, cudaStream_t stream) {
  // W1 (F x H), W2 (H x F)
  dwst_tf32::SplitJobs jobs{{{W1, nullptr, F, F, H, H, 1},
                             {W2, nullptr, H, H, F, F, 1}},
                            2};
  int e = dwst_tf32::split_weights_launch<3>(jobs, wf, stream);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(ln_ff_res_tf32_kernel<P, BLOCKS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  const bool vec = L % 4 == 0 && aligned16(x) && aligned16(skip) &&
                   aligned16(out);
  ln_ff_res_tf32_kernel<P, BLOCKS>
      <<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      x, skip, wf, b1, wf + (size_t)64 * dwst_tf32::split_tiles(jobs.job[0]),
      b2, m, s, out, mean, var, H, F, L, FC, vec);
  return (int)cudaGetLastError();
}

// Kernel 7f on smem bytes of dynamic shared memory a block: the weights
// rounded (and transposed) into the scratch wb (3 F H bf16 entries), then
// the tensor-core pass; H <= 16384 / P.
template <int P>
int launch_ff_bwd_tc(const __nv_bfloat16* x, const __nv_bfloat16* g,
                     const float* W1, const float* b1, const float* W2,
                     const float* m, const float* s, __nv_bfloat16* dx,
                     float* xn, float* hact, float* dz, float* stat_part,
                     __nv_bfloat16* wb, int B, int H, int F, int L, int smem,
                     cudaStream_t stream) {
  int e = round_weights_t<7>(W1, W2, wb, F, H, stream);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(ln_ff_res_bwd_tc_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  const bool vec = L % 8 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dx) && aligned16(xn) && aligned16(hact) &&
                   aligned16(dz);
  const uint4* wf = reinterpret_cast<const uint4*>(wb);
  const size_t n = (size_t)F * H / 8;        // uint4s a matrix
  ln_ff_res_bwd_tc_kernel<P>
      <<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
          x, g, wf, wf + n, wf + 2 * n, b1, m, s, dx, xn, hact, dz,
          stat_part, H, F, L, vec);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

// Every entry below takes P (positions a block) and smem (bytes of shared
// memory a block) from the kernel's plan in ops/chmix.py.

// Kernel 2: y, res and out f32; wf a scratch for the split weights
// (ops/chmix.py::glu_tf32_split_floats floats); P, blocks an SM (P 32, 16
// or 8 at one; 64 or 32 at two) and smem from ops/chmix.py::
// glu_tf32_plan; H a multiple of 8.
extern "C" int dwst_glu_res(const float* y, const float* res, const float* W,
                            const float* b, float* out, void* wf, int B,
                            int H, int L, int P, int blocks, int smem,
                            cudaStream_t stream) {
  if (H <= 0 || H % 8 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  auto* w = static_cast<uint4*>(wf);
  auto run = [&](auto launch) {
    return launch(y, res, W, b, out, w, B, H, L, smem, stream);
  };
  if (blocks == 2) {
    if (P == 64) return run(launch_glu_tf32<64, 2>);
    if (P == 32) return run(launch_glu_tf32<32, 2>);
    return (int)cudaErrorInvalidValue;
  }
  if (blocks != 1) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 32: return run(launch_glu_tf32<32, 1>);
    case 16: return run(launch_glu_tf32<16, 1>);
    case 8: return run(launch_glu_tf32<8, 1>);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Kernel 3: x, skip, out, mean and var f32; wf a scratch for the split
// weights (ops/chmix.py::ff_tf32_split_floats floats); P 128, 64, 32, 16 or
// 8 at one block an SM, or 64 at two (blocks); FC hidden rows a chunk (F,
// or a multiple of 16 below F); H and F multiples of 8.
extern "C" int dwst_ln_ff_res(const float* x, const float* skip,
                              const float* W1, const float* b1,
                              const float* W2, const float* b2,
                              const float* m, const float* s, float* out,
                              float* mean, float* var, void* wf, int B, int H,
                              int F, int L, int P, int FC, int blocks,
                              int smem, cudaStream_t stream) {
  if (H <= 0 || F <= 0 || H % 8 || F % 8 || FC <= 0 || (FC < F && FC % 16))
    return (int)cudaErrorInvalidValue;
  auto* w = static_cast<uint4*>(wf);
  auto run = [&](auto launch) {
    return launch(x, skip, W1, b1, W2, b2, m, s, out, mean, var, w, B, H, F,
                  L, FC, smem, stream);
  };
  if (blocks == 2)
    return P == 64 ? run(launch_ff_tf32<64, 2>) : (int)cudaErrorInvalidValue;
  if (blocks != 1) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 128: return run(launch_ff_tf32<128, 1>);
    case 64: return run(launch_ff_tf32<64, 1>);
    case 32: return run(launch_ff_tf32<32, 1>);
    case 16: return run(launch_ff_tf32<16, 1>);
    case 8: return run(launch_ff_tf32<8, 1>);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Kernel 6: y, g, dy, dz, part and grads f32; wf a scratch for the split
// weights (ops/chmix.py::glu_bwd_tf32_split_floats floats); P, blocks an SM
// (P 64 at two; 64, 32, 16 or 8 at one) and smem from ops/chmix.py::
// glu_bwd_tf32_plan; H a multiple of 8.  The 3xTF32 pass, then dW and db
// from dz and y.
extern "C" int dwst_glu_res_bwd(const float* y, const float* g, const float* W,
                                const float* b, float* dy, float* dz,
                                float* part, float* grads, void* wf, int B,
                                int H, int L, int tc, int P, int blocks,
                                int smem, cudaStream_t stream) {
  if (H <= 0 || H % 8 || B <= 0 || L <= 0 || tc <= 0 || tc % 8)
    return (int)cudaErrorInvalidValue;
  auto* w = static_cast<uint4*>(wf);
  auto run = [&](auto launch) {
    return launch(y, g, W, b, dy, dz, w, B, H, L, smem, stream);
  };
  int e;
  if (blocks == 2 && P == 64) {
    e = run(launch_glu_bwd_tf32<64, 2>);
  } else if (blocks == 1) {
    switch (P) {
      case 64: e = run(launch_glu_bwd_tf32<64, 1>); break;
      case 32: e = run(launch_glu_bwd_tf32<32, 1>); break;
      case 16: e = run(launch_glu_bwd_tf32<16, 1>); break;
      case 8: e = run(launch_glu_bwd_tf32<8, 1>); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return weight_grad(dz, y, part, grads, B, 2 * H, H, L, tc, stream);
}

// Kernel 6f: y, g and dy bf16; dz, part and grads f32; wb a scratch for W
// and W^T rounded to bf16 (4 H H entries); P 128, 64, 32 or 16; H a
// multiple of 16 up to 1024.  The pass, then dW and db from dz and y.
extern "C" int dwst_glu_res_bwd_bf16(const void* y, const void* g,
                                     const float* W, const float* b,
                                     void* dy, float* dz, float* part,
                                     float* grads, void* wb, int B, int H,
                                     int L, int tc, int P, int smem,
                                     cudaStream_t stream) {
  if (H <= 0 || H % 16 || H > 1024 || tc <= 0 || tc % 8)
    return (int)cudaErrorInvalidValue;
  const auto* yb = static_cast<const bf16*>(y);
  const auto* gb = static_cast<const bf16*>(g);
  auto* db = static_cast<bf16*>(dy);
  auto* w = static_cast<bf16*>(wb);
  auto run = [&](auto launch) {
    return launch(yb, gb, W, b, db, dz, w, B, H, L, smem, stream);
  };
  int e;
  switch (P) {
    case 128: e = run(launch_glu_bwd_tc<128>); break;
    case 64: e = run(launch_glu_bwd_tc<64>); break;
    case 32: e = run(launch_glu_bwd_tc<32>); break;
    case 16: e = run(launch_glu_bwd_tc<16>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return weight_grad(dz, yb, part, grads, B, 2 * H, H, L, tc, stream);
}

// Kernel 7: x, g, dx, the scratch and the gradients f32; wf a scratch for
// the split weights (ops/chmix.py::ff_bwd_split_floats floats); P 64, 32,
// 16 or 8; H and F multiples of 8.  The 3xTF32 pass, then the (dm, ds)
// sum and the two contractions.
extern "C" int dwst_ln_ff_res_bwd(
    const float* x, const float* g, const float* W1, const float* b1,
    const float* W2, const float* m, const float* s, float* dx, float* xn,
    float* hact, float* dz, float* stat_part, float* dms, float* part1,
    float* grads1, float* part2, float* grads2, void* wf, int B, int H,
    int F, int L, int tc, int P, int smem, cudaStream_t stream) {
  if (H <= 0 || F <= 0 || H % 8 || F % 8 || tc <= 0 || tc % 8)
    return (int)cudaErrorInvalidValue;
  auto* w = static_cast<uint4*>(wf);
  auto run = [&](auto launch) {
    return launch(x, g, W1, b1, W2, m, s, dx, xn, hact, dz, stat_part, w, B,
                  H, F, L, smem, stream);
  };
  int e;
  switch (P) {
    case 64: e = run(launch_ff_bwd_tf32<64>); break;
    case 32: e = run(launch_ff_bwd_tf32<32>); break;
    case 16: e = run(launch_ff_bwd_tf32<16>); break;
    case 8: e = run(launch_ff_bwd_tf32<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return ff_bwd_sums(g, xn, hact, dz, stat_part, dms, part1, grads1, part2,
                     grads2, (L + P - 1) / P * B, B, H, F, L, tc, stream);
}

// Kernel 7f: x, g and dx bf16; the scratch and the gradients f32; wb a
// scratch for the weights rounded to bf16 (3 F H entries); P 128, 64, 32
// or 16 with H P <= 16384; H and F multiples of 16, H <= 1024.
extern "C" int dwst_ln_ff_res_bwd_bf16(
    const void* x, const void* g, const float* W1, const float* b1,
    const float* W2, const float* m, const float* s, void* dx, float* xn,
    float* hact, float* dz, float* stat_part, float* dms, float* part1,
    float* grads1, float* part2, float* grads2, void* wb, int B, int H,
    int F, int L, int tc, int P, int smem, cudaStream_t stream) {
  if (H <= 0 || F <= 0 || H % 16 || F % 16 || H * P > 16384 || tc <= 0 ||
      tc % 8)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  auto* db = static_cast<bf16*>(dx);
  auto* w = static_cast<bf16*>(wb);
  auto run = [&](auto launch) {
    return launch(xb, gb, W1, b1, W2, m, s, db, xn, hact, dz, stat_part, w,
                  B, H, F, L, smem, stream);
  };
  int e;
  switch (P) {
    case 128: e = run(launch_ff_bwd_tc<128>); break;
    case 64: e = run(launch_ff_bwd_tc<64>); break;
    case 32: e = run(launch_ff_bwd_tc<32>); break;
    case 16: e = run(launch_ff_bwd_tc<16>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return ff_bwd_sums(gb, xn, hact, dz, stat_part, dms, part1, grads1, part2,
                     grads2, (L + P - 1) / P * B, B, H, F, L, tc, stream);
}
