// The WaveNet block's tail: gate + res/skip 1x1 convs in one pass (kernel 11).
//
// Replaces diffwave_sashimi_tpu/ops/wavenet_gate.py:58 (_kernel, through
// gate_res_skip).  For h (B, 2C, L) from the dilated conv and the block
// input x (B, C, L):
//   out  = tanh(h[:, :C]) * sigmoid(h[:, C:])
//   res  = (x + W_r out + b_r) * sqrt(1/2)      W_r (C, C), res (B, C, L)
//   skip = W_s out + b_s                         W_s (S, C), skip (B, S, L)
//
// What bounds it on the H100: a position-wise GEMM of the stacked weight
// [W_r; W_s] ((C + S) x C) over the gated activation, 2 C (C + S) fp32 flops
// per position, against (2C + C + C + S) x 4 bytes of activations: 128
// flops per byte at C = S = 256, far past the fp32 CUDA-core balance
// (67 TFLOP/s : 3.35 TB/s = 20), so it is compute bound and the inner
// product must not be bound by shared memory.
//
// Design (kernel 2's scheme, csrc/chmix.cu, with the nonlinearity moved to
// the input side): one block of 256 threads per (batch row, P positions),
// P = 16384 / C within [32, 128].  The block computes the gate of its
// (2C x P) input tile once, into shared memory (C x P floats, 64 KB at
// C = 256), then runs the (C + S) x C product out of shared memory in
// chunks of TM stacked-weight rows.  Weights stream through a transposed
// (TK x TM) shared tile, prefetched into registers one k-step ahead; each
// thread keeps an 8 x 8 register tile (rows {r, r + TM/2} x 4, positions
// {p, p + P/2} x 4, so a quarter-warp's 16-byte loads fall on distinct
// banks) and the epilogue writes res (adding x and b_r, scaled by
// sqrt(1/2)) and skip (adding b_s) straight to device memory.  The ragged
// tail past L is masked, so any L works.  tanhf and expf are the exact
// ones (no fast-math intrinsics): the strict f32 path.
//
// Kernel 11f, the bf16 path's form (the TPU kernel with fast=True, _kernel
// :58-73): h, x, res and skip are bf16; the gate is computed in f32 and
// rounded to bf16 as it is stored in shared memory (still as floats, so
// the tile layout is kernel 11's); the weights stay f32 in device memory
// and are rounded to bf16 after their float4 loads, as 6f and 7f round
// theirs; the products accumulate in f32, the f32 biases are added, res is
// (x + W_r out + b_r) sqrt(1/2) in f32, and res and skip are rounded to
// bf16 as they are stored.  The products stay fp32 CUDA-core FMAs of
// bf16-valued operands: what bf16 buys here is half the activation bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

using namespace dwst_act;

constexpr int NT = 256;        // threads per block
constexpr int TK = 8;          // contraction tile
constexpr float SQRT_HALF = 0.70710678118654752f;

template <int P>
struct Tile {
  static constexpr int PG = P / 8;          // position groups of 4 + 4
  static constexpr int RG = NT / PG;        // row groups of 4 + 4
  static constexpr int TM = RG * 8;         // stacked-weight rows per chunk
  static constexpr int LDT = TM + 4;        // padded transposed row
  static constexpr int NPRE = TM * 2 / NT;  // float4 prefetches per thread
};

// Row g of the stacked weight [W_r; W_s], or null past its C + S rows.
__device__ __forceinline__ const float* weight_row(const float* Wr,
                                                  const float* Ws, int g,
                                                  int C, int S) {
  if (g < C) return Wr + (size_t)g * C;
  if (g < C + S) return Ws + (size_t)(g - C) * C;
  return nullptr;
}

// A product's operand: as it is, or rounded to bf16 in kernel 11f.
template <bool FAST>
__device__ __forceinline__ float operand(float v) {
  return FAST ? round_bf16(v) : v;
}

// Four activations from t on (16-byte aligned for float, 8 for bf16), and
// four stored there.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// TA: the activations' type, float (kernel 11) or bf16 (kernel 11f).
template <int P, typename TA>
__global__ void __launch_bounds__(NT, 1)
gate_res_skip_kernel(const TA* __restrict__ h, const TA* __restrict__ x,
                     const float* __restrict__ Wr,
                     const float* __restrict__ br,
                     const float* __restrict__ Ws,
                     const float* __restrict__ bs, TA* __restrict__ res,
                     TA* __restrict__ skip, int C, int S, int L) {
  using T = Tile<P>;
  constexpr bool FAST = sizeof(TA) == 2;
  extern __shared__ float4 sh4[];
  float* gs = reinterpret_cast<float*>(sh4);     // C x P gated activation
  float* AsT = gs + C * P;                        // TK x LDT weight tile
  const int tid = threadIdx.x;
  const int pg = tid % T::PG, rg = tid / T::PG;
  const int b = blockIdx.y, t0 = blockIdx.x * P;

  // prologue: gs[c, p] = tanh(h[b, c, t]) * sigmoid(h[b, C + c, t]), 0 past L
  const TA* hb = h + (size_t)b * 2 * C * L;
  for (int idx = tid; idx < C * P; idx += NT) {
    const int c = idx / P, p = idx % P, t = t0 + p;
    float v = 0.0f;
    if (t < L) {
      const float a = to_f(hb[(size_t)c * L + t]);
      const float g = to_f(hb[(size_t)(C + c) * L + t]);
      v = operand<FAST>(tanhf(a) / (1.0f + expf(-g)));
    }
    gs[idx] = v;
  }
  // (the first barrier of the k loop orders these writes before any read)

  // the thread's positions: j < 4 -> pg * 4 + j, j >= 4 -> P/2 + pg * 4 + j-4
  const int tA = t0 + pg * 4, tB = t0 + P / 2 + pg * 4;
  const bool vec = (L & 3) == 0;                 // rows start 16-byte aligned
  const int M = C + S;
  for (int m0 = 0; m0 < M; m0 += T::TM) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;

    float4 pre[T::NPRE];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < T::NPRE; ++q) {
        const int idx = tid + q * NT;          // (row, half) pairs
        const float* row = weight_row(Wr, Ws, m0 + (idx >> 1), C, S);
        pre[q] = row ? *reinterpret_cast<const float4*>(row + k0 +
                                                         4 * (idx & 1))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < C; k0 += TK) {
      __syncthreads();                          // AsT free, gs complete
#pragma unroll
      for (int q = 0; q < T::NPRE; ++q) {
        const int idx = tid + q * NT;
        const int lr = idx >> 1, k = 4 * (idx & 1);
        AsT[(k + 0) * T::LDT + lr] = operand<FAST>(pre[q].x);
        AsT[(k + 1) * T::LDT + lr] = operand<FAST>(pre[q].y);
        AsT[(k + 2) * T::LDT + lr] = operand<FAST>(pre[q].z);
        AsT[(k + 3) * T::LDT + lr] = operand<FAST>(pre[q].w);
      }
      __syncthreads();
      if (k0 + TK < C) fetch(k0 + TK);          // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float* at = AsT + kk * T::LDT;
        const float4 a0 = *reinterpret_cast<const float4*>(at + rg * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(at + T::TM / 2 + rg * 4);
        const float* bt = gs + (size_t)(k0 + kk) * P + pg * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(bt);
        const float4 b1 = *reinterpret_cast<const float4*>(bt + P / 2);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
      }
    }

    // epilogue: rows < C are res rows, the rest skip rows
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int g = m0 + (r < 4 ? rg * 4 + r : T::TM / 2 + rg * 4 + r - 4);
      if (g >= M) continue;
      const bool is_res = g < C;
      const float bias = is_res ? br[g] : bs[g - C];
      TA* orow = is_res ? res + ((size_t)b * C + g) * L
                        : skip + ((size_t)b * S + (g - C)) * L;
      const TA* xrow = is_res ? x + ((size_t)b * C + g) * L : nullptr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? tB : tA;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[r][4 * half + j] + bias;
        if (vec && t + 4 <= L) {
          if (is_res) {
            float xv[4];
            load4(xrow + t, xv);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = (xv[j] + v[j]) * SQRT_HALF;
          }
          store4(orow + t, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (t + j < L)
              orow[t + j] = from_f<TA>(
                  is_res ? (to_f(xrow[t + j]) + v[j]) * SQRT_HALF : v[j]);
          }
        }
      }
    }
  }
}

// Positions per block: P = 16384 / C within [32, 128] (64 at C = 256).
int choose_p(int C) {
  const int p = 16384 / (C > 0 ? C : 1);
  return p >= 128 ? 128 : (p >= 64 ? 64 : 32);
}

template <int P, typename TA>
int launch(const TA* h, const TA* x, const float* Wr, const float* br,
           const float* Ws, const float* bs, TA* res, TA* skip, int B,
           int C, int S, int L, cudaStream_t stream) {
  using T = Tile<P>;
  const size_t smem = ((size_t)C * P + TK * T::LDT) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gate_res_skip_kernel<P, TA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + P - 1) / P, B);
  gate_res_skip_kernel<P, TA><<<grid, NT, smem, stream>>>(
      h, x, Wr, br, Ws, bs, res, skip, C, S, L);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_any(const TA* h, const TA* x, const float* Wr, const float* br,
               const float* Ws, const float* bs, TA* res, TA* skip, int B,
               int C, int S, int L, cudaStream_t stream) {
  if (C <= 0 || C % TK || S <= 0 || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  switch (choose_p(C)) {
    case 128: return launch<128>(h, x, Wr, br, Ws, bs, res, skip, B, C, S, L,
                                 stream);
    case 64: return launch<64>(h, x, Wr, br, Ws, bs, res, skip, B, C, S, L,
                               stream);
    default: return launch<32>(h, x, Wr, br, Ws, bs, res, skip, B, C, S, L,
                               stream);
  }
}

}  // namespace

extern "C" int dwst_gate_res_skip(const float* h, const float* x,
                                  const float* Wr, const float* br,
                                  const float* Ws, const float* bs,
                                  float* res, float* skip, int B, int C,
                                  int S, int L, cudaStream_t stream) {
  return launch_any(h, x, Wr, br, Ws, bs, res, skip, B, C, S, L, stream);
}

// Kernel 11f: h, x, res and skip bf16; the weights and biases f32.
extern "C" int dwst_gate_res_skip_bf16(const void* h, const void* x,
                                       const float* Wr, const float* br,
                                       const float* Ws, const float* bs,
                                       void* res, void* skip, int B, int C,
                                       int S, int L, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return launch_any(static_cast<const bf*>(h), static_cast<const bf*>(x), Wr,
                    br, Ws, bs, static_cast<bf*>(res), static_cast<bf*>(skip),
                    B, C, S, L, stream);
}
