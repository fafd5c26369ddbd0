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
// :58-73), is gate_res_skip_tc_kernel below: h, x, res and skip bf16; the
// gate in f32 (the exact tanhf and expf) rounded to bf16; the weights
// rounded to bf16; the products summed in f32 on the tensor cores; the f32
// biases and res = (x + W_r out + b_r) sqrt(1/2) in f32; res and skip
// rounded to bf16 once.  Its GEMM is 2 C (C + S) operations a position
// against (4C + S) x 2 bytes: 100 a byte at C = S = 256, under the bf16
// tensor cores' balance (989 TFLOP/s : 3.35 TB/s = 295), so it is bound by
// bytes.  Design (kernels 2f's and 7f's, csrc/chmix.cu): the stacked
// weight rounded to bf16 once a call into the wrapper's scratch, in
// fragment order and padded with zeros to 16-row, 16-column tiles
// (round_gate_weights_kernel), so C need only be a multiple of 8 and S
// anything; one block of 8 warps per (batch row, P positions), two blocks
// an SM (64 f32 sums a thread) so that one block's loads and gate overlap
// the other's products.  The block forms the gate 16 bytes a thread (8
// positions of an a row and of its g row) into a bf16 C x P tile, rows
// padded for ldmatrix.trans, while x's rows stream into a staging tile by
// cp.async.  The warps then take 16-row m-tiles of the stacked weight (P
// 128: 4 row groups x 2 halves of the positions; P 64 and 32: all
// positions), in passes of ROWS stacked rows, their A fragments straight
// from L2 two k-steps ahead (one at P 32, whose warps hold 4 m-tiles) in a
// ring of registers (mma_bf16.cuh::warp_gemm_ring), with no weight tile
// and no barrier in the k-loop.  Each
// pass's epilogue adds the bias (and x, then the sqrt(1/2) scale, on res
// rows) in registers and writes the bf16 result over the staging tile,
// which is then stored 16 bytes a thread, coalesced (element by element
// when L % 8 != 0 or a tensor is not 16-byte aligned).
// ops/wavenet_gate.py::gate_bf16_plan picks P and computes the block's
// shared memory, which the kernel takes as given.  Every sum in a fixed
// order: two calls are bit-equal.  What bounds it as built (gate_parts.py):
// the gate, the loads and the stores of a block run in phases that its
// products do not overlap, only the other block's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf = __nv_bfloat16;
using dwst_mma::aligned16;
using dwst_async::cp_async16;
using dwst_async::cp_async_commit;
using dwst_async::cp_async_wait;
using dwst_mma::pack8;
using dwst_mma::unpack8;

constexpr int NT = 256;        // threads per block
constexpr int NWARPS = NT / 32;
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

// Four activations from p on (16-byte aligned), and four stored there.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Kernel 11 (f32; kernel 11f is gate_res_skip_tc_kernel below).
template <int P>
__global__ void __launch_bounds__(NT, 1)
gate_res_skip_kernel(const float* __restrict__ h, const float* __restrict__ x,
                     const float* __restrict__ Wr,
                     const float* __restrict__ br,
                     const float* __restrict__ Ws,
                     const float* __restrict__ bs, float* __restrict__ res,
                     float* __restrict__ skip, int C, int S, int L) {
  using T = Tile<P>;
  extern __shared__ float4 sh4[];
  float* gs = reinterpret_cast<float*>(sh4);     // C x P gated activation
  float* AsT = gs + C * P;                        // TK x LDT weight tile
  const int tid = threadIdx.x;
  const int pg = tid % T::PG, rg = tid / T::PG;
  const int b = blockIdx.y, t0 = blockIdx.x * P;

  // prologue: gs[c, p] = tanh(h[b, c, t]) * sigmoid(h[b, C + c, t]), 0 past L
  const float* hb = h + (size_t)b * 2 * C * L;
  for (int idx = tid; idx < C * P; idx += NT) {
    const int c = idx / P, p = idx % P, t = t0 + p;
    float v = 0.0f;
    if (t < L) {
      const float a = hb[(size_t)c * L + t];
      const float g = hb[(size_t)(C + c) * L + t];
      v = tanhf(a) / (1.0f + expf(-g));
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
        AsT[(k + 0) * T::LDT + lr] = pre[q].x;
        AsT[(k + 1) * T::LDT + lr] = pre[q].y;
        AsT[(k + 2) * T::LDT + lr] = pre[q].z;
        AsT[(k + 3) * T::LDT + lr] = pre[q].w;
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
      float* orow = is_res ? res + ((size_t)b * C + g) * L
                           : skip + ((size_t)b * S + (g - C)) * L;
      const float* xrow = is_res ? x + ((size_t)b * C + g) * L : nullptr;
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
              orow[t + j] = is_res ? (xrow[t + j] + v[j]) * SQRT_HALF : v[j];
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

template <int P>
int launch(const float* h, const float* x, const float* Wr, const float* br,
           const float* Ws, const float* bs, float* res, float* skip, int B,
           int C, int S, int L, cudaStream_t stream) {
  using T = Tile<P>;
  const size_t smem = ((size_t)C * P + TK * T::LDT) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gate_res_skip_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + P - 1) / P, B);
  gate_res_skip_kernel<P><<<grid, NT, smem, stream>>>(h, x, Wr, br, Ws, bs,
                                                      res, skip, C, S, L);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 11f on the tensor cores.

// Kernel 11f's tiles at P positions a block: the 8 warps as WR row groups x
// WP position groups, each taking MT 16-row m-tiles over PW = P / WP
// positions at a time (MT PW = 128: 64 f32 sums a thread), so one pass
// covers ROWS stacked rows; bf16 rows padded to LD elements (LD / 8 odd:
// ldmatrix's eight rows on distinct banks); each thread moves 8
// consecutive positions (16 bytes) of every HS-th row.
template <int P>
struct GateTile {
  static constexpr int WP = P >= 128 ? 2 : 1;
  static constexpr int PW = P / WP;
  static constexpr int N8 = PW / 8;
  static constexpr int MT = 128 / PW;
  static constexpr int WR = NWARPS / WP;
  static constexpr int ROWS = WR * MT * 16;
  static constexpr int LD = P + 8;
  static constexpr int HS = NT / (P / 8);
  static constexpr int U = 4;               // gate rows in flight a thread
  static constexpr int AHEAD = MT >= 4 ? 1 : 2;   // k-steps of A ahead
};

// The stacked weight [W_r; W_s] ((C + S) x C, f32) rounded to bf16 into Wf
// as Mt x Kt m16k16 tiles in fragment order (mma_bf16.cuh::load_a_frag),
// rows past C + S and columns past C zero: kernel 11f's weights, once a
// call.  Each warp writes one tile: its 16 x 16 source through shared
// memory, 32 bytes a lane in (C % 8 == 0: an 8-column chunk lies wholly
// inside the matrix or past it), 16 bytes a lane out.
__global__ void round_gate_weights_kernel(const float* __restrict__ Wr,
                                          const float* __restrict__ Ws,
                                          uint4* __restrict__ Wf, int C,
                                          int S, int tiles) {
  __shared__ float tile[NWARPS][16][17];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int id = blockIdx.x * NWARPS + warp;    // = mt Kt + kt
  if (id >= tiles) return;
  const int Kt = (C + 15) / 16, mt = id / Kt, kt = id % Kt;
  const int rr = lane >> 1, cc = (lane & 1) * 8;
  const int r = 16 * mt + rr, k = 16 * kt + cc;
  const float* row = r < C       ? Wr + (size_t)r * C
                     : r < C + S ? Ws + (size_t)(r - C) * C
                                 : nullptr;
  float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
  if (row != nullptr && k < C) {
    v0 = *reinterpret_cast<const float4*>(row + k);
    v1 = *reinterpret_cast<const float4*>(row + k + 4);
  }
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) tile[warp][rr][cc + e] = v[e];
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ar = g + 8 * (i & 1), ak = 2 * t + 8 * (i >> 1);
    a[i] = dwst_mma::pack_bf16x2(tile[warp][ar][ak], tile[warp][ar][ak + 1]);
  }
  Wf[(size_t)id * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
}

// Eight bf16 values from p on, the n of them that exist (0 past them): one
// 16-byte load when vec (then n >= 8 or n <= 0), else one by one.
__device__ __forceinline__ uint4 load8(const bf* __restrict__ p, int n,
                                       bool vec) {
  if (n <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < n ? q[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < n ? q[2 * i + 1] : 0u;
    w[i] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Kernel 11f (bf16 h, x, res and skip; Wf = the stacked weight from
// round_gate_weights_kernel; f32 biases).  Dynamic shared memory, sized by
// ops/wavenet_gate.py::gate_bf16_plan: the gate tile (16 Kt rows), then
// the staging tile of R = min(16 Mt, ROWS) rows.  vec: L % 8 == 0 and
// every activation tensor 16-byte aligned.
template <int P>
__global__ void __launch_bounds__(NT, 2)
gate_res_skip_tc_kernel(const bf* __restrict__ h, const bf* __restrict__ x,
                        const uint4* __restrict__ Wf,
                        const float* __restrict__ br,
                        const float* __restrict__ bs, bf* __restrict__ res,
                        bf* __restrict__ skip, int C, int S, int L,
                        bool vec) {
  using T = GateTile<P>;
  constexpr int LD = T::LD, MT = T::MT, N8 = T::N8, HS = T::HS;
  extern __shared__ float4 sh4[];
  const int M = C + S, Kt = (C + 15) / 16, Mt = (M + 15) / 16;
  const int R = min(16 * Mt, T::ROWS);
  bf* gs = reinterpret_cast<bf*>(sh4);                // 16 Kt x LD gate
  bf* os = gs + (size_t)16 * Kt * LD;                 // R x LD staging
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's chunk of 8 positions, and its first row
  const int c = tid % (P / 8) * 8, t = t0 + c, r0 = tid / (P / 8);
  const int n = L - t;                  // positions of the chunk that exist
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // x's rows of the stacked rows [m0, m0 + R) that are res rows into the
  // staging tile (0 past L): by cp.async when vec, else one by one
  auto fetch_x = [&](int m0) {
    for (int i = r0; i < R && m0 + i < C; i += HS) {
      bf* dst = os + i * LD + c;
      const bf* src = x + ((size_t)b * C + m0 + i) * L + t;
      if (vec && n > 0)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = load8(src, n, vec);
    }
    cp_async_commit();
  };
  fetch_x(0);

  // the gate tile: gs[k, p] = bf16(tanh(a) sigmoid(g)), a = h[b, k, t0 + p]
  // and g = h[b, C + k, t0 + p]; 0 for k >= C and past L.  U rows' loads in
  // flight at a time.
  const bf* hb = h + (size_t)b * 2 * C * L + t;
  const int Kp = 16 * Kt;
  for (int k0 = r0; k0 < Kp; k0 += T::U * HS) {
    uint4 av[T::U], gv[T::U];
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const int k = k0 + u * HS;
      const int m = k < C ? n : 0;
      av[u] = load8(hb + (size_t)k * L, m, vec);
      gv[u] = load8(hb + (size_t)(C + k) * L, m, vec);
    }
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const int k = k0 + u * HS;
      if (k >= Kp) break;
      uint4 q = zero;
      if (k < C && n > 0) {
        float fa[8], fg[8], f[8];
        unpack8(av[u], fa);
        unpack8(gv[u], fg);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = j < n ? tanhf(fa[j]) / (1.0f + expf(-fg[j])) : 0.0f;
        q = pack8(f);
      }
      *reinterpret_cast<uint4*>(gs + k * LD + c) = q;
    }
  }
  __syncthreads();                      // the gate tile is complete

  const int wr = warp % T::WR, wp = warp / T::WR;
  const int g = lane >> 2, tq = lane & 3;
  const bf* bsm = gs + wp * T::PW;      // the warp's positions
  for (int m0 = 0; m0 < M; m0 += R) {
    if (m0 > 0) fetch_x(m0);            // the staging tile is free
    const int mt0 = m0 / 16 + wr * MT;
    const bool active = mt0 < Mt;       // the warp has rows in this pass
    float acc[MT][N8][4];
    if (active)
      dwst_mma::warp_gemm_ring<MT, N8, T::AHEAD>(Wf, Mt, Kt, mt0, bsm, LD,
                                                 acc);
    cp_async_wait<0>();
    __syncthreads();                    // x is staged
    if (active) {
      // res rows: (x + acc + b_r) sqrt(1/2); skip rows: acc + b_s; each
      // written over the x it read, in place
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * (mt0 + mt) + g + 8 * hh;
          if (row >= M) continue;
          const bool is_res = row < C;
          const float bias = is_res ? br[row] : bs[row - C];
          bf* srow = os + (row - m0) * LD + wp * T::PW + 2 * tq;
#pragma unroll
          for (int j = 0; j < N8; ++j) {
            uint32_t* e = reinterpret_cast<uint32_t*>(srow + 8 * j);
            float v0 = acc[mt][j][2 * hh] + bias;
            float v1 = acc[mt][j][2 * hh + 1] + bias;
            if (is_res) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(e));
              v0 = (xv.x + v0) * SQRT_HALF;
              v1 = (xv.y + v1) * SQRT_HALF;
            }
            *e = dwst_mma::pack_bf16x2(v0, v1);
          }
        }
    }
    __syncthreads();                    // the pass's results are staged
    for (int i = r0; i < R && m0 + i < M; i += HS) {
      const int row = m0 + i;
      bf* dst = row < C ? res + ((size_t)b * C + row) * L + t
                        : skip + ((size_t)b * S + row - C) * L + t;
      const bf* src = os + i * LD + c;
      if (vec) {
        if (n > 0)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8 && j < n; ++j) dst[j] = src[j];
      }
    }
    __syncthreads();                    // the staging tile is free
  }
}

// Kernel 11f: the weights rounded into the scratch Wf, then the tensor-core
// kernel on smem bytes of dynamic shared memory a block.
template <int P>
int launch_tc(const bf* h, const bf* x, const float* Wr, const float* br,
              const float* Ws, const float* bs, bf* res, bf* skip, uint4* Wf,
              int B, int C, int S, int L, int smem, cudaStream_t stream) {
  const int tiles = (C + S + 15) / 16 * ((C + 15) / 16);
  round_gate_weights_kernel<<<(tiles + NWARPS - 1) / NWARPS, NT, 0,
                              stream>>>(Wr, Ws, Wf, C, S, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = gate_res_skip_tc_kernel<P>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const bool vec = L % 8 == 0 && aligned16(h) && aligned16(x) &&
                   aligned16(res) && aligned16(skip);
  kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      h, x, Wf, br, bs, res, skip, C, S, L, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dwst_gate_res_skip(const float* h, const float* x,
                                  const float* Wr, const float* br,
                                  const float* Ws, const float* bs,
                                  float* res, float* skip, int B, int C,
                                  int S, int L, cudaStream_t stream) {
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

// Kernel 11f: h, x, res and skip bf16; the weights and biases f32; wf the
// scratch of the rounded weights (16 Mt x 16 Kt bf16); P and smem from
// ops/wavenet_gate.py::gate_bf16_plan.
extern "C" int dwst_gate_res_skip_bf16(const void* h, const void* x,
                                       const float* Wr, const float* br,
                                       const float* Ws, const float* bs,
                                       void* res, void* skip, void* wf, int B,
                                       int C, int S, int L, int P, int smem,
                                       cudaStream_t stream) {
  if (C <= 0 || C % 8 || S <= 0 || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const bf* hb = static_cast<const bf*>(h);
  const bf* xb = static_cast<const bf*>(x);
  bf* rb = static_cast<bf*>(res);
  bf* sb = static_cast<bf*>(skip);
  uint4* Wf = static_cast<uint4*>(wf);
  switch (P) {
    case 128: return launch_tc<128>(hb, xb, Wr, br, Ws, bs, rb, sb, Wf, B, C,
                                    S, L, smem, stream);
    case 64: return launch_tc<64>(hb, xb, Wr, br, Ws, bs, rb, sb, Wf, B, C,
                                  S, L, smem, stream);
    case 32: return launch_tc<32>(hb, xb, Wr, br, Ws, bs, rb, sb, Wf, B, C,
                                  S, L, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
