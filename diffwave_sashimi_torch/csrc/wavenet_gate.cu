// The WaveNet block's tail: gate + res/skip 1x1 convs in one pass (kernel 11).
//
// Replaces diffwave_sashimi_tpu/ops/wavenet_gate.py:58 (_kernel, through
// gate_res_skip).  For h (B, 2C, L) from the dilated conv and the block
// input x (B, C, L):
//   out  = tanh(h[:, :C]) * sigmoid(h[:, C:])
//   res  = (x + W_r out + b_r) * sqrt(1/2)      W_r (C, C), res (B, C, L)
//   skip = W_s out + b_s                         W_s (S, C), skip (B, S, L)
//
// Kernel 11, the f32 form (the TPU kernel with fast=False: its products
// at HIGHEST precision), is gate_res_skip_tf32_kernel below, on the
// tensor cores at f32 accuracy: the gate in f32 (the exact tanhf and expf,
// no fast-math intrinsics), the products in 3xTF32 (mma_tf32.cuh: each f32
// operand split into tf32 hi and lo, a product lo hi + hi lo + hi hi, each
// k-step's terms summed from zero and added to f32 sums), res = (x + (W_r
// out + b_r)) sqrt(1/2) and skip = W_s out + b_s in f32.  What bounds it on
// the H100: the stacked weight [W_r; W_s] ((C + S) x C) over the gated
// activation, 2 C (C + S) operations a position, three tf32 products apiece
// at the dense TF32 rate (0.102 ms at B4 C256 S256 L16000), against (4C +
// S) x 4 bytes a position (0.098 ms); every block also reads the split
// weight (8 bytes an entry, 1 MB at C = S = 256) from L2, once per P
// positions.  Design (kernel 3's, csrc/chmix.cu): the stacked weight split
// once a call into the wrapper's scratch in fragment order, zero-padded to
// whole m-tiles (split_weights_tf32_kernel<11>), so C need only be a
// multiple of 8 and S anything; one block of 8 warps per (batch row, P
// positions), built for BLOCKS blocks an SM (P 64 at two at C = S = 256,
// P 32 at three at C 128, S 256: the other blocks' warps hide each one's
// latencies, while the weight's L2 reads per position stay at most 16 KB).
// The block forms the gate 16 bytes a thread into an f32 C x P tile, rows
// padded so that a B fragment's loads fall on distinct banks; the warps
// then take MT m-tiles of the stacked weight over all P positions, their A
// fragments from L2 AHEAD k-steps ahead in a ring of registers
// (warp_gemm_3xtf32_ring), B values split as they load, no weight tile and
// no barrier in the k-loop.  Each m-tile's 16 rows (+ bias) go through the
// warp's own staging tile, so that x is read and res and skip stored 16
// bytes a lane, coalesced (element by element when L % 4 != 0 or a tensor
// is not 16-byte aligned); the ragged tail past L is masked.
// ops/wavenet_gate.py::gate_tf32_plan picks P and the blocks an SM and
// computes the block's shared memory, which the kernel takes as given.
// Every sum in a fixed order: two calls are bit-equal.
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
#include "mma_tf32.cuh"

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
constexpr float SQRT_HALF = 0.70710678118654752f;

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

// ---------------------------------------------------------------------------
// Kernel 11 (f32) on the tensor cores at f32 accuracy: the products in
// 3xTF32 (mma_tf32.cuh), the gate and the epilogue in f32.

// Kernel 11's tiles at P positions a block: f32 rows of LD floats (LD % 32
// of 8 or 24: a B fragment's 32 loads on distinct banks); each warp takes
// MT 16-row m-tiles of the stacked weight over all P positions at a time
// (16 MT N8 <= 64 sums a thread, MT <= 4); each thread gates 4 consecutive
// positions (16 bytes) of every HS-th row.
template <int P, int BLOCKS>
struct GateTf32Tile {
  static constexpr int N8 = P / 8;
  static constexpr int LD = P == 8 ? 8 : P + 8;
  static constexpr int MT = BLOCKS > 2 || N8 >= 16 ? 1
                                                   : (16 / N8 < 4 ? 16 / N8
                                                                  : 4);
  // k-steps of A in flight ahead of their use: one at two blocks an SM
  // (128 registers a thread) and at four m-tiles a warp
  static constexpr int AHEAD = BLOCKS == 2 || MT >= 4 ? 1 : 2;
  static constexpr int C4 = P / 4;
  static constexpr int HS = NT / C4;
};

// Kernel 11 (f32 h, x, res and skip; Wf = the stacked weight [W_r; W_s]
// split by split_weights_tf32_kernel<11>: ceil((C + S) / 16) x C / 8 tiles,
// rows past C + S zero).  Dynamic shared memory, sized by
// ops/wavenet_gate.py::gate_tf32_plan: the f32 gate tile (C rows), then
// each warp's 16-row staging tile.  vec: L % 4 == 0 and every activation
// tensor 16-byte aligned.
template <int P, int BLOCKS>
__global__ void __launch_bounds__(NT, BLOCKS)
gate_res_skip_tf32_kernel(const float* __restrict__ h,
                          const float* __restrict__ x,
                          const uint4* __restrict__ Wf,
                          const float* __restrict__ br,
                          const float* __restrict__ bs,
                          float* __restrict__ res, float* __restrict__ skip,
                          int C, int S, int L, bool vec) {
  using T = GateTf32Tile<P, BLOCKS>;
  constexpr int LD = T::LD, N8 = T::N8, MT = T::MT, C4 = T::C4;
  extern __shared__ float4 sh4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* gs = reinterpret_cast<float*>(sh4);          // C x LD gate
  float* st = gs + (size_t)C * LD + warp * 16 * LD;   // the warp's 16 rows
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int M = C + S, Mt = (M + 15) / 16, Kt = C / 8;

  // gs[k, p] = tanh(a) sigmoid(g), a = h[b, k, t0 + p], g = h[b, C + k,
  // t0 + p], the exact tanhf and expf; 0 past L
  {
    const int c = tid % C4 * 4, t = t0 + c;
    const float* hb = h + (size_t)b * 2 * C * L + t;
    for (int k = tid / C4; k < C; k += T::HS) {
      float a[4], g[4], v[4];
      if (vec && t < L) {            // L % 4 == 0: the chunk is all in
        const float4 av = __ldg(reinterpret_cast<const float4*>(
            hb + (size_t)k * L));
        const float4 gv = __ldg(reinterpret_cast<const float4*>(
            hb + (size_t)(C + k) * L));
        a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
        g[0] = gv.x; g[1] = gv.y; g[2] = gv.z; g[3] = gv.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = t + e < L ? hb[(size_t)k * L + e] : 0.0f;
          g[e] = t + e < L ? hb[(size_t)(C + k) * L + e] : 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = t + e < L ? tanhf(a[e]) / (1.0f + expf(-g[e])) : 0.0f;
      *reinterpret_cast<float4*>(gs + k * LD + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  for (int u = warp; u * MT < Mt; u += NWARPS) {
    const int mt0 = u * MT;
    float acc[MT][N8][4];
    dwst_tf32::zero_acc<MT, N8>(acc);
    dwst_tf32::warp_gemm_3xtf32_ring<MT, N8, T::AHEAD>(Wf, Mt, Kt, mt0, 0, Kt,
                                                       gs, LD, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = 16 * (mt0 + mt);
      if (r0 >= M) break;
      // the m-tile's 16 rows + bias into the warp's staging tile
      __syncwarp();                  // the last m-tile's rows are read
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + gq + 8 * hh;
        const float bias = row < C ? br[row] : (row < M ? bs[row - C] : 0.0f);
        float* sr = st + (gq + 8 * hh) * LD + 2 * tq;
#pragma unroll
        for (int j = 0; j < N8; ++j)
          *reinterpret_cast<float2*>(sr + 8 * j) =
              make_float2(acc[mt][j][2 * hh] + bias,
                          acc[mt][j][2 * hh + 1] + bias);
      }
      __syncwarp();
      // res rows: (x + W_r out + b_r) sqrt(1/2); skip rows: W_s out + b_s;
      // 16 bytes a lane, a warp's lanes on consecutive positions
      for (int i = lane; i < 16 * C4; i += 32) {
        const int r = i / C4, cc = i % C4 * 4, row = r0 + r, t = t0 + cc;
        if (row >= M) break;
        const bool is_res = row < C;
        const float* sv = st + r * LD + cc;
        float* dst = is_res ? res + ((size_t)b * C + row) * L + t
                            : skip + ((size_t)b * S + row - C) * L + t;
        const float* xr =
            is_res ? x + ((size_t)b * C + row) * L + t : nullptr;
        if (vec && t < L) {
          float4 v = *reinterpret_cast<const float4*>(sv);
          if (is_res) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr));
            v = make_float4((xv.x + v.x) * SQRT_HALF, (xv.y + v.y) * SQRT_HALF,
                            (xv.z + v.z) * SQRT_HALF,
                            (xv.w + v.w) * SQRT_HALF);
          }
          *reinterpret_cast<float4*>(dst) = v;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t + e < L)
              dst[e] = is_res ? (xr[e] + sv[e]) * SQRT_HALF : sv[e];
        }
      }
    }
  }
}

// Kernel 11: the stacked weight split into the scratch Wf, then the 3xTF32
// kernel on smem bytes of dynamic shared memory a block, built for BLOCKS
// blocks an SM.
template <int P, int BLOCKS>
int launch_tf32(const float* h, const float* x, const float* Wr,
                const float* br, const float* Ws, const float* bs, float* res,
                float* skip, uint4* Wf, int B, int C, int S, int L, int smem,
                cudaStream_t stream) {
  // [W_r; W_s] ((C + S) x C)
  dwst_tf32::SplitJobs jobs{{{Wr, Ws, C, C + S, C, C, 1}}, 1};
  int e = dwst_tf32::split_weights_launch<11>(jobs, Wf, stream);
  if (e) return e;
  auto kernel = gate_res_skip_tf32_kernel<P, BLOCKS>;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  const bool vec = L % 4 == 0 && aligned16(h) && aligned16(x) &&
                   aligned16(res) && aligned16(skip);
  kernel<<<dim3((L + P - 1) / P, B), NT, smem, stream>>>(
      h, x, Wf, br, bs, res, skip, C, S, L, vec);
  return (int)cudaGetLastError();
}

}  // namespace

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

// Kernel 11: h, x, res and skip f32; wf the scratch of the split weights
// (ops/wavenet_gate.py::gate_tf32_split_floats floats); P, blocks an SM
// (P 128, 64, 32, 16 or 8 at one; 64 at two; 32 at three) and smem from
// ops/wavenet_gate.py::gate_tf32_plan.
extern "C" int dwst_gate_res_skip(const float* h, const float* x,
                                  const float* Wr, const float* br,
                                  const float* Ws, const float* bs,
                                  float* res, float* skip, void* wf, int B,
                                  int C, int S, int L, int P, int blocks,
                                  int smem, cudaStream_t stream) {
  if (C <= 0 || C % 8 || S <= 0 || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  uint4* Wf = static_cast<uint4*>(wf);
  auto run = [&](auto launch) {
    return launch(h, x, Wr, br, Ws, bs, res, skip, Wf, B, C, S, L, smem,
                  stream);
  };
  if (blocks == 2 && P == 64) return run(launch_tf32<64, 2>);
  if (blocks == 3 && P == 32) return run(launch_tf32<32, 3>);
  if (blocks != 1) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 128: return run(launch_tf32<128, 1>);
    case 64: return run(launch_tf32<64, 1>);
    case 32: return run(launch_tf32<32, 1>);
    case 16: return run(launch_tf32<16, 1>);
    case 8: return run(launch_tf32<8, 1>);
    default: return (int)cudaErrorInvalidValue;
  }
}
