// Long S4 FFT convolution (kernel 9): the four-step conv, for FFT sizes
// past one block's shared memory; and kernel 5L, the conv spectrum's
// gradient at those sizes, on the same four-step transform (its design
// is above its kernels, dkf_cols_kernel and dkf_rows_kernel, then
// dkf_cluster_kernel below 9f's cluster kernel).
//
// Replaces the TPU kernels diffwave_sashimi_tpu/ops/fftconv_pallas.py::
// _kernel (fftconv_fused, the per-row four-step DFT as matmuls) and its
// channel-batched schedule _kernel_batched: the same function,
//
//   y = irfft(rfft(u, n) * khat, n)[:L]
//
// for u (B, H, L) float32 and the spectrum khat of the combined
// bidirectional S4 kernel at any power of two 256 <= n <= 2^20 with
// L <= n, in factorized (k1, k2) order; its training entry also takes
// conj(khat), the conv's input gradient, and takes u and gives y as f32 or
// as bf16 (the chain f32, y rounded once).  The sampling entry adds kernel
// 1's prologue u' = a u + c + bias (a, c (B, L) norm1 as scale and shift;
// bias (B, H) the step bias) and epilogue gelu_erf(y + D u').
//
// Kernel 9f, the sampling form of the bf16 path (the TPU kernel with
// fast=True, whose only change there is the MXU precision, composed with
// the bf16 policy around it, diffwave_sashimi_tpu/models/s4.py:705-712):
// u and out are bf16, a, c, bias, the spectrum and D f32; the prologue
// u' = a u + c + bias is rounded to bf16 (JAX's conv input is a bf16
// tensor), the chain stays f32, and the epilogue rounds v = y + D u' to
// bf16 before the exact GELU, whose result is stored as bf16.  Kernel 1f
// (csrc/fftconv.cu) differs on purpose: its prologue stays unrounded and
// its GELU is gelu_fast, the compact path's function.
//
// Design, four-step (n = N1 N2, N1 = 2^floor(l/2), N2 = 2^ceil(l/2) for
// n = 2^l; time index t = n1 N2 + n2, frequency k = k1 + N1 k2):
//
//   X[k1 + N1 k2] = sum_n2 W_N2^(n2 k2) W_n^(n2 k1)
//                   sum_n1 W_N1^(n1 k1) x[n1 N2 + n2]
//
// in three phases: N1-point FFTs of the columns n2 (after the prologue,
// zero past L), the twiddle W_n^(n2 k1); per row k1 the N2-point FFT, the
// product with the spectrum at k = k1 + N1 k2 (kp[h][k1][k2], permuted
// once per run), the N2-point inverse and the twiddle W_n^(-m2 k1); the
// inverse N1-point FFTs of the columns m2, 1/n, and only outputs t = m1 N2
// + m2 < L written, with the epilogue.  Two batch rows of one channel
// share one complex transform: k is real, so conv(u_b + i u_b+1, k) =
// conv(u_b, k) + i conv(u_b+1, k) against the Hermitian-completed
// spectrum (H, n), and the real and imaginary parts of the result are the
// two rows' outputs.  That halves the transform work with no real-FFT
// split.  Every FFT is fft_stockham.cuh's, in shared memory.
//
// What bounds it on the H100: at the vocoder's top tier (B 2, H 128,
// L 143360, n 2^18) the function reads u and the half spectrum once and
// writes y once, 0.43 GB, 0.13 ms at 3.35 TB/s; its ~6 GFLOP of transforms
// take 0.09 ms at the fp32 peak, so device memory bounds it (9f moves its
// activations at 2 bytes, 0.28 GB, 0.08 ms, so there the transforms' fp32
// operations bound it, 0.10 ms).  A complex row of 2^18 values is 2 MB,
// past one SM's shared memory, so the row is spread over several SMs.
// The f32 forms take the three passes below at every n; kernel 9f takes
// the route that ops/fftconv_long.py::long_plan gives its n (long_plan
// also sizes the cluster route's blocks):
//
// - the cluster route, n 2^16 and 2^17 (the vocoder's middle tier), where
//   it beats the three passes on the H100 (PERF.md, Findings PR 13): one
//   thread-block cluster of C = n / 16384 blocks owns one (batch pair,
//   channel) row from load to store, each block 16384 complex values
//   (128 KB of shared memory) and 1024 threads.  Block j loads the
//   columns [j N2/C, (j+1) N2/C) (runs of 64 adjacent activations) and
//   transforms them; exchange 1 moves, over distributed shared memory, to
//   each peer the (N1/C) x (N2/C) tile of block j's columns that holds
//   the peer's rows (no room for a second buffer, so every block reads
//   what it sends into registers, the cluster syncs, and every block
//   stores into its peers); block j runs its rows' transforms against one
//   contiguous 128 KB slab of kp; exchange 2 moves the tiles back, and
//   block j transforms its columns again and stores them.  The twiddles
//   are applied as a value crosses an exchange.  Each transform belongs
//   to one warp (fft_warp, warp barriers only; a slot layout, Swz, that
//   no access of the kernel meets with a bank conflict).  No device-
//   memory scratch: the device traffic is u once (the conv input u' stays
//   in a 64 KB stash of shared memory for the D-skip), out once and kp
//   once.  What bounds it: the instructions of its 4 transforms a row
//   (two radix-16 passes at N 256, three radix-8 passes at N 512), the
//   two exchanges (the network between a cluster's SMs is far slower than
//   an SM's own shared memory), and the device-memory phases' latency
//   with one block an SM, whose phases do not overlap.  The instance at
//   n 2^18 (clusters of 16, past the portable size of 8) is built and
//   measured (chip_smoke.py, cluster_phases.py) but loses to the three
//   passes there, so it serves no call;
// - the three-pass route, every other n, through a scratch S (one complex
//   n-row per (batch pair, channel)) in (k1, n2) row-major order, so no
//   transpose is materialised:
//
//   A (cols_fwd): each block takes TC adjacent columns n2 (coalesced rows
//     of u), the prologue, the column FFTs and twiddle, writes S[k1][n2];
//   B (rows):     each block takes contiguous rows k1 of S, the row
//     transforms and spectrum product, writes S[k1][m2];
//   C (cols_inv): the inverse column FFTs and the epilogue.
//
//   Its scratch round trips cost ~4 x 8 n bytes per (pair, channel)
//   beyond the bound, and its column passes move u and out in 32-byte
//   runs (TC bf16 columns); many blocks an SM overlap one block's
//   device-memory waits with another's transforms.
//
//   Two things pay on the H100 (PERF.md, Findings), and change no
//   value: with f32 activations (L % 4 == 0, aligned tensors) the column
//   passes move u, a, c and out four adjacent columns a 16-byte load or
//   store (load_cols4, store_cols4), a quarter of the instructions and of
//   the requests in flight for the same bytes; and at N2 64 .. 512 the
//   row pass knows N2 at compile time, so its index divisions become
//   shifts and each thread's scratch loads are all in flight at once.
//   Keeping a wave's scratch in L2 instead lost at every n tried: in
//   waves of three launches, or as the tiles of one persistent launch in
//   a pipeline over the waves, the launches' and waves' tails cost more
//   than the round trips saved; the cluster kernel's f32 instances (no
//   stash, u' formed again in the store) lost at 2^16, 2^17 and 2^18.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "activations.cuh"
#include "fft_stockham.cuh"

// A probe build (-DDWST_PHASE_STAMPS, cluster_phases.py) times the cluster
// kernel phase by phase: thread 0 of each block (the first 4096) records
// clock64() at each of its PHASE_STAMPS phase boundaries.  In the shipped
// build STAMP is empty.
#define PHASE_STAMPS 12
#ifdef DWST_PHASE_STAMPS
__device__ long long dwst_stamps[4096][PHASE_STAMPS];
#define STAMP(k) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) \
  dwst_stamps[blockIdx.x][k] = clock64()
#else
#define STAMP(k)
#endif

namespace {

namespace cg = cooperative_groups;
using namespace dwst_fft;
using namespace dwst_act;

constexpr int TC = 16;           // columns per block in passes A and C
constexpr int ROW_THREADS = 256;  // threads per block in pass B
// The cluster route: the threads of a block, the complex values it holds,
// the values a thread takes in each phase, and the bf16 pairs u' of the
// stash (a float2 slot holds two of them) at the start of the block's
// shared memory.
constexpr int CLUSTER_THREADS = 1024;
constexpr int CLUSTER_VALUES = 16384;
constexpr int CV = CLUSTER_VALUES / CLUSTER_THREADS;
constexpr int STASH_SLOTS = CLUSTER_VALUES / 2;

// exp(-+2 pi i m / n) for 0 <= m < n <= 2^20: the argument is exact.
template <bool INV>
__device__ __forceinline__ float2 twiddle(int m, float two_over_n) {
  float s, c;
  sincospif((float)m * two_over_n, &s, &c);
  return make_float2(c, INV ? s : -s);
}

struct Dims {
  int B, H, L, N1, N2;
  float two_over_n;
  // the f32 column passes' four-column loads and stores: L % 4 == 0 and
  // u, a, c and out 16-byte aligned (else their element-wise path)
  bool vec;
};

// The conv input at one position from u (as f32): u, or in the sampling
// form u' = a u + c + bias, rounded to bf16 in 9f (T bf16).  The column
// load and the column store both call it, so the D-skip sees the very
// value that was transformed.
template <bool FUSED, typename T>
__device__ __forceinline__ float conv_in(float u, float a, float c,
                                         float bh) {
  if (!FUSED) return u;
  const float v = a * u + c + bh;
  return sizeof(T) == 2 ? round_bf16(v) : v;
}

// The sampling form's output from v = y + D u': gelu_erf(v), or in 9f
// gelu_erf of v rounded to bf16, stored as bf16.
template <typename T>
__device__ __forceinline__ T gelu_out(float v) {
  return from_f<T>(gelu_erf(sizeof(T) == 2 ? round_bf16(v) : v));
}

// threadIdx.x, read anew in each phase of the cluster kernel: the phases'
// index arithmetic then stays apart, where the compiler would otherwise
// keep values common to two phases (every transform's slots, every
// column's positions) alive in registers across the whole kernel.
__device__ __forceinline__ int phase_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The (batch pair, channel) row r = pair * H + h.
struct Row {
  int b0, b1, h;
  bool two;
  __device__ Row(int r, int B, int H) {
    const int p = r / H;
    h = r - p * H;
    b0 = 2 * p;
    b1 = b0 + 1;
    two = b1 < B;
  }
};

// A column phase gives each of its nt threads VPT values, the value i =
// tid + e nt for e < VPT (both routes size their blocks so); a thread
// starts the device-memory loads of G values before it uses them, so it
// keeps G loads of each stream in flight.
constexpr int G = 4;

// Load columns [c0, c0 + ncols) of row w (every n1) into z[cc st +
// Lay::slot(n1)] as u_b0 + i u_b1, through the prologue, zero past L; nt
// threads tid.  STASH (9f's cluster route): also keep each value's u'
// pair, bf16 as the prologue rounds it, in stash[i] for the store.
template <bool FUSED, int ncols, typename Lay, bool STASH = false,
          typename T>
__device__ __forceinline__ void load_cols(
    float2* z, const T* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ c, const float* __restrict__ bias,
    const Dims& d, const Row& w, int c0, int tid, int nt,
    __nv_bfloat162* stash = nullptr) {
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = Lay::stride(N1);
  const T* u0 = u + ((size_t)w.b0 * d.H + w.h) * L;
  const T* u1 = u + ((size_t)w.b1 * d.H + w.h) * L;
  const float* a0 = FUSED ? a + (size_t)w.b0 * L : a;
  const float* a1 = FUSED ? a + (size_t)w.b1 * L : a;
  const float* s0 = FUSED ? c + (size_t)w.b0 * L : c;
  const float* s1 = FUSED ? c + (size_t)w.b1 * L : c;
  const float bh0 = FUSED ? bias[(size_t)w.b0 * d.H + w.h] : 0.0f;
  const float bh1 = FUSED && w.two ? bias[(size_t)w.b1 * d.H + w.h] : 0.0f;
#pragma unroll 1
  for (int g = 0; g < VPT; g += G) {
    int t[G];
    float x0[G], x1[G], p0[G], p1[G], q0[G], q1[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = tid + (g + k) * nt;
      const int n1 = i / ncols;
      t[k] = n1 * N2 + c0 + (i - n1 * ncols);
      const bool in0 = t[k] < L, in1 = in0 && w.two;
      x0[k] = in0 ? to_f(u0[t[k]]) : 0.0f;
      x1[k] = in1 ? to_f(u1[t[k]]) : 0.0f;
      p0[k] = FUSED && in0 ? a0[t[k]] : 0.0f;
      q0[k] = FUSED && in0 ? s0[t[k]] : 0.0f;
      p1[k] = FUSED && in1 ? a1[t[k]] : 0.0f;
      q1[k] = FUSED && in1 ? s1[t[k]] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = tid + (g + k) * nt;
      const int n1 = i / ncols, cc = i - n1 * ncols;
      const bool in0 = t[k] < L, in1 = in0 && w.two;
      const float v0 = in0 ? conv_in<FUSED, T>(x0[k], p0[k], q0[k], bh0) : 0;
      const float v1 = in1 ? conv_in<FUSED, T>(x1[k], p1[k], q1[k], bh1) : 0;
      z[cc * st + Lay::slot(n1)] = make_float2(v0, v1);
      if (STASH) stash[i] = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Store columns [c0, c0 + ncols) of row w from z[cc st + Lay::slot(m1)]
// (the inverse column transforms, unscaled): y = 1/n z, t < L only, with
// the epilogue in the sampling form; nt threads tid, the values of
// load_cols.  STASH: the D-skip's u' from stash[i], where load_cols kept
// it, instead of u, a and c read again.
template <bool FUSED, int ncols, typename Lay, bool STASH = false,
          typename T>
__device__ __forceinline__ void store_cols(
    const float2* z, const T* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ c, const float* __restrict__ bias,
    const float* __restrict__ D, T* __restrict__ out, const Dims& d,
    const Row& w, int c0, int tid, int nt,
    const __nv_bfloat162* stash = nullptr) {
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = Lay::stride(N1);
  const float inv_n = 0.5f * d.two_over_n;
  const size_t o0 = ((size_t)w.b0 * d.H + w.h) * L;
  const size_t o1 = ((size_t)w.b1 * d.H + w.h) * L;
  const size_t r0 = (size_t)w.b0 * L, r1 = (size_t)w.b1 * L;
  const float dh = FUSED ? D[w.h] : 0.0f;
  const float bh0 = FUSED ? bias[(size_t)w.b0 * d.H + w.h] : 0.0f;
  const float bh1 = FUSED && w.two ? bias[(size_t)w.b1 * d.H + w.h] : 0.0f;
#pragma unroll 1
  for (int g = 0; g < VPT; g += G) {
    int t[G];
    float x0[G], x1[G], p0[G], p1[G], q0[G], q1[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = tid + (g + k) * nt;
      const int m1 = i / ncols;
      t[k] = m1 * N2 + c0 + (i - m1 * ncols);
      const bool in0 = FUSED && !STASH && t[k] < L, in1 = in0 && w.two;
      x0[k] = in0 ? to_f(u[o0 + t[k]]) : 0.0f;
      x1[k] = in1 ? to_f(u[o1 + t[k]]) : 0.0f;
      p0[k] = in0 ? a[r0 + t[k]] : 0.0f;
      q0[k] = in0 ? c[r0 + t[k]] : 0.0f;
      p1[k] = in1 ? a[r1 + t[k]] : 0.0f;
      q1[k] = in1 ? c[r1 + t[k]] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (t[k] >= L) continue;
      const int i = tid + (g + k) * nt;
      const int m1 = i / ncols, cc = i - m1 * ncols;
      const float2 v = z[cc * st + Lay::slot(m1)];
      const float y0 = v.x * inv_n, y1 = v.y * inv_n;
      if (FUSED) {
        float2 xs;
        if (STASH) {
          xs = __bfloat1622float2(stash[i]);
        } else {
          xs.x = conv_in<true, T>(x0[k], p0[k], q0[k], bh0);
          xs.y = conv_in<true, T>(x1[k], p1[k], q1[k], bh1);
        }
        out[o0 + t[k]] = gelu_out<T>(y0 + dh * xs.x);
        if (w.two) out[o1 + t[k]] = gelu_out<T>(y1 + dh * xs.y);
      } else {
        out[o0 + t[k]] = from_f<T>(y0);
        if (w.two) out[o1 + t[k]] = from_f<T>(y1);
      }
    }
  }
}

// load_cols and store_cols of the f32 column passes (f32 u and out, the
// Pad layout, with vec): each of the nt threads takes items i = tid + e nt
// of the block's N1 ncols / 4, item i four adjacent columns c0 + 4 (i %
// (ncols / 4)) .. + 3 of row n1 = i / (ncols / 4), so that u, a, c and out
// move 16 bytes a load or store (a quarter warp covers a row's 64-byte
// run of one tensor); the arithmetic is load_cols' and store_cols', value
// by value.  With L % 4 == 0 an item's four positions are all in or all
// past L.
__device__ __forceinline__ float4 ld4(const float* p, bool in) {
  return in ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <bool FUSED, int ncols>
__device__ __forceinline__ void load_cols4(
    float2* z, const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ c, const float* __restrict__ bias,
    const Dims& d, const Row& w, int c0, int tid, int nt) {
  constexpr int CH = ncols / 4;
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = Pad::stride(N1);
  const float* u0 = u + ((size_t)w.b0 * d.H + w.h) * L;
  const float* u1 = u + ((size_t)w.b1 * d.H + w.h) * L;
  const float* a0 = FUSED ? a + (size_t)w.b0 * L : a;
  const float* a1 = FUSED ? a + (size_t)w.b1 * L : a;
  const float* s0 = FUSED ? c + (size_t)w.b0 * L : c;
  const float* s1 = FUSED ? c + (size_t)w.b1 * L : c;
  const float bh0 = FUSED ? bias[(size_t)w.b0 * d.H + w.h] : 0.0f;
  const float bh1 = FUSED && w.two ? bias[(size_t)w.b1 * d.H + w.h] : 0.0f;
#pragma unroll 1
  for (int i = tid; i < N1 * CH; i += nt) {
    const int n1 = i / CH, cc = 4 * (i - n1 * CH), t = n1 * N2 + c0 + cc;
    const bool in0 = t < L, in1 = in0 && w.two;
    const float4 x0 = ld4(u0 + t, in0), x1 = ld4(u1 + t, in1);
    const float4 p0 = ld4(a0 + t, FUSED && in0);
    const float4 q0 = ld4(s0 + t, FUSED && in0);
    const float4 p1 = ld4(a1 + t, FUSED && in1);
    const float4 q1 = ld4(s1 + t, FUSED && in1);
    const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
    const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
    const float pa[4] = {p0.x, p0.y, p0.z, p0.w};
    const float pb[4] = {p1.x, p1.y, p1.z, p1.w};
    const float qa[4] = {q0.x, q0.y, q0.z, q0.w};
    const float qb[4] = {q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0 =
          in0 ? conv_in<FUSED, float>(xa[j], pa[j], qa[j], bh0) : 0;
      const float v1 =
          in1 ? conv_in<FUSED, float>(xb[j], pb[j], qb[j], bh1) : 0;
      z[(cc + j) * st + pad(n1)] = make_float2(v0, v1);
    }
  }
}

template <bool FUSED, int ncols>
__device__ __forceinline__ void store_cols4(
    const float2* z, const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ c, const float* __restrict__ bias,
    const float* __restrict__ D, float* __restrict__ out, const Dims& d,
    const Row& w, int c0, int tid, int nt) {
  constexpr int CH = ncols / 4;
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = Pad::stride(N1);
  const float inv_n = 0.5f * d.two_over_n;
  const size_t o0 = ((size_t)w.b0 * d.H + w.h) * L;
  const size_t o1 = ((size_t)w.b1 * d.H + w.h) * L;
  const size_t r0 = (size_t)w.b0 * L, r1 = (size_t)w.b1 * L;
  const float dh = FUSED ? D[w.h] : 0.0f;
  const float bh0 = FUSED ? bias[(size_t)w.b0 * d.H + w.h] : 0.0f;
  const float bh1 = FUSED && w.two ? bias[(size_t)w.b1 * d.H + w.h] : 0.0f;
#pragma unroll 1
  for (int i = tid; i < N1 * CH; i += nt) {
    const int m1 = i / CH, cc = 4 * (i - m1 * CH), t = m1 * N2 + c0 + cc;
    if (t >= L) continue;
    const bool in0 = FUSED, in1 = FUSED && w.two;
    const float4 x0 = ld4(u + o0 + t, in0), x1 = ld4(u + o1 + t, in1);
    const float4 p0 = ld4(a + r0 + t, in0), q0 = ld4(c + r0 + t, in0);
    const float4 p1 = ld4(a + r1 + t, in1), q1 = ld4(c + r1 + t, in1);
    const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
    const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
    const float pa[4] = {p0.x, p0.y, p0.z, p0.w};
    const float pb[4] = {p1.x, p1.y, p1.z, p1.w};
    const float qa[4] = {q0.x, q0.y, q0.z, q0.w};
    const float qb[4] = {q1.x, q1.y, q1.z, q1.w};
    float ya[4], yb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = z[(cc + j) * st + pad(m1)];
      ya[j] = v.x * inv_n;
      yb[j] = v.y * inv_n;
      if (FUSED) {
        ya[j] = gelu_out<float>(
            ya[j] + dh * conv_in<true, float>(xa[j], pa[j], qa[j], bh0));
        yb[j] = gelu_out<float>(
            yb[j] + dh * conv_in<true, float>(xb[j], pb[j], qb[j], bh1));
      }
    }
    *reinterpret_cast<float4*>(out + o0 + t) =
        make_float4(ya[0], ya[1], ya[2], ya[3]);
    if (w.two)
      *reinterpret_cast<float4*>(out + o1 + t) =
          make_float4(yb[0], yb[1], yb[2], yb[3]);
  }
}

// z[q st + pad(k2)] *= kb[q N2 + k2] (conj(kb[...]) with conj) over the
// rows q of N2 values that the nt threads' VPT values each cover, 2 G
// loads of kb in flight (the three-pass route's row pass).
__device__ __forceinline__ void spectrum_product(
    float2* z, const float2* __restrict__ kb, int N2, int tid, int nt,
    bool conj) {
  const int st = Pad::stride(N2);
#pragma unroll
  for (int g = 0; g < VPT; g += 2 * G) {
    float2 k[2 * G];
#pragma unroll
    for (int m = 0; m < 2 * G; ++m) {
      k[m] = kb[tid + (g + m) * nt];
      if (conj) k[m] = cconj(k[m]);
    }
#pragma unroll
    for (int m = 0; m < 2 * G; ++m) {
      const int i = tid + (g + m) * nt, q = i / N2;
      float2* zi = z + q * st + pad(i - q * N2);
      *zi = cmul(*zi, k[m]);
    }
  }
}

// Pass A.  blockIdx.x: column tile; blockIdx.y: r = pair * H + h.  With
// f32 activations and d.vec, the column load moves four columns a load.
template <bool FUSED, typename T>
__global__ void __launch_bounds__(1024)
cols_fwd_kernel(const T* __restrict__ u, const float* __restrict__ a,
                const float* __restrict__ c, const float* __restrict__ bias,
                float2* __restrict__ S, Dims d) {
  extern __shared__ float2 z[];    // TC columns of N1 values
  const int r = blockIdx.y;
  const Row w(r, d.B, d.H);
  const int c0 = blockIdx.x * TC;
  const int N1 = d.N1, N2 = d.N2, st = Pad::stride(N1);
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (std::is_same_v<T, float>) {
    if (d.vec)
      load_cols4<FUSED, TC>(z, u, a, c, bias, d, w, c0, tid, nt);
    else
      load_cols<FUSED, TC, Pad>(z, u, a, c, bias, d, w, c0, tid, nt);
  } else {
    load_cols<FUSED, TC, Pad>(z, u, a, c, bias, d, w, c0, tid, nt);
  }
  __syncthreads();
  const int fpt = N1 / VPT, col = tid / fpt;
  fft<false>(z + col * st, N1, tid - col * fpt, fpt);

  float2* Sr = S + (size_t)r * N1 * N2;
  for (int i = tid; i < TC * N1; i += nt) {
    const int k1 = i / TC, cc = i - k1 * TC;
    const int n2 = c0 + cc;
    Sr[(size_t)k1 * N2 + n2] =
        cmul(z[cc * st + pad(k1)], twiddle<false>(n2 * k1, d.two_over_n));
  }
}

// Pass B.  blockIdx.x: a run of rpb rows k1 of one r.  N2C: N2 at compile
// time (then each thread's scratch loads are all in flight at once), or 0
// (d.N2; rows_instance picks).
template <int N2C>
__global__ void __launch_bounds__(ROW_THREADS)
rows_kernel(float2* __restrict__ S, const float2* __restrict__ kp, Dims d,
            int rpb, bool conj) {
  extern __shared__ float2 z[];    // rpb rows of N2 values
  const int N1 = d.N1, N2 = N2C ? N2C : d.N2, st = Pad::stride(N2);
  const int row0 = blockIdx.x * rpb;           // over (r, k1)
  const int r = row0 / N1, h = r % d.H;
  const int k10 = row0 - r * N1;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* Sb = S + (size_t)row0 * N2;

  if constexpr (N2C > 0) {
    float2 v[VPT];
#pragma unroll
    for (int e = 0; e < VPT; ++e) v[e] = Sb[tid + e * nt];
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      const int i = tid + e * nt;
      z[(i / N2) * st + pad(i % N2)] = v[e];
    }
  } else {
    for (int i = tid; i < rpb * N2; i += nt)
      z[(i / N2) * st + pad(i % N2)] = Sb[i];
  }
  __syncthreads();
  const int fpt = N2 / VPT, rr = tid / fpt, lane = tid - rr * fpt;
  fft<false>(z + rr * st, N2, lane, fpt);
  spectrum_product(z, kp + ((size_t)h * N1 + k10) * N2, N2, tid, nt, conj);
  __syncthreads();
  fft<true>(z + rr * st, N2, lane, fpt);
  for (int i = tid; i < rpb * N2; i += nt) {
    const int q = i / N2, m2 = i - q * N2;
    Sb[i] = cmul(z[q * st + pad(m2)],
                 twiddle<true>(m2 * (k10 + q), d.two_over_n));
  }
}

// Pass C.  Grid as pass A; the store as pass A's load.
template <bool FUSED, typename T>
__global__ void __launch_bounds__(1024)
cols_inv_kernel(const float2* __restrict__ S, const T* __restrict__ u,
                const float* __restrict__ a, const float* __restrict__ c,
                const float* __restrict__ bias, const float* __restrict__ D,
                T* __restrict__ out, Dims d) {
  extern __shared__ float2 z[];
  const int r = blockIdx.y;
  const Row w(r, d.B, d.H);
  const int c0 = blockIdx.x * TC;
  const int N1 = d.N1, N2 = d.N2, st = Pad::stride(N1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float2* Sr = S + (size_t)r * N1 * N2;

  for (int i = tid; i < TC * N1; i += nt) {
    const int k1 = i / TC, cc = i - k1 * TC;
    z[cc * st + pad(k1)] = Sr[(size_t)k1 * N2 + c0 + cc];
  }
  __syncthreads();
  const int fpt = N1 / VPT, col = tid / fpt;
  fft<true>(z + col * st, N1, tid - col * fpt, fpt);
  if constexpr (std::is_same_v<T, float>) {
    if (d.vec) {
      store_cols4<FUSED, TC>(z, u, a, c, bias, D, out, d, w, c0, tid, nt);
      return;
    }
  }
  store_cols<FUSED, TC, Pad>(z, u, a, c, bias, D, out, d, w, c0, tid, nt);
}

// Kernel 5L, the spectrum gradient past kernel 5's FFT sizes (one block's
// shared memory caps kernel 5 at n 32768): it replaces the TPU kernel
// diffwave_sashimi_tpu/ops/fftconv2.py::_dkf_kernel (fftconv2_dkf) at
// 2^16 <= n <= 2^20, with kernel 5's function (csrc/fftconv.cu),
//
//   dkhat[h, k] = c_k sum_b conj(U_b[k]) G_b[k],  U = rfft(u), G = rfft(g)
//
// at size n, c_k = 1/n at the DC and Nyquist bins and 2/n between them,
// for u and g (B, H, L) float32 or bf16.  Each real row x (u_b or g_b of
// one channel h) is the M = n/2 point complex transform Z of the packed
// pairs z[m] = x[2m] + i x[2m+1], split into its spectrum
//
//   X[k] = E[k] + W_n^k O[k],  E = (Z[k] + conj Z[M-k]) / 2,
//   O = (Z[k] - conj Z[M-k]) / 2i,  X[M] = Re Z[0] - Im Z[0],
//
// so u's and g's spectra keep their own scales (a product of one packed
// transform of u + i g would carry u's rounding into a small g's bins).
// Z is kernel 9's four-step transform (M = N1 N2, time m = n1 N2 + n2,
// frequency k = k1 + N1 k2).  Each bin k is split against its partner M -
// k, whose row is N1 - k1 (k1 0 and N1/2 are their own partners), so the
// row phase holds the rows in pairs {k1, N1 - k1}, the first pair {0,
// N1/2} (dkf_row).  ops/fftconv_long.py::dkf_long_plan picks one of two
// routes by n alone:
//
// - the cluster route, n 2^16 and 2^17 (dkf_cluster_kernel): one
//   thread-block cluster of C = DKF_CLUSTER = 8 blocks owns channel h,
//   each block NT threads and 16 NT complex values, its share of u_b's and
//   of g_b's transform (NT 512 at n 2^16, two blocks an SM; 1024 at 2^17,
//   one): COLS = N2 / C columns n2 of each in the column phase, ROWS = N1
//   / C rows of each, ROWS / 2 whole pairs, in the row phase.  For b = 0 .. B-1 in order a block
//   loads its columns of u_b and g_b (zero past L; bf16 read as bf16),
//   runs the N1-point column FFTs, moves each value over distributed
//   shared memory to the block that owns its row (one exchange, the
//   twiddle W_M^(n2 k1) applied as the value crosses it; the exchange
//   pushes as 9f's does, and the cluster barrier before its stores also
//   keeps them off the peers' previous row phase), runs the N2-point row
//   FFTs, splits each bin against its partner and adds conj(U) G to the
//   bin's sum, which the one thread that owns the bin keeps in a slot of
//   shared memory.  After the last b the bins are scaled by c_k and
//   stored once, in runs of consecutive k.  No device-memory scratch: the
//   device traffic is u and g once and the half spectrum once, in one
//   launch.  The transforms are 9f's (fft_warp, the Swz slot layout).
//   What bounds it: the instructions of the two transform phases and the
//   exchange, as in 9f; at n 2^16 two blocks an SM overlap one block's
//   exchange with the other's transforms;
// - the two-pass route, every other n, through a device-memory scratch S,
//   one M-point row per (b, h, u or g) in (k1, n2) order:
//
//   A (dkf_cols_kernel): each block takes TC columns n2 of one row, loads
//     the packed pairs (zero past L), runs the N1-point column FFTs, and
//     writes S[k1][n2] times the twiddle W_M^(n2 k1);
//   B (dkf_rows_kernel): each block takes one channel and the rows of
//     rpb / 2 pairs, for b = 0 .. B-1 in order loads those rows of u_b and
//     g_b, runs the N2-point row FFTs, splits each bin's U and G, and adds
//     conj(U) G to the bin's sum in a register of the one thread that owns
//     the bin; then it scales and stores the bins.
//
//   Its scratch round trip moves 2 x 8 n bytes a (b, h) beyond the bound,
//   and pass B holds one block an SM.  Past n 2^17 a cluster of the
//   portable size cannot hold a channel's two transforms (at 2^18 it would
//   need 16 blocks).
//
// On either route the batch is summed in b order by one thread a bin, so
// two calls give the same bits, and the (B, H, n/2+1) spectra never reach
// device memory.  What bounds the function on the H100: it reads u and g
// once and writes the half spectrum once (B2 H128 L44000 n 2^17: 0.16 GB,
// 0.05 ms at 3.35 TB/s; its transforms take about as long at the fp32
// peak).

// The row k1 of a slot's pair p: side 0 p, side 1 its partner row.
__device__ __forceinline__ int dkf_row(int p, int side, int N1) {
  return side == 0 ? p : (p == 0 ? N1 / 2 : N1 - p);
}

// X[k] of a real row from its packed transform: a = Z[k], c = Z[M-k],
// w = W_n^k.
__device__ __forceinline__ float2 split_bin(float2 a, float2 c, float2 w) {
  const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
  return cadd(e, cmul(w, o));
}

// Pass A of kernel 5L.  blockIdx.x: the row r = 2 (b H + h) + s (s 0 for
// u, 1 for g); blockIdx.y: the column tile; d: the M-point split, 2/M.
template <typename T>
__global__ void __launch_bounds__(1024)
dkf_cols_kernel(const T* __restrict__ u, const T* __restrict__ g,
                float2* __restrict__ S, Dims d) {
  extern __shared__ float2 z[];    // TC columns of N1 values
  const int r = blockIdx.x;
  const T* x = ((r & 1) ? g : u) + (size_t)(r >> 1) * d.L;
  const int c0 = blockIdx.y * TC;
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = Pad::stride(N1);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < TC * N1; i += nt) {
    const int n1 = i / TC, cc = i - n1 * TC;
    const int t = 2 * (n1 * N2 + c0 + cc);
    z[cc * st + pad(n1)] = make_float2(t < L ? to_f(x[t]) : 0.0f,
                                       t + 1 < L ? to_f(x[t + 1]) : 0.0f);
  }
  __syncthreads();
  const int fpt = N1 / VPT, col = tid / fpt;
  fft<false>(z + col * st, N1, tid - col * fpt, fpt);

  float2* Sr = S + (size_t)r * N1 * N2;
  for (int i = tid; i < TC * N1; i += nt) {
    const int k1 = i / TC, cc = i - k1 * TC;
    const int n2 = c0 + cc;
    Sr[(size_t)k1 * N2 + n2] =
        cmul(z[cc * st + pad(k1)], twiddle<false>(n2 * k1, d.two_over_n));
  }
}

// Pass B of kernel 5L.  blockIdx.x: pairs [x rpb/2, (x+1) rpb/2);
// blockIdx.y: the channel h.  z holds slot q's row of u_b in q and of g_b
// in rpb + q, slot q the row dkf_row(p0 + q / 2, q % 2); the launch sizes
// 2 rpb N2 = ROW_THREADS VPT, so a thread owns VPT / 2 bins.
__global__ void __launch_bounds__(ROW_THREADS)
dkf_rows_kernel(const float2* __restrict__ S, float2* __restrict__ out,
                Dims d, int rpb) {
  extern __shared__ float2 z[];
  constexpr int BINS = VPT / 2;
  const int N1 = d.N1, N2 = d.N2, M = N1 * N2, st = Pad::stride(N2);
  const int h = blockIdx.y, p0 = blockIdx.x * (rpb / 2);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fpt = N2 / VPT, rr = tid / fpt;
  const float inv_m = 0.5f * d.two_over_n;       // 2/n: W_n^k's argument
  float2 acc[BINS];
  float acc_nyq = 0.0f;                          // bin M, real
#pragma unroll
  for (int e = 0; e < BINS; ++e) acc[e] = make_float2(0.0f, 0.0f);

#pragma unroll 1
  for (int b = 0; b < d.B; ++b) {
    const float2* Sb = S + (size_t)(b * d.H + h) * 2 * M;
    for (int i = tid; i < 2 * rpb * N2; i += nt) {
      const int s = i / N2, k2 = i - s * N2;
      const int of_g = s >= rpb, q = s - of_g * rpb;
      const int k1 = dkf_row(p0 + q / 2, q & 1, N1);
      z[s * st + pad(k2)] = Sb[(size_t)of_g * M + (size_t)k1 * N2 + k2];
    }
    __syncthreads();
    fft<false>(z + rr * st, N2, tid - rr * fpt, fpt);
#pragma unroll
    for (int e = 0; e < BINS; ++e) {
      const int i = tid + e * nt, q = i / N2, k2 = i - q * N2;
      const int k1 = dkf_row(p0 + q / 2, q & 1, N1);
      const int k = k1 + N1 * k2, kr = (M - k) & (M - 1);
      const int k1r = kr & (N1 - 1), k2r = kr / N1;
      const int qr = k1r == k1 ? q : (q ^ 1);
      const float2 w = twiddle<false>(k, inv_m);
      const float2 zu = z[q * st + pad(k2)], zg = z[(q + rpb) * st + pad(k2)];
      const float2 xu = split_bin(zu, z[qr * st + pad(k2r)], w);
      const float2 xg = split_bin(zg, z[(qr + rpb) * st + pad(k2r)], w);
      acc[e] = cadd(acc[e], cmul(cconj(xu), xg));
      if (k == 0) acc_nyq += (zu.x - zu.y) * (zg.x - zg.y);
    }
    __syncthreads();
  }

  float2* o = out + (size_t)h * (M + 1);
  const float c_edge = 0.25f * d.two_over_n;     // 1/n
  const float c_mid = 0.5f * d.two_over_n;       // 2/n
#pragma unroll
  for (int e = 0; e < BINS; ++e) {
    const int i = tid + e * nt, q = i / N2, k2 = i - q * N2;
    const int k = dkf_row(p0 + q / 2, q & 1, N1) + N1 * k2;
    const float c = k == 0 ? c_edge : c_mid;
    o[k] = make_float2(c * acc[e].x, c * acc[e].y);
    if (k == 0) o[M] = make_float2(c_edge * acc_nyq, 0.0f);
  }
}

// Kernel 9f's cluster route at n = N1 N2, C = n / CLUSTER_VALUES blocks a
// cluster:
// blockIdx.x / C is the row r = pair * H + h, the rank j in the cluster
// gives the block's columns [j COLS, (j+1) COLS) and rows [j ROWS, (j+1)
// ROWS).  Block j holds its columns as z[cc ST1 + slot(k1)] in the column
// phases and its rows as z[q ST2 + slot(k2)] in the row phase, in the Swz
// layout; its shared memory is the stash, then z.  Each transform
// belongs to the N / 16 threads of one warp (or half-warp), so between
// the exchanges and the device-memory phases a warp runs at its own pace.
// An exchange pushes: every block reads what it sends from its own z
// into registers, the cluster syncs, every block stores into its peers' z
// over distributed shared memory (runs of COLS or ROWS values, no thread
// waits on a store), and the cluster syncs again.
template <int N1, int N2>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
fftconv_cluster_kernel(const __nv_bfloat16* __restrict__ u,
                       const float* __restrict__ a,
                       const float* __restrict__ c,
                       const float* __restrict__ bias,
                       const float2* __restrict__ kp,
                       const float* __restrict__ D,
                       __nv_bfloat16* __restrict__ out, Dims d) {
  constexpr int C = N1 * N2 / CLUSTER_VALUES, COLS = N2 / C, ROWS = N1 / C;
  constexpr int TILE = COLS * ROWS, NT = CLUSTER_THREADS;
  constexpr int ST1 = Swz::stride(N1), ST2 = Swz::stride(N2);
  constexpr int F1 = N1 / VPT, F2 = N2 / VPT;   // threads a transform
  static_assert(NT % ROWS == 0 && NT % COLS == 0, "fixed tile positions");
  extern __shared__ float2 smem[];
  __nv_bfloat162* const stash = reinterpret_cast<__nv_bfloat162*>(smem);
  float2* const z = smem + STASH_SLOTS;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const Row w(blockIdx.x / C, d.B, d.H);
  float2 v[CV];
  int tid = phase_tid();

  // this block's slab of the spectrum: rows [j ROWS, (j+1) ROWS)
  const float2* kb = kp + ((size_t)w.h * N1 + j * ROWS) * N2;

  // phase 1: the columns, forward
  STAMP(0);
  load_cols<true, COLS, Swz, true>(z, u, a, c, bias, d, w, j * COLS, tid,
                                   NT, stash);
  __syncthreads();
  STAMP(1);
  tid = phase_tid();
  fft_warp<N1, false>(z + tid / F1 * ST1, tid % F1);
  __syncthreads();

  // exchange 1: to peer i the rows [i ROWS, (i+1) ROWS) of this block's
  // columns, times W_n^(n2 k1).  A thread's value e is column n2 = j COLS
  // + tid % COLS at k1 = tid / COLS + e NT / COLS (its peer k1 / ROWS), so
  // its twiddles step by W_n^(n2 NT / COLS), exact every 8 values.
  STAMP(2);
  tid = phase_tid();
  {
    const int cc = tid % COLS, n2 = j * COLS + cc, k10 = tid / COLS;
    const float2 step = twiddle<false>(NT / COLS * n2, d.two_over_n);
    float2 tw;
#pragma unroll
    for (int e = 0; e < CV; ++e) {
      const int k1 = k10 + e * (NT / COLS);
      if (e % 8 == 0) tw = twiddle<false>(n2 * k1, d.two_over_n);
      v[e] = cmul(z[cc * ST1 + Swz::slot(k1)], tw);
      tw = cmul(tw, step);
    }
  }
  cluster.sync();
  STAMP(3);
  tid = phase_tid();
  {
    const int cc = tid % COLS;
#pragma unroll
    for (int e = 0; e < CV; ++e) {
      const int x = tid + e * NT, q = x % TILE / COLS;
      st_cluster(cluster_addr(z + q * ST2 + Swz::slot(j * COLS + cc),
                              x / TILE),
                 v[e]);
    }
  }
  STAMP(4);
  cluster.sync();

  // phase 2: each row, forward, times the spectrum, inverse
  STAMP(5);
  tid = phase_tid();
  {
    const int q = tid / F2, lane = tid % F2;
    float2* zq = z + q * ST2;
    fft_warp<N2, false>(zq, lane);
    float2 k[VPT];
#pragma unroll
    for (int m = 0; m < VPT; ++m) k[m] = kb[q * N2 + lane + m * F2];
#pragma unroll
    for (int m = 0; m < VPT; ++m) {
      float2* zi = zq + Swz::slot(lane + m * F2);
      *zi = cmul(*zi, k[m]);
    }
    __syncwarp();
    tid = phase_tid();
    fft_warp<N2, true>(z + tid / F2 * ST2, tid % F2);
  }
  __syncthreads();

  // exchange 2: to peer i the columns [i COLS, (i+1) COLS) of this block's
  // rows, times W_n^(-m2 k1); value e is row k1 = j ROWS + tid % ROWS at
  // m2 = tid / ROWS + e NT / ROWS (its peer m2 / COLS)
  STAMP(6);
  tid = phase_tid();
  {
    const int q = tid % ROWS, k1 = j * ROWS + q, m20 = tid / ROWS;
    const float2 step = twiddle<true>(NT / ROWS * k1, d.two_over_n);
    float2 tw;
#pragma unroll
    for (int e = 0; e < CV; ++e) {
      const int m2 = m20 + e * (NT / ROWS);
      if (e % 8 == 0) tw = twiddle<true>(m2 * k1, d.two_over_n);
      v[e] = cmul(z[q * ST2 + Swz::slot(m2)], tw);
      tw = cmul(tw, step);
    }
  }
  cluster.sync();
  STAMP(7);
  tid = phase_tid();
  {
    const int q = tid % ROWS;
#pragma unroll
    for (int e = 0; e < CV; ++e) {
      const int x = tid + e * NT, cc = x % TILE / ROWS;
      st_cluster(cluster_addr(z + cc * ST1 + Swz::slot(j * ROWS + q),
                              x / TILE),
                 v[e]);
    }
  }
  STAMP(8);
  cluster.sync();

  // phase 3: the columns, inverse, and the store
  STAMP(9);
  tid = phase_tid();
  fft_warp<N1, true>(z + tid / F1 * ST1, tid % F1);
  __syncthreads();
  STAMP(10);
  tid = phase_tid();
  store_cols<true, COLS, Swz, true>(z, u, a, c, bias, D, out, d, w,
                                    j * COLS, tid, NT, stash);
  STAMP(11);
}

// Kernel 5L's cluster route at M = n/2 = N1 N2, NT threads a block, C =
// 2 M / (NT CV) blocks a cluster, one cluster a channel h = blockIdx.x /
// C.  Block j (its rank) holds in the column phase z[c ST1 + slot(n1)] for
// its columns c < COLS of u_b (n2 = j COLS + c) and c - COLS of g_b, and
// in the row phase z[r ST2 + slot(k2)] for its slots r < ROWS of u_b and
// r - ROWS of g_b: slot q the row dkf_row(j ROWS/2 + q/2, q % 2).  A
// thread owns the bins of its BINS u slots (q, k2) = (i / N2, i % N2), i =
// tid + e NT, and their sums across the batch in acc[q ST2 + k2], shared
// memory past z that no other thread touches (in registers the sums would
// spill: the transforms take the 64 registers a thread has at 1024
// threads an SM).  Thread tid loads and sends the values of column c =
// tid % (2 COLS) at n1 (k1) = tid / (2 COLS) + e KS, so a warp moves
// runs of 16 or 32 adjacent values.  In the column transforms thread l of
// a transform takes lane l ^ 1: at N1 = N2 = 256 the rows' lanes would
// give the same twiddles, which ptxas then keeps in registers across the
// b loop, and spills.  The block's shared memory: z's slots, then acc's.
// The route runs clusters of DKF_CLUSTER blocks at both n, the portable
// size: blocks of 16384 values at n 2^16 (clusters of 4) and of 8192 at
// 2^17 (clusters of 16) were slower in turns on the H100 (PERF.md).
constexpr int DKF_CLUSTER = 8;

template <int N1, int N2, int NT>
__host__ __device__ constexpr int dkf_cluster_slots() {
  constexpr int C = 2 * N1 * N2 / (NT * CV);
  constexpr int cols = 2 * (N2 / C) * Swz::stride(N1);
  constexpr int rows = 2 * (N1 / C) * Swz::stride(N2);
  return cols > rows ? cols : rows;
}

template <int N1, int N2, int NT>
constexpr int dkf_cluster_smem() {
  constexpr int C = 2 * N1 * N2 / (NT * CV);
  return 8 * (dkf_cluster_slots<N1, N2, NT>() + (N1 / C) * Swz::stride(N2));
}

template <int N1, int N2, int NT, typename T>
__global__ void __launch_bounds__(NT, CLUSTER_THREADS / NT)
dkf_cluster_kernel(const T* __restrict__ u, const T* __restrict__ g,
                   float2* __restrict__ out, Dims d) {
  constexpr int M = N1 * N2, C = 2 * M / (NT * CV);
  constexpr int COLS = N2 / C, ROWS = N1 / C, PAIRS = ROWS / 2;
  constexpr int SPAN = 2 * COLS, KS = NT / SPAN;
  constexpr int ST1 = Swz::stride(N1), ST2 = Swz::stride(N2);
  constexpr int F1 = N1 / VPT, F2 = N2 / VPT;   // threads a transform
  constexpr int BINS = ROWS * N2 / NT;
  static_assert(NT % SPAN == 0 && KS * CV == N1 && SPAN * F1 == NT &&
                    2 * ROWS * F2 == NT && BINS * NT == ROWS * N2 &&
                    COLS % 16 == 0 && PAIRS >= 1 && C <= 16,
                "a block: 2 COLS columns and 2 ROWS rows of NT CV values");
  extern __shared__ float2 z[];
  float2* const acc = z + dkf_cluster_slots<N1, N2, NT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int h = blockIdx.x / C, p0 = j * PAIRS;
  const float two_over_m = d.two_over_n;          // W_M's argument
  const float inv_m = 0.5f * two_over_m;          // W_n's
  float acc_nyq = 0.0f;                           // bin M, real
  {
    const int tid = phase_tid();
#pragma unroll
    for (int e = 0; e < BINS; ++e) {
      const int i = tid + e * NT;
      acc[i / N2 * ST2 + i % N2] = make_float2(0.0f, 0.0f);
    }
  }

#pragma unroll 1
  for (int b = 0; b < d.B; ++b) {
    // the columns of u_b and g_b, packed pairs, zero past L
    int tid = phase_tid();
    {
      const int c = tid % SPAN, n10 = tid / SPAN, L = d.L;
      const T* x = (c < COLS ? u : g) + ((size_t)b * d.H + h) * L;
      const int m0 = j * COLS + c % COLS;
      float2* zc = z + c * ST1;
#pragma unroll 1
      for (int e0 = 0; e0 < CV; e0 += G) {
        float x0[G], x1[G];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int t = 2 * ((n10 + (e0 + k) * KS) * N2 + m0);
          x0[k] = t < L ? to_f(x[t]) : 0.0f;
          x1[k] = t + 1 < L ? to_f(x[t + 1]) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < G; ++k)
          zc[Swz::slot(n10 + (e0 + k) * KS)] = make_float2(x0[k], x1[k]);
      }
    }
    __syncthreads();
    tid = phase_tid();
    fft_warp<N1, false>(z + tid / F1 * ST1, (tid % F1) ^ 1);
    __syncthreads();

    // the exchange: value (c, k1) times W_M^(n2 k1) to slot (pair of k1)
    // of the block that owns that pair, row by row; a thread's twiddles
    // step by W_M^(n2 KS), exact every 8 values
    tid = phase_tid();
    float2 v[CV];
    {
      const int c = tid % SPAN, n2 = j * COLS + c % COLS, k10 = tid / SPAN;
      const float2 step = twiddle<false>(KS * n2, two_over_m);
      float2 tw;
#pragma unroll
      for (int e = 0; e < CV; ++e) {
        const int k1 = k10 + e * KS;
        if (e % 8 == 0) tw = twiddle<false>(n2 * k1, two_over_m);
        v[e] = cmul(z[c * ST1 + Swz::slot(k1)], tw);
        tw = cmul(tw, step);
      }
    }
    cluster.sync();
    tid = phase_tid();
    {
      const int c = tid % SPAN, k10 = tid / SPAN;
      const int r0 = c < COLS ? 0 : ROWS;
      const int n2 = j * COLS + c % COLS;
#pragma unroll
      for (int e = 0; e < CV; ++e) {
        const int k1 = k10 + e * KS, side = k1 >= N1 / 2;
        const int p = side ? (k1 == N1 / 2 ? 0 : N1 - k1) : k1;
        st_cluster(cluster_addr(z + (r0 + 2 * (p % PAIRS) + side) * ST2 +
                                    Swz::slot(n2),
                                p / PAIRS),
                   v[e]);
      }
    }
    cluster.sync();

    // the rows, forward; then each u bin's split and sum
    tid = phase_tid();
    fft_warp<N2, false>(z + tid / F2 * ST2, tid % F2);
    __syncthreads();
    tid = phase_tid();
#pragma unroll
    for (int e = 0; e < BINS; ++e) {
      const int i = tid + e * NT, q = i / N2, k2 = i % N2;
      const int k1 = dkf_row(p0 + q / 2, q & 1, N1);
      const int k = k1 + N1 * k2, kr = (M - k) & (M - 1);
      const int k1r = kr & (N1 - 1), k2r = kr / N1;
      const int qr = k1r == k1 ? q : (q ^ 1);
      const float2 w = twiddle<false>(k, inv_m);
      const float2 zu = z[q * ST2 + Swz::slot(k2)];
      const float2 zg = z[(q + ROWS) * ST2 + Swz::slot(k2)];
      const float2 xu = split_bin(zu, z[qr * ST2 + Swz::slot(k2r)], w);
      const float2 xg =
          split_bin(zg, z[(qr + ROWS) * ST2 + Swz::slot(k2r)], w);
      float2* a = acc + q * ST2 + k2;
      *a = cadd(*a, cmul(cconj(xu), xg));
      if (k == 0) acc_nyq += (zu.x - zu.y) * (zg.x - zg.y);
    }
    __syncthreads();
  }

  // the bins, scaled, in runs of consecutive k1: r < PAIRS the pairs'
  // first rows, ascending, the rest their partners, ascending (the last
  // barrier above orders every thread's sums before these reads)
  float2* o = out + (size_t)h * (M + 1);
  const float c_edge = 0.5f * inv_m, c_mid = inv_m;   // 1/n, 2/n
  const int tid = phase_tid();
  if (j == 0 && tid == 0) o[M] = make_float2(c_edge * acc_nyq, 0.0f);
#pragma unroll
  for (int e = 0; e < BINS; ++e) {
    const int i = tid + e * NT, r = i % ROWS, k2 = i / ROWS;
    const int q = r < PAIRS ? 2 * r : 2 * (ROWS - 1 - r) + 1;
    const int k = dkf_row(p0 + q / 2, q & 1, N1) + N1 * k2;
    const float s = k == 0 ? c_edge : c_mid;
    const float2 a = acc[q * ST2 + k2];
    o[k] = make_float2(s * a.x, s * a.y);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// power of two, 256 <= n <= 2^20 (N1, N2 in [16, 1024]), L <= n
bool bad_size(int n, int L) {
  return n < 256 || n > (1 << 20) || (n & (n - 1)) || L > n || L < 1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Dims dims(int B, int H, int L, int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return Dims{B, H, L, 1 << (l / 2), 1 << (l - l / 2), 2.0f / (float)n};
}

// The cluster route's launch configuration for a grid of `clusters`
// clusters of C blocks, with its attribute (in *attr), after the kernel's
// attributes are set.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int C, int smem, int clusters,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr,
                           int threads = CLUSTER_THREADS) {
  cudaError_t e;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  if (C > 8 && (e = cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                    1)) != cudaSuccess)
    return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * C);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The cluster kernel's instance at n = N1 N2 (2^16, 2^17 or 2^18), or
// null; *C its blocks a cluster.
using ClusterKernel = void (*)(const __nv_bfloat16*, const float*,
                               const float*, const float*, const float2*,
                               const float*, __nv_bfloat16*, Dims);

ClusterKernel cluster_kernel(int n, int* C) {
  *C = n / CLUSTER_VALUES;
  switch (n) {
    case 1 << 16: return fftconv_cluster_kernel<256, 256>;
    case 1 << 17: return fftconv_cluster_kernel<256, 512>;
    case 1 << 18: return fftconv_cluster_kernel<512, 512>;
    default: return nullptr;
  }
}

// Kernel 9f on the cluster route with the plan's (cluster, cols, rows,
// smem), which must be the instance's: every block holds CLUSTER_VALUES
// values as N2 / C columns and as N1 / C rows.
int launch_cluster(const __nv_bfloat16* u, const float* a, const float* c,
                   const float* bias, const void* kp, const float* D,
                   __nv_bfloat16* out, int B, int H, int L, int n,
                   int cluster, int cols, int rows, int smem,
                   cudaStream_t stream) {
  if (bad_size(n, L) || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Dims d = dims(B, H, L, n);
  int C;
  const auto kernel = cluster_kernel(n, &C);
  if (!kernel || cluster != C || cols * C != d.N2 || rows * C != d.N1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kernel, C, smem, (B + 1) / 2 * H, stream,
                                 &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kernel, u, a, c, bias,
                         static_cast<const float2*>(kp), D, out, d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The row pass's instance: N2 at compile time at N2 64 .. 512 (at 16 and
// 32 it spilled; at 1024 its registers a thread cut the blocks an SM, and
// it ran slower than the runtime instance); else the runtime one.
using RowsKernel = void (*)(float2*, const float2*, Dims, int, bool);

RowsKernel rows_instance(int N2) {
  switch (N2) {
    case 64: return rows_kernel<64>;
    case 128: return rows_kernel<128>;
    case 256: return rows_kernel<256>;
    case 512: return rows_kernel<512>;
  }
  return rows_kernel<0>;
}

// The three-pass route through scratch.
template <bool FUSED, typename T>
int launch_long(const T* u, const float* a, const float* c,
                const float* bias, const void* kp, const float* D,
                void* scratch, T* out, int B, int H, int L, int n,
                cudaStream_t stream, bool conj = false) {
  if (bad_size(n, L) || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Dims d = dims(B, H, L, n);
  d.vec = std::is_same_v<T, float> && L % 4 == 0 && aligned16(u) &&
          aligned16(out) && (!FUSED || (aligned16(a) && aligned16(c)));
  const int R = (B + 1) / 2 * H;     // rows r = pair * H + h
  float2* S = static_cast<float2*>(scratch);

  const size_t smem_col =
      (size_t)TC * Pad::stride(d.N1) * sizeof(float2);
  const int rpb = std::min(ROW_THREADS * VPT / d.N2, d.N1);
  const size_t smem_row = (size_t)rpb * Pad::stride(d.N2) * sizeof(float2);
  const auto rows = rows_instance(d.N2);
  cudaError_t e;
  if ((e = allow_smem(cols_fwd_kernel<FUSED, T>, smem_col)) != cudaSuccess ||
      (e = allow_smem(rows, smem_row)) != cudaSuccess ||
      (e = allow_smem(cols_inv_kernel<FUSED, T>, smem_col)) != cudaSuccess)
    return (int)e;

  const dim3 col_grid(d.N2 / TC, R);
  const int col_threads = TC * d.N1 / VPT;
  cols_fwd_kernel<FUSED, T><<<col_grid, col_threads, smem_col, stream>>>(
      u, a, c, bias, S, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  rows<<<R * d.N1 / rpb, rpb * d.N2 / VPT, smem_row, stream>>>(
      S, static_cast<const float2*>(kp), d, rpb, conj);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cols_inv_kernel<FUSED, T><<<col_grid, col_threads, smem_col, stream>>>(
      S, u, a, c, bias, D, out, d);
  return (int)cudaGetLastError();
}

// Kernel 5L's cluster-route instance at FFT size n (2^16 or 2^17) for
// inputs of type T: clusters of DKF_CLUSTER blocks, so NT = n / (8 CV)
// threads a block (512 at n 2^16, two blocks an SM; 1024 at 2^17, one),
// with its shared-memory bytes; a null kernel at any other n.
template <typename T>
struct DkfCluster {
  void (*kernel)(const T*, const T*, float2*, Dims);
  int threads, smem;
};

template <int N1, int N2, typename T>
DkfCluster<T> dkf_cluster_at() {
  constexpr int NT = 2 * N1 * N2 / (DKF_CLUSTER * CV);
  return {dkf_cluster_kernel<N1, N2, NT, T>, NT,
          dkf_cluster_smem<N1, N2, NT>()};
}

template <typename T>
DkfCluster<T> dkf_cluster_instance(int n) {
  switch (n) {
    case 1 << 16: return dkf_cluster_at<128, 256, T>();
    case 1 << 17: return dkf_cluster_at<256, 256, T>();
    default: return {nullptr, 0, 0};
  }
}

// Kernel 5L on its plan's route (ops/fftconv_long.py::dkf_long_plan):
// cluster DKF_CLUSTER the cluster route, one launch of H clusters (scratch
// unused); cluster 0 the two passes through the scratch (B H n complex64),
// pass A over 2 B H rows, pass B over the channels.
template <typename T>
int launch_dkf_long(const T* u, const T* g, void* scratch, void* out, int B,
                    int H, int L, int n, int cluster, cudaStream_t stream) {
  if (bad_size(n, L) || n < (1 << 16) || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Dims d = dims(B, H, L, n / 2);
  cudaError_t e;
  if (cluster != 0) {
    const DkfCluster<T> k = dkf_cluster_instance<T>(n);
    if (!k.kernel || cluster != DKF_CLUSTER)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if ((e = cluster_config(k.kernel, cluster, k.smem, H, stream, &cfg,
                            &attr, k.threads)) != cudaSuccess ||
        (e = cudaLaunchKernelEx(&cfg, k.kernel, u, g,
                                static_cast<float2*>(out), d)) !=
            cudaSuccess)
      return (int)e;
    return (int)cudaGetLastError();
  }
  float2* S = static_cast<float2*>(scratch);
  const size_t smem_col = (size_t)TC * Pad::stride(d.N1) * sizeof(float2);
  const int rpb = ROW_THREADS * VPT / (2 * d.N2);
  const size_t smem_row =
      (size_t)2 * rpb * Pad::stride(d.N2) * sizeof(float2);
  if ((e = allow_smem(dkf_cols_kernel<T>, smem_col)) != cudaSuccess ||
      (e = allow_smem(dkf_rows_kernel, smem_row)) != cudaSuccess)
    return (int)e;
  dkf_cols_kernel<T><<<dim3(2 * B * H, d.N2 / TC), TC * d.N1 / VPT,
                       smem_col, stream>>>(u, g, S, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dkf_rows_kernel<<<dim3(d.N1 / rpb, H), ROW_THREADS, smem_row, stream>>>(
      S, static_cast<float2*>(out), d, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// kp: (H, N1, N2) complex64, the Hermitian-completed spectrum K[k1 + N1 k2]
// at [h][k1][k2]; scratch: ceil(B/2) H n complex64.  The f32 forms take
// the three passes at every n.
extern "C" int dwst_fftconv_long_ln_bias_gelu_d(
    const float* u, const float* a, const float* c, const float* bias,
    const void* kp, const float* D, void* scratch, float* out, int B, int H,
    int L, int n, cudaStream_t stream) {
  return launch_long<true>(u, a, c, bias, kp, D, scratch, out, B, H, L, n,
                           stream);
}

// Kernel 9f: u and out bf16, the rest as above; cluster, cols, rows, smem:
// its route's plan (ops/fftconv_long.py::long_plan), cluster 0 the three
// passes through scratch, cluster > 0 the cluster route (scratch unused).
extern "C" int dwst_fftconv_long_ln_bias_gelu_d_bf16(
    const void* u, const float* a, const float* c, const float* bias,
    const void* kp, const float* D, void* scratch, void* out, int B, int H,
    int L, int n, int cluster, int cols, int rows, int smem,
    cudaStream_t stream) {
  const auto* ub = static_cast<const __nv_bfloat16*>(u);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (cluster > 0)
    return launch_cluster(ub, a, c, bias, kp, D, ob, B, H, L, n, cluster,
                          cols, rows, smem, stream);
  return launch_long<true>(ub, a, c, bias, kp, D, scratch, ob, B, H, L, n,
                           stream);
}

// The TPU kernel's contract, the training conv: conj 0 y = conv(u, k),
// conj 1 the same with conj(kp), its input gradient (k is real, and the
// output is as long as the input); three passes at every n.
extern "C" int dwst_fftconv_long(const float* u, const void* kp,
                                 void* scratch, float* out, int B, int H,
                                 int L, int n, int conj, cudaStream_t stream) {
  return launch_long<false, float>(u, nullptr, nullptr, nullptr, kp,
                                   nullptr, scratch, out, B, H, L, n, stream,
                                   conj != 0);
}

// The same with u and out bf16 (the bf16 training route): u read as bf16,
// the chain and the scratch f32, y rounded to the nearest bf16 once, so
// the result is the f32 entry's on the widened input, narrowed.
extern "C" int dwst_fftconv_long_bf16(const void* u, const void* kp,
                                      void* scratch, void* out, int B, int H,
                                      int L, int n, int conj,
                                      cudaStream_t stream) {
  return launch_long<false>(static_cast<const __nv_bfloat16*>(u), nullptr,
                            nullptr, nullptr, kp, nullptr, scratch,
                            static_cast<__nv_bfloat16*>(out), B, H, L, n,
                            stream, conj != 0);
}

// Kernel 5L: u, g (B, H, L) float32, out (H, n/2+1) complex64, 2^16 <= n
// <= 2^20; cluster: its route (ops/fftconv_long.py::dkf_long_plan), 0 the
// two passes through scratch (B H n complex64), DKF_CLUSTER the cluster
// route (scratch unused).
extern "C" int dwst_fftconv_dkf_long(const float* u, const float* g,
                                     void* scratch, void* out, int B, int H,
                                     int L, int n, int cluster,
                                     cudaStream_t stream) {
  return launch_dkf_long(u, g, scratch, out, B, H, L, n, cluster, stream);
}

// Kernel 5L, u and g bf16.
extern "C" int dwst_fftconv_dkf_long_bf16(const void* u, const void* g,
                                          void* scratch, void* out, int B,
                                          int H, int L, int n, int cluster,
                                          cudaStream_t stream) {
  return launch_dkf_long(static_cast<const __nv_bfloat16*>(u),
                         static_cast<const __nv_bfloat16*>(g), scratch, out,
                         B, H, L, n, cluster, stream);
}

// How many clusters of 9f's cluster kernel at FFT size n (C = n / 16384
// blocks a cluster), each block with smem bytes of shared memory, the card
// can hold at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error.
extern "C" int dwst_fftconv_long_max_clusters(int n, int smem) {
  int C;
  const auto kernel = cluster_kernel(n, &C);
  if (!kernel) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kernel, C, smem, 1, 0, &cfg, &attr);
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// The same for kernel 5L's cluster route at FFT size n.
extern "C" int dwst_fftconv_dkf_long_max_clusters(int n) {
  const DkfCluster<float> k = dkf_cluster_instance<float>(n);
  if (!k.kernel) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(k.kernel, DKF_CLUSTER, k.smem, 1, 0, &cfg,
                                 &attr, k.threads);
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, k.kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

#ifdef DWST_PHASE_STAMPS
// The probe build's stamps, copied to dst ((4096, stamps) int64); fails
// unless stamps is the kernel's PHASE_STAMPS.
extern "C" int dwst_read_stamps(void* dst, int stamps) {
  if (stamps != PHASE_STAMPS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, dwst_stamps, sizeof(dwst_stamps));
}
#endif
