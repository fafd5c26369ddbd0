// Symmetric Cauchy sum that builds the S4 (NPLR) convolution kernels
// (kernel 4), and its closed-form backward (kernel 8, below).
//
// Kernel 4 replaces the TPU kernel diffwave_sashimi_tpu/ops/
// cauchy_pallas.py::_fwd_kernel (called by _cauchy_quad_fwd_impl for
// cauchy_sym_pallas):
//
//   out[k, m, l] = sum_n (a[k,m,n] z_l + b[k,m,n])
//                        / (z_l^2 + c[m,n] z_l + d[m,n])
//
// the conjugate-pair resolvent sum in real-coefficient form.  The K
// numerators ((1 + rank) * (channels + rank) = 6 for the bidirectional
// rank-1 S4 layer) share one denominator per (m, n, l), so its reciprocal,
// the costliest step, is computed once for all K.
//
// What bounds it on the H100: its flops per (m, n, l), counted as the
// fewer of its two forms need (chip_smoke.py::work): 13 + 11K with the
// numerator a_k z + b_k multiplied by G0 = 1/den for each k (the TPU
// kernel's form), or 19 + 8K with G1 = z G0 formed once and
// a_k G1 + b_k G0 added for each k (this kernel's form), 67 at K = 6;
// against K complex outputs per (m, l): at N = 32 states it is compute
// bound (fp32 CUDA cores); device memory sees only the output.  So every
// instruction per (m, n, l) counts.
//
// Design (cauchy_fwd_kernel<K>): a thread owns P = 4 positions of one
// channel m, l = base + t + j x threads for j < P (so each j's float2
// stores coalesce across a warp), and all K components: 2KP sums in
// registers, added over n in the order 0..N-1.  No sum crosses threads:
// no atomics, no reduction pass, and two calls give the same bits.  The
// block stages its channel's coefficients once in shared memory, one
// record a state, [c, d, a_0..a_{K-1}, b_0..b_{K-1}] padded to whole
// float4s, read as 128-bit broadcasts once a state for all P positions
// (R / P loads a (n, l), R = 4 float4s at K = 6).  Per (m, n, l): the
// denominator chain with one reciprocal (kernel 8's: den scaled by the
// exact power of two pow2_inverse gives, then reciprocal_1_8 of the
// scaled |den|^2), G0 = 1/den, G1 = z G0, then acc_k += a_k G1 + b_k G0,
// 4 FMAs a component: about 20 + 4K instructions.  K is a template
// argument: no work on components k >= K.  P = 4 won in turns with 2 and
// 8 at every tier (chip_smoke.py, PERF.md); at 8 the sums take too many
// registers, at 2 the records are read twice as often.  ops/cauchy.py::
// cauchy_fwd_plan alone sizes the launch (threads, blocks a channel,
// shared memory).  The kernel writes interleaved (re, im) pairs: the
// (K, M, Lz, 2) float32 output is a complex64 (K, M, Lz) tensor's memory,
// which the S4 kernel construction views, with no copy.
// It runs once per sampling run (30 S4 layers), and once per layer in
// every training step.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

using dwst_async::cp_async4;
using dwst_async::cp_async8;
using dwst_async::cp_async_commit;
using dwst_async::cp_async_wait;

constexpr int KMAX = 8;
constexpr int FWD_THREADS = 128;           // the most threads a block
constexpr int FWD_P = 4;                   // positions a thread
constexpr int FWD_SMEM_MAX = 232448;       // shared memory a block may use

// 2^-e for x = 2^e x [1, 2), from x's exponent bits: exact, so scaling by
// it adds no rounding (for normal x below 2^127)
__device__ __forceinline__ float pow2_inverse(float x) {
  return __int_as_float(0x7f000000 - (__float_as_int(x) & 0x7f800000));
}

// 1 / q for q in [1, 8): the approximate reciprocal, then one Newton step
// (cauchy_bwd_parts.py times the kernel without it)
__device__ __forceinline__ float reciprocal_1_8(float q) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
  return fmaf(r, fmaf(-q, r, 1.0f), r);
}

// float4s of one state's record: c, d, the K a's and the K b's
__host__ __device__ constexpr int fwd_record_f4(int K) {
  return (2 * K + 2 + 3) / 4;
}

// component q of a record held in registers (q a constant once unrolled)
template <int R>
__device__ __forceinline__ float record_at(const float4 (&rq)[R], int q) {
  const float4 v = rq[q >> 2];
  return (q & 3) == 0 ? v.x : (q & 3) == 1 ? v.y : (q & 3) == 2 ? v.z : v.w;
}

// The launch bounds' one block an SM: without it ptxas spills a few of
// K 6's sums (112 registers a thread hold them) to fit more blocks an SM;
// with it every instance keeps its sums in registers.
template <int K>
__global__ void __launch_bounds__(FWD_THREADS, 1)
cauchy_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ d,
                  const float2* __restrict__ z, float2* __restrict__ out,
                  int M, int N, int Lz) {
  constexpr int R = fwd_record_f4(K), Q = 2 * K + 2, P = FWD_P;
  extern __shared__ float4 fwd_sh[];
  float* rec = reinterpret_cast<float*>(fwd_sh);
  const int m = blockIdx.y, T = blockDim.x;
  // the records: item i is field q = i / N of state n = i % N, so each
  // field's reads from device memory run along n
  for (int i = threadIdx.x; i < Q * N; i += T) {
    const int q = i / N, n = i - q * N;
    float v;
    if (q == 0)
      v = c[(size_t)m * N + n];
    else if (q == 1)
      v = d[(size_t)m * N + n];
    else if (q < K + 2)
      v = a[((size_t)(q - 2) * M + m) * N + n];
    else
      v = b[((size_t)(q - 2 - K) * M + m) * N + n];
    rec[n * 4 * R + q] = v;
  }
  const int l0 = blockIdx.x * T * P + threadIdx.x;
  float zr[P], zi[P], z2r[P], z2i[P], accr[K][P], acci[K][P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int l = l0 + j * T;
    const float2 zl = l < Lz ? z[l] : make_float2(0.0f, 0.0f);
    zr[j] = zl.x;
    zi[j] = zl.y;
    z2r[j] = zl.x * zl.x - zl.y * zl.y;           // as kernel 8 forms it
    z2i[j] = 2.0f * zl.x * zl.y;
#pragma unroll
    for (int k = 0; k < K; ++k) accr[k][j] = acci[k][j] = 0.0f;
  }
  __syncthreads();

  for (int n = 0; n < N; ++n) {
    float4 rq[R];
#pragma unroll
    for (int i = 0; i < R; ++i) rq[i] = fwd_sh[n * R + i];
    const float cn = rq[0].x, dn = rq[0].y;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      // kernel 8's denominator chain: the same G0 from the same
      // instructions
      const float den_r = z2r[j] + cn * zr[j] + dn;
      const float den_i = z2i[j] + cn * zi[j];
      const float s = pow2_inverse(fmaxf(fabsf(den_r), fabsf(den_i)));
      const float sr = den_r * s, si = den_i * s;
      const float t = reciprocal_1_8(sr * sr + si * si) * s;
      const float g0r = sr * t, g0i = -si * t;              // 1 / den
      const float g1r = zr[j] * g0r - zi[j] * g0i;          // z / den
      const float g1i = zr[j] * g0i + zi[j] * g0r;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float ak = record_at(rq, 2 + k), bk = record_at(rq, 2 + K + k);
        accr[k][j] = fmaf(bk, g0r, fmaf(ak, g1r, accr[k][j]));
        acci[k][j] = fmaf(bk, g0i, fmaf(ak, g1i, acci[k][j]));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int l = l0 + j * T;
      if (l < Lz)
        out[((size_t)k * M + m) * Lz + l] = make_float2(accr[k][j],
                                                         acci[k][j]);
    }
}

template <int K>
int launch_fwd(const float* a, const float* b, const float* c,
               const float* d, const float2* z, float2* out, int M, int N,
               int Lz, int threads, int splits, int smem,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cauchy_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  cauchy_fwd_kernel<K><<<dim3(splits, M), threads, smem, stream>>>(
      a, b, c, d, z, out, M, N, Lz);
  return (int)cudaGetLastError();
}

// Kernel 8 replaces cauchy_pallas.py::_bwd_kernel (_cauchy_quad_bwd): the
// gradients of the real coefficients for the output cotangent
// g[k, m, l] = (g_re, g_im), summed over l.  With G0 = 1/den, G1 = z/den
// and gc_k = conj(g_k):
//
//   da[k,m,n] = sum_l Re(gc_k G1),   db[k,m,n] = sum_l Re(gc_k G0)
//   dd[m,n] = -sum_l Re(G0 G0 T),    dc[m,n] = -sum_l Re(G1 G0 T)
//   T = z A + Bb,  A = sum_k a_k gc_k,  Bb = sum_k b_k gc_k
//
// (A and Bb collapse the K components for dc and dd, as in the TPU
// kernel.)  What bounds it: ~(30 + 16K) flops per (m, n, l) against one
// read of g, so the fp32 CUDA cores: a warp issues 31 + 8K fp32
// instructions a position for its 32 states, besides 4 shared-memory
// loads and the reciprocal, so every instruction per (m, n, l) counts.
//
// Design (cauchy_bwd_lanes_kernel<K, PAIRED>): the N <= 32 states of a
// channel are the lanes of a warp.  Each lane keeps its state's c, d, a_k,
// b_k and its own 2K + 2 sums in registers; no sum crosses lanes.  The
// positions l are split across blocks and, in chunks of BWD_CHUNK, across
// the warps of a block: ops/cauchy.py::cauchy_bwd_plan alone sizes the
// split (`span` positions a block, `splits` blocks a channel) and the
// shared memory.  Each warp stages its own chunks of z and of g's K rows
// into shared memory by cp.async, double-buffered, so its next chunk loads
// while this one computes and no block barrier stands in the loop; every
// lane reads them as broadcasts, and each channel's g crosses from device
// memory once.  g is read in place: the real and imaginary views of one
// complex tensor (element stride 2, one 8-byte copy a value; PAIRED) or
// two planes (stride 1, two 4-byte copies).  K is a template argument: no
// work on components k >= K.
//
// One reciprocal per (m, n, l): den is scaled by the exact power of two
// 2^-e with max(|den_r|, |den_i|) = 2^e x [1, 2), so the scaled |den|^2
// lies in [1, 8), where the approximate reciprocal and a Newton step are
// good to an ulp.  The scaling adds no rounding and keeps |den|^2 in range
// at the Nyquist node, where z is huge (|z| ~ 8e5 at L = 1000).  Kernel 4
// computes G0 by the same helpers and the same chain, so the two kernels'
// G0 agree.
//
// Sums run in a fixed order: each thread's chain of span / BWD_WARPS
// positions (at most 64, the plan's cap), the warps' sums pairwise through
// shared memory, then, where splits > 1, the blocks' partials in a second
// pass (cauchy_bwd_reduce_kernel).  No float atomics: two calls give the
// same bits.

constexpr int BWD_THREADS = 256;                    // threads a block
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_CHUNK = 16;           // positions a warp stages at a time
constexpr int BWD_BLOCKS_PER_SM = 4;   // the plan's too; 3 past K 6
constexpr int BWD_LANES = 32;                       // the most states, N

// A warp's stage, in float4s: BWD_CHUNK z records (zr, zi, Re z^2,
// Im z^2), then g's K values of each position, padded to whole float4s.
// Each warp has two stages; the warps' sums reuse the space at the end.
template <int K>
__host__ __device__ constexpr int bwd_stage_f4() {
  return BWD_CHUNK * (1 + (K + 1) / 2);
}

template <int K>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return BWD_WARPS * 2 * bwd_stage_f4<K>() * 16 >
                 BWD_WARPS * (2 * K + 2) * 32 * 4
             ? BWD_WARPS * 2 * bwd_stage_f4<K>() * 16
             : BWD_WARPS * (2 * K + 2) * 32 * 4;
}

// One warp stages `cnt` <= BWD_CHUNK positions from l0 into `st`: z into
// the first half of each record (lane j, position j), g's K values after
// them (item i: row k = i / BWD_CHUNK, position j = i % BWD_CHUNK);
// PAIRED: the real and imaginary parts adjacent in memory, g_re's
// element stride 2; else two planes of stride 1.
template <int K, bool PAIRED>
__device__ __forceinline__ void bwd_stage(
    float4* st, int l0, int cnt, int lane, int m, int M, int Lz,
    const float2* __restrict__ z, const float* __restrict__ g_re,
    const float* __restrict__ g_im) {
  constexpr int KP = (K + 1) / 2;
  constexpr int ITEMS = (K * BWD_CHUNK + 31) / 32;
  float2* gs = reinterpret_cast<float2*>(st + BWD_CHUNK);
  if (lane < cnt) cp_async8(&st[lane], &z[l0 + lane]);
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = lane + it * 32;
    const int k = i / BWD_CHUNK, j = i % BWD_CHUNK;
    if (i < K * BWD_CHUNK && j < cnt) {
      const size_t e = ((size_t)k * M + m) * Lz + l0 + j;
      float2* dst = &gs[j * 2 * KP + k];
      if (PAIRED) {
        cp_async8(dst, g_re + 2 * e);
      } else {
        cp_async4(&dst->x, g_re + e);
        cp_async4(&dst->y, g_im + e);
      }
    }
  }
  cp_async_commit();
}

// Position j for one state: the denominator chain, then every sum.
template <int K>
__device__ __forceinline__ void bwd_position(
    const float4* zs, const float4* gs, int j, float cn, float dn,
    const float (&an)[K], const float (&bn)[K], float (&sa)[K],
    float (&sb)[K], float& sc, float& sd) {
  constexpr int KP = (K + 1) / 2;
  const float4 zq = zs[j];                   // zr, zi, Re z^2, Im z^2
  float4 gq[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) gq[i] = gs[j * KP + i];
  const float den_r = zq.z + cn * zq.x + dn;         // as kernel 4
  const float den_i = zq.w + cn * zq.y;
  const float s = pow2_inverse(fmaxf(fabsf(den_r), fabsf(den_i)));
  const float sr = den_r * s, si = den_i * s;
  const float t = reciprocal_1_8(sr * sr + si * si) * s;
  const float g0r = sr * t, g0i = -si * t;                 // 1 / den
  const float g1r = zq.x * g0r - zq.y * g0i;               // z / den
  const float g1i = zq.x * g0i + zq.y * g0r;
  float Ar = 0.0f, Ai = 0.0f, Br = 0.0f, Bi = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float gr = (k & 1) ? gq[k >> 1].z : gq[k >> 1].x;
    const float gi = (k & 1) ? gq[k >> 1].w : gq[k >> 1].y;
    sa[k] = fmaf(gi, g1i, fmaf(gr, g1r, sa[k]));
    sb[k] = fmaf(gi, g0i, fmaf(gr, g0r, sb[k]));
    Ar = fmaf(an[k], gr, Ar);
    Ai = fmaf(-an[k], gi, Ai);
    Br = fmaf(bn[k], gr, Br);
    Bi = fmaf(-bn[k], gi, Bi);
  }
  const float tr = fmaf(zq.x, Ar, fmaf(-zq.y, Ai, Br));    // z A + Bb
  const float ti = fmaf(zq.x, Ai, fmaf(zq.y, Ar, Bi));
  const float wr = g0r * tr - g0i * ti, wi = g0r * ti + g0i * tr;
  sc = fmaf(g1i, wi, fmaf(-g1r, wr, sc));                  // dc
  sd = fmaf(g0i, wi, fmaf(-g0r, wr, sd));                  // dd
}

// Block (s, m) writes its sums over positions [s span, (s + 1) span) to
// part[s][q][m][n], q = k (da), K + k (db), 2K (dc), 2K + 1 (dd): with one
// split, the outputs themselves.  Warp w takes the block's chunks w,
// w + BWD_WARPS, ... of BWD_CHUNK positions, each staged by the warp
// itself one chunk ahead, so no block barrier stands in the loop.
// Past K 6 the planes' instances spill at 64 registers a thread, so every
// instance there takes one block an SM less (up to 85 registers).
template <int K, bool PAIRED>
__global__ void __launch_bounds__(
    BWD_THREADS, K > 6 ? BWD_BLOCKS_PER_SM - 1 : BWD_BLOCKS_PER_SM)
cauchy_bwd_lanes_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ c,
                        const float* __restrict__ d,
                        const float2* __restrict__ z,
                        const float* __restrict__ g_re,
                        const float* __restrict__ g_im,
                        float* __restrict__ part, int M, int N, int Lz,
                        int span) {
  constexpr int Q = 2 * K + 2;               // sums a state
  extern __shared__ float4 bwd_sh[];
  const int m = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lbeg = blockIdx.x * span, lend = min(Lz, lbeg + span);
  const int chunks = (lend - lbeg + BWD_CHUNK - 1) / BWD_CHUNK;
  float4* mine = bwd_sh + warp * 2 * bwd_stage_f4<K>();

  if (warp < chunks) {
    const int l0 = lbeg + warp * BWD_CHUNK;
    bwd_stage<K, PAIRED>(mine, l0, min(BWD_CHUNK, lend - l0), lane, m, M,
                         Lz, z, g_re, g_im);
  }
  const bool on = lane < N;
  const float cn = on ? c[(size_t)m * N + lane] : 0.0f;
  const float dn = on ? d[(size_t)m * N + lane] : 1.0f;
  float an[K], bn[K], sa[K], sb[K], sc = 0.0f, sd = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    an[k] = on ? a[((size_t)k * M + m) * N + lane] : 0.0f;
    bn[k] = on ? b[((size_t)k * M + m) * N + lane] : 0.0f;
    sa[k] = sb[k] = 0.0f;
  }

  for (int ch = warp, i = 0; ch < chunks; ch += BWD_WARPS, ++i) {
    const int l0 = lbeg + ch * BWD_CHUNK, cnt = min(BWD_CHUNK, lend - l0);
    if (ch + BWD_WARPS < chunks) {
      const int l1 = l0 + BWD_WARPS * BWD_CHUNK;
      bwd_stage<K, PAIRED>(mine + ((i + 1) & 1) * bwd_stage_f4<K>(), l1,
                           min(BWD_CHUNK, lend - l1), lane, m, M, Lz, z,
                           g_re, g_im);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    float4* zs = mine + (i & 1) * bwd_stage_f4<K>();
    const float4* gs = zs + BWD_CHUNK;
    // z^2, formed as kernel 4 forms it
    if (lane < cnt) {
      float4 zq = zs[lane];
      zq.z = zq.x * zq.x - zq.y * zq.y;
      zq.w = 2.0f * zq.x * zq.y;
      zs[lane] = zq;
    }
    __syncwarp();
    if (cnt == BWD_CHUNK) {
#pragma unroll
      for (int j = 0; j < BWD_CHUNK; ++j)
        bwd_position<K>(zs, gs, j, cn, dn, an, bn, sa, sb, sc, sd);
    } else {
      for (int j = 0; j < cnt; ++j)
        bwd_position<K>(zs, gs, j, cn, dn, an, bn, sa, sb, sc, sd);
    }
    __syncwarp();              // this stage is refilled next iteration
  }
  __syncthreads();             // the warps' sums reuse every warp's stages

  // the warps' sums, pairwise in a fixed order, through shared memory
  float* red = reinterpret_cast<float*>(bwd_sh);       // [warp][q][lane]
#pragma unroll
  for (int k = 0; k < K; ++k) {
    red[(warp * Q + k) * 32 + lane] = sa[k];
    red[(warp * Q + K + k) * 32 + lane] = sb[k];
  }
  red[(warp * Q + 2 * K) * 32 + lane] = sc;
  red[(warp * Q + 2 * K + 1) * 32 + lane] = sd;
  __syncthreads();
  for (int i = threadIdx.x; i < Q * 32; i += BWD_THREADS) {
    const int q = i / 32, n = i % 32;
    float v[BWD_WARPS];
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) v[w] = red[(w * Q + q) * 32 + n];
#pragma unroll
    for (int h = 1; h < BWD_WARPS; h *= 2)
#pragma unroll
      for (int w = 0; w < BWD_WARPS; w += 2 * h) v[w] += v[w + h];
    if (n < N)
      part[(((size_t)blockIdx.x * Q + q) * M + m) * N + n] = v[0];
  }
}

// out[i] = the sum of the S blocks' partials part[s][i] in a fixed order:
// four interleaved chains, then their pairwise sum.
__global__ void cauchy_bwd_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int S,
                                         int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int s = 0;
  for (; s + 4 <= S; s += 4) {
    s0 += part[(size_t)s * size + i];
    s1 += part[(size_t)(s + 1) * size + i];
    s2 += part[(size_t)(s + 2) * size + i];
    s3 += part[(size_t)(s + 3) * size + i];
  }
  for (; s < S; ++s) s0 += part[(size_t)s * size + i];
  out[i] = (s0 + s1) + (s2 + s3);
}

template <int K>
int launch_bwd_lanes(const float* a, const float* b, const float* c,
                     const float* d, const float2* z, const float* g_re,
                     const float* g_im, bool paired, float* out,
                     float* part, int M, int N, int Lz, int span, int splits,
                     int smem, cudaStream_t stream) {
  if (smem < bwd_smem_bytes<K>() || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid(splits, M);
  float* dst = splits > 1 ? part : out;
  if (paired)
    cauchy_bwd_lanes_kernel<K, true><<<grid, BWD_THREADS, smem, stream>>>(
        a, b, c, d, z, g_re, g_im, dst, M, N, Lz, span);
  else
    cauchy_bwd_lanes_kernel<K, false><<<grid, BWD_THREADS, smem, stream>>>(
        a, b, c, d, z, g_re, g_im, dst, M, N, Lz, span);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const int size = (2 * K + 2) * M * N;
  cauchy_bwd_reduce_kernel<<<(size + 255) / 256, 256, 0, stream>>>(
      part, out, splits, size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dwst_cauchy(const float* a, const float* b, const float* c,
                           const float* d, const void* z, void* out, int K,
                           int M, int N, int Lz, int threads, int splits,
                           int smem, cudaStream_t stream) {
  // the plan's threads, splits and smem (ops/cauchy.py::
  // cauchy_fwd_plan), taken as given once they cover [0, Lz) and hold
  // the channel's records
  if (K < 1 || K > KMAX || N < 1 || M < 1 || M > 65535 || Lz < 1 ||
      threads < 32 || threads > FWD_THREADS || threads % 32 != 0 ||
      splits < 1 || (long long)(splits - 1) * threads * FWD_P >= Lz ||
      (long long)splits * threads * FWD_P < Lz ||
      (long long)N * fwd_record_f4(K) * 16 > smem || smem > FWD_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const float2* zz = static_cast<const float2*>(z);
  float2* o = static_cast<float2*>(out);
#define DWST_FWD_CASE(KK)                                                  \
  case KK:                                                                 \
    return launch_fwd<KK>(a, b, c, d, zz, o, M, N, Lz, threads, splits,    \
                          smem, stream);
  switch (K) {
    DWST_FWD_CASE(1) DWST_FWD_CASE(2) DWST_FWD_CASE(3) DWST_FWD_CASE(4)
    DWST_FWD_CASE(5) DWST_FWD_CASE(6) DWST_FWD_CASE(7) DWST_FWD_CASE(8)
  }
#undef DWST_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int dwst_cauchy_bwd(const float* a, const float* b, const float* c,
                               const float* d, const void* z,
                               const float* g_re, const float* g_im,
                               int gstride, float* out, float* part, int K,
                               int M, int N, int Lz, int span, int splits,
                               int smem, cudaStream_t stream) {
  // the plan's span, splits and smem (ops/cauchy.py::cauchy_bwd_plan),
  // taken as given once they cover [0, Lz) in whole chunks; g's element
  // stride 1 (two planes) or 2 (one complex tensor's views: g_im one
  // float past g_re, 8-byte aligned)
  const bool paired = gstride == 2;
  if (K < 1 || K > KMAX || N < 1 || N > BWD_LANES || M < 1 || M > 65535 ||
      Lz < 1 || span < BWD_CHUNK || span % BWD_CHUNK != 0 || splits < 1 ||
      (long long)(splits - 1) * span >= Lz ||
      (long long)splits * span < Lz || (gstride != 1 && !paired) ||
      (paired && (g_im != g_re + 1 ||
                  reinterpret_cast<uintptr_t>(g_re) % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  const float2* zz = static_cast<const float2*>(z);
#define DWST_BWD_CASE(KK)                                                  \
  case KK:                                                                 \
    return launch_bwd_lanes<KK>(a, b, c, d, zz, g_re, g_im, paired, out,   \
                                part, M, N, Lz, span, splits, smem,        \
                                stream);
  switch (K) {
    DWST_BWD_CASE(1) DWST_BWD_CASE(2) DWST_BWD_CASE(3) DWST_BWD_CASE(4)
    DWST_BWD_CASE(5) DWST_BWD_CASE(6) DWST_BWD_CASE(7) DWST_BWD_CASE(8)
  }
#undef DWST_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
