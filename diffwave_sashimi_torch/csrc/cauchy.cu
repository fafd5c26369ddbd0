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
// What bounds it on the H100: ~(13 + 8K) flops per (m, n, l) and one
// division, against K complex outputs per (m, l): at N = 32 states it is
// compute bound (fp32 CUDA cores); device memory sees only the output.
//
// Design: one thread per (m, l) with 2K register accumulators, looping
// over n; the block's row coefficients (c, d and the K rows of a, b) are
// staged in shared memory and read as broadcasts.  The reciprocal is
// computed with the denominator scaled by its largest component, so the
// huge z at the Nyquist node (1 + omega nearly 0) cannot overflow |den|^2.
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
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
cauchy_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, const float* __restrict__ d,
              const float2* __restrict__ z, float2* __restrict__ out, int K,
              int M, int N, int Lz) {
  extern __shared__ float sh[];
  float* sc = sh;             // N
  float* sd = sc + N;         // N
  float* sa = sd + N;         // K x N
  float* sb = sa + K * N;     // K x N
  const int m = blockIdx.y;
  for (int i = threadIdx.x; i < N; i += NT) {
    sc[i] = c[(size_t)m * N + i];
    sd[i] = d[(size_t)m * N + i];
  }
  for (int i = threadIdx.x; i < K * N; i += NT) {
    const int k = i / N, n = i - k * N;
    sa[i] = a[((size_t)k * M + m) * N + n];
    sb[i] = b[((size_t)k * M + m) * N + n];
  }
  __syncthreads();
  const int l = blockIdx.x * NT + threadIdx.x;
  if (l >= Lz) return;
  const float2 zl = z[l];
  const float z2r = zl.x * zl.x - zl.y * zl.y;
  const float z2i = 2.0f * zl.x * zl.y;
  float acc_r[KMAX], acc_i[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc_r[k] = acc_i[k] = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float den_r = z2r + sc[n] * zl.x + sd[n];
    const float den_i = z2i + sc[n] * zl.y;
    // g = 1 / den = conj(den) / |den|^2, with den scaled into range first
    const float scale = 1.0f / fmaxf(fabsf(den_r), fabsf(den_i));
    const float dr = den_r * scale, di = den_i * scale;
    const float inv = scale / (dr * dr + di * di);
    const float g_r = dr * inv, g_i = -di * inv;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float an = sa[k * N + n], bn = sb[k * N + n];
        const float num_r = an * zl.x + bn, num_i = an * zl.y;
        acc_r[k] += num_r * g_r - num_i * g_i;
        acc_i[k] += num_i * g_r + num_r * g_i;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < K)
      out[((size_t)k * M + m) * Lz + l] = make_float2(acc_r[k], acc_i[k]);
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
// at the Nyquist node, where z is huge (|z| ~ 8e5 at L = 1000); G0 then
// differs from the forward's (two IEEE divisions) by about one rounding,
// which the CPU tests' Nyquist-tail case shows is harmless.
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
                           int M, int N, int Lz, cudaStream_t stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 + 2 * K) * N * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((Lz + NT - 1) / NT, M);
  cauchy_kernel<<<grid, NT, smem, stream>>>(
      a, b, c, d, static_cast<const float2*>(z), static_cast<float2*>(out),
      K, M, N, Lz);
  return (int)cudaGetLastError();
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
