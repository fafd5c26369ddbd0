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

namespace {

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
// kernel.)  What bounds it: ~(20 + 10K) flops per (m, n, l) against one
// read of g, so the fp32 CUDA cores.  Design: one block per (m, tile of
// NTN states), its threads striding over l with (2K + 2) NTN register
// accumulators; the denominator chain (den, its scaled reciprocal, G0,
// G1) is built once per (m, n, l) and shared by the K components, and g
// is read once per block for all NTN states.  The sums over l end in a
// fixed-order warp-shuffle and shared-memory tree, so a run repeats bit
// for bit.  The reciprocal scales den by its largest component as the
// forward does: at the Nyquist node z is large (|z| ~ 8e5 at L = 1000),
// and G0 ~ 1/|z|^2 must come out of the same arithmetic as the forward's.

constexpr int NTN = 4;       // states per block
constexpr int NT_BWD = 256;  // threads per block
constexpr int NV = (2 * KMAX + 2) * NTN;   // accumulators per thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT_BWD)
cauchy_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ d,
                  const float2* __restrict__ z, const float2* __restrict__ g,
                  float* __restrict__ da, float* __restrict__ db,
                  float* __restrict__ dc, float* __restrict__ dd, int K,
                  int M, int N, int Lz) {
  __shared__ float red[NT_BWD / 32][NV];
  const int m = blockIdx.y, n0 = blockIdx.x * NTN;
  float cn[NTN], dn[NTN], an[KMAX][NTN], bn[KMAX][NTN];
#pragma unroll
  for (int j = 0; j < NTN; ++j) {
    const int n = n0 + j;
    const bool ok = n < N;
    cn[j] = ok ? c[(size_t)m * N + n] : 0.0f;
    dn[j] = ok ? d[(size_t)m * N + n] : 1.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const bool kk = ok && k < K;
      an[k][j] = kk ? a[((size_t)k * M + m) * N + n] : 0.0f;
      bn[k][j] = kk ? b[((size_t)k * M + m) * N + n] : 0.0f;
    }
  }
  // acc layout: [0, K NTN) da, [KMAX NTN, ...) db, then dc, dd
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;

  for (int l = threadIdx.x; l < Lz; l += NT_BWD) {
    const float2 zl = z[l];
    const float z2r = zl.x * zl.x - zl.y * zl.y;
    const float z2i = 2.0f * zl.x * zl.y;
    float gr[KMAX], gi[KMAX];      // gc_k = gr - i gi
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const float2 gk = k < K ? g[((size_t)k * M + m) * Lz + l]
                              : make_float2(0.0f, 0.0f);
      gr[k] = gk.x;
      gi[k] = gk.y;
    }
#pragma unroll
    for (int j = 0; j < NTN; ++j) {
      const float den_r = z2r + cn[j] * zl.x + dn[j];
      const float den_i = z2i + cn[j] * zl.y;
      const float scale = 1.0f / fmaxf(fabsf(den_r), fabsf(den_i));
      const float sr = den_r * scale, si = den_i * scale;
      const float inv = scale / (sr * sr + si * si);
      const float g0r = sr * inv, g0i = -si * inv;           // 1 / den
      const float g1r = zl.x * g0r - zl.y * g0i;             // z / den
      const float g1i = zl.x * g0i + zl.y * g0r;
      float Ar = 0.0f, Ai = 0.0f, Br = 0.0f, Bi = 0.0f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        acc[k * NTN + j] += gr[k] * g1r + gi[k] * g1i;
        acc[(KMAX + k) * NTN + j] += gr[k] * g0r + gi[k] * g0i;
        Ar += an[k][j] * gr[k];
        Ai -= an[k][j] * gi[k];
        Br += bn[k][j] * gr[k];
        Bi -= bn[k][j] * gi[k];
      }
      const float tr = zl.x * Ar - zl.y * Ai + Br;           // z A + Bb
      const float ti = zl.x * Ai + zl.y * Ar + Bi;
      const float wr = g0r * tr - g0i * ti, wi = g0r * ti + g0i * tr;
      acc[2 * KMAX * NTN + j] -= g1r * wr - g1i * wi;        // dc
      acc[(2 * KMAX + 1) * NTN + j] -= g0r * wr - g0i * wi;  // dd
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float s = warp_sum(acc[v]);
    if (lane == 0) red[warp][v] = s;
  }
  __syncthreads();
  const int v = threadIdx.x;
  if (v >= NV) return;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NT_BWD / 32; ++w) s += red[w][v];
  const int q = v / NTN, n = n0 + v % NTN;
  if (n >= N) return;
  if (q < KMAX) {
    if (q < K) da[((size_t)q * M + m) * N + n] = s;
  } else if (q < 2 * KMAX) {
    if (q - KMAX < K) db[((size_t)(q - KMAX) * M + m) * N + n] = s;
  } else if (q == 2 * KMAX) {
    dc[(size_t)m * N + n] = s;
  } else {
    dd[(size_t)m * N + n] = s;
  }
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
                               const float* d, const void* z, const void* g,
                               float* da, float* db, float* dc, float* dd,
                               int K, int M, int N, int Lz,
                               cudaStream_t stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  dim3 grid((N + NTN - 1) / NTN, M);
  cauchy_bwd_kernel<<<grid, NT_BWD, 0, stream>>>(
      a, b, c, d, static_cast<const float2*>(z),
      static_cast<const float2*>(g), da, db, dc, dd, K, M, N, Lz);
  return (int)cudaGetLastError();
}
