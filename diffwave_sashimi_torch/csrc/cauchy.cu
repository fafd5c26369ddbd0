// Symmetric Cauchy sum that builds the S4 (NPLR) convolution kernels.
//
// Replaces the TPU kernel diffwave_sashimi_tpu/ops/cauchy_pallas.py::
// _fwd_kernel (called by _cauchy_quad_fwd_impl for cauchy_sym_pallas):
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
// It runs once per sampling run (30 S4 layers), not per step.

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
