// Long S4 FFT convolution (kernel 9): the four-step conv through device
// memory, for FFT sizes past one block's shared memory.
//
// Replaces the TPU kernels diffwave_sashimi_tpu/ops/fftconv_pallas.py::
// _kernel (fftconv_fused, the per-row four-step DFT as matmuls) and its
// channel-batched schedule _kernel_batched: the same function,
//
//   y = irfft(rfft(u, n) * khat, n)[:L]
//
// for u (B, H, L) float32 and the spectrum khat of the combined
// bidirectional S4 kernel at any power of two 256 <= n <= 2^20 with
// L <= n, in factorized (k1, k2) order.  The sampling entry adds kernel 1's
// prologue u' = a u + c + bias (a, c (B, L) norm1 as scale and shift; bias
// (B, H) the step bias) and epilogue gelu_erf(y + D u').
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
// What bounds it on the H100: at the vocoder's top tier (B 2, H 128,
// L 143360, n 2^18) the function reads u and the half spectrum once and
// writes y once, 0.43 GB, 0.13 ms at 3.35 TB/s; its ~6 GFLOP of transforms
// take 0.09 ms at the fp32 peak, so device memory bounds it (9f moves its
// activations at 2 bytes, 0.28 GB, 0.08 ms, so there the transforms' fp32
// operations bound it; the scratch round trips cost it the same).  A whole
// complex row of 2^18 values is 2 MB, past one SM's shared memory, so the
// transform cannot stay on chip the way kernel 1's does.
//
// Design, four-step (n = N1 N2, N1 = 2^floor(l/2), N2 = 2^ceil(l/2) for
// n = 2^l; time index t = n1 N2 + n2, frequency k = k1 + N1 k2):
//
//   X[k1 + N1 k2] = sum_n2 W_N2^(n2 k2) W_n^(n2 k1)
//                   sum_n1 W_N1^(n1 k1) x[n1 N2 + n2]
//
// with the scratch S (one complex n-row per (batch pair, channel)) in
// (k1, n2) row-major order throughout, so no transpose is materialised:
//
//   A (cols_fwd): each block takes TC adjacent columns n2 (coalesced rows
//     of u), applies the prologue, zero past L, runs N1-point column FFTs
//     in shared memory, multiplies by W_n^(n2 k1), writes S[k1][n2];
//   B (rows):     each block takes contiguous rows k1 of S, runs the
//     N2-point forward FFT, multiplies by the spectrum at k = k1 + N1 k2
//     (kp[h][k1][k2], permuted once per run), runs the N2-point inverse,
//     multiplies by W_n^(-m2 k1), writes S[k1][m2];
//   C (cols_inv): inverse N1-point column FFTs, 1/n, and only outputs
//     t = m1 N2 + m2 < L written, with the epilogue.
//
// Two batch rows of one channel share one complex transform: k is real, so
// conv(u_b + i u_b+1, k) = conv(u_b, k) + i conv(u_b+1, k) against the
// Hermitian-completed spectrum (H, n), and the real and imaginary parts of
// the result are the two rows' outputs.  That halves the transform work
// with no real-FFT split.  The passes' FFTs are fft_stockham.cuh's.  The
// scratch round trips cost ~4 x 8 n bytes per (pair, channel) beyond the
// bound: a first design, right before fast; keeping a row on chip
// (thread-block clusters sharing shared memory) is later work.

#include <cuda_runtime.h>

#include <algorithm>

#include "activations.cuh"
#include "fft_stockham.cuh"

namespace {

using namespace dwst_fft;
using namespace dwst_act;

constexpr int TC = 16;           // columns per block in passes A and C
constexpr int ROW_THREADS = 256;  // threads per block in pass B

// Shared-memory slots per transform: pad() of N values plus one, so that
// transforms side by side start on different banks.
__host__ __device__ __forceinline__ int slots(int N) {
  return N + N / 32 + 1;
}

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
};

// The conv input at one position: u, or in the sampling form u' = a u + c
// + bias, rounded to bf16 in 9f.  Passes A and C both call it, so the
// D-skip sees the very value that was transformed.
template <bool FUSED, typename T>
__device__ __forceinline__ float conv_in(T u, float a, float c, float bh) {
  if (!FUSED) return to_f(u);
  const float v = a * to_f(u) + c + bh;
  return sizeof(T) == 2 ? round_bf16(v) : v;
}

// The sampling form's output from v = y + D u': gelu_erf(v), or in 9f
// gelu_erf of v rounded to bf16, stored as bf16.
template <typename T>
__device__ __forceinline__ T gelu_out(float v) {
  return from_f<T>(gelu_erf(sizeof(T) == 2 ? round_bf16(v) : v));
}

// Pass A.  blockIdx.x: column tile; blockIdx.y: r = pair * H + h.
template <bool FUSED, typename T>
__global__ void __launch_bounds__(1024)
cols_fwd_kernel(const T* __restrict__ u, const float* __restrict__ a,
                const float* __restrict__ c, const float* __restrict__ bias,
                float2* __restrict__ S, Dims d) {
  extern __shared__ float2 z[];    // TC columns of N1 values
  const int r = blockIdx.y;
  const int p = r / d.H, h = r - p * d.H;
  const int b0 = 2 * p, b1 = b0 + 1;
  const bool two = b1 < d.B;
  const int c0 = blockIdx.x * TC;
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = slots(N1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* u0 = u + ((size_t)b0 * d.H + h) * L;
  const T* u1 = u + ((size_t)b1 * d.H + h) * L;
  const float* a0 = FUSED ? a + (size_t)b0 * L : nullptr;
  const float* a1 = FUSED ? a + (size_t)b1 * L : nullptr;
  const float* s0 = FUSED ? c + (size_t)b0 * L : nullptr;
  const float* s1 = FUSED ? c + (size_t)b1 * L : nullptr;
  const float bh0 = FUSED ? bias[(size_t)b0 * d.H + h] : 0.0f;
  const float bh1 = FUSED && two ? bias[(size_t)b1 * d.H + h] : 0.0f;

  for (int i = tid; i < TC * N1; i += nt) {
    const int n1 = i / TC, cc = i - n1 * TC;
    const int t = n1 * N2 + c0 + cc;
    float v0 = 0.0f, v1 = 0.0f;
    if (t < L) {
      v0 = conv_in<FUSED>(u0[t], FUSED ? a0[t] : 0.0f, FUSED ? s0[t] : 0.0f,
                          bh0);
      if (two)
        v1 = conv_in<FUSED>(u1[t], FUSED ? a1[t] : 0.0f,
                            FUSED ? s1[t] : 0.0f, bh1);
    }
    z[cc * st + pad(n1)] = make_float2(v0, v1);
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

// Pass B.  blockIdx.x: a run of rpb rows k1 of one r.
__global__ void __launch_bounds__(ROW_THREADS)
rows_kernel(float2* __restrict__ S, const float2* __restrict__ kp, Dims d,
            int rpb) {
  extern __shared__ float2 z[];    // rpb rows of N2 values
  const int N1 = d.N1, N2 = d.N2, st = slots(N2);
  const int row0 = blockIdx.x * rpb;           // over (r, k1)
  const int r = row0 / N1, h = r % d.H;
  const int k10 = row0 - r * N1;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* Sb = S + (size_t)row0 * N2;
  const float2* kb = kp + ((size_t)h * N1 + k10) * N2;

  for (int i = tid; i < rpb * N2; i += nt)
    z[(i / N2) * st + pad(i % N2)] = Sb[i];
  __syncthreads();
  const int fpt = N2 / VPT, rr = tid / fpt, lane = tid - rr * fpt;
  fft<false>(z + rr * st, N2, lane, fpt);
  for (int i = tid; i < rpb * N2; i += nt) {
    float2* zi = z + (i / N2) * st + pad(i % N2);
    *zi = cmul(*zi, kb[i]);
  }
  __syncthreads();
  fft<true>(z + rr * st, N2, lane, fpt);
  for (int i = tid; i < rpb * N2; i += nt) {
    const int q = i / N2, m2 = i - q * N2;
    Sb[i] = cmul(z[q * st + pad(m2)],
                 twiddle<true>(m2 * (k10 + q), d.two_over_n));
  }
}

// Pass C.  Grid as pass A.
template <bool FUSED, typename T>
__global__ void __launch_bounds__(1024)
cols_inv_kernel(const float2* __restrict__ S, const T* __restrict__ u,
                const float* __restrict__ a, const float* __restrict__ c,
                const float* __restrict__ bias, const float* __restrict__ D,
                T* __restrict__ out, Dims d) {
  extern __shared__ float2 z[];
  const int r = blockIdx.y;
  const int p = r / d.H, h = r - p * d.H;
  const int b0 = 2 * p, b1 = b0 + 1;
  const bool two = b1 < d.B;
  const int c0 = blockIdx.x * TC;
  const int N1 = d.N1, N2 = d.N2, L = d.L, st = slots(N1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float2* Sr = S + (size_t)r * N1 * N2;

  for (int i = tid; i < TC * N1; i += nt) {
    const int k1 = i / TC, cc = i - k1 * TC;
    z[cc * st + pad(k1)] = Sr[(size_t)k1 * N2 + c0 + cc];
  }
  __syncthreads();
  const int fpt = N1 / VPT, col = tid / fpt;
  fft<true>(z + col * st, N1, tid - col * fpt, fpt);

  const float inv_n = 0.5f * d.two_over_n;
  const size_t o0 = ((size_t)b0 * d.H + h) * L;
  const size_t o1 = ((size_t)b1 * d.H + h) * L;
  const float dh = FUSED ? D[h] : 0.0f;
  const float bh0 = FUSED ? bias[(size_t)b0 * d.H + h] : 0.0f;
  const float bh1 = FUSED && two ? bias[(size_t)b1 * d.H + h] : 0.0f;
  for (int i = tid; i < TC * N1; i += nt) {
    const int m1 = i / TC, cc = i - m1 * TC;
    const int t = m1 * N2 + c0 + cc;
    if (t >= L) continue;
    const float2 v = z[cc * st + pad(m1)];
    const float y0 = v.x * inv_n, y1 = v.y * inv_n;
    if (FUSED) {
      const size_t q0 = (size_t)b0 * L + t, q1 = (size_t)b1 * L + t;
      out[o0 + t] = gelu_out<T>(
          y0 + dh * conv_in<true>(u[o0 + t], a[q0], c[q0], bh0));
      if (two)
        out[o1 + t] = gelu_out<T>(
            y1 + dh * conv_in<true>(u[o1 + t], a[q1], c[q1], bh1));
    } else {
      out[o0 + t] = from_f<T>(y0);
      if (two) out[o1 + t] = from_f<T>(y1);
    }
  }
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

template <bool FUSED, typename T>
int launch_long(const T* u, const float* a, const float* c,
                const float* bias, const void* kp, const float* D,
                void* scratch, T* out, int B, int H, int L, int n,
                cudaStream_t stream) {
  if (bad_size(n, L) || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int l = 0;
  while ((1 << l) < n) ++l;
  Dims d{B, H, L, 1 << (l / 2), 1 << (l - l / 2), 2.0f / (float)n};
  const int R = (B + 1) / 2 * H;     // rows r = pair * H + h
  float2* S = static_cast<float2*>(scratch);

  const size_t smem_col = (size_t)TC * slots(d.N1) * sizeof(float2);
  const int rpb = std::min(ROW_THREADS * VPT / d.N2, d.N1);
  const size_t smem_row = (size_t)rpb * slots(d.N2) * sizeof(float2);
  cudaError_t e;
  if ((e = allow_smem(cols_fwd_kernel<FUSED, T>, smem_col)) != cudaSuccess ||
      (e = allow_smem(rows_kernel, smem_row)) != cudaSuccess ||
      (e = allow_smem(cols_inv_kernel<FUSED, T>, smem_col)) != cudaSuccess)
    return (int)e;

  const dim3 col_grid(d.N2 / TC, R);
  const int col_threads = TC * d.N1 / VPT;
  cols_fwd_kernel<FUSED, T><<<col_grid, col_threads, smem_col, stream>>>(
      u, a, c, bias, S, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  rows_kernel<<<R * d.N1 / rpb, rpb * d.N2 / VPT, smem_row, stream>>>(
      S, static_cast<const float2*>(kp), d, rpb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cols_inv_kernel<FUSED, T><<<col_grid, col_threads, smem_col, stream>>>(
      S, u, a, c, bias, D, out, d);
  return (int)cudaGetLastError();
}

}  // namespace

// kp: (H, N1, N2) complex64, the Hermitian-completed spectrum K[k1 + N1 k2]
// at [h][k1][k2]; scratch: ceil(B/2) H n complex64.
extern "C" int dwst_fftconv_long_ln_bias_gelu_d(
    const float* u, const float* a, const float* c, const float* bias,
    const void* kp, const float* D, void* scratch, float* out, int B, int H,
    int L, int n, cudaStream_t stream) {
  return launch_long<true>(u, a, c, bias, kp, D, scratch, out, B, H, L, n,
                           stream);
}

// Kernel 9f: u and out bf16, the rest as above.
extern "C" int dwst_fftconv_long_ln_bias_gelu_d_bf16(
    const void* u, const float* a, const float* c, const float* bias,
    const void* kp, const float* D, void* scratch, void* out, int B, int H,
    int L, int n, cudaStream_t stream) {
  return launch_long<true>(static_cast<const __nv_bfloat16*>(u), a, c, bias,
                           kp, D, scratch, static_cast<__nv_bfloat16*>(out),
                           B, H, L, n, stream);
}

extern "C" int dwst_fftconv_long(const float* u, const void* kp,
                                 void* scratch, float* out, int B, int H,
                                 int L, int n, cudaStream_t stream) {
  return launch_long<false, float>(u, nullptr, nullptr, nullptr, kp,
                                   nullptr, scratch, out, B, H, L, n, stream);
}
