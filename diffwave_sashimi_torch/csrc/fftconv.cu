// S4 FFT convolution (kernel 1) and its spectrum gradient (kernel 5).
//
// Kernel 1 replaces the TPU kernel diffwave_sashimi_tpu/ops/fftconv2.py::
// _kernel, called through _conv2_impl.  Sampling form (fftconv2_ln_bias_
// gelu_d), for one (batch b, channel h) row of length L:
//
//   u'[t] = a[b,t] * u[b,h,t] + c[b,t] + bias[b,h]       (t < L, else 0)
//   y     = irfft(rfft(u', n) * khat[h], n)[:L]
//   out   = gelu_erf(y + D[h] * u')
//
// a and c are norm1 (the channel LayerNorm) as a per-position scale and
// shift; bias is the diffusion-step bias; khat is the rfft of the combined
// bidirectional S4 kernel at a power-of-two size n >= L + L_k, L_k <= L
// the S4 kernel's length (the output's first L samples of the circular
// conv are then the linear conv's: no lag wraps onto a tap).  Training form
// (fftconv2 and its custom VJP): out = y with u' = u, and, with the conj
// flag, the same conv with conj(khat), which is its input gradient (the
// kernel k is real, so the adjoint of the cut circular conv is the cut
// circular correlation).
//
// Kernel 1f, the sampling form of the bf16 path (the TPU kernel with
// fast=True and a bf16 layout): u and out are bf16, a, c, bias, khat and D
// f32, the GELU is gelu_fast (activations.cuh), and the D-skip takes the
// f32 u'.  The transform chain stays f32 in shared memory, more exact than
// the TPU kernel's bf16 chain and well inside its ~4e-3 conv budget
// (ops/fftconv_pallas.py:38-41): what bf16 buys on this card is half the
// device-memory bytes of the input and output.
//
// Kernel 1f's training entry (fftconv2 with fast=True, and its input
// gradient, the same call on -kfi) is the plain form templated on bf16: u
// and out bf16, the chain f32.
//
// Kernel 5 replaces fftconv2.py::_dkf_kernel (fftconv2_dkf): the khat
// gradient summed over the batch, in the convention of torch autograd for
// a complex input,
//
//   dkhat[h, k] = c_k sum_b conj(U_b[k]) G_b[k],  U = rfft(u), G = rfft(g)
//
// with c_k = 1/n at the DC and Nyquist bins and 2/n between them (the
// adjoint of irfft).  Kernel 5f (fast=True) is the same code reading bf16
// u and g; the transforms, the sum and the output stay f32 (the TPU
// kernel's bf16 DFT operands cost it ~2e-3 of the result; this kernel
// matches JAX's f32 function of the same inputs instead).  One block per
// channel h walks the batch: it
// transforms u_b, keeps each pair's half-spectrum values in the thread's
// own local array, transforms g_b, and accumulates the products in
// registers of the thread that owns the pair, so the (B, H, n/2+1) spectra
// never reach device memory and the sum over b has a fixed order.
//
// What bounds it on the H100: the transform is ~5 n log2(n) flops per row
// against 8 bytes of input and output per sample, so the passes over the
// data run from shared memory, bound by shared-memory traffic and by the
// block-wide barriers between passes, not by device memory.
//
// Design: one block per row does the whole chain in shared memory, so the
// input is read once and the output written once (plus one re-read of u,
// a, c for the D-skip, which hits L2).  The length-n real FFT is an
// M = n/2 point complex FFT of the packed even/odd samples: 132 KB of
// dynamic shared memory at n = 32768 (the full n-point buffer would not
// fit in a block's 227 KB).  The complex FFTs are the Stockham radix-8
// transforms of fft_stockham.cuh: 5 passes at M = 16384, M / 16 threads
// per row.  The spectrum split, the multiply by khat and the inverse's
// pre-twiddle are one pairwise (k, M-k) pass.  The irfft's 1/n is applied
// in the epilogue.

#include <cuda_runtime.h>

#include "activations.cuh"
#include "fft_stockham.cuh"

namespace {

using namespace dwst_fft;
using namespace dwst_act;

// W^k = exp(-i pi k / M), the twiddle of the packed real transform.
__device__ __forceinline__ float2 half_twiddle(int k, int M) {
  float s, co;
  sincospif((float)k / (float)M, &s, &co);
  return make_float2(co, -s);
}

// z[j] = x[2j] + i x[2j+1] of one real row x (float or bf16) of length L,
// zero past L.
template <typename T>
__device__ void load_packed(float2* z, const T* __restrict__ xr, int L,
                            int M) {
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const int t0 = 2 * j, t1 = t0 + 1;
    z[pad(j)] = make_float2(t0 < L ? to_f(xr[t0]) : 0.0f,
                            t1 < L ? to_f(xr[t1]) : 0.0f);
  }
}

// The real signal's half spectrum at the pair (k, M-k), 0 < k <= M/2, from
// the packed spectrum Z of its even/odd samples:
//   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O)
__device__ __forceinline__ void split_pair(const float2* z, int k, int M,
                                           float2* xk, float2* xm) {
  const float2 zk = z[pad(k)], zm = z[pad(M - k)];
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 dv = csub(zk, cconj(zm));
  const float2 o = make_float2(0.5f * dv.y, -0.5f * dv.x);   // dv / 2i
  const float2 wo = cmul(half_twiddle(k, M), o);
  *xk = cadd(e, wo);
  *xm = cconj(csub(e, wo));
}

// FUSED: the sampling form (prologue a u + c + bias, epilogue D skip +
// GELU); otherwise the plain conv, with conj(khat) when conj != 0.  T is
// the activations' type: float, or bf16 for kernel 1f (the sampling form
// of the bf16 path: the chain stays f32, the GELU is gelu_fast).
template <bool FUSED, typename T>
__global__ void __launch_bounds__(1024)
fftconv_kernel(const T* __restrict__ u, const float* __restrict__ a,
               const float* __restrict__ c, const float* __restrict__ bias,
               const float2* __restrict__ khat, const float* __restrict__ D,
               T* __restrict__ out, int H, int L, int M, int conj) {
  constexpr bool FAST = sizeof(T) == 2;
  extern __shared__ float2 z[];      // M complex values at pad(i)
  const int row = blockIdx.x;        // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const T* ur = u + (size_t)row * L;
  const float* ar = FUSED ? a + (size_t)b * L : nullptr;
  const float* cr = FUSED ? c + (size_t)b * L : nullptr;
  const float bh = FUSED ? bias[row] : 0.0f;
  const float dh = FUSED ? D[h] : 0.0f;
  const float2* kr = khat + (size_t)h * (M + 1);
  const float ksign = conj ? -1.0f : 1.0f;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (FUSED) {
    // prologue while loading: z[j] = u'[2j] + i u'[2j+1], zero past L
    for (int j = tid; j < M; j += nt) {
      const int t0 = 2 * j, t1 = t0 + 1;
      const float v0 = t0 < L ? ar[t0] * to_f(ur[t0]) + cr[t0] + bh : 0.0f;
      const float v1 = t1 < L ? ar[t1] * to_f(ur[t1]) + cr[t1] + bh : 0.0f;
      z[pad(j)] = make_float2(v0, v1);
    }
  } else {
    load_packed(z, ur, L, M);
  }
  __syncthreads();
  fft<false>(z, M, tid, nt);

  // Per pair (k, M-k): split the packed spectrum Z into the real signal's
  // half spectrum X, multiply by khat, and fold the product Y back into
  // the packed spectrum Z' of the inverse:
  //   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
  //   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),     W = exp(-i pi / M)
  //   Z'[k]   = (Y[k] + conj Y[M-k]) + i W^-k (Y[k] - conj Y[M-k])
  //   Z'[M-k] = conj(Y[k] + conj Y[M-k]) + i W^k conj(Y[k] - conj Y[M-k])
  // so that the unnormalised inverse of Z' is n * (y[2j] + i y[2j+1]).
  for (int k = tid; k <= (M >> 1); k += nt) {
    if (k == 0) {
      // DC and Nyquist bins are real: irfft ignores their imaginary parts
      const float2 z0 = z[0];          // pad(0) == 0
      const float y0 = (z0.x + z0.y) * kr[0].x;
      const float yM = (z0.x - z0.y) * kr[M].x;
      z[0] = make_float2(y0 + yM, y0 - yM);
      continue;
    }
    const int mk = M - k;
    float2 xk, xm;
    split_pair(z, k, M, &xk, &xm);
    const float2 w = half_twiddle(k, M);                        // W^k
    const float2 kk = kr[k], km = kr[mk];
    const float2 yk = cmul(xk, make_float2(kk.x, ksign * kk.y));
    const float2 ym = cmul(xm, make_float2(km.x, ksign * km.y));
    const float2 sa = cadd(yk, cconj(ym));
    const float2 sb = csub(yk, cconj(ym));
    z[pad(k)] = cadd(sa, cmuli(cmul(cconj(w), sb)));
    if (mk != k) z[pad(mk)] = cadd(cconj(sa), cmuli(cmul(w, cconj(sb))));
  }
  __syncthreads();
  fft<true>(z, M, tid, nt);

  // epilogue: 1/n; in the sampling form also the D-skip on the f32
  // post-prologue input and GELU (exact, or gelu_fast for bf16)
  const float inv_n = 1.0f / (float)(2 * M);
  T* orow = out + (size_t)row * L;
  for (int j = tid; j < M; j += nt) {
    const float2 v = z[pad(j)];
    const float y[2] = {v.x * inv_n, v.y * inv_n};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * j + e;
      if (t >= L) continue;
      if (!FUSED) {
        orow[t] = from_f<T>(y[e]);
        continue;
      }
      const float v = y[e] + dh * (ar[t] * to_f(ur[t]) + cr[t] + bh);
      orow[t] = from_f<T>(FAST ? gelu_fast(v) : gelu_erf(v));
    }
  }
}

constexpr int MAX_PAIRS = 9;   // pairs (k, M-k), 0 <= k <= M/2, per thread

// Kernel 5 (T float) and 5f (T bf16): one block per channel h; see the
// header.
template <typename T>
__global__ void __launch_bounds__(1024)
fftconv_dkf_kernel(const T* __restrict__ u, const T* __restrict__ g,
                   float2* __restrict__ out, int B, int H, int L, int M) {
  extern __shared__ float2 z[];      // M complex values at pad(i)
  const int h = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  // the thread's pairs k = tid + i nt (i < MAX_PAIRS, k <= M/2): U at
  // (k, M-k) of the current batch row, and the running sums there
  float2 uk[MAX_PAIRS], um[MAX_PAIRS], ak[MAX_PAIRS], am[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i)
    ak[i] = am[i] = make_float2(0.0f, 0.0f);

  for (int b = 0; b < B; ++b) {
    const size_t row = ((size_t)b * H + h) * L;
    load_packed(z, u + row, L, M);
    __syncthreads();
    fft<false>(z, M, tid, nt);
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int k = tid + i * nt;
      if (k > (M >> 1)) break;
      if (k == 0) {            // DC and Nyquist: real
        const float2 z0 = z[0];
        uk[i] = make_float2(z0.x + z0.y, 0.0f);
        um[i] = make_float2(z0.x - z0.y, 0.0f);
      } else {
        split_pair(z, k, M, &uk[i], &um[i]);
      }
    }
    __syncthreads();           // all reads of z done before it is reused
    load_packed(z, g + row, L, M);
    __syncthreads();
    fft<false>(z, M, tid, nt);
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int k = tid + i * nt;
      if (k > (M >> 1)) break;
      float2 gk, gm;
      if (k == 0) {
        const float2 z0 = z[0];
        gk = make_float2(z0.x + z0.y, 0.0f);
        gm = make_float2(z0.x - z0.y, 0.0f);
      } else {
        split_pair(z, k, M, &gk, &gm);
      }
      ak[i] = cadd(ak[i], cmul(cconj(uk[i]), gk));
      am[i] = cadd(am[i], cmul(cconj(um[i]), gm));
    }
    __syncthreads();
  }

  const float edge = 1.0f / (float)(2 * M), inner = 2.0f * edge;
  float2* orow = out + (size_t)h * (M + 1);
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int k = tid + i * nt;
    if (k > (M >> 1)) break;
    const float ck = k == 0 ? edge : inner;
    const float cm = k == 0 ? edge : inner;
    orow[k] = make_float2(ck * ak[i].x, ck * ak[i].y);
    if (M - k != k) orow[M - k] = make_float2(cm * am[i].x, cm * am[i].y);
  }
}

// power of two, 16 <= M <= 16384 (n <= 32768: one block's shared memory)
bool bad_size(int n, int L) {
  const int M = n / 2;
  return n != 2 * M || M < 16 || M > 16384 || (M & (M - 1)) || L > n;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int M, size_t* smem) {
  *smem = (size_t)(M + M / 32) * sizeof(float2);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool FUSED, typename T>
int launch_conv(const T* u, const float* a, const float* c,
                const float* bias, const void* khat, const float* D,
                T* out, int B, int H, int L, int n, int conj,
                cudaStream_t stream) {
  if (bad_size(n, L)) return (int)cudaErrorInvalidValue;
  const int M = n / 2;
  size_t smem;
  const cudaError_t attr = set_smem(fftconv_kernel<FUSED, T>, M, &smem);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = M / VPT;     // each thread holds 16 values per pass
  fftconv_kernel<FUSED, T><<<B * H, threads, smem, stream>>>(
      u, a, c, bias, static_cast<const float2*>(khat), D, out, H, L, M, conj);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkf(const T* u, const T* g, void* out, int B, int H, int L, int n,
               cudaStream_t stream) {
  if (bad_size(n, L)) return (int)cudaErrorInvalidValue;
  const int M = n / 2;
  size_t smem;
  const cudaError_t attr = set_smem(fftconv_dkf_kernel<T>, M, &smem);
  if (attr != cudaSuccess) return (int)attr;
  fftconv_dkf_kernel<T><<<H, M / VPT, smem, stream>>>(
      u, g, static_cast<float2*>(out), B, H, L, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dwst_fftconv_ln_bias_gelu_d(
    const float* u, const float* a, const float* c, const float* bias,
    const void* khat, const float* D, float* out, int B, int H, int L, int n,
    cudaStream_t stream) {
  return launch_conv<true>(u, a, c, bias, khat, D, out, B, H, L, n, 0,
                           stream);
}

// Kernel 1f: u and out bf16, the rest as kernel 1.
extern "C" int dwst_fftconv_ln_bias_gelu_d_bf16(
    const void* u, const float* a, const float* c, const float* bias,
    const void* khat, const float* D, void* out, int B, int H, int L, int n,
    cudaStream_t stream) {
  return launch_conv<true>(static_cast<const __nv_bfloat16*>(u), a, c, bias,
                           khat, D, static_cast<__nv_bfloat16*>(out), B, H,
                           L, n, 0, stream);
}

extern "C" int dwst_fftconv(const float* u, const void* khat, float* out,
                            int B, int H, int L, int n, int conj,
                            cudaStream_t stream) {
  return launch_conv<false, float>(u, nullptr, nullptr, nullptr, khat,
                                   nullptr, out, B, H, L, n, conj, stream);
}

// Kernel 1f's training entry: u and out bf16, the rest as dwst_fftconv.
extern "C" int dwst_fftconv_bf16(const void* u, const void* khat, void* out,
                                 int B, int H, int L, int n, int conj,
                                 cudaStream_t stream) {
  return launch_conv<false>(static_cast<const __nv_bfloat16*>(u), nullptr,
                            nullptr, nullptr, khat, nullptr,
                            static_cast<__nv_bfloat16*>(out), B, H, L, n,
                            conj, stream);
}

extern "C" int dwst_fftconv_dkf(const float* u, const float* g, void* out,
                                int B, int H, int L, int n,
                                cudaStream_t stream) {
  return launch_dkf(u, g, out, B, H, L, n, stream);
}

// Kernel 5f: u and g bf16, out complex64 as kernel 5's.
extern "C" int dwst_fftconv_dkf_bf16(const void* u, const void* g, void* out,
                                     int B, int H, int L, int n,
                                     cudaStream_t stream) {
  return launch_dkf(static_cast<const __nv_bfloat16*>(u),
                    static_cast<const __nv_bfloat16*>(g), out, B, H, L, n,
                    stream);
}
