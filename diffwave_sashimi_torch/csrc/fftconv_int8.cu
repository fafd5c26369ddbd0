// The int8 S4 convolution, sampling form (kernel 12).
//
// Replaces the int8 branch of diffwave_sashimi_tpu/ops/fftconv2.py::_kernel
// (qscale != None; switched on by set_int8, the factor matrices from
// _consts_q8): kernel 1's sampling function, for one (batch b, channel h)
// row of length L,
//
//   u'[t] = a[b,t] * u[b,h,t] + c[b,t] + bias[b,h]       (t < L, else 0)
//   out   = gelu(conv(u', k)[t] + D[h] * u'[t])
//
// with the length-n DFTs of the conv factored four-step, n = R S, t =
// t1 S + t2 (t1 < Rc, Rc S >= L), and the four DFT stages run as int8 x
// int8 -> int32 tensor-core products (mma.sync m16n8k32):
//
//   S1  A[t2, kr]  = sum_t1 x[t2, t1] Dr[t1, kr]            (x = u')
//   tw  B = A exp(-2 pi i t2 kr / n)
//   S2  [Xr; Xi]   = DsP [Br; Bi]          (ks < S/2: the half spectrum)
//   *   Y = X K,   K[ks, kr] = c_k khat[kr + R ks]  (c_k the irfft scale)
//   iA  [Zr; Zi]   = EsP [Yr; Yi],  Zr[t2, 0] += (-1)^t2 y_nyq
//   tw  T = Z exp(+2 pi i t2 kr / n)
//   iB  y[t2, t1]  = sum_kr Tr Er_re - Ti Er_im
//
// The factor matrices (Dr, DsP, EsP, Er; the TPU kernel's) are quantized
// per tensor on the host (scale max|m| / 127, round half to even:
// ops/int8conv.py).  Each stage's input gets a fresh symmetric scale,
// max|t| / 127 over this row's whole stage tensor, and the int32 result is
// dequantized by the product of the two scales.  Scale granularity: one per
// stage per (b, h) row, which is the TPU kernel's at one channel per
// program (HB = 1).  The Nyquist bin (ks = S/2, kr = 0) is the TPU
// kernel's rank-1 Alt path: its int8 DFT is an alternating sum of the
// quantized Br column kr = 0, and its inverse, which quantizes exactly
// (a single nonzero value), is added in float.  Twiddles, the spectrum
// product and the epilogue are f32, as in the TPU kernel's f32 form, in
// both of this kernel's forms: T = float (I/O f32, exact GELU) and T =
// bf16 (I/O bf16, gelu_fast; the TPU kernel's bf16 form also rounds each
// stage's output to bf16, which this one does not, as kernel 1f keeps its
// chain f32).
//
// The row's mean (a departure from the TPU kernel, given W): the DiffWave
// step bias shifts each (b, h) row by a constant, whose window spectrum
// (~n mu / (pi k) at the low bins k) then sets every stage's per-tensor
// scale and leaves the rest of the spectrum a few steps of the int8 grid.
// The TPU algorithm loses ~1e-1 of the output's max on such rows at n =
// 32768 and fails BASELINE.md's quality gate at d128/n6 (PERF.md).  So
// the mean mu of u' over t < L is taken out before the int8 chain, and its
// conv, mu W[h, t] with W = conv(1[t < L], k) computed in f32 once per run
// (ops/int8conv.py::int8_spectrum), is added back in float.  With W null
// the kernel is the TPU algorithm unchanged.
//
// Layout: the TPU kernel's family (R = 256, S = n / 256 at n = 32768 and
// 8192) except that S is at least 32 (R = 64, S = 32 at n = 2048, where
// the TPU's S = 8), because every product's contraction must be a
// multiple of mma's k = 32 and S is the contraction of the iA stage.
//
// What bounds it on the H100: per row, 4 (R Rc S + 2 R S^2) int8 MACs
// (67 M int ops at n = 32768) against 2-4 bytes of input and output per
// sample: far below the int8 tensor rate's balance, so the bound is the
// activation bytes, and the real cost is in the passes between the
// products (twiddles, the spectrum product, quantization) and the
// block-wide max of each stage.
//
// Design: one block of 512 threads per row keeps the whole chain on
// chip.  A stage's scale needs the max over the whole stage tensor before
// any of it is quantized, and at n = 32768 that tensor, complex (S x R)
// f32, is 256 KB, more than a block's 227 KB.  So each of the first three
// stages runs twice: once for the max of its float outputs, once more to
// quantize them as they come out of the registers.  The int8 products are
// cheap here; a round trip through device memory, or rounding the stage to
// bf16 to stage it on chip, would not be.  The quantized outputs go
// straight into the int8 operand buffer of the next product (two buffers
// in turn, 132 KB at n = 32768), in the layout that product reads
// (contraction innermost, rows padded by 16 bytes so the fragment loads
// hit distinct banks).  Warps take 16 x 8 output tiles in turn; the
// constant factors' fragments are read from global memory (the same for
// every block, so L2-resident).  The output goes through shared memory in
// time order, so the input and the output are read and written coalesced
// (u read once per pass of the first stage and once for the D-skip).
// Simple first: no cp.async, no overlap between stages.

#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"

namespace {

using namespace dwst_act;

constexpr int NT = 512;          // threads per block
constexpr int NW = NT / 32;      // warps
constexpr int PAD = 16;          // bytes of pad per int8 operand row

// Scales of the quantized constants, in the order of the host's list.
enum { S_DRR, S_DRI, S_DSP, S_ESP, S_ERR, S_ERI, S_ALT, N_QS = 8 };

struct Dims {
  int n, R, S, Rc, L;
};

// Shared-memory bytes of the operand buffers (rows padded by PAD):
// A holds x (S x Rc), then Y (R x S), then the f32 output (S Rc floats);
// B holds B (R x 2S), then T (2S x R).
__host__ __device__ inline int a_bytes(const Dims& d) {
  const int x = d.S * (d.Rc + PAD), y = d.R * (d.S + PAD);
  const int o = 4 * d.S * d.Rc;
  return x > y ? (x > o ? x : o) : (y > o ? y : o);
}
__host__ __device__ inline int b_bytes(const Dims& d) {
  const int bb = d.R * (2 * d.S + PAD), t = 2 * d.S * (d.R + PAD);
  return bb > t ? bb : t;
}

__device__ __forceinline__ void mma_s8(int* d, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// The A fragment (16 x 32, row-major, contraction innermost, row stride
// lda bytes) of rows m0.., columns k0..: lane (g = lane / 4, q = lane % 4)
// holds rows g and g + 8 at columns 4q.. and 16 + 4q..
__device__ __forceinline__ void frag_a(int* a, const int8_t* A, int lda,
                                       int m0, int k0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int8_t* p = A + (size_t)(m0 + g) * lda + k0 + 4 * q;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * lda);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * lda + 16);
}

// The B fragment (32 x 8) of columns n0.. from B stored column-major
// (each column's contraction contiguous, column stride ldb bytes).
__device__ __forceinline__ void frag_b(int* b, const int8_t* Bt, int ldb,
                                       int n0, int k0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int8_t* p = Bt + (size_t)(n0 + g) * ldb + k0 + 4 * q;
  b[0] = ld32(p);
  b[1] = ld32(p + 16);
}

// max over the block of v (every thread calls it; every thread gets it).
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) m = fmaxf(m, red[i]);
  return m;
}

// sum over the block of v (every thread calls it; every thread gets it).
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

// The TPU kernel's q8 scale: max(max|t|, 1e-20) / 127.
__device__ __forceinline__ float q8_scale(float amax) {
  return fmaxf(amax, 1e-20f) * (1.0f / 127.0f);
}

// round(v / s), half to even; the clamp only guards against a max that
// a recomputed value exceeds by a rounding
__device__ __forceinline__ int8_t q8(float v, float inv) {
  return (int8_t)max(-127, min(127, __float2int_rn(v * inv)));
}

// The float arithmetic that feeds a quantizer, rounded op by op (no
// contraction into fma), as the plain version computes it: the int8
// codes then come out the same, not only nearly the same.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// (a.x + i a.y) (w.x + i w.y)
__device__ __forceinline__ float2 cmul_rn(float ar, float ai, float2 w) {
  return make_float2(sub(mul(ar, w.x), mul(ai, w.y)),
                     add(mul(ar, w.y), mul(ai, w.x)));
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
fftconv_int8_kernel(const T* __restrict__ u, const float* __restrict__ a,
                    const float* __restrict__ c,
                    const float* __restrict__ bias,
                    const float2* __restrict__ khat,
                    const float* __restrict__ D,
                    const float* __restrict__ W,
                    const int8_t* __restrict__ qc,
                    const float* __restrict__ qs, T* __restrict__ out,
                    int H, Dims d) {
  // qs: the scales, then the twiddles exp(-2 pi i t2 kr / n), [S][R]
  const float2* tw = reinterpret_cast<const float2*>(qs + N_QS);
  constexpr bool FAST = sizeof(T) == 2;
  const int n = d.n, R = d.R, S = d.S, Rc = d.Rc, L = d.L;
  const int Q2 = S / 2;
  extern __shared__ float4 smem4[];
  // two operand buffers, in turn written by one stage and read by the next
  int8_t* Ab = reinterpret_cast<int8_t*>(smem4);      // x, then Y, then y
  int8_t* Bb = Ab + a_bytes(d);                        // B, then T
  float* yf = reinterpret_cast<float*>(smem4);        // the output (in A)
  __shared__ float red[NW];
  __shared__ double red_d[NW];
  __shared__ float nyq_s;

  const int row = blockIdx.x, b = row / H, h = row - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* ur = u + (size_t)row * L;
  const float* ar = a + (size_t)b * L;
  const float* cr = c + (size_t)b * L;
  const float bh = bias[row];
  const float2* kh = khat + (size_t)h * (n / 2 + 1);
  auto u_pro = [&](int t) {          // u'[t], 0 past L
    return t < L ? add(add(mul(ar[t], to_f(ur[t])), cr[t]), bh) : 0.0f;
  };

  // the quantized constants (layout: ops/int8conv.py::int8_consts)
  const int8_t* DrrT = qc;                       // [R][Rc]
  const int8_t* DriT = DrrT + R * Rc;            // [R][Rc]
  const int8_t* DsPp = DriT + R * Rc;            // [S][2S], rows paired
  const int8_t* EsPp = DsPp + 2 * S * S;         // [2S][S], rows paired
  const int8_t* ErrT = EsPp + 2 * S * S;         // [Rc][R]
  const int8_t* EriT = ErrT + R * Rc;            // [Rc][R]
  const int ldx = Rc + PAD, ldb = 2 * S + PAD, ldy = S + PAD, ldt = R + PAD;

  // ---- x[t2][t1] = u'[t1 S + t2] - mu (t < L), quantized ------------
  float mu = 0.0f;
  if (W != nullptr) {
    double sum = 0.0;
    for (int t = tid; t < L; t += NT) sum += (double)u_pro(t);
    mu = (float)(block_sum(sum, red_d) / (double)L);
  }
  auto x_of = [&](int t) { return t < L ? sub(u_pro(t), mu) : 0.0f; };
  float m = 0.0f;
  for (int t = tid; t < Rc * S; t += NT) m = fmaxf(m, fabsf(x_of(t)));
  float sc = q8_scale(block_max(m, red));
  float inv = 1.0f / sc;
  for (int t = tid; t < Rc * S; t += NT)
    Ab[(t % S) * ldx + t / S] = q8(x_of(t), inv);
  __syncthreads();

  // ---- S1 and twiddle -> B[kr][j], j < S: Br[t2 = j], else Bi[j - S] ---
  {
    const float sr = sc * qs[S_DRR], si = sc * qs[S_DRI];
    const int MT = S / 16, NTL = R / 8;
    for (int pass = 0; pass < 2; ++pass) {
      m = 0.0f;
      for (int unit = warp; unit < MT * NTL; unit += NW) {
        const int m0 = (unit % MT) * 16, n0 = (unit / MT) * 8;
        int accr[4] = {0, 0, 0, 0}, acci[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < Rc; k0 += 32) {
          int fa[4], fr[2], fi[2];
          frag_a(fa, Ab, ldx, m0, k0, lane);
          frag_b(fr, DrrT, Rc, n0, k0, lane);
          frag_b(fi, DriT, Rc, n0, k0, lane);
          mma_s8(accr, fa, fr);
          mma_s8(acci, fa, fi);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t2 = m0 + (lane >> 2) + (i >> 1) * 8;
          const int kr = n0 + 2 * (lane & 3) + (i & 1);
          const float xr = (float)accr[i] * sr, xi = (float)acci[i] * si;
          const float2 bb = cmul_rn(xr, xi, tw[t2 * R + kr]);
          const float br = bb.x, bi = bb.y;
          if (pass) {
            Bb[kr * ldb + t2] = q8(br, inv);
            Bb[kr * ldb + S + t2] = q8(bi, inv);
          } else {
            m = fmaxf(m, fmaxf(fabsf(br), fabsf(bi)));
          }
        }
      }
      if (!pass) {
        sc = q8_scale(block_max(m, red));
        inv = 1.0f / sc;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the Nyquist row: X_nyq[kr = 0] = alt . quantized Br[:, 0] (Alt8
    // quantizes to +-127); its spectrum value is real, the only one of the
    // row that the irfft keeps
    int s = 0;
    for (int j = lane; j < S; j += 32) s += (j & 1 ? -1 : 1) * Bb[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float x = (float)(127 * s) * (sc * qs[S_ALT]);
      nyq_s = mul(x, mul(kh[n / 2].x, 1.0f / (float)n));
    }
  }

  // ---- S2 and spectrum product -> Y[kr][j], j < Q2: Yr[ks = j], else Yi
  {
    const float sx = sc * qs[S_DSP];
    const float c_in = 2.0f / (float)n;
    const int MT = S / 16, NTL = R / 8;
    for (int pass = 0; pass < 2; ++pass) {
      m = 0.0f;
      for (int unit = warp; unit < MT * NTL; unit += NW) {
        const int mt = unit % MT, n0 = (unit / MT) * 8;
        int acc[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < 2 * S; k0 += 32) {
          int fa[4], fb[2];
          frag_a(fa, DsPp, 2 * S, mt * 16, k0, lane);
          frag_b(fb, Bb, ldb, n0, k0, lane);
          mma_s8(acc, fa, fb);
        }
        // rows g / g + 8 of tile mt: Xr / Xi of ks = 8 mt + g
        const int ks = 8 * mt + (lane >> 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kr = n0 + 2 * (lane & 3) + e;
          const int k = kr + R * ks;
          const float2 kk = kh[k];
          const float ck = k == 0 ? 0.5f * c_in : c_in;
          const float xr = (float)acc[e] * sx, xi = (float)acc[e + 2] * sx;
          const float2 y = cmul_rn(xr, xi,
                                   make_float2(mul(ck, kk.x), mul(ck, kk.y)));
          const float yr = y.x, yi = y.y;
          if (pass) {
            Ab[kr * ldy + ks] = q8(yr, inv);
            Ab[kr * ldy + Q2 + ks] = q8(yi, inv);
          } else {
            m = fmaxf(m, fmaxf(fabsf(yr), fabsf(yi)));
          }
        }
      }
      if (!pass) {
        sc = q8_scale(block_max(m, red));
        inv = 1.0f / sc;
      }
    }
  }
  __syncthreads();

  // ---- iA and twiddle -> Tr[t2][kr], Ti[t2][kr] (two scales) ----------
  float s_tr = 0.0f, s_ti = 0.0f;
  {
    const float sz = sc * qs[S_ESP];
    const float yn = nyq_s;
    float ir = 0.0f, ii = 0.0f;
    const int MT = 2 * S / 16, NTL = R / 8;
    for (int pass = 0; pass < 2; ++pass) {
      float mr = 0.0f, mi = 0.0f;
      for (int unit = warp; unit < MT * NTL; unit += NW) {
        const int mt = unit % MT, n0 = (unit / MT) * 8;
        int acc[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < S; k0 += 32) {
          int fa[4], fb[2];
          frag_a(fa, EsPp, S, mt * 16, k0, lane);
          frag_b(fb, Ab, ldy, n0, k0, lane);
          mma_s8(acc, fa, fb);
        }
        // rows g / g + 8 of tile mt: Zr / Zi of t2 = 8 mt + g
        const int t2 = 8 * mt + (lane >> 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kr = n0 + 2 * (lane & 3) + e;
          float zr = (float)acc[e] * sz;
          const float zi = (float)acc[e + 2] * sz;
          if (kr == 0) zr = add(zr, (t2 & 1) ? -yn : yn);
          const float2 w = tw[t2 * R + kr];
          const float2 tt = cmul_rn(zr, zi, make_float2(w.x, -w.y));
          const float tr = tt.x, ti = tt.y;
          if (pass) {
            Bb[t2 * ldt + kr] = q8(tr, ir);
            Bb[(S + t2) * ldt + kr] = q8(ti, ii);
          } else {
            mr = fmaxf(mr, fabsf(tr));
            mi = fmaxf(mi, fabsf(ti));
          }
        }
      }
      if (!pass) {
        s_tr = q8_scale(block_max(mr, red));
        s_ti = q8_scale(block_max(mi, red));
        ir = 1.0f / s_tr;
        ii = 1.0f / s_ti;
      }
    }
  }
  __syncthreads();

  // ---- iB: y[t2][t1], kept in time order t = t1 S + t2 -----------------
  {
    const float sr = s_tr * qs[S_ERR], si = s_ti * qs[S_ERI];
    const int MT = S / 16, NTL = Rc / 8;
    for (int unit = warp; unit < MT * NTL; unit += NW) {
      const int m0 = (unit % MT) * 16, n0 = (unit / MT) * 8;
      int accr[4] = {0, 0, 0, 0}, acci[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < R; k0 += 32) {
        int fr[4], fi[4], br[2], bi[2];
        frag_a(fr, Bb, ldt, m0, k0, lane);
        frag_a(fi, Bb + S * ldt, ldt, m0, k0, lane);
        frag_b(br, ErrT, R, n0, k0, lane);
        frag_b(bi, EriT, R, n0, k0, lane);
        mma_s8(accr, fr, br);
        mma_s8(acci, fi, bi);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t2 = m0 + (lane >> 2) + (i >> 1) * 8;
        const int t1 = n0 + 2 * (lane & 3) + (i & 1);
        yf[t1 * S + t2] = sub((float)accr[i] * sr, (float)acci[i] * si);
      }
    }
  }
  __syncthreads();

  // ---- epilogue: the mean's conv, D-skip on the f32 u', GELU -----------
  const float dh = D[h];
  const float* wr = W == nullptr ? nullptr : W + (size_t)h * L;
  T* orow = out + (size_t)row * L;
  for (int t = tid; t < L; t += NT) {
    const float y = wr == nullptr ? yf[t] : add(yf[t], mul(mu, wr[t]));
    const float v = add(y, mul(dh, u_pro(t)));
    orow[t] = from_f<T>(FAST ? gelu_fast(v) : gelu_erf(v));
  }
}

size_t smem_bytes(const Dims& d) { return a_bytes(d) + b_bytes(d); }

bool bad_dims(const Dims& d) {
  auto pow2 = [](int v) { return v > 0 && !(v & (v - 1)); };
  return !pow2(d.n) || !pow2(d.R) || !pow2(d.S) || !pow2(d.Rc) ||
         d.R * d.S != d.n || d.S < 32 || d.R < 32 || d.Rc < 32 ||
         d.Rc > d.R || d.Rc * d.S < d.L || d.L < 1;
}

template <typename T>
int launch(const T* u, const float* a, const float* c, const float* bias,
           const void* khat, const float* D, const float* W, const void* qc,
           const float* qs, T* out, int B, int H, Dims d,
           cudaStream_t stream) {
  if (bad_dims(d)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  const cudaError_t e = cudaFuncSetAttribute(
      fftconv_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fftconv_int8_kernel<T><<<B * H, NT, smem, stream>>>(
      u, a, c, bias, static_cast<const float2*>(khat), D, W,
      static_cast<const int8_t*>(qc), qs, out, H, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 12.  u, out: (B, H, L), bf16 when bf16 != 0 else f32; a, c (B, L),
// bias (B, H), D (H,) f32; khat (H, n/2 + 1) complex64; W (H, L) f32 the
// conv of the window 1[t < L], or null for no mean split; qc the quantized
// factors, qs their scales (8 floats) and the twiddles (S R complex64)
// (ops/int8conv.py::int8_consts).
extern "C" int dwst_fftconv_int8(const void* u, const float* a,
                                 const float* c, const float* bias,
                                 const void* khat, const float* D,
                                 const float* W, const void* qc,
                                 const float* qs, void* out, int B, int H,
                                 int L, int n, int R, int S, int Rc, int bf16,
                                 cudaStream_t stream) {
  const Dims d{n, R, S, Rc, L};
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(u), a, c, bias, khat, D,
                  W, qc, qs, static_cast<__nv_bfloat16*>(out), B, H, d,
                  stream);
  return launch(static_cast<const float*>(u), a, c, bias, khat, D, W, qc, qs,
                static_cast<float*>(out), B, H, d, stream);
}
