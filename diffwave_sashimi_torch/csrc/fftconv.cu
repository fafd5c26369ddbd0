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
// and out bf16, the chain f32.  Both forms of kernel 1 and of kernel 1f
// also have a radix-16 route (fftconv_r16_kernel<M, FUSED, T>, below),
// which ops/fftconv.py::conv_plan takes at the FFT sizes it has instances
// for (every size the SaShiMi paths launch kernel 1 at); the Stockham
// kernel below serves every other size.  The f32 instances keep kernel
// 1's function to f32 accuracy: twiddles from once-rounded roots, the
// exact GELU, and the D-skip added in the epilogue.
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
// matches JAX's f32 function of the same inputs instead).  Both have two
// routes, chosen by ops/fftconv.py::dkf_plan: the radix-16 route
// (fftconv_dkf_r16_kernel, below: a thread-block cluster a channel, the
// batch's transforms in parallel) at the sizes it has instances for, and
// at every other size the Stockham kernel, where one block per channel h
// walks the batch: it transforms u_b, keeps each pair's half-spectrum
// values in the thread's own local array, transforms g_b, and accumulates
// the products in registers of the thread that owns the pair.  On either
// route the (B, H, n/2+1) spectra never reach device memory and the sum
// over b has a fixed order.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "activations.cuh"
#include "fft_stockham.cuh"

// A probe build (-DDWST_R16_STAMPS, fftconv_phases.py) times the radix-16
// kernel phase by phase: thread 0 of each block (the first 4096) records
// clock64() at each of its R16_STAMPS phase boundaries.  In the shipped
// build R16_STAMP is empty.
#define R16_STAMPS 6
#ifdef DWST_R16_STAMPS
__device__ long long dwst_r16_stamps[4096][R16_STAMPS];
#define R16_STAMP(k) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) \
  dwst_r16_stamps[blockIdx.x][k] = clock64()
#else
#define R16_STAMP(k)
#endif

namespace {

namespace cg = cooperative_groups;
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

// ---- Kernels 1 and 1f on the radix-16 route (both forms) ---------------------
//
// The same functions as fftconv_kernel<*, T>, redesigned for the H100
// (ops/fftconv.py::conv_plan routes each FFT size to it or to that
// kernel).  What held the Stockham kernel back, per (b, h) row at n = 32768:
// 12 shared-memory round trips of the whole 128 KB row and 24 block-wide
// barriers over 32 warps (5 radix-8/4 passes each way, the load, the
// pairwise split pass, the store), a second pass over u, a and c for the
// D-skip, and a transform of the zero half of the input where L <= n/2.
// This kernel:
//
// - folds the D-skip into the spectrum: khat[h, k] + D[h] at every bin is
//   the transform of khat's kernel plus D delta[0], so the conv of u' with
//   it is y + D u', and the epilogue is gelu_fast(y / n) alone, reading
//   nothing from device memory (the f32 transform's rounding of D u' is far
//   below bf16's rounding of the output);
// - takes the M = n/2 point complex transform of the packed row in one
//   radix-R0 pass and P >= 2 radix-16 passes (M = R0 16^P: n 32768 as 4,
//   16, 16, 16; ops/fftconv.py::radix16_plan), each thread holding 32
//   values (two radix-16 butterflies, or 32 / R0 radix-R0 ones) between
//   one read and one write of shared memory, M / 32 threads a row;
// - reads the input straight from device memory into the first pass
//   (radix R0 at Ns = 1), with the prologue, only where t < L: where
//   L <= n/2 the upper half of each butterfly is zero, never loaded and
//   not transformed (dft_lower); and writes the output straight from the
//   last inverse pass (radix R0 at Ns = M/R0) with the epilogue, only
//   where t < L.  The pruning keys on L, so the vocoder's deepest tier
//   (L 8960 > n/2 at n 16384) takes the whole transform;
// - merges the spectrum step into the passes around it: thread t takes,
//   in the last forward pass, butterflies j0 = t and j1 = M/16 - t (M/32
//   for t = 0), whose outputs Z[j + r M/16] hold each bin k with its
//   partner M - k, and the first inverse pass (radix 16 at Ns = 1) reads
//   exactly those slots.  So the thread runs the last forward pass in
//   place, folds its 16 pairs (split, multiply, pack the inverse's input)
//   from its own slots, and transforms them again, with no barrier but
//   the inverse pass's own;
// - lays the row out with one pad slot per 16 values (slot16), so each
//   half warp's 64-bit reads and writes meet 16 distinct bank pairs in
//   every pass (the merged pass's reads of j1, a run that crosses a pad
//   slot, meet one pair twice);
// - stays within 128 registers a thread with no spills, which it needs to
//   run 16 warps an SM: each phase reads threadIdx.x anew (r16_tid), the
//   phases with no barrier in them (load, fold, store) hold one group of
//   values at a time, and every twiddle is one sincospif a thread and
//   phase times constant 32nd roots of unity (root32, which must inline:
//   a call costs a stack frame in the unrolled loops).
//
// So a row takes 8 round trips of shared memory (3 of them the merged
// pass's, of the thread's own slots) and 11 block barriers (n 32768: 512
// threads, 136 KB, one block an SM; smaller n several blocks an SM).  The
// chain stays f32, as in the Stockham kernel.
//
// Kernel 1 (T float: u and out f32) takes the same schedule with three
// changes, so that its error against float64 stays near the plain
// version's (cuFFT's) and its function is the Stockham kernel's:
// - the radix-16 passes twiddle by twiddle16 (products of at most two
//   once-rounded roots, as kernels 5 and 5f do; ROOTS below), not by
//   twiddle_all's running products to W^(15 k), but for the inverse one
//   at n 8192 (INV_ROOTS in the kernel);
// - the D-skip is not folded into the spectrum: the store pass adds D u'
//   to y / n, u' re-read from device memory (L2) and formed as the load
//   pass formed it, then takes the exact GELU (gelu_erf);
// - its loads and stores of the row move f32 pairs, 8 bytes each.

using bf16 = __nv_bfloat16;

constexpr int R16_HELD = 32;       // complex values a thread holds a pass

// Shared-memory slot of value i: one pad slot per 16 values.
__device__ __forceinline__ int slot16(int i) { return i + (i >> 4); }

// threadIdx.x, read anew in each phase (as fftconv_long.cu's phase_tid):
// the phases' slot and position arithmetic then stays apart, where the
// compiler would otherwise keep values common to two phases alive in
// registers across the kernel, past the 128 a thread has.
__device__ __forceinline__ int r16_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__host__ __device__ constexpr int r16_log2(int x) {
  return x <= 1 ? 0 : 1 + r16_log2(x >> 1);
}

// The radix-16 route at M = n/2 (ops/fftconv.py::radix16_plan): P
// radix-16 passes and one of radix R0, NT threads a block, SLOTS 8-byte
// slots of shared memory; MIN_BLOCKS keeps a thread at <= 128 registers.
template <int M>
struct R16 {
  static constexpr int P = (r16_log2(M) - 1) / 4;
  static constexpr int R0 = M >> (4 * P);
  static constexpr int NT = M / R16_HELD;
  static constexpr int SLOTS = M + M / 16;
  static constexpr int MIN_BLOCKS = NT >= 512 ? 1 : 512 / NT;
  static_assert(P >= 2 && R0 >= 2 && R0 <= 16, "M = R0 16^P");
};

// The thread's index in its transform, where a block holds Q transforms of
// R16<M>::NT threads each (kernels 5 and 5f; Q = 1 everywhere else).
template <int M, int Q>
__device__ __forceinline__ int r16_lane() {
  if constexpr (Q == 1) return r16_tid();
  else return r16_tid() & (R16<M>::NT - 1);
}

// exp(-+2 pi i m / N) for 0 <= m < N, N a power of two (exact argument).
template <bool INV>
__device__ __forceinline__ float2 root(int m, int N) {
  float s, c;
  sincospif(2.0f * (float)m / (float)N, &s, &c);
  return make_float2(c, INV ? s : -s);
}

// cos(pi m / 16), 0 <= m <= 16, and exp(-i pi r / 16), 0 <= r < 16: the
// 32nd roots of unity as constants where r is one after unrolling (not
// recursive, so always inlined: a call would cost a stack frame).
__device__ __forceinline__ float cos_pi16(int m) {
  const int a = m > 8 ? 16 - m : m;
  const float c = a == 0 ? 1.0f
                  : a == 1 ? 0.98078528040323044f
                  : a == 2 ? 0.92387953251128674f
                  : a == 3 ? 0.83146961230254524f
                  : a == 4 ? 0.70710678118654752f
                  : a == 5 ? 0.55557023301960222f
                  : a == 6 ? 0.38268343236508977f
                  : a == 7 ? 0.19509032201612826f
                  : 0.0f;
  return m > 8 ? -c : c;
}
__device__ __forceinline__ float2 root32(int r) {
  return make_float2(cos_pi16(r), -cos_pi16(r <= 8 ? 8 - r : r - 8));
}
// exp(-i pi / 32)
constexpr float COS_PI32 = 0.99518472667219689f;
constexpr float SIN_PI32 = 0.09801714032956060f;

// v[q][r] *= w1^r for r = 1 .. R-1 and each of NB butterflies q (one w1
// for all of them), the powers as a running product.
template <int R, int NB>
__device__ __forceinline__ void twiddle_all(float2 (*v)[R], float2 w1) {
  float2 w = w1;
#pragma unroll
  for (int r = 1; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < NB; ++q) v[q][r] = cmul(v[q][r], w);
    if (r + 1 < R) w = cmul(w, w1);
  }
}

// A radix-16 butterfly's twiddles W^(k r), r < 16, W = exp(-+2 pi i / N),
// as the products of at most two of p[s-1] = W^(s k) and q[s-1] = W^(4 s
// k), s = 1 .. 3, each of those one or two once-rounded roots: a power
// carries a few roundings, where twiddle_all's running product carries r
// roundings of W^k.  Kernels 5 and 5f take this form: their error against
// complex128 is held to twice the plain version's (cuFFT's), and running
// products to W^(15 k) in every pass cost about 4x (a plain torch model of
// the schedule, tests/test_torch_dkf_tc.py).
struct Pow16 {
  float2 p[3], q[3];
};

// From the roots a[i] = W^(2^i k), i < 4.
__device__ __forceinline__ Pow16 pow16(float2 a0, float2 a1, float2 a2,
                                       float2 a3) {
  return Pow16{{a0, a1, cmul(a1, a0)}, {a2, a3, cmul(a3, a2)}};
}

// From k and N, 8 k < N (sincospif of exact arguments).
template <bool INV>
__device__ __forceinline__ Pow16 pow16(int k, int N) {
  return pow16(root<INV>(k, N), root<INV>(2 * k, N), root<INV>(4 * k, N),
               root<INV>(8 * k, N));
}

// v[b][r] *= W^(k r) for r = 1 .. 15 and each of NB butterflies b.
template <int NB>
__device__ __forceinline__ void twiddle16(float2 (*v)[16], const Pow16& w) {
#pragma unroll
  for (int r = 1; r < 16; ++r) {
    const int s = r & 3, j = r >> 2;
    const float2 t = j == 0 ? w.p[s - 1]
                     : s == 0 ? w.q[j - 1] : cmul(w.q[j - 1], w.p[s - 1]);
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b][r] = cmul(v[b][r], t);
  }
}

// The forward DFT of R values whose upper half is zero:
// X[2m] = DFT_{R/2}(x)[m], X[2m+1] = DFT_{R/2}(x_r W_R^r)[m].
template <int R>
__device__ __forceinline__ void dft_lower(float2* v) {
  if constexpr (R == 2) {
    v[1] = v[0];
  } else {
    constexpr int H = R / 2;
    float2 e[H], o[H];
#pragma unroll
    for (int r = 0; r < H; ++r) {
      e[r] = v[r];
      o[r] = cmul(v[r], root32(32 / R * r));      // W_R^r
    }
    dft<H, false>(e);
    dft<H, false>(o);
#pragma unroll
    for (int m = 0; m < H; ++m) {
      v[2 * m] = e[m];
      v[2 * m + 1] = o[m];
    }
  }
}

// One Stockham pass in shared memory, radix R at sub-transform size NS:
// butterfly j = tid + q NT (q < 32 / R) reads z[j + r M/R], twiddles by
// W_(NS R)^(k r), k = j mod NS, transforms and (after the barrier)
// writes z[(j - k) R + k + r NS].  ROOTS: the twiddles by twiddle16
// (radix 16, one k a thread; its powers formed before the loads, so that
// they and the roots' arithmetic are not live beside the 32 values), else
// by twiddle_all.  Q: as r16_lane.
template <int M, int R, int NS, bool INV, bool ROOTS = false, int Q = 1>
__device__ __forceinline__ void r16_pass(float2* z) {
  constexpr int NT = R16<M>::NT, NB = R16_HELD / R, S = M / R;
  int tid = r16_lane<M, Q>();
  [[maybe_unused]] Pow16 w;
  if constexpr (NS > 1 && ROOTS) {
    static_assert(R == 16 && NT % NS == 0, "radix 16, one k a thread");
    w = pow16<INV>(tid & (NS - 1), NS * R);
  }
  float2 v[NB][R];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) v[q][r] = z[slot16(tid + q * NT + r * S)];
  if constexpr (NS > 1 && ROOTS) {
    twiddle16<NB>(v, w);
  } else if constexpr (NS > 1) {
    if constexpr (NT % NS == 0) {     // every butterfly of the thread: one k
      twiddle_all<R, NB>(v, root<INV>(tid & (NS - 1), NS * R));
    } else {
#pragma unroll
      for (int q = 0; q < NB; ++q)
        twiddle_all<R, 1>(&v[q],
                          root<INV>((tid + q * NT) & (NS - 1), NS * R));
    }
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) dft<R, INV>(v[q]);
  __syncthreads();
  tid = r16_lane<M, Q>();
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int j = tid + q * NT, k = j & (NS - 1), base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) z[slot16(base + r * NS)] = v[q][r];
  }
  __syncthreads();
}

// The radix-16 passes between the first and the merged pass (forward: NS
// = R0, 16 R0, ...) or between the merged and the last (inverse: NS =
// 16, 256, ...): P - 1 of them (ROOTS, Q: as r16_pass).
template <int M, int I, bool INV, bool ROOTS = false, int Q = 1>
__device__ __forceinline__ void r16_passes(float2* z) {
  if constexpr (I + 1 < R16<M>::P) {
    constexpr int NS = INV ? 1 << (4 * (I + 1)) : R16<M>::R0 << (4 * I);
    r16_pass<M, 16, NS, INV, ROOTS, Q>(z);
    r16_passes<M, I + 1, INV, ROOTS, Q>(z);
  }
}

// The pair (x[2p], x[2p+1]) of a row as one load: 4 bytes of bf16, or 8
// of float.
__device__ __forceinline__ float2 load_pair(const bf16* __restrict__ x,
                                            int p) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x)[p]);
}
__device__ __forceinline__ float2 load_pair(const float* __restrict__ x,
                                            int p) {
  return reinterpret_cast<const float2*>(x)[p];
}

// The conv input's packed value p, (x[2p], x[2p+1]), zero past L: u, or in
// the sampling form a u + c + bias (u bf16 or f32).  VEC (L even, rows
// aligned): one load of u (load_pair) and 8-byte loads of a and c for the
// pair.
template <bool FUSED, bool VEC, typename T>
__device__ __forceinline__ float2 r16_in(const T* __restrict__ ur,
                                         const float* __restrict__ ar,
                                         const float* __restrict__ cr,
                                         float bh, int p, int L) {
  const int t = 2 * p;
  if constexpr (VEC) {
    if (t >= L) return make_float2(0.0f, 0.0f);
    const float2 x = load_pair(ur, p);
    if (!FUSED) return x;
    const float2 av = reinterpret_cast<const float2*>(ar)[p];
    const float2 cv = reinterpret_cast<const float2*>(cr)[p];
    return make_float2(av.x * x.x + cv.x + bh, av.y * x.y + cv.y + bh);
  } else {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = t + e < L ? to_f(ur[t + e]) : 0.0f;
      v[e] = t + e >= L ? 0.0f : FUSED ? ar[t + e] * x + cr[t + e] + bh : x;
    }
    return make_float2(v[0], v[1]);
  }
}

// The first forward pass, radix R0 at Ns = 1, from device memory: packed
// value p = j + r M/R0 is (x[2p], x[2p+1]), loaded only where t < L, a
// group of butterflies at a time (their loads in flight together: GL
// packed values, 8 in the sampling form, whose three loads a value hold
// more registers, 16 in the plain one).  x is bf16, or float for kernel
// 1's and kernel 5's rows; Q: as r16_lane.
template <int M, bool FUSED, bool VEC, int Q = 1, typename T>
__device__ __forceinline__ void r16_load_pass(
    float2* z, const T* __restrict__ ur, const float* __restrict__ ar,
    const float* __restrict__ cr, float bh, int L) {
  constexpr int R = R16<M>::R0, NT = R16<M>::NT, NB = R16_HELD / R;
  constexpr int S = M / R;
  constexpr int GL = FUSED ? 8 : 16;
  constexpr int QG = GL >= R ? GL / R : 1;     // butterflies a group
  // L <= M: p >= M/2 lies past L, so each butterfly's upper half is zero
  const bool lower = L <= M;
#pragma unroll 1
  for (int q0 = 0; q0 < NB; q0 += QG) {
    const int tid = r16_lane<M, Q>();
    float2 v[QG][R];
#pragma unroll
    for (int q = 0; q < QG; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[q][r] = r16_in<FUSED, VEC>(ur, ar, cr, bh,
                                     tid + (q0 + q) * NT + r * S, L);
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      if (lower) dft_lower<R>(v[q]);
      else dft<R, false>(v[q]);
      const int j = tid + (q0 + q) * NT;
#pragma unroll
      for (int r = 0; r < R; ++r) z[slot16(j * R + r)] = v[q][r];
    }
  }
  __syncthreads();
}

// Z'[k] and Z'[M-k] in place of the packed spectrum's Z[k] = zk and
// Z[M-k] = zm (one value at k = M/2, passed as both), w = W^k =
// exp(-i pi k / M), kk and km the conv spectrum at k and M - k:
//   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),  Y = X * spectrum
//   Z'[k]   = (Y[k] + conj Y[M-k]) + i W^-k (Y[k] - conj Y[M-k])
//   Z'[M-k] = conj(Y[k] + conj Y[M-k]) + i W^k conj(Y[k] - conj Y[M-k])
// so that the unnormalised inverse of Z' is n (y[2j] + i y[2j+1]).
__device__ __forceinline__ void fold_pair(float2& zk, float2& zm, float2 w,
                                          float2 kk, float2 km) {
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 dv = csub(zk, cconj(zm));
  const float2 o = make_float2(0.5f * dv.y, -0.5f * dv.x);   // dv / 2i
  const float2 wo = cmul(w, o);
  const float2 yk = cmul(cadd(e, wo), kk);
  const float2 ym = cmul(cconj(csub(e, wo)), km);
  const float2 sa = cadd(yk, cconj(ym));
  const float2 sb = csub(yk, cconj(ym));
  zk = cadd(sa, cmuli(cmul(cconj(w), sb)));
  zm = cadd(cconj(sa), cmuli(cmul(w, cconj(sb))));
}

// The merged pass's pairs.  Thread t >= 1 holds k = t + r M/16 (r < 16),
// whose partners M - k are butterfly j1's; thread 0 k = r M/16 (0 < r <=
// 8; M/2 with itself) and k = M/32 + r M/16 (r < 8), and the real DC and
// Nyquist bins.  r16_bin is the thread's r-th pair's k; r16_pair_root its
// W^k = exp(-i pi k / M), from et = exp(-i pi t / M): et W^(r M/16) for t
// >= 1; for thread 0 W^((r+1) M/16), or W^(M/32) W^((r-8) M/16).
template <int M>
__device__ __forceinline__ int r16_bin(int tid, int r) {
  constexpr int S = M / 16, T = M / 32;
  return tid != 0 ? tid + r * S : r < 8 ? (r + 1) * S : T + (r - 8) * S;
}

__device__ __forceinline__ float2 r16_pair_root(int tid, int r, float2 et) {
  return tid != 0 ? cmul(et, root32(r))
         : r < 8  ? root32(r + 1)
                  : cmul(make_float2(COS_PI32, -SIN_PI32), root32(r - 8));
}

// The last forward pass (radix 16 at Ns = M/16) in place, on the thread's
// butterflies j0 = t and j1 = M/16 - t (M/32 for t = 0): the pass writes
// Z[j + r M/16] to the slots it read, the thread's own, so no barrier is
// needed, and afterwards the thread's slots hold each of its pairs (k, M -
// k).  et = exp(-i pi t / M), the thread's one root: its square W_M^t is
// j0's twiddle, and W_M^(M/16 - t) = W_16 conj(W_M^t) j1's (for thread 0,
// W_M^(M/32) = W_32).
template <int M>
__device__ __forceinline__ void r16_last_forward(float2* z, float2 et) {
  constexpr int S = M / 16, T = M / 32;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int tid = r16_tid();
    const int j = b == 0 ? tid : tid == 0 ? T : S - tid;
    const float2 w0 = cmul(et, et);
    const float2 w1 = b == 0 ? w0
                      : tid == 0 ? root32(1) : cmul(root32(2), cconj(w0));
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = z[slot16(j + r * S)];
    twiddle_all<16, 1>(&v, w1);
    dft<16, false>(v);
#pragma unroll
    for (int r = 0; r < 16; ++r) z[slot16(j + r * S)] = v[r];
  }
}

// r16_last_forward with its twiddles by twiddle16: j0's from the roots
// a[i] = W_M^(2^i t), j1's from W_M^(2^i (M/16 - t)) = W_16^(2^i)
// conj(a[i]) (for thread 0, W_M^(2^i M/32) = W_32^(2^i), constants).
template <int M, int Q>
__device__ __forceinline__ void r16_last_forward_roots(float2* z) {
  constexpr int S = M / 16, T = M / 32;
  float2 a[4];
  const int t = r16_lane<M, Q>();
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = root<false>(t << i, M);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int tid = r16_lane<M, Q>();
    const int j = b == 0 ? tid : tid == 0 ? T : S - tid;
    float2 e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = b == 0 ? a[i]
             : tid == 0 ? root32(1 << i)
                        : cmul(root32(2 << i), cconj(a[i]));
    const Pow16 w = pow16(e[0], e[1], e[2], e[3]);
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = z[slot16(j + r * S)];
    twiddle16<1>(&v, w);
    dft<16, false>(v);
#pragma unroll
    for (int r = 0; r < 16; ++r) z[slot16(j + r * S)] = v[r];
  }
}

// The merged pass: the last forward pass (radix 16 at Ns = M/16) on
// butterflies j0 and j1, the fold of their bins with the spectrum (khat
// + D, or conj(khat)), and the first inverse pass (radix 16 at Ns = 1).
// The last forward pass runs in place (r16_last_forward), and the fold
// reads each pair (k, M - k) in natural order from the thread's own slots:
// the thread holds one butterfly's 16 values, or a pair and two groups of
// spectrum values, until the first inverse pass, whose 32 values cross
// the barrier.  The thread folds its 16 pairs (r16_bin), thread 0 also the
// real DC and Nyquist bins.  ROOTS: the last forward pass twiddles by
// twiddle16 (r16_last_forward_roots).
template <int M, bool ROOTS>
__device__ __forceinline__ void r16_middle(float2* z,
                                           const float2* __restrict__ kr,
                                           float dh, float ksign) {
  constexpr int S = M / 16, T = M / 32, G = 4;
  const auto spec = [&](int k) {
    const float2 s = kr[k];
    return make_float2(s.x + dh, ksign * s.y);
  };
  int tid = r16_tid();
  // the spectrum of the first group of pairs, in flight during the DFTs
  float2 kk[G], km[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    kk[i] = spec(r16_bin<M>(tid, i));
    km[i] = spec(M - r16_bin<M>(tid, i));
  }
  const float2 et = root<false>(tid, 2 * M);     // exp(-i pi t / M)
  if constexpr (ROOTS) r16_last_forward_roots<M, 1>(z);
  else r16_last_forward<M>(z, et);
  tid = r16_tid();
  if (tid == 0) {
    // the DC and Nyquist bins are real: irfft reads only their real parts
    const float2 z0 = z[0];
    const float y0 = (z0.x + z0.y) * (kr[0].x + dh);
    const float yM = (z0.x - z0.y) * (kr[M].x + dh);
    z[0] = make_float2(y0 + yM, y0 - yM);
  }
#pragma unroll
  for (int g = 0; g < 16 / G; ++g) {
    float2 nk[G], nm[G];
    if (g + 1 < 16 / G) {                 // the next group's spectrum
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int k = r16_bin<M>(tid, G * (g + 1) + i);
        nk[i] = spec(k);
        nm[i] = spec(M - k);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = G * g + i, k = r16_bin<M>(tid, r);
      float2* zk = z + slot16(k);
      float2* zm = z + slot16(M - k);
      float2 a = *zk, c = *zm;
      fold_pair(a, c, r16_pair_root(tid, r, et), kk[i], km[i]);
      *zm = c;
      *zk = a;                            // at k = M/2 the same slot
    }
    if (g + 1 < 16 / G) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        kk[i] = nk[i];
        km[i] = nm[i];
      }
    }
  }
  tid = r16_tid();
  const int j0 = tid, j1 = tid == 0 ? T : S - tid;
  float2 A[16], Bv[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    A[r] = z[slot16(j0 + r * S)];
    Bv[r] = z[slot16(j1 + r * S)];
  }
  dft<16, true>(A);
  dft<16, true>(Bv);
  __syncthreads();
  tid = r16_tid();
  const int i0 = tid, i1 = tid == 0 ? T : S - tid;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    z[slot16(i0 * 16 + r)] = A[r];
    z[slot16(i1 * 16 + r)] = Bv[r];
  }
  __syncthreads();
}

// The last inverse pass, radix R0 at Ns = M/R0, to device memory: packed
// output p = j + r M/R0 is n (y[2p] + i y[2p+1]); t = 2p, 2p + 1 stored
// only where t < L, as one store of the pair (4 bytes of bf16, 8 of f32)
// where L is even and the row aligned.  The sampling form's epilogue: T
// bf16 (kernel 1f, the D-skip folded into the spectrum) gelu_fast(y); T
// float (kernel 1) gelu_erf(y + dh u'), u' = a u + c + bias re-read from
// the row as r16_in forms it (ur, ar, cr, bh: as for r16_load_pass; VEC:
// its pair loads).  No barrier follows, so two butterflies at a time.
// ROOTS: at R0 = 16 the twiddles by twiddle16, from once-rounded roots of
// each butterfly's j, one butterfly at a time (two, with their roots, do
// not fit 128 registers); else W_M^-j as one product of roots, its powers
// by twiddle_all (a product or two at R0 <= 4).
template <int M, bool FUSED, bool VEC, bool ROOTS, typename T>
__device__ __forceinline__ void r16_store_pass(
    const float2* z, T* __restrict__ orow, const T* __restrict__ ur,
    const float* __restrict__ ar, const float* __restrict__ cr, float bh,
    float dh, int L) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int R = R16<M>::R0, NT = R16<M>::NT, NB = R16_HELD / R;
  constexpr int S = M / R, QS = NB >= 2 && !(ROOTS && R == 16) ? 2 : 1;
  constexpr float inv_n = 1.0f / (float)(2 * M);
  const bool pairs =
      !(L & 1) && !(reinterpret_cast<size_t>(orow) & (2 * sizeof(T) - 1));
  // butterfly j = t + q M/32 twiddles by W_M^-j = W_M^-t W_32^-q: one
  // root a thread, and a constant a butterfly
  const float2 wt = root<true>(r16_tid(), M);
#pragma unroll 1
  for (int q0 = 0; q0 < NB; q0 += QS) {
    const int tid = r16_tid();
    float2 v[QS][R];
#pragma unroll
    for (int q = 0; q < QS; ++q) {
      const int j = tid + (q0 + q) * NT;
      if constexpr (ROOTS && R == 16) {
        const Pow16 w = pow16<true>(j, M);
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = z[slot16(j + r * S)];
        twiddle16<1>(&v[q], w);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = z[slot16(j + r * S)];
        // W_32^-(q0 + q) = conj(exp(-i pi (q0 + q) / 16)), q0 + q < NB <= 16
        twiddle_all<R, 1>(&v[q], cmul(wt, cconj(root32(q0 + q))));
      }
      dft<R, true>(v[q]);
    }
#pragma unroll
    for (int q = 0; q < QS; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = tid + (q0 + q) * NT + r * S, t = 2 * p;
        float y0 = v[q][r].x * inv_n, y1 = v[q][r].y * inv_n;
        if constexpr (F32) {
          if constexpr (FUSED) {
            const float2 x = r16_in<true, VEC>(ur, ar, cr, bh, p, L);
            y0 = gelu_erf(y0 + dh * x.x);
            y1 = gelu_erf(y1 + dh * x.y);
          }
          if (pairs) {
            if (t < L)
              *reinterpret_cast<float2*>(orow + t) = make_float2(y0, y1);
          } else {
            if (t < L) orow[t] = y0;
            if (t + 1 < L) orow[t + 1] = y1;
          }
        } else {
          if (FUSED) {
            y0 = gelu_fast(y0);
            y1 = gelu_fast(y1);
          }
          if (pairs) {
            if (t < L)
              *reinterpret_cast<__nv_bfloat162*>(orow + t) =
                  __floats2bfloat162_rn(y0, y1);
          } else {
            if (t < L) orow[t] = __float2bfloat16_rn(y0);
            if (t + 1 < L) orow[t + 1] = __float2bfloat16_rn(y1);
          }
        }
      }
  }
}

// One block a (b, h) row, blocks in channel-major order (the B rows of a
// channel read its spectrum back to back).  FUSED: the sampling form;
// otherwise the training entry, with conj(khat) when conj != 0.  T: bf16
// (kernel 1f), or float (kernel 1: the ROOTS twiddles, the D-skip in the
// store pass; see above).
template <int M, bool FUSED, typename T>
__global__ void __launch_bounds__(R16<M>::NT, R16<M>::MIN_BLOCKS)
fftconv_r16_kernel(const T* __restrict__ u, const float* __restrict__ a,
                   const float* __restrict__ c,
                   const float* __restrict__ bias,
                   const float2* __restrict__ khat,
                   const float* __restrict__ D, T* __restrict__ out,
                   int B, int H, int L, int conj) {
  constexpr bool F32 = sizeof(T) == 4;
  // the inverse radix-16 passes' twiddles from roots, but at R0 = 16 (M
  // 4096), where the roots' powers there took a thread past its 128
  // registers (ptxas spilled 76-88 bytes) and the pass takes running
  // products instead: one pass of them kept the float64 error within 1.1x
  // the plain version's on the card (chip_smoke.py's hold_1_routes)
  constexpr bool INV_ROOTS = F32 && R16<M>::R0 < 16;
  extern __shared__ float2 z[];      // R16<M>::SLOTS slots, slot16(i)
  const int h = blockIdx.x / B, b = blockIdx.x - h * B;
  const size_t row = (size_t)b * H + h;
  R16_STAMP(0);
  const T* ur = u + row * L;
  const float* ar = FUSED ? a + (size_t)b * L : a;
  const float* cr = FUSED ? c + (size_t)b * L : c;
  const float bh = FUSED ? bias[row] : 0.0f;
  const float dh = FUSED ? D[h] : 0.0f;
  // pairs of the row as one load of u (4 bytes of bf16, 8 of f32) and one
  // 8-byte load of a and of c each
  const bool vec = !(L & 1) &&
                   !(reinterpret_cast<size_t>(u) & (2 * sizeof(T) - 1)) &&
                   !((reinterpret_cast<size_t>(a) |
                      reinterpret_cast<size_t>(c)) & 7);
  if (vec) r16_load_pass<M, FUSED, true>(z, ur, ar, cr, bh, L);
  else r16_load_pass<M, FUSED, false>(z, ur, ar, cr, bh, L);
  R16_STAMP(1);
  r16_passes<M, 0, false, F32>(z);
  R16_STAMP(2);
  r16_middle<M, F32>(z, khat + (size_t)h * (M + 1), F32 ? 0.0f : dh,
                     conj ? -1.0f : 1.0f);
  R16_STAMP(3);
  r16_passes<M, 0, true, INV_ROOTS>(z);
  R16_STAMP(4);
  if (F32 && vec)
    r16_store_pass<M, FUSED, true, F32>(z, out + row * L, ur, ar, cr, bh, dh,
                                        L);
  else
    r16_store_pass<M, FUSED, false, F32>(z, out + row * L, ur, ar, cr, bh,
                                         dh, L);
  R16_STAMP(5);
}

// ---- Kernels 5 and 5f on the radix-16 route ---------------------------------
//
// The same function as fftconv_dkf_kernel<T>, redesigned for the H100
// (ops/fftconv.py::dkf_plan routes each FFT size to it or to that kernel).
// What held that kernel back: one block a channel walked the batch, 2B
// Stockham transforms one after another (128 blocks at SC09's top tier,
// a wave of one block an SM doing 8 transforms), each with 12 block
// barriers, and its loads wrote all M packed slots where only L/2 are
// nonzero.  This kernel:
//
// - transforms the 2R rows of a chunk of R batch rows (R = rows, at most
//   DKF_MAX_ROWS) all at once, u_b and g_b for each b, Q of them a block
//   (dkf_per_block: 8 at n 2048, else 1), so a channel takes a
//   thread-block cluster of C = ceil(2R / Q) blocks (8 at B4 from n 8192
//   up; at n 2048 1, all in one block); the cluster walks the batch in
//   chunks of R rows;
// - transforms a row as kernel 1f's radix-16 route does (R16<M>, M / 32
//   threads a transform): the load pass reads only the nonzero part of
//   the packed row (r16_load_pass), the radix-16 passes follow, and the
//   last forward pass runs in place (r16_last_forward_roots), so each
//   thread then holds both bins of its 16 pairs (k, M - k) and splits them
//   into the real row's half spectrum X in the same slots, with no barrier
//   (r16_split): slot k holds X[k], slot 0 (X[0], X[M]), both real.  Its
//   twiddles are products of at most two once-rounded roots (twiddle16),
//   not kernel 1f's running products: the transform's error stays near
//   cuFFT's;
// - after a cluster barrier, block c sums the bins [c S, (c+1) S) of the
//   chunk, S = ceil(M / C), reading each row's U and G in its own shared
//   memory or its peers' over the cluster's network (dkf_sum): a warp reads
//   32 adjacent slots of a spectrum at once, and no spectrum reaches device
//   memory;
// - adds the batch terms one by one in b order: each bin's running sum
//   starts at 0, takes conj(U_b) G_b for b = 0, 1, ... in turn, and
//   crosses from one chunk to the next unscaled in the output row (the
//   bins' owner writes and re-reads its own values), the last chunk
//   writing c_k times the sum.  The order is the same for every chunk
//   size, so the result is the same bit for bit for any plan; no atomics.
//
// What bounds it: the transforms' fp32 operations and shared-memory round
// trips (a row takes 5-6 of them: the load pass, the radix-16 passes, the
// in-place last pass and split), then the read of (C-1)/C of 2R half
// spectra of M/C bins from the cluster's network a block a chunk, which
// on an H100 ran at about 13 bytes a cycle an SM, a block's own slots
// read through it no faster: 28% of a block's cycles at n = 32768
// (fftconv_phases.py).  There a block holds 139 KB and takes a whole SM,
// so the card runs one transform an SM at a time, and 15 clusters of 8
// fit at once.

constexpr int DKF_MAX_ROWS = 4;    // batch rows a chunk: <= 8 transforms

// The last forward pass in place (r16_last_forward_roots), then each of
// the thread's pairs (k, M - k) split into the real row's half spectrum in
// the same two slots:
//   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),   W = exp(-i pi / M);
// thread 0 also writes (X[0], X[M]) = (Re + Im, Re - Im) of Z[0] to slot 0.
template <int M, int Q>
__device__ __forceinline__ void r16_split(float2* z) {
  r16_last_forward_roots<M, Q>(z);
  const int tid = r16_lane<M, Q>();
  const float2 et = root<false>(tid, 2 * M);     // exp(-i pi t / M)
  if (tid == 0) {
    const float2 z0 = z[0];
    z[0] = make_float2(z0.x + z0.y, z0.x - z0.y);
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int k = r16_bin<M>(tid, r);
    float2* zk = z + slot16(k);
    float2* zm = z + slot16(M - k);
    const float2 a = *zk, c = *zm;
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 dv = csub(a, cconj(c));
    const float2 o = make_float2(0.5f * dv.y, -0.5f * dv.x);   // dv / 2i
    const float2 wo = cmul(r16_pair_root(tid, r, et), o);
    *zm = cconj(csub(e, wo));
    *zk = cadd(e, wo);                      // at k = M/2 the same value
  }
}

// One chunk's batch terms, for the block's bins [lo, hi): the rows' half
// spectra U (spectra 0 .. nr-1 of the cluster) and G (spectra rows ..
// rows+nr-1), spectrum s in transform s mod Q of block s / Q, read in the
// block's own or its peers' shared memory.  Each bin's sum starts at 0 in
// the first chunk, else at the unscaled sum the block left in orow; the
// last chunk writes c_k times it (c_k = 1/n at the DC and Nyquist bins,
// 2/n between), every other chunk the sum itself.
template <int M, int Q>
__device__ __forceinline__ void dkf_sum(const float2* z,
                                        float2* __restrict__ orow, int lo,
                                        int hi, int rows, int nr, bool first,
                                        bool last) {
  constexpr int NT = R16<M>::NT, SLOTS = R16<M>::SLOTS;
  constexpr float edge = 1.0f / (float)(2 * M), inner = 2.0f * edge;
  const auto spectrum = [&](int s) {
    return cluster_addr(z + s % Q * SLOTS, s / Q);
  };
  unsigned ua[DKF_MAX_ROWS], ga[DKF_MAX_ROWS];
#pragma unroll
  for (int i = 0; i < DKF_MAX_ROWS; ++i) {
    ua[i] = spectrum(i < nr ? i : 0);
    ga[i] = spectrum(i < nr ? rows + i : 0);
  }
#pragma unroll 2
  for (int k = lo + r16_tid(); k < hi; k += Q * NT) {
    const unsigned off = (unsigned)(slot16(k) * sizeof(float2));
    float2 uv[DKF_MAX_ROWS], gv[DKF_MAX_ROWS];
#pragma unroll
    for (int i = 0; i < DKF_MAX_ROWS; ++i) {
      if (i < nr) {
        uv[i] = ld_cluster(ua[i] + off);
        gv[i] = ld_cluster(ga[i] + off);
      }
    }
    float2 acc = first ? make_float2(0.0f, 0.0f) : orow[k];
    if (k == 0) {             // (DC, Nyquist), both real
#pragma unroll
      for (int i = 0; i < DKF_MAX_ROWS; ++i) {
        if (i < nr) {
          acc.x += uv[i].x * gv[i].x;
          acc.y += uv[i].y * gv[i].y;
        }
      }
      if (last) {
        orow[0] = make_float2(edge * acc.x, 0.0f);
        orow[M] = make_float2(edge * acc.y, 0.0f);
      } else {
        orow[0] = acc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DKF_MAX_ROWS; ++i)
        if (i < nr) acc = cadd(acc, cmul(cconj(uv[i]), gv[i]));
      orow[k] = last ? make_float2(inner * acc.x, inner * acc.y) : acc;
    }
  }
}

// %cluster_ctarank, read anew in each phase (as r16_tid): values kept
// across the transform would cost registers its passes need.
__device__ __forceinline__ int dkf_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The transforms a block of kernels 5 and 5f holds at M
// (ops/fftconv.py::DKF_PER_BLOCK): at n 2048 a transform is one warp, and
// a chunk's eight (256 threads, 70 KB) sum in the block's own shared
// memory with no cluster; a larger transform takes 128-512 threads, and
// several in one block would lose what separate blocks an SM give, one
// block's loads under another's passes.
template <int M>
constexpr int dkf_per_block() {
  return M == 1024 ? 2 * DKF_MAX_ROWS : 1;
}

// Kernel 5 (T float) and 5f (T bf16) on the radix-16 route: Q transforms
// a block, a cluster of C = ceil(2 rows / Q) blocks a channel, blocks in
// channel-major order (the launch's cluster dimension is C); see above.
template <int M, int Q, typename T>
__global__ void __launch_bounds__(Q * R16<M>::NT,
                                  Q * R16<M>::NT >= 512 ? 1
                                  : 512 / (Q * R16<M>::NT))
fftconv_dkf_r16_kernel(const T* __restrict__ u, const T* __restrict__ g,
                       float2* __restrict__ out, int B, int H, int L,
                       int rows) {
  constexpr int NT = R16<M>::NT;
  extern __shared__ float2 z[];      // Q transforms of R16<M>::SLOTS slots
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (2 * rows + Q - 1) / Q;
  for (int b0 = 0; b0 < B; b0 += rows) {
    R16_STAMP(0);
    {
      // the transform's spectrum s: u of the chunk's row s, or g of row
      // s - rows; one past the chunk's rows transforms zeros (Lq 0), as
      // its block's barriers need, or with Q 1 is skipped
      const int q = r16_tid() / NT, s = dkf_rank() * Q + q;
      const int r = s < rows ? s : s - rows;
      const bool live = s < 2 * rows && b0 + r < B;
      if (Q > 1 || live) {
        const int Lq = live ? L : 0;
        const T* xr = live ? (s < rows ? u : g) +
                                 ((size_t)(b0 + r) * H + blockIdx.x / C) * L
                           : u;
        float2* zq = z + q * R16<M>::SLOTS;
        // pairs of a row as one load each (load_pair)
        const bool vec = !(L & 1) && !((reinterpret_cast<size_t>(u) |
                                        reinterpret_cast<size_t>(g)) &
                                       (2 * sizeof(T) - 1));
        if (vec)
          r16_load_pass<M, false, true, Q>(zq, xr, nullptr, nullptr, 0.0f,
                                           Lq);
        else
          r16_load_pass<M, false, false, Q>(zq, xr, nullptr, nullptr, 0.0f,
                                            Lq);
        R16_STAMP(1);
        r16_passes<M, 0, false, true, Q>(zq);
        R16_STAMP(2);
        r16_split<M, Q>(zq);
      }
    }
    R16_STAMP(3);
    cluster.sync();
    R16_STAMP(4);
    {
      const int span = (M + C - 1) / C;
      const int lo = min(M, dkf_rank() * span);
      dkf_sum<M, Q>(z, out + (size_t)(blockIdx.x / C) * (M + 1), lo,
                    min(M, lo + span), rows, min(rows, B - b0), b0 == 0,
                    b0 + rows >= B);
    }
    R16_STAMP(5);
    cluster.sync();
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

// Kernels 5 and 5f on the radix-16 route at M = n/2, with the plan's rows,
// threads and shared-memory bytes (ops/fftconv.py::dkf_plan), which must be
// this instance's: dkf_per_block<M>() transforms a block.
template <int M, typename T>
int launch_dkf_r16_at(const T* u, const T* g, void* out, int B, int H,
                      int L, int rows, int threads, int smem,
                      cudaStream_t stream) {
  constexpr int Q = dkf_per_block<M>();
  if (threads != Q * R16<M>::NT
      || smem != Q * R16<M>::SLOTS * (int)sizeof(float2) || rows < 1
      || rows > DKF_MAX_ROWS || B < 1 || H < 1 || L < 1 || L > 2 * M)
    return (int)cudaErrorInvalidValue;
  const int C = (2 * rows + Q - 1) / Q;
  const auto kernel = fftconv_dkf_r16_kernel<M, Q, T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, u, g, static_cast<float2*>(out), B, H, L, rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel 5 or 5f on the route of the plan (rows, threads, smem): rows 0
// the Stockham kernel (threads and smem 0; it sizes its own launch),
// rows > 0 the radix-16 route.
template <typename T>
int launch_dkf_plan(const T* u, const T* g, void* out, int B, int H, int L,
                    int n, int rows, int threads, int smem,
                    cudaStream_t stream) {
  if (rows == 0) {
    if (threads != 0 || smem != 0) return (int)cudaErrorInvalidValue;
    return launch_dkf(u, g, out, B, H, L, n, stream);
  }
  switch (n) {
    case 2048:
      return launch_dkf_r16_at<1024>(u, g, out, B, H, L, rows, threads, smem,
                                     stream);
    case 8192:
      return launch_dkf_r16_at<4096>(u, g, out, B, H, L, rows, threads, smem,
                                     stream);
    case 16384:
      return launch_dkf_r16_at<8192>(u, g, out, B, H, L, rows, threads, smem,
                                     stream);
    case 32768:
      return launch_dkf_r16_at<16384>(u, g, out, B, H, L, rows, threads,
                                      smem, stream);
    default:
      return (int)cudaErrorInvalidValue;   // no instance at this n
  }
}

// Kernel 1's (T float) or 1f's (T bf16) radix-16 route at M = n/2, with
// the plan's threads and shared-memory bytes (ops/fftconv.py::
// radix16_plan), which must be this instance's.
template <int M, bool FUSED, typename T>
int launch_r16_at(const T* u, const float* a, const float* c,
                  const float* bias, const void* khat, const float* D,
                  T* out, int B, int H, int L, int conj, int threads,
                  int smem, cudaStream_t stream) {
  if (threads != R16<M>::NT || smem != R16<M>::SLOTS * (int)sizeof(float2)
      || L < 1 || L > 2 * M)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      fftconv_r16_kernel<M, FUSED, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  fftconv_r16_kernel<M, FUSED, T><<<B * H, threads, smem, stream>>>(
      u, a, c, bias, static_cast<const float2*>(khat), D, out, B, H, L,
      conj);
  return (int)cudaGetLastError();
}

template <bool FUSED, typename T>
int launch_r16(const T* u, const float* a, const float* c,
               const float* bias, const void* khat, const float* D, T* out,
               int B, int H, int L, int n, int conj, int threads, int smem,
               cudaStream_t stream) {
  switch (n) {
    case 2048:
      return launch_r16_at<1024, FUSED>(u, a, c, bias, khat, D, out, B, H,
                                        L, conj, threads, smem, stream);
    case 8192:
      return launch_r16_at<4096, FUSED>(u, a, c, bias, khat, D, out, B, H,
                                        L, conj, threads, smem, stream);
    case 16384:
      return launch_r16_at<8192, FUSED>(u, a, c, bias, khat, D, out, B, H,
                                        L, conj, threads, smem, stream);
    case 32768:
      return launch_r16_at<16384, FUSED>(u, a, c, bias, khat, D, out, B, H,
                                         L, conj, threads, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;   // no instance at this n
  }
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

// Kernel 5 with its plan (rows, threads, smem; ops/fftconv.py::dkf_plan).
extern "C" int dwst_fftconv_dkf(const float* u, const float* g, void* out,
                                int B, int H, int L, int n, int rows,
                                int threads, int smem, cudaStream_t stream) {
  return launch_dkf_plan(u, g, out, B, H, L, n, rows, threads, smem, stream);
}

// Kernel 5f: u and g bf16, out complex64 as kernel 5's.
extern "C" int dwst_fftconv_dkf_bf16(const void* u, const void* g, void* out,
                                     int B, int H, int L, int n, int rows,
                                     int threads, int smem,
                                     cudaStream_t stream) {
  return launch_dkf_plan(static_cast<const bf16*>(u),
                         static_cast<const bf16*>(g), out, B, H, L, n, rows,
                         threads, smem, stream);
}

// Kernel 1 on its radix-16 route: the arguments of
// dwst_fftconv_ln_bias_gelu_d and the route's plan.
extern "C" int dwst_fftconv_r16_ln_bias_gelu_d(
    const float* u, const float* a, const float* c, const float* bias,
    const void* khat, const float* D, float* out, int B, int H, int L, int n,
    int threads, int smem, cudaStream_t stream) {
  return launch_r16<true>(u, a, c, bias, khat, D, out, B, H, L, n, 0,
                          threads, smem, stream);
}

// Kernel 1f on its radix-16 route: the arguments of
// dwst_fftconv_ln_bias_gelu_d_bf16 and the route's plan.
extern "C" int dwst_fftconv_r16_ln_bias_gelu_d_bf16(
    const void* u, const float* a, const float* c, const float* bias,
    const void* khat, const float* D, void* out, int B, int H, int L, int n,
    int threads, int smem, cudaStream_t stream) {
  return launch_r16<true>(static_cast<const bf16*>(u), a, c, bias, khat, D,
                          static_cast<bf16*>(out), B, H, L, n, 0, threads,
                          smem, stream);
}

// Kernel 1's training entry on its radix-16 route: the arguments of
// dwst_fftconv and the route's plan.
extern "C" int dwst_fftconv_r16(const float* u, const void* khat, float* out,
                                int B, int H, int L, int n, int conj,
                                int threads, int smem, cudaStream_t stream) {
  return launch_r16<false, float>(u, nullptr, nullptr, nullptr, khat, nullptr,
                                  out, B, H, L, n, conj, threads, smem,
                                  stream);
}

// Kernel 1f's training entry on its radix-16 route: the arguments of
// dwst_fftconv_bf16 and the route's plan.
extern "C" int dwst_fftconv_r16_bf16(const void* u, const void* khat,
                                     void* out, int B, int H, int L, int n,
                                     int conj, int threads, int smem,
                                     cudaStream_t stream) {
  return launch_r16<false>(static_cast<const bf16*>(u), nullptr, nullptr,
                           nullptr, khat, nullptr, static_cast<bf16*>(out),
                           B, H, L, n, conj, threads, smem, stream);
}

#ifdef DWST_R16_STAMPS
extern "C" int dwst_read_r16_stamps(void* dst, int stamps) {
  if (stamps != R16_STAMPS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, dwst_r16_stamps,
                                   sizeof(dwst_r16_stamps));
}
#endif
