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
// chain f32).  Every float operation that feeds a quantizer is rounded op
// by op (the _rn intrinsics, never contracted into an fma), and the int32
// sums are exact in any order, so the codes are the plain version's.
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
// the kernel is the TPU algorithm unchanged.  The mean's double sum runs in
// one fixed order at every block size: VT strands, strand v summing t = v,
// v + VT, ... in turn, then each warp's 32 strands by a butterfly, then the
// VT / 32 warp sums in order.
//
// Layout: the TPU kernel's family (R = 256, S = n / 256 at n = 32768 and
// 8192) except that S is at least 32 (R = 64, S = 32 at n = 2048, where
// the TPU's S = 8), because every product's contraction must be a
// multiple of mma's k = 32 and S is the contraction of the iA stage.
//
// What bounds it on the H100: per row, 4 (R Rc S + 2 R S^2) int8 MACs
// (67 M int ops at n = 32768) against 2-4 bytes of input and output per
// sample: far below the int8 tensor rate's balance, so the bound is the
// activation bytes.  What a row costs is on chip: the products, each run
// twice for the first three stages (below), at mma.sync's rate, the f32
// passes between them (dequantization, twiddles, the spectrum product,
// quantization), the twiddle and spectrum reads from L2 (1.3 MB a row at
// n = 32768), a block barrier for each stage's max, and the latency of
// the input's reads before the first product and the output's after the
// last.
//
// Design: one block per row keeps the whole chain on chip.  A stage's
// scale needs the max over the whole stage tensor before any of it is
// quantized, and at n = 32768 that tensor, complex (S x R) f32, is 256
// KB, more than a block's 227 KB.  So each of the first three stages runs
// twice: once for the max of its float outputs, once more to quantize them
// as they come out of the registers (recomputing is cheap once the factors
// are on chip; an f32 scratch in device memory would move 512 KB a row).
// The quantized outputs go straight into the int8 operand buffer of the
// next product (regions A and B in turn), in the layout that product reads
// (contraction innermost, rows padded by 16 bytes: a row's stride is an
// odd number of 16-byte units, so ldmatrix's eight rows hit distinct
// banks).  Each stage's int8 factors (Dr, DsP, EsP, Er) are copied once
// into region F by cp.async, and where ops/int8conv.py::int8_plan finds
// room the next stage's are copied during the current stage (at the
// SC09 tiers every stage's).  Each warp takes output tiles of 2 x 2 (S1,
// iB, two products) or 2 x 4 (S2, iA) mma tiles, its fragments loaded by
// ldmatrix from shared memory (the int8 rows viewed as b16), so one
// fragment feeds two or four products; the tile's twiddles or spectrum
// values are loaded into registers before its products, so their L2
// latency runs under the mma loop.  The output goes through shared memory
// (a chunk of t1 columns at a time, rows padded by 4 floats) in time
// order, so the input and the output are read and written coalesced; x is
// read once into registers (XW words a thread; a layout with more reads the
// rest again), and quantized four t1 values a thread into one 32-bit
// store.  The plan
// (threads a block, regions, offsets, chunk, prefetches) is computed in
// Python alone, and the kernel takes it as given.

#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"
#include "cp_async.cuh"

namespace {

using namespace dwst_act;
using namespace dwst_async;

constexpr int PAD = 16;          // bytes of pad per int8 operand row
constexpr int OPAD = 4;          // floats of pad per output-staging row
constexpr int VT = 512;          // the mean's strands (its sum's order)
constexpr int REG_THREADS = 512; // threads an SM at 128 registers a thread
constexpr int XW = 8;            // x's 32-bit words a thread in registers

// Scales of the quantized constants, in the order of the host's list.
enum { S_DRR, S_DRI, S_DSP, S_ESP, S_ERR, S_ERI, S_ALT, N_QS = 8 };

#ifdef DWST_INT8_STAMPS
// timing builds (int8_parts.py): thread 0 of each block records clock64()
// at the stage boundaries (0-10) and inside the first part, after the mean
// (11), x's max (12) and x's stores (13)
constexpr int N_STAMPS = 14, STAMP_BLOCKS = 8192;
__device__ long long g_stamps[STAMP_BLOCKS * N_STAMPS];
#define STAMP(k)                                                  \
  do {                                                            \
    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS)            \
      g_stamps[blockIdx.x * N_STAMPS + (k)] = clock64();          \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

struct Dims {
  int n, R, S, Rc, L;
};

// ops/int8conv.py::int8_plan: the regions (A at 0: x, then Y, then an
// output chunk; B: B, then T; F: the factors), each stage's factors'
// offset in F, S1's factor panels over kr, iB's output chunk (t1
// columns), whether Er is staged a chunk at a time, and the prefetches
// (bit s: stage s's factors copied during stage s - 1)
struct Plan {
  int b_off, f_off;
  int foff[4];
  int panels, chunk, er_chunked, prefetch;
};

__device__ __forceinline__ void mma_s8(int* d, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 16-byte matrices of shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i holds bytes 4 (l % 4).. of row
// l / 4 of matrix i
__device__ __forceinline__ void ldsm4(int* r, const int8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// A warp's tile of NP products C_p = A_p B_p (k < K): TM x TN mma tiles
// at (m0, n0), acc[p][i][j] the 16 x 8 tile (m0 + 16 i, n0 + 8 j).  A_p is
// row-major (row stride lda bytes), B_p stored by column (each column's
// contraction contiguous, stride ldb), both in shared memory; A_1 is A_0
// where SHARE_A.  The A fragment of a 16 x 32 tile (lane (g, q): rows g and
// g + 8 at columns 4q.. and 16 + 4q..) is one ldmatrix of its four 8 x 16
// quarters in fragment order; one ldmatrix gives the B fragments of two
// n-tiles.
template <int NP, int TM, int TN, bool SHARE_A>
__device__ __forceinline__ void warp_mma(int (&acc)[NP][TM][TN][4],
                                         const int8_t* A0, const int8_t* A1,
                                         int lda, const int8_t* B0,
                                         const int8_t* B1, int ldb, int m0,
                                         int n0, int K, int lane) {
  static_assert(TN % 2 == 0, "B fragments come in pairs of n-tiles");
  constexpr int NA = SHARE_A ? 1 : NP;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0;
  const int8_t* A[2] = {A0 + (m0 + (lane & 15)) * lda + 16 * (lane >> 4),
                        A1 + (m0 + (lane & 15)) * lda + 16 * (lane >> 4)};
  const int8_t* Bc[2] = {
      B0 + (n0 + (lane & 7) + 8 * (lane >> 4)) * ldb + 16 * ((lane >> 3) & 1),
      B1 + (n0 + (lane & 7) + 8 * (lane >> 4)) * ldb +
          16 * ((lane >> 3) & 1)};
  for (int k0 = 0; k0 < K; k0 += 32) {
    int fa[NA][TM][4], fb[NP][TN][2];
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i) ldsm4(fa[p][i], A[p] + 16 * i * lda + k0);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        int r[4];
        ldsm4(r, Bc[p] + 8 * j * ldb + k0);
        fb[p][j][0] = r[0];
        fb[p][j][1] = r[1];
        fb[p][j + 1][0] = r[2];
        fb[p][j + 1][1] = r[3];
      }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          mma_s8(acc[p][i][j], fa[SHARE_A ? 0 : p][i], fb[p][j]);
  }
}

// cp.async of `rows` rows of w bytes (w a power of two >= 32) from src
// (dense) to dst (row stride w + PAD), 16 bytes a copy, by the whole block
template <int NT>
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* src,
                                           int rows, int w) {
  const int sh = __ffs(w) - 1 - 4;           // log2(w / 16)
  for (int i = threadIdx.x; i < rows << sh; i += NT) {
    const int r = i >> sh, c = (i - (r << sh)) * 16;
    cp_async16(dst + r * (w + PAD) + c, src + r * w + c);
  }
}

// max over the block of v (every thread calls it; every thread gets it).
template <int NT>
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

// The TPU kernel's q8 scale: max(max|t|, 1e-20) / 127.
__device__ __forceinline__ float q8_scale(float amax) {
  return fmaxf(amax, 1e-20f) * (1.0f / 127.0f);
}

// round(v / s), half to even; the clamp only guards against a max that
// a recomputed value exceeds by a rounding
__device__ __forceinline__ int q8(float v, float inv) {
  return max(-127, min(127, __float2int_rn(v * inv)));
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

// two adjacent twiddles (kr even; the table's rows 16-byte aligned) and
// two spectrum values (8-byte aligned only: a channel's n/2 + 1 is odd);
// a timing build without their reads takes constants
__device__ __forceinline__ float4 ld_tw2(const float2* tw, int i) {
#ifdef DWST_INT8_NO_TWIDDLE
  return make_float4(1.0f, 0.0f, 1.0f, 0.0f);
#else
  return __ldg(reinterpret_cast<const float4*>(tw + i));
#endif
}
__device__ __forceinline__ float4 ld_kh2(const float2* kh, int k) {
#ifdef DWST_INT8_NO_TWIDDLE
  return make_float4(1.0f, 0.0f, 1.0f, 0.0f);
#else
  const float2 a = __ldg(kh + k), b = __ldg(kh + k + 1);
  return make_float4(a.x, a.y, b.x, b.y);
#endif
}
__device__ __forceinline__ float2 half2of(const float4& v, int e) {
  return e ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT, REG_THREADS / NT)
fftconv_int8_kernel(const T* __restrict__ u, const float* __restrict__ a,
                    const float* __restrict__ c,
                    const float* __restrict__ bias,
                    const float2* __restrict__ khat,
                    const float* __restrict__ D,
                    const float* __restrict__ W,
                    const int8_t* __restrict__ qc,
                    const float* __restrict__ qs, T* __restrict__ out,
                    int H, Dims d, Plan pl) {
  constexpr int NW = NT / 32;
  // qs: the scales, then the twiddles exp(-2 pi i t2 kr / n), [S][R]
  const float2* tw = reinterpret_cast<const float2*>(qs + N_QS);
  constexpr bool FAST = sizeof(T) == 2;
  const int n = d.n, R = d.R, S = d.S, Rc = d.Rc, L = d.L;
  const int Q2 = S / 2;
  extern __shared__ float4 smem4[];
  int8_t* Ab = reinterpret_cast<int8_t*>(smem4);      // x, then Y
  int8_t* Bb = Ab + pl.b_off;                          // B, then T
  int8_t* Fb = Ab + pl.f_off;                          // the factors
  float* yf = reinterpret_cast<float*>(smem4);        // an output chunk
  __shared__ float red[NW];
  __shared__ double red_d[VT / 32];
  __shared__ float nyq_s;

  const int row = blockIdx.x, b = row / H, h = row - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const T* ur = u + (size_t)row * L;
  const float* ar = a + (size_t)b * L;
  const float* cr = c + (size_t)b * L;
  const float bh = bias[row];
  const float2* kh = khat + (size_t)h * (n / 2 + 1);
  // u'[t] (t < L); the loops below clamp t into the row and drop what
  // lies past L, so that a batch of reads is issued before any is used
  auto u_pro = [&](int t) {
    return add(add(mul(ar[t], to_f(ur[t])), cr[t]), bh);
  };

  // the quantized constants (layout: ops/int8conv.py::int8_consts)
  const int8_t* DrrT = qc;                       // [R][Rc]
  const int8_t* DriT = DrrT + R * Rc;            // [R][Rc]
  const int8_t* DsPp = DriT + R * Rc;            // [S][2S], rows paired
  const int8_t* EsPp = DsPp + 2 * S * S;         // [2S][S], rows paired
  const int8_t* ErrT = EsPp + 2 * S * S;         // [Rc][R]
  const int8_t* EriT = ErrT + R * Rc;            // [Rc][R]
  const int ldx = Rc + PAD, ldb = 2 * S + PAD, ldy = S + PAD, ldt = R + PAD;
  const int ldo = S + OPAD;
  const int RP = R / pl.panels;                  // S1's kr a panel
  const int ER = pl.er_chunked ? pl.chunk : Rc;  // Er's rows staged at once
  // stage s's factors (part: S1's panel, or iB's chunk) into F
  auto load_stage = [&](int s, int part) {
    int8_t* f = Fb + pl.foff[s];
    if (s == 0) {
      stage_rows<NT>(f, DrrT + part * RP * Rc, RP, Rc);
      stage_rows<NT>(f + RP * ldx, DriT + part * RP * Rc, RP, Rc);
    } else if (s == 1) {
      stage_rows<NT>(f, DsPp, S, 2 * S);
    } else if (s == 2) {
      stage_rows<NT>(f, EsPp, 2 * S, S);
    } else {
      stage_rows<NT>(f, ErrT + part * ER * R, ER, R);
      stage_rows<NT>(f + ER * ldt, EriT + part * ER * R, ER, R);
    }
    cp_async_commit();
  };
  auto staged = [&]() {              // every copy issued so far has landed
    cp_async_wait<0>();
    __syncthreads();
  };

  STAMP(0);
  load_stage(0, 0);                  // under the mean and x

  // ---- x[t2][t1] = u'[t1 S + t2] - mu (t < L), quantized ------------
  float mu = 0.0f;
  if (W != nullptr) {
    constexpr int KS = VT / NT;      // strands a thread: tid + k NT
    double part[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      double s = 0.0;
      for (int t0 = tid + k * NT; t0 < L; t0 += 8 * VT) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = u_pro(min(t0 + i * VT, L - 1));
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (t0 + i * VT < L) s += (double)v[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      part[k] = s;
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < KS; ++k) red_d[warp + k * NW] = part[k];
    __syncthreads();
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < VT / 32; ++i) s += red_d[i];
    mu = (float)(s / (double)L);
  }
  STAMP(11);
  auto x_of = [&](int t) {          // x[t], 0 past L
    const float v = u_pro(min(t, L - 1));
    return t < L ? sub(v, mu) : 0.0f;
  };
  // word w of x: t1 = 4 (4 (w / 4S) + w % 4) + j (j < 4), t2 = (w / 4) % S;
  // a warp's 32 words are 8 rows t2 by 4 words, in distinct banks
  const int sh_s = __ffs(S) - 1;
  auto word_t = [&](int w, int j) {
    const int t2 = (w >> 2) & (S - 1), hi = (w >> 2) >> sh_s;
    return (4 * (4 * hi + (w & 3)) + j) * S + t2;
  };
  // a thread's words w = tid + i NT: the first XW read once into
  // registers, any past them (n 32768 at L > 16384) read again
  const int words = S * Rc / 4;
  float xv[XW][4];
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < XW; ++i)
    if (tid + i * NT < words)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xv[i][j] = x_of(word_t(tid + i * NT, j));
        m = fmaxf(m, fabsf(xv[i][j]));
      }
  for (int w = tid + XW * NT; w < words; w += NT)
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(x_of(word_t(w, j))));
  float sc = q8_scale(block_max<NT>(m, red));
  float inv = 1.0f / sc;
  STAMP(12);
  auto store_word = [&](int w, const float* v4) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= (uint32_t)(q8(v4[j], inv) & 0xff) << (8 * j);
    const int t2 = (w >> 2) & (S - 1), hi = (w >> 2) >> sh_s;
    *reinterpret_cast<uint32_t*>(Ab + t2 * ldx + 4 * (4 * hi + (w & 3))) = v;
  };
#pragma unroll
  for (int i = 0; i < XW; ++i)
    if (tid + i * NT < words) store_word(tid + i * NT, xv[i]);
  for (int w = tid + XW * NT; w < words; w += NT) {
    float v4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v4[j] = x_of(word_t(w, j));
    store_word(w, v4);
  }
  STAMP(13);
  staged();
  STAMP(1);

  // ---- S1 and twiddle -> B[kr][j], j < S: Br[t2 = j], else Bi[j - S] ---
  if (pl.prefetch & 2) load_stage(1, 0);
  {
    const float sr = sc * qs[S_DRR], si = sc * qs[S_DRI];
    const int MT = S / 32, units = MT * (RP / 16);
    const int8_t* Fr = Fb + pl.foff[0];
    const int8_t* Fi = Fr + RP * ldx;
    for (int pass = 0; pass < 2; ++pass) {
      m = 0.0f;
      for (int p = 0; p < pl.panels; ++p) {
        if (pl.panels > 1 && (pass || p)) {
          __syncthreads();           // the last panel's products are done
          load_stage(0, p);
          staged();
        }
        for (int unit = warp; unit < units; unit += NW) {
          const int m0 = (unit % MT) * 32, n0 = (unit / MT) * 16;
          const int k0r = p * RP + n0;           // the tile's first kr
          float4 w[2][2][2];                     // [i][row g, g + 8][j]
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                w[i][hh][j] = ld_tw2(tw, (m0 + 16 * i + 8 * hh + g) * R +
                                             k0r + 8 * j + 2 * q);
          int acc[2][2][2][4];
          warp_mma<2, 2, 2, true>(acc, Ab, Ab, ldx, Fr, Fi, ldx, m0, n0, Rc,
                                  lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int t2 = m0 + 16 * i + g + 8 * (e >> 1);
                const int kr = k0r + 8 * j + 2 * q + (e & 1);
                const float xr = (float)acc[0][i][j][e] * sr;
                const float xi = (float)acc[1][i][j][e] * si;
                const float2 bb =
                    cmul_rn(xr, xi, half2of(w[i][e >> 1][j], e & 1));
                if (pass) {
                  Bb[kr * ldb + t2] = (int8_t)q8(bb.x, inv);
                  Bb[kr * ldb + S + t2] = (int8_t)q8(bb.y, inv);
                } else {
                  m = fmaxf(m, fmaxf(fabsf(bb.x), fabsf(bb.y)));
                }
              }
        }
      }
      if (!pass) {
        sc = q8_scale(block_max<NT>(m, red));
        inv = 1.0f / sc;
      }
      STAMP(2 + pass);
    }
  }
  __syncthreads();
  if (!(pl.prefetch & 2)) load_stage(1, 0);
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
  staged();
  STAMP(4);

  // ---- S2 and spectrum product -> Y[kr][j], j < Q2: Yr[ks = j], else Yi
  if (pl.prefetch & 4) load_stage(2, 0);
  {
    const float sx = sc * qs[S_DSP];
    const float c_in = 2.0f / (float)n;
    const int MT = S / 32, units = MT * (R / 32);
    const int8_t* F = Fb + pl.foff[1];
    for (int pass = 0; pass < 2; ++pass) {
      m = 0.0f;
      for (int unit = warp; unit < units; unit += NW) {
        const int m0 = (unit % MT) * 32, n0 = (unit / MT) * 32;
        // rows g / g + 8 of m-tile m0 / 16 + i: Xr / Xi of ks = m0 / 2 +
        // 8 i + g
        float4 kk4[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kk4[i][j] = ld_kh2(kh, n0 + 8 * j + 2 * q +
                                       R * (m0 / 2 + 8 * i + g));
        int acc[1][2][4][4];
        warp_mma<1, 2, 4, false>(acc, F, F, ldb, Bb, Bb, ldb, m0, n0, 2 * S,
                                 lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ks = m0 / 2 + 8 * i + g;
              const int kr = n0 + 8 * j + 2 * q + e;
              const int k = kr + R * ks;
              const float2 kk = half2of(kk4[i][j], e);
              const float ck = k == 0 ? 0.5f * c_in : c_in;
              const float xr = (float)acc[0][i][j][e] * sx;
              const float xi = (float)acc[0][i][j][e + 2] * sx;
              const float2 y = cmul_rn(
                  xr, xi, make_float2(mul(ck, kk.x), mul(ck, kk.y)));
              if (pass) {
                Ab[kr * ldy + ks] = (int8_t)q8(y.x, inv);
                Ab[kr * ldy + Q2 + ks] = (int8_t)q8(y.y, inv);
              } else {
                m = fmaxf(m, fmaxf(fabsf(y.x), fabsf(y.y)));
              }
            }
      }
      if (!pass) {
        sc = q8_scale(block_max<NT>(m, red));
        inv = 1.0f / sc;
      }
      STAMP(5 + pass);
    }
  }
  __syncthreads();
  if (!(pl.prefetch & 4)) load_stage(2, 0);
  staged();
  STAMP(7);

  // ---- iA and twiddle -> Tr[t2][kr], Ti[t2][kr] (two scales) ----------
  if (pl.prefetch & 8) load_stage(3, 0);
  float s_tr = 0.0f, s_ti = 0.0f;
  {
    const float sz = sc * qs[S_ESP];
    const float yn = nyq_s;
    float ir = 0.0f, ii = 0.0f;
    const int MT = 2 * S / 32, units = MT * (R / 32);
    const int8_t* F = Fb + pl.foff[2];
    for (int pass = 0; pass < 2; ++pass) {
      float mr = 0.0f, mi = 0.0f;
      for (int unit = warp; unit < units; unit += NW) {
        const int m0 = (unit % MT) * 32, n0 = (unit / MT) * 32;
        // rows g / g + 8 of m-tile m0 / 16 + i: Zr / Zi of t2 = m0 / 2 +
        // 8 i + g
        float4 w[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[i][j] = ld_tw2(tw, (m0 / 2 + 8 * i + g) * R + n0 + 8 * j +
                                     2 * q);
        int acc[1][2][4][4];
        warp_mma<1, 2, 4, false>(acc, F, F, ldy, Ab, Ab, ldy, m0, n0, S,
                                 lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t2 = m0 / 2 + 8 * i + g;
            const int kr0 = n0 + 8 * j + 2 * q;
            int qr[2], qi[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float zr = (float)acc[0][i][j][e] * sz;
              const float zi = (float)acc[0][i][j][e + 2] * sz;
              if (kr0 + e == 0) zr = add(zr, (t2 & 1) ? -yn : yn);
              const float2 wv = half2of(w[i][j], e);
              const float2 tt = cmul_rn(zr, zi, make_float2(wv.x, -wv.y));
              if (pass) {
                qr[e] = q8(tt.x, ir);
                qi[e] = q8(tt.y, ii);
              } else {
                mr = fmaxf(mr, fabsf(tt.x));
                mi = fmaxf(mi, fabsf(tt.y));
              }
            }
            if (pass) {                          // kr0, kr0 + 1: one store
              *reinterpret_cast<uint16_t*>(Bb + t2 * ldt + kr0) =
                  (uint16_t)((qr[0] & 0xff) | (qr[1] & 0xff) << 8);
              *reinterpret_cast<uint16_t*>(Bb + (S + t2) * ldt + kr0) =
                  (uint16_t)((qi[0] & 0xff) | (qi[1] & 0xff) << 8);
            }
          }
      }
      if (!pass) {
        s_tr = q8_scale(block_max<NT>(mr, red));
        s_ti = q8_scale(block_max<NT>(mi, red));
        ir = 1.0f / s_tr;
        ii = 1.0f / s_ti;
      }
      STAMP(8 + pass);
    }
  }
  __syncthreads();
  if (!(pl.prefetch & 8) && !pl.er_chunked) load_stage(3, 0);
  staged();

  // ---- iB: y[t2][t1] a chunk of t1 at a time, then the epilogue in time
  // order t = t1 S + t2: the mean's conv, D-skip on the f32 u', GELU ------
  {
    const float sr = s_tr * qs[S_ERR], si = s_ti * qs[S_ERI];
    const int MT = S / 32, units = MT * (pl.chunk / 16);
    const float dh = D[h];
    const float* wr = W == nullptr ? nullptr : W + (size_t)h * L;
    T* orow = out + (size_t)row * L;
    for (int c0 = 0; c0 < Rc; c0 += pl.chunk) {
      if (pl.er_chunked) {
        load_stage(3, c0 / pl.chunk);
        staged();
      }
      const int8_t* Fr =
          Fb + pl.foff[3] + (pl.er_chunked ? 0 : c0 * ldt);
      const int8_t* Fi = Fb + pl.foff[3] + ER * ldt +
                         (pl.er_chunked ? 0 : c0 * ldt);
      for (int unit = warp; unit < units; unit += NW) {
        const int m0 = (unit % MT) * 32, n0 = (unit / MT) * 16;
        int acc[2][2][2][4];
        warp_mma<2, 2, 2, false>(acc, Bb, Bb + S * ldt, ldt, Fr, Fi, ldt, m0,
                                 n0, R, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t2 = m0 + 16 * i + g + 8 * (e >> 1);
              const int t1 = n0 + 8 * j + 2 * q + (e & 1);  // in the chunk
              yf[t1 * ldo + t2] = sub((float)acc[0][i][j][e] * sr,
                                      (float)acc[1][i][j][e] * si);
            }
      }
      __syncthreads();
      const int t0 = c0 * S, t_end = min(L, (c0 + pl.chunk) * S);
      for (int tb = t0 + tid; tb < t_end; tb += 4 * NT) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = min(tb + i * NT, t_end - 1);
          const int tl = t - t0, t1 = tl >> sh_s, t2 = tl & (S - 1);
          const float yv = yf[t1 * ldo + t2];
          const float y = wr == nullptr ? yv : add(yv, mul(mu, wr[t]));
          v[i] = add(y, mul(dh, u_pro(t)));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (tb + i * NT < t_end)
            orow[tb + i * NT] =
                from_f<T>(FAST ? gelu_fast(v[i]) : gelu_erf(v[i]));
      }
      __syncthreads();               // yf (and a staged Er chunk) free
    }
  }
  STAMP(10);
}

bool bad_dims(const Dims& d) {
  auto pow2 = [](int v) { return v > 0 && !(v & (v - 1)); };
  return !pow2(d.n) || !pow2(d.R) || !pow2(d.S) || !pow2(d.Rc) ||
         d.R * d.S != d.n || d.S < 32 || d.R < 32 ||
         d.Rc < 32 || d.Rc > d.R || d.Rc * d.S < d.L || d.L < 1;
}

bool bad_plan(const Plan& p, const Dims& d) {
  auto pow2 = [](int v) { return v > 0 && !(v & (v - 1)); };
  return !pow2(p.panels) || d.R / p.panels < 16 || !pow2(p.chunk) ||
         p.chunk < 16 || p.chunk > d.Rc || (p.b_off | p.f_off) & 15 ||
         (p.panels > 1 && (p.prefetch & 2)) ||
         (p.er_chunked && (p.prefetch & 8));
}

template <typename T, int NT>
int launch_nt(const T* u, const float* a, const float* c, const float* bias,
              const void* khat, const float* D, const float* W,
              const void* qc, const float* qs, T* out, int B, int H, Dims d,
              Plan p, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fftconv_int8_kernel<T, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fftconv_int8_kernel<T, NT><<<B * H, NT, smem, stream>>>(
      u, a, c, bias, static_cast<const float2*>(khat), D, W,
      static_cast<const int8_t*>(qc), qs, out, H, d, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const float* a, const float* c, const float* bias,
           const void* khat, const float* D, const float* W, const void* qc,
           const float* qs, T* out, int B, int H, Dims d, Plan p,
           int threads, int smem, cudaStream_t stream) {
  if (bad_dims(d) || bad_plan(p, d)) return (int)cudaErrorInvalidValue;
  switch (threads) {
    case 128:
      return launch_nt<T, 128>(u, a, c, bias, khat, D, W, qc, qs, out, B, H,
                               d, p, smem, stream);
    case 256:
      return launch_nt<T, 256>(u, a, c, bias, khat, D, W, qc, qs, out, B, H,
                               d, p, smem, stream);
    case 512:
      return launch_nt<T, 512>(u, a, c, bias, khat, D, W, qc, qs, out, B, H,
                               d, p, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifdef DWST_INT8_STAMPS
extern "C" int dwst_read_int8_stamps(long long* host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps,
                                   sizeof(long long) * blocks * N_STAMPS);
}
#endif

// Kernel 12.  u, out: (B, H, L), bf16 when bf16 != 0 else f32; a, c (B, L),
// bias (B, H), D (H,) f32; khat (H, n/2 + 1) complex64; W (H, L) f32 the
// conv of the window 1[t < L], or null for no mean split; qc the quantized
// factors, qs their scales (8 floats) and the twiddles (S R complex64)
// (ops/int8conv.py::int8_consts); then ops/int8conv.py::int8_plan's
// threads, smem, b_off, f_off, the four stage offsets, panels, chunk,
// er_chunked and prefetch.
extern "C" int dwst_fftconv_int8(const void* u, const float* a,
                                 const float* c, const float* bias,
                                 const void* khat, const float* D,
                                 const float* W, const void* qc,
                                 const float* qs, void* out, int B, int H,
                                 int L, int n, int R, int S, int Rc, int bf16,
                                 int threads, int smem, int b_off, int f_off,
                                 int foff0, int foff1, int foff2, int foff3,
                                 int panels, int chunk, int er_chunked,
                                 int prefetch, cudaStream_t stream) {
  const Dims d{n, R, S, Rc, L};
  const Plan p{b_off,  f_off, {foff0, foff1, foff2, foff3},
               panels, chunk, er_chunked, prefetch};
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(u), a, c, bias, khat, D,
                  W, qc, qs, static_cast<__nv_bfloat16*>(out), B, H, d, p,
                  threads, smem, stream);
  return launch(static_cast<const float*>(u), a, c, bias, khat, D, W, qc, qs,
                static_cast<float*>(out), B, H, d, p, threads, smem, stream);
}
