// Complex helpers and the Stockham autosort FFT in shared memory, shared by
// the S4 FFT convolutions (fftconv.cu: one row per block; fftconv_long.cu:
// several rows or columns per block, the four-step passes).
//
// The complex FFTs are Stockham transforms (natural order in and out) in
// radix-8 passes with a radix-4 or radix-2 last pass, each thread holding
// VPT = 16 values in registers between one read and one write of shared
// memory, so an M-point transform takes M / 16 threads.  Twiddles are
// computed in registers (one sincospif per butterfly, then powers), not
// read from a table, whose strided reads conflict on the shared-memory
// banks; one pad slot per 32 elements (pad()) keeps the first passes'
// strided writes conflict-free too.

#pragma once

#include <cuda_runtime.h>

namespace dwst_fft {

constexpr int VPT = 16;    // complex values per thread per pass

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}
// i * a
__device__ __forceinline__ float2 cmuli(float2 a) {
  return make_float2(-a.y, a.x);
}
// a * (-i) forward, a * i inverse: the radix-4 rotation W4
template <bool INV>
__device__ __forceinline__ float2 rot4(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register DFTs of size 2, 4, 8, natural order in and out;
// forward uses exp(-2 pi i / R), inverse exp(+2 pi i / R), unnormalised.
template <bool INV>
__device__ __forceinline__ void dft2(float2* v) {
  const float2 t = csub(v[0], v[1]);
  v[0] = cadd(v[0], v[1]);
  v[1] = t;
}

template <bool INV>
__device__ __forceinline__ void dft4(float2* v) {
  const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]), d13 = rot4<INV>(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[2] = csub(s02, s13);
  v[1] = cadd(d02, d13);
  v[3] = csub(d02, d13);
}

template <bool INV>
__device__ __forceinline__ void dft8(float2* v) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft4<INV>(e);
  dft4<INV>(o);
  const float h = 0.70710678118654752f;
  // W8^k for k = 1, 2, 3 (conjugated for the inverse)
  const float2 w1 = INV ? make_float2(h, h) : make_float2(h, -h);
  const float2 w3 = INV ? make_float2(-h, h) : make_float2(-h, -h);
  o[1] = cmul(o[1], w1);
  o[2] = rot4<INV>(o[2]);
  o[3] = cmul(o[3], w3);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  if (R == 8) dft8<INV>(v);
  else if (R == 4) dft4<INV>(v);
  else dft2<INV>(v);
}

// Shared-memory slot of complex element i: one pad slot per 32 elements.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One Stockham radix-R pass over z (length M) at sub-transform size Ns:
// butterfly j reads z[j + r M/R], twiddles by W_{Ns R}^{(j mod Ns) r},
// transforms, and writes z[(j / Ns) Ns R + j mod Ns + r Ns].  The transform
// belongs to the nt = M / 16 threads tid = 0 .. nt-1 (the block may hold
// several transforms of the same M, every thread of it calling this); each
// does 16 / R butterflies.  All reads finish (barrier) before any write, so
// the pass works in place.
template <int R, bool INV>
__device__ void stockham_pass(float2* z, int M, int Ns, int tid, int nt) {
  constexpr int NB = VPT / R;
  const int stride = M / R;
  float2 v[NB][R];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int j = tid + q * nt;
    const int k = j & (Ns - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q][r] = z[pad(j + r * stride)];
    if (Ns > 1) {
      // W = exp(-+2 pi i k / (Ns R)); the argument is exact in float
      float s, c;
      sincospif(2.0f * (float)k / (float)(Ns * R), &s, &c);
      const float2 w1 = make_float2(c, INV ? s : -s);
      float2 w = w1;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[q][r] = cmul(v[q][r], w);
        w = cmul(w, w1);
      }
    }
    dft<R, INV>(v[q]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int j = tid + q * nt;
    const int k = j & (Ns - 1);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) z[pad(base + r * Ns)] = v[q][r];
  }
  __syncthreads();
}

// Complex FFT of length M = 2^log2M >= 16 in place, natural order in and
// out, by the nt = M / 16 threads tid of the transform: radix-8 passes,
// then one radix-4 or radix-2 pass for the rest.  Every thread of the
// block must call it (the passes hold block-wide barriers).
template <bool INV>
__device__ void fft(float2* z, int M, int tid, int nt) {
  int Ns = 1;
  while (Ns * 8 <= M) {
    stockham_pass<8, INV>(z, M, Ns, tid, nt);
    Ns *= 8;
  }
  if (Ns * 4 == M) stockham_pass<4, INV>(z, M, Ns, tid, nt);
  else if (Ns * 2 == M) stockham_pass<2, INV>(z, M, Ns, tid, nt);
}

}  // namespace dwst_fft
