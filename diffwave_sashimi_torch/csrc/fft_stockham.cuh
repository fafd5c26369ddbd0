// Complex helpers, access to a cluster's shared memory, and the Stockham
// autosort FFT in shared memory, shared by the S4 FFT convolutions
// (fftconv.cu: one row per block; fftconv_long.cu: several rows or columns
// per block, the four-step passes).
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

// In-register DFTs of size 2, 4, 8, 16, natural order in and out;
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

template <bool INV>
__device__ __forceinline__ void dft16(float2* v) {
  float2 e[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    e[k] = v[2 * k];
    o[k] = v[2 * k + 1];
  }
  dft8<INV>(e);
  dft8<INV>(o);
  // W16^k = (cos(pi k / 8), -+sin(pi k / 8)) for k = 1 .. 7
  const float c1 = 0.92387953251128676f, s1 = 0.38268343236508977f;
  const float h = 0.70710678118654752f, sg = INV ? 1.0f : -1.0f;
  o[1] = cmul(o[1], make_float2(c1, sg * s1));
  o[2] = cmul(o[2], make_float2(h, sg * h));
  o[3] = cmul(o[3], make_float2(s1, sg * c1));
  o[4] = rot4<INV>(o[4]);
  o[5] = cmul(o[5], make_float2(-s1, sg * c1));
  o[6] = cmul(o[6], make_float2(-h, sg * h));
  o[7] = cmul(o[7], make_float2(-c1, sg * s1));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 8] = csub(e[k], o[k]);
  }
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  if (R == 16) dft16<INV>(v);
  else if (R == 8) dft8<INV>(v);
  else if (R == 4) dft4<INV>(v);
  else dft2<INV>(v);
}

// The shared::cluster address of z's slot in the block of rank `rank` of
// the thread-block cluster, a store to it and a load from it: asm
// volatile, so the stores go out in program order and none waits for
// another; the load also clobbers memory, so it stays after the cluster
// barrier that makes the peer's values visible.
__device__ __forceinline__ unsigned cluster_addr(const float2* z, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out)
      : "r"((unsigned)__cvta_generic_to_shared(z)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr),
               "f"(v.x), "f"(v.y));
}

__device__ __forceinline__ float2 ld_cluster(unsigned addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// Shared-memory slot of complex element i: one pad slot per 32 elements.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Where an N-point transform keeps element i, and its slots (the stride
// between transforms side by side).  Pad: pad() and one more slot, so
// that neighbouring transforms start on different banks.  Swz (N a
// multiple of 128): bits 0-3 of i XOR bits 3-6, N + 1 slots; with the
// warp transforms' lanes (fft_warp) every pass's 64-bit reads and writes
// are then free of bank conflicts, and so are the cluster route's column
// and row accesses at an odd stride.
struct Pad {
  static constexpr __host__ __device__ int stride(int N) {
    return N + N / 32 + 1;
  }
  static __device__ __forceinline__ int slot(int i) { return pad(i); }
};

struct Swz {
  static constexpr __host__ __device__ int stride(int N) { return N + 1; }
  static __device__ __forceinline__ int slot(int i) {
    return i ^ ((i >> 3) & 15);
  }
};

// One Stockham radix-R pass over z (length M) at sub-transform size Ns:
// butterfly j reads z[j + r M/R], twiddles by W_{Ns R}^{(j mod Ns) r},
// transforms, and writes z[(j / Ns) Ns R + j mod Ns + r Ns].  The transform
// belongs to the nt = M / 16 threads tid = 0 .. nt-1 (the block may hold
// several transforms of the same M, every thread of it calling this); each
// does 16 / R butterflies.  All reads finish (barrier) before any write, so
// the pass works in place.  pass_read reads and transforms into v,
// pass_write writes v back; the callers place the barriers.
template <int R, bool INV, typename Lay = Pad>
__device__ __forceinline__ void pass_read(float2 (*v)[R], const float2* z,
                                          int M, int Ns, int tid, int nt) {
  constexpr int NB = VPT / R;
  const int stride = M / R;
  const float two_over = 2.0f / (float)(Ns * R);   // a power of two
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int j = tid + q * nt;
    const int k = j & (Ns - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q][r] = z[Lay::slot(j + r * stride)];
    if (Ns > 1) {
      // W = exp(-+2 pi i k / (Ns R)); the argument is exact in float
      float s, c;
      sincospif((float)k * two_over, &s, &c);
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
}

template <int R, typename Lay = Pad>
__device__ __forceinline__ void pass_write(float2 (*v)[R], float2* z, int Ns,
                                           int tid, int nt) {
  constexpr int NB = VPT / R;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int j = tid + q * nt;
    const int k = j & (Ns - 1);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) z[Lay::slot(base + r * Ns)] = v[q][r];
  }
}

template <int R, bool INV>
__device__ void stockham_pass(float2* z, int M, int Ns, int tid, int nt) {
  float2 v[VPT / R][R];
  pass_read<R, INV>(v, z, M, Ns, tid, nt);
  __syncthreads();
  pass_write<R>(v, z, Ns, tid, nt);
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

// A transform of a compile-time length M, 128 <= M <= 512, in the Swz
// layout, whose M / 16 threads lane lie in one warp: warp barriers take
// the place of the block's, so a warp runs its own transforms at its own
// pace.  M = 256 takes two radix-16 passes (a thread's 16 values are one
// butterfly), a third fewer shared-memory round trips than 8, 8, 4; the
// other lengths take radix-8 passes as a loop over one copy of their
// code.  Every thread of the warp must call it.
template <int R, bool INV>
__device__ __forceinline__ void warp_pass(float2* z, int M, int Ns,
                                          int lane) {
  float2 v[VPT / R][R];
  pass_read<R, INV, Swz>(v, z, M, Ns, lane, M / VPT);
  __syncwarp();
  pass_write<R, Swz>(v, z, Ns, lane, M / VPT);
  __syncwarp();
}

template <int M, bool INV>
__device__ __forceinline__ void fft_warp(float2* z, int lane) {
  static_assert(M >= 128 && M <= 32 * VPT && M % 128 == 0,
                "a warp's transform in the Swz layout");
  if constexpr (M == 256) {
    warp_pass<16, INV>(z, M, 1, lane);
    warp_pass<16, INV>(z, M, 16, lane);
  } else {
    int Ns = 1;
#pragma unroll 1
    for (; Ns * 8 <= M; Ns *= 8) warp_pass<8, INV>(z, M, Ns, lane);
    if (Ns * 4 == M) warp_pass<4, INV>(z, M, Ns, lane);
    else if (Ns * 2 == M) warp_pass<2, INV>(z, M, Ns, lane);
  }
}

}  // namespace dwst_fft
