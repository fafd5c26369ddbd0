// f32 tile products on Hopper's tensor cores at f32 accuracy: 3xTF32 with
// mma.sync (m16n8k8, tf32 operands, f32 sums).  Each f32 operand x is split
// into two tf32 values, hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact
// in f32), which keep about 22 of its 24 significand bits (lo rounded, not
// left to the tensor cores' truncation, which would bias every product the
// same way); a product is
// lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each term exact in f32, lo(a)
// lo(b) (below 2^-22 of the product) dropped.  The three terms of one
// k-step (8 deep) are summed from zero on the tensor cores, the small ones
// first, and that sum is added to the f32 accumulator by an f32 add: the
// tensor cores' own additions, which truncate, then never see the
// accumulator's magnitude, so their error stays at the scale of one
// k-step's sum instead of growing with the accumulator's.
//
// Fragments of mma.sync.m16n8k8.row.col tf32, lane = 4 g + t (g < 8, t < 4):
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8):             b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8, f32):       c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][...]

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dwst_tf32 {

// x rounded to tf32 by cvt.rna (its 13 low significand bits to nearest,
// ties away from zero; inf and nan stay so), the low bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + (below 2^-22 |x|), hi and lo tf32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += A B for one m16n8k8 tile of tf32 operands.
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B in 3xTF32 for one k-step: A's split fragments ah, al, B's bh,
// bl (b0, b1 each).
__device__ __forceinline__ void mma_3xtf32(float acc[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_1688(s, al, bh[0], bh[1]);
  mma_1688(s, ah, bl[0], bl[1]);
  mma_1688(s, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += s[e];
}

// Split weights in fragment order: an f32 matrix A (M x K, K a multiple of
// 8) stored as its ceil(M / 16) x (K / 8) m16k8 tiles, k-tiles fastest
// (rows past M zero), each tile as the 32 lanes' hi fragments, then their
// lo fragments: lane l's hi a[0..3] at uint4 64 (mt (K / 8) + kt) + l, its
// lo at 32 more.  Two 16-byte loads a lane, 1 KB a warp in one piece, load
// a split fragment; m-tiles at or past Mt load as 0.
__device__ __forceinline__ void load_a_split(uint32_t ah[4], uint32_t al[4],
                                             const uint4* __restrict__ Af,
                                             int Mt, int Kt, int mt, int kt) {
  uint4 h = make_uint4(0u, 0u, 0u, 0u), l = h;
  if (mt < Mt) {
    const uint4* p = Af + ((size_t)mt * Kt + kt) * 64 + (threadIdx.x & 31);
    h = __ldg(p);
    l = __ldg(p + 32);
  }
  ah[0] = h.x;
  ah[1] = h.y;
  ah[2] = h.z;
  ah[3] = h.w;
  al[0] = l.x;
  al[1] = l.y;
  al[2] = l.z;
  al[3] = l.w;
}

// One warp's product acc[m][j] (MT m-tiles x N8 n-tiles, f32) = A[m-tile
// mt0 + m] Bs in 3xTF32: A split in fragment order (Mt x Kt tiles) in
// device memory, its fragments loaded one k-step ahead of their use; Bs f32
// (K x 8 N8) in shared memory, row stride ld (ld % 32 of 8 or 24, so that a
// fragment's 32 loads fall on distinct banks), each B value split as it
// loads.
template <int MT, int N8>
__device__ __forceinline__ void warp_gemm_3xtf32(const uint4* __restrict__ Af,
                                                 int Mt, int Kt, int mt0,
                                                 const float* Bs, int ld,
                                                 float acc[MT][N8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  uint32_t pre[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a_split(pre[mt][0], pre[mt][1], Af, Mt, Kt, mt0 + mt, 0);
  for (int kt = 0; kt < Kt; ++kt) {
    uint32_t a[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[mt][0][i] = pre[mt][0][i];
        a[mt][1][i] = pre[mt][1][i];
      }
    if (kt + 1 < Kt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_split(pre[mt][0], pre[mt][1], Af, Mt, Kt, mt0 + mt, kt + 1);
    }
    const float* b = Bs + (size_t)(8 * kt + t) * ld + g;
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      uint32_t bh[2], bl[2];
      split(b[8 * j], bh[0], bl[0]);
      split(b[4 * ld + 8 * j], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(acc[mt][j], a[mt][0], a[mt][1], bh, bl);
    }
  }
}

}  // namespace dwst_tf32
