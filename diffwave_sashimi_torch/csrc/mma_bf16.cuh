// bf16 tile products on Hopper's tensor cores with mma.sync (m16n8k16,
// bf16 operands, f32 sums), for channel GEMMs whose weights sit in device
// memory, bf16 or f32 rounded to bf16 as they load (read through L2
// straight into A fragments), and whose activations sit in shared memory
// as bf16, one row per channel with the positions contiguous.
//
// Fragments of mma.sync.m16n8k16.row.col, lane = 4 g + t (g < 8, t < 4):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):             b0 = B[2t, 2t+1][g],  b1 = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][...]
// (the lower-indexed value in the low half of each 32-bit register).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace dwst_mma {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight bf16 values (16 bytes) as floats, and eight floats rounded to bf16.
__device__ __forceinline__ void unpack8(uint4 r, float f[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// Whether a pointer (null counts) is 16-byte aligned, for the launchers.
inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of the
// bf16 matrix A (M x K, row-major, K even), rows past M as 0: four 4-byte
// loads, a[i] at row g + 8 (i & 1), columns 2t + 8 (i >> 1) and the next.
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* __restrict__ A,
                                       int M, int K, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1), k = k0 + 2 * t + 8 * (i >> 1);
    a[i] = r < M ? __ldg(reinterpret_cast<const unsigned int*>(
                       A + (size_t)r * K + k))
                 : 0u;
  }
}

// The same fragment of an f32 matrix A, rounded to bf16 as it loads: four
// 8-byte loads.
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const float* __restrict__ A, int M,
                                       int K, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1), k = k0 + 2 * t + 8 * (i >> 1);
    const float2 v = r < M ? __ldg(reinterpret_cast<const float2*>(
                                 A + (size_t)r * K + k))
                           : make_float2(0.0f, 0.0f);
    a[i] = pack_bf16x2(v.x, v.y);
  }
}

// The B fragments of two neighbouring n-tiles, columns [n0, n0 + 16), rows
// [k0, k0 + 16), of the K x N bf16 tile Bs in shared memory (row stride ld
// elements, a multiple of 8; rows on distinct banks when ld / 8 is odd):
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.  Lane l
// gives the address of row l % 8 of the 8 x 8 matrix l / 8.
__device__ __forceinline__ void ldsm_b_x4_trans(uint32_t b[4],
                                                const __nv_bfloat16* Bs,
                                                int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const __nv_bfloat16* p =
      Bs + (size_t)(k0 + (q & 1) * 8 + i) * ld + n0 + (q >> 1) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr)
      : "memory");
}

// c += A B for one m16n8k16 tile.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's product acc[m][j] (MT m-tiles x N8 n-tiles, f32) = A[rows of
// m-tile m, :] Bs: A bf16 or f32 (M x K, row-major) in device memory, its
// fragments loaded one k-step ahead of their use; Bs bf16 (K x 8 N8) in
// shared memory, row stride ld.  K % 16 == 0, N8 even.  The m-tiles come in
// groups of MG consecutive ones, gap rows apart: m-tile m covers rows
// [r0 + 16 (m % MG) + gap (m / MG), + 16) (by default one group, rows [r0,
// r0 + 16 MT)).
template <int MT, int N8, typename TA, int MG = MT>
__device__ __forceinline__ void warp_gemm(const TA* __restrict__ A,
                                          int M, int K, int r0,
                                          const __nv_bfloat16* Bs, int ld,
                                          float acc[MT][N8][4],
                                          int gap = 0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  int row[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    row[mt] = r0 + 16 * (mt % MG) + gap * (mt / MG);
  uint32_t pre[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) load_a(pre[mt], A, M, K, row[mt], 0);
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[mt][i] = pre[mt][i];
    if (k0 + 16 < K) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(pre[mt], A, M, K, row[mt], k0 + 16);
    }
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4];
      ldsm_b_x4_trans(b, Bs, ld, k0, 8 * j);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][j], a[mt], b[0], b[1]);
        mma_16816(acc[mt][j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// Weights in fragment order: a bf16 matrix A (M x K, M and K multiples of
// 16) stored as its (M / 16) x (K / 16) m16k16 tiles, k-tiles fastest,
// each tile as the 32 lanes' A fragments, lane l's a[0..3] in 16 bytes at
// uint4 32 (mt (K / 16) + kt) + l.  One 16-byte load a lane, 512 bytes a
// warp in one piece, loads a fragment (four 4-byte loads, 16 rows apart,
// in load_a).  m-tiles at or past Mt load as 0.
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const uint4* __restrict__ Af,
                                            int Mt, int Kt, int mt, int kt) {
  const uint4 v = mt < Mt ? __ldg(Af + ((size_t)mt * Kt + kt) * 32 +
                                  (threadIdx.x & 31))
                          : make_uint4(0u, 0u, 0u, 0u);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// warp_gemm with A in fragment order (Mt x Kt tiles): acc[m][j] = A[m-tile
// mt0 + m] Bs, the fragments loaded one k-step ahead.
template <int MT, int N8>
__device__ __forceinline__ void warp_gemm_frag(const uint4* __restrict__ Af,
                                               int Mt, int Kt, int mt0,
                                               const __nv_bfloat16* Bs,
                                               int ld, float acc[MT][N8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  uint32_t pre[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a_frag(pre[mt], Af, Mt, Kt, mt0 + mt, 0);
  for (int kt = 0; kt < Kt; ++kt) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[mt][i] = pre[mt][i];
    if (kt + 1 < Kt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_frag(pre[mt], Af, Mt, Kt, mt0 + mt, kt + 1);
    }
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4];
      ldsm_b_x4_trans(b, Bs, ld, 16 * kt, 8 * j);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][j], a[mt], b[0], b[1]);
        mma_16816(acc[mt][j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// warp_gemm_frag with the fragments AHEAD k-steps ahead of their use, in a
// ring of AHEAD + 1 register sets that the k-loop, unrolled by AHEAD + 1,
// indexes at compile time: no register copy waits on a load in flight, so
// AHEAD k-steps of products cover the L2 latency of each load.  The m-tiles
// come in groups of MG consecutive ones, gap tiles apart: acc[m] is A's
// m-tile mt0 + m % MG + gap (m / MG) (by default one group, mt0 + m).
template <int MT, int N8, int AHEAD, int MG = MT>
__device__ __forceinline__ void warp_gemm_ring(const uint4* __restrict__ Af,
                                               int Mt, int Kt, int mt0,
                                               const __nv_bfloat16* Bs,
                                               int ld, float acc[MT][N8][4],
                                               int gap = 0) {
  constexpr int D = AHEAD + 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  int tile[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) tile[mt] = mt0 + mt % MG + gap * (mt / MG);
  uint32_t ring[D][MT][4];
#pragma unroll
  for (int s = 0; s < AHEAD; ++s)
    if (s < Kt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_frag(ring[s][mt], Af, Mt, Kt, tile[mt], s);
    }
  for (int k0 = 0; k0 < Kt; k0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int kt = k0 + s;
      if (kt >= Kt) break;
      if (kt + AHEAD < Kt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_frag(ring[(s + AHEAD) % D][mt], Af, Mt, Kt, tile[mt],
                      kt + AHEAD);
      }
#pragma unroll
      for (int j = 0; j < N8; j += 2) {
        uint32_t b[4];
        ldsm_b_x4_trans(b, Bs, ld, 16 * kt, 8 * j);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][j], ring[s][mt], b[0], b[1]);
          mma_16816(acc[mt][j + 1], ring[s][mt], b[2], b[3]);
        }
      }
    }
  }
}

}  // namespace dwst_mma
