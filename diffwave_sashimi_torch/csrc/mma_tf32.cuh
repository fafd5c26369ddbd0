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

template <int MT, int N8>
__device__ __forceinline__ void zero_acc(float acc[MT][N8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
}

// One warp's acc[m][j] (MT m-tiles x N8 n-tiles, f32) += A[m-tile mt0 + m,
// k-tiles kt0 .. kt0 + nk) Bs in 3xTF32, as warp_gemm_3xtf32 but with A's
// fragments in a ring of AHEAD + 1 k-steps, loaded AHEAD k-steps ahead of
// their use into the slot the ring indexes at compile time: no register
// copy waits on a load in flight (as mma_bf16.cuh::warp_gemm_ring), so
// AHEAD k-steps of products cover the L2 latency of each load.  Bs (8 nk x
// 8 N8) has its row 0 at k-tile kt0.  Each k-step's sum is added to acc in
// k order, so a product taken in pieces of k-tiles, in order, sums as one
// taken whole.  The m-tiles come in groups of MG consecutive ones, gap
// tiles apart: acc[m] is A's m-tile mt0 + m % MG + gap (m / MG) (by default
// one group, mt0 + m; kernel 2 pairs each value m-tile with its gate
// m-tile, as mma_bf16.cuh::warp_gemm_ring does for kernel 2f).
template <int MT, int N8, int AHEAD, int MG = MT>
__device__ __forceinline__ void warp_gemm_3xtf32_ring(
    const uint4* __restrict__ Af, int Mt, int Kt, int mt0, int kt0, int nk,
    const float* Bs, int ld, float acc[MT][N8][4], int gap = 0) {
  constexpr int D = AHEAD + 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ring[D][MT][2][4];
#pragma unroll
  for (int s = 0; s < AHEAD; ++s)
    if (s < nk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_split(ring[s][mt][0], ring[s][mt][1], Af, Mt, Kt,
                     mt0 + mt % MG + gap * (mt / MG), kt0 + s);
    }
  for (int k0 = 0; k0 < nk; k0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int kk = k0 + s;
      if (kk >= nk) break;
      if (kk + AHEAD < nk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_split(ring[(s + AHEAD) % D][mt][0],
                       ring[(s + AHEAD) % D][mt][1], Af, Mt, Kt,
                       mt0 + mt % MG + gap * (mt / MG), kt0 + kk + AHEAD);
      }
      const float* b = Bs + (size_t)(8 * kk + t) * ld + g;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        uint32_t bh[2], bl[2];
        split(b[8 * j], bh[0], bl[0]);
        split(b[4 * ld + 8 * j], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][j], ring[s][mt][0], ring[s][mt][1], bh, bl);
      }
    }
  }
}

// A weight matrix to split into fragment order (load_a_split's layout): M
// x K (K a multiple of 8), entry (r, k) = a[r rs + k ks] for r < rows_a,
// b[(r - rows_a) rs + k ks] for rows_a <= r < M, so that two matrices of K
// columns stack into one (kernel 11's [W_r; W_s]); ks 1 reads a row-major
// matrix, rs 1 its transpose.
struct SplitJob {
  const float* a;
  const float* b;
  int rows_a, M, K, rs, ks;
};

// Up to three matrices split in one launch, their tiles one after another
// in the scratch in job order.
struct SplitJobs {
  SplitJob job[3];
  int n;
};

__host__ __device__ inline int split_tiles(const SplitJob& j) {
  return (j.M + 15) / 16 * (j.K / 8);
}

// Thread id's share of split_weights: lane id % 32 of tile id / 32 (tiles
// of the jobs in order), its four entries split into tf32 hi and lo and
// stored as load_a_split reads them; entries past a job's M rows are 0.
// Each source file's split_weights_tf32_kernel<K> (K names the kernel
// whose call launches it, so that traces tell them apart) runs this.
__device__ __forceinline__ void split_weights(const SplitJobs& jobs,
                                              uint4* __restrict__ wf,
                                              int id) {
  const int lane = id & 31, base = id >> 5;
  int tile = base;
  bool found = false;
  SplitJob w = jobs.job[0];
#pragma unroll
  for (int q = 0; q < 3; ++q) {      // constant indices: no local copy
    if (!found && q < jobs.n) {
      const int n = split_tiles(jobs.job[q]);
      if (tile < n) {
        w = jobs.job[q];
        found = true;
      } else {
        tile -= n;
      }
    }
  }
  if (!found) return;
  const int Kt = w.K / 8, mt = tile / Kt, kt = tile % Kt;
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * mt + gq + 8 * (i & 1), k = 8 * kt + tq + 4 * (i >> 1);
    float v = 0.0f;
    if (r < w.M)
      v = r < w.rows_a ? w.a[(size_t)r * w.rs + (size_t)k * w.ks]
                       : w.b[(size_t)(r - w.rows_a) * w.rs +
                             (size_t)k * w.ks];
    split(v, hi[i], lo[i]);
  }
  uint4* out = wf + (size_t)base * 64 + lane;
  out[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  out[32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Tiles of all the jobs: the scratch holds 64 uint4 (256 floats) a tile.
__host__ inline int split_tiles(const SplitJobs& jobs) {
  int n = 0;
  for (int j = 0; j < jobs.n; ++j) n += split_tiles(jobs.job[j]);
  return n;
}

}  // namespace dwst_tf32

// The split pass of kernel K (3, 7 or 11: the kernel whose call launches
// it, so that traces tell them apart): one thread a (tile, lane).
template <int K>
__global__ void split_weights_tf32_kernel(dwst_tf32::SplitJobs jobs,
                                          uint4* __restrict__ wf) {
  dwst_tf32::split_weights(jobs, wf, blockIdx.x * blockDim.x + threadIdx.x);
}

namespace dwst_tf32 {

// Launch kernel K's split of jobs into wf (64 split_tiles(jobs) uint4s) on
// stream; the launch's error, or 0.
template <int K>
int split_weights_launch(const SplitJobs& jobs, uint4* wf,
                         cudaStream_t stream) {
  const int threads = 32 * split_tiles(jobs);
  split_weights_tf32_kernel<K><<<(threads + 255) / 256, 256, 0, stream>>>(
      jobs, wf);
  return (int)cudaGetLastError();
}

}  // namespace dwst_tf32
