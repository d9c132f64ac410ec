// The tensor-core complex running product shared by the kernels B6
// (tensor_sketch.cu, its stage 1) and B7 (ctr_feature.cu): for each column
// f of a packed plan and each row r of x,
//
//     (Ar, Ai)[r][f] = prod_{j < col_deg[f]} <wr[j, f, :] + i wi[j, f, :], x[r, :]>
//
// from (1, 0), x [B, d] and wr, wi [kdeg, F, d] read as they are.
//
// Work: a block of W warps owns 16 rows of x and walks *rounds* of W
// 8-column tiles, one tile a warp. A warp runs its tile's chain slot by
// slot to the block's depth (the largest degree among its columns; each
// column stops at its own degree by a mask), reading its x rows and the
// slot rows straight from device memory into mma fragments (rmm::Chain,
// the lane layout of B1's chain_z), two slots (four weight rows: wr_j,
// wi_j, wr_j+1, wi_j+1) a pass over d, so each x fragment serves four
// products; the complex product is updated in the accumulator fragments,
// which share one layout. Stage 1 keeps nothing in shared memory and
// holds no barrier: the most blocks in flight, each chain as short as its
// depth. (A staged variant, x and the slot rows in shared memory by
// cp.async, each staged row serving 32 or 64 x rows, measured slower at
// every shape of the serving path and the paper's maps: PERF.md.)
//
// Precision (rm_featurize_mma.cuh): fp32 runs 3xTF32; the hi(x) lo(w) term
// is skipped for a d step where a warp vote finds every weight of the step
// a TF32 number (B7's {0, +-1} are; B6's cos / sin are not), which only
// drops exact zeros. bf16 runs bf16 m16n8k16 with fp32 accumulation.
#pragma once

#include "rm_featurize_mma.cuh"

namespace cmm {

constexpr int kColTile = rmm::kColTile;          // columns of a warp's tile

// Whether a launch may read rows with 16-byte loads: the row bytes and
// the pointers in whole 16 bytes.
__host__ inline bool vec16(size_t row_bytes, const void* a, const void* b,
                           const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return row_bytes % 16 == 0 && bits % 16 == 0;
}

// The largest degree (at most kdeg) among columns [c_lo, c_hi), the same
// in every thread of a block of W warps.
template <int W>
__device__ __forceinline__ int block_depth(const int* __restrict__ col_deg,
                                           int c_lo, int c_hi, int kdeg) {
  __shared__ int warp_max[W];
  int m = 0;
  for (int c = c_lo + threadIdx.x; c < c_hi; c += 32 * W)
    m = max(m, __ldg(col_deg + c));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) m = max(m, warp_max[w]);
  return min(m, kdeg);
}

// The running products of `rounds` rounds for the rows r0 .. r0 + 15 of x
// (those below B exist): round i gives warp w the tile of columns col_base
// + 8 (W i + w) .. + 7; columns at or past col_end are not the block's
// (degree 0, weight rows never read). depth: block_depth of the block's
// columns. Every thread calls round_start(i) before round i's chains (a
// cp.async copy it issues has landed when round_end(i) runs) and, after
// them, round_end(i, first column of the warp's tile, zr, zi): zr[e],
// zi[e] are the tile's fragments (rows g (+ 8 for elements 2, 3), columns
// 2 t (+ 1 for elements 1, 3)). Both calls are block-uniform, so they may
// hold barriers. vec: 16-byte loads (vec16 of x, wr, wi).
template <typename T, int W, typename RoundStart, typename RoundEnd>
__device__ __forceinline__ void complex_rounds(
    const T* __restrict__ x, int B, int r0, const T* __restrict__ wr,
    const T* __restrict__ wi, int f, int d, int col_base, int col_end,
    int rounds, int depth, const int* __restrict__ col_deg, bool vec,
    RoundStart round_start, RoundEnd round_end) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* x0 = x + static_cast<size_t>(r0 + g) * d;
  const T* x8 = x0 + 8 * static_cast<size_t>(d);
  const bool valid0 = r0 + g < B, valid8 = r0 + g + 8 < B;
  const int slots = max(depth, 1);   // depth 0: one masked slot, z = (1, 0)
  for (int i = 0; i < rounds; ++i) {
    round_start(i);
    rmm::cp_async_commit();
    const int cw = col_base + (i * W + warp) * kColTile;
    const int deg0 = cw + 2 * t < col_end ? __ldg(col_deg + cw + 2 * t) : 0;
    const int deg1 =
        cw + 2 * t + 1 < col_end ? __ldg(col_deg + cw + 2 * t + 1) : 0;
    float zr[4] = {1.f, 1.f, 1.f, 1.f}, zi[4] = {0.f, 0.f, 0.f, 0.f};
    // z *= P_j for the columns below their degree
    auto fold = [&](int j, const float pr[4], const float pi[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j < ((e & 1) ? deg1 : deg0)) {
          const float a = zr[e], b = zi[e];
          zr[e] = a * pr[e] - b * pi[e];
          zi[e] = a * pi[e] + b * pr[e];
        }
    };
    const int cl = cw + g;                    // the lane's weight row
    const bool wvalid = cl < col_end;
    // a tile wholly past col_end has nothing to compute (z stays (1, 0))
    for (int j = 0; j < (cw < col_end ? slots : 0); j += 2) {
      const size_t o0 = (static_cast<size_t>(j) * f + cl) * d;
      if (j + 1 < slots) {
        const size_t o1 = o0 + static_cast<size_t>(f) * d;
        const T* w4[4] = {wr + o0, wi + o0, wr + o1, wi + o1};
        float p[4][4];
        rmm::Chain<T>::template run<4>(x0, x8, valid0, valid8, w4, wvalid, d,
                                       vec, lane, p);
        fold(j, p[0], p[1]);
        fold(j + 1, p[2], p[3]);
      } else {
        const T* w2[2] = {wr + o0, wi + o0};
        float p[2][4];
        rmm::Chain<T>::template run<2>(x0, x8, valid0, valid8, w2, wvalid, d,
                                       vec, lane, p);
        fold(j, p[0], p[1]);
      }
    }
    rmm::cp_async_wait<0>();
    round_end(i, cw, zr, zi);
  }
}

}  // namespace cmm
