// rm_fused_state: the whole-sequence RM key state (S, n) of non-causal
// attention, for Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_attention/fused.py
// rm_fused_state_pallas (body _fused_state_kernel, helper _featurize_block).
// With zk = Z(k) * kvalid it computes, per batch*head row,
//
//     S = zk^T v   [F, dv],     n = colsum(zk)   [F]
//
// over all T keys, without writing zk to device memory.
//
// Design. A block owns one (batch*head row, key split, feature group,
// value group) and walks its split's 64-key tiles. Per tile:
//   1. featurize (rm_featurize_mma.cuh): the 64 x d key tile against the
//      omega slab, which the block loaded into shared memory once (53 KB in
//      bf16, 102 KB in fp32 for the hubert plan at d 80), on the tensor
//      cores, one 8-column tile at a time to that tile's own depth; zk *
//      kvalid goes to the shared feature tile Z [64, F];
//   2. contract: [S | n] += Z^T [v | 1] on the tensor cores (3xTF32): the
//      value tile carries a column of ones, so n is one more column of the
//      product. The block's [F, dv + 1] state stays in registers across
//      all its tiles: its (16 x 8) tiles are dealt out to a 4 x 4 grid of
//      warps, at most 3 x 3 a warp.
// k and v tiles arrive with cp.async: the next key tile loads while this
// tile contracts, the next value tile while the next key tile featurizes.
// A d too deep for the key tile and a column tile's slab rows to share
// shared memory is tiled (Sched::dk < dp): the featurize then stages both
// a d chunk at a time and sums the projections over the chunks
// (rm_featurize_mma.cuh featurize_tile_dchunks).
//
// Split. Hopper's blocks run unordered, so the TPU's in-order chunk axis
// becomes a split of the key tiles over `splits` blocks
// (repro_torch.kernels.common.noncausal_schedule picks it: at least two
// waves of blocks on 132 SMs where T allows, never more splits than key
// tiles). With splits > 1 each block writes its partial (S, n) to fp32
// scratch of the wrapper's, and a second kernel adds the partials in split
// order 0, 1, ...: no atomics, so every call sums in the same order and two
// calls give bitwise-equal S and n.
//
// What bounds it on the card: operations (the featurize, 2 d per used
// slot per key, and the state, 2 F (dv + 1) per key), on the tensor cores
// at up to a third of the TF32 rate in 3xTF32. Shared memory holds one
// block an SM.
//
// Layouts: k [BH, T, d] fp32 or bf16; v [BH, T, dv] fp32; kvalid [BH, T]
// fp32; slab [rows, d] of k's type, tile_row0 [n_ct + 1], class_tiles,
// col_deg / col_scale [8 n_ct] (noncausal.pack_noncausal) -> S [BH, F,
// dv], n [BH, F] fp32. T, F, d and dv are ragged (masked).
#include <string.h>

#include "rm_featurize_mma.cuh"

namespace {

using rmm::kRows;
using rmm::kThreads;
using rmm::kWarps;
using rmm::Sched;

// acc[mi][ni] += Z^T V over the 64 keys of the tile for the warp's state
// tiles: feature tiles m = wm + 4 mi by value tiles n = wn + 4 ni on a 4 x 4
// grid of warps (an index past the last tile is clamped to it: the tile is
// computed again and never stored). A (m = feature, k = key) is Z
// transposed, B (k = key, n = value column) the value tile. Each k-step
// runs the three 3xTF32 terms as three passes over the warp's nine
// tiles, so no mma waits on the one before it.
__device__ __forceinline__ void contract(
    const float* zs, int ldz, const float* vs, int ldb, int mt, int nt,
    float acc[rmm::kStateMI][rmm::kStateNI][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / 4, wn = warp % 4;
  int moff[rmm::kStateMI], noff[rmm::kStateNI];
#pragma unroll
  for (int mi = 0; mi < rmm::kStateMI; ++mi)
    moff[mi] = 16 * min(wm + 4 * mi, mt - 1);
#pragma unroll
  for (int ni = 0; ni < rmm::kStateNI; ++ni)
    noff[ni] = 8 * min(wn + 4 * ni, nt - 1);
#pragma unroll 2
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    uint32_t ah[rmm::kStateMI][4], al[rmm::kStateMI][4];
    uint32_t bh[rmm::kStateNI][2], bl[rmm::kStateNI][2];
#pragma unroll
    for (int mi = 0; mi < rmm::kStateMI; ++mi)
      rmm::frag_a(zs + k0 * ldz + moff[mi], 1, ldz, lane, ah[mi], al[mi]);
#pragma unroll
    for (int ni = 0; ni < rmm::kStateNI; ++ni)
      rmm::frag_b(vs + k0 * ldb + noff[ni], ldb, 1, lane, bh[ni], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < rmm::kStateMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < rmm::kStateNI; ++ni)
        rmm::mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < rmm::kStateMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < rmm::kStateNI; ++ni)
        rmm::mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < rmm::kStateMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < rmm::kStateNI; ++ni)
        rmm::mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

template <typename T, bool kExactW, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
rm_fused_state_kernel(const T* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ kvalid,
                      const T* __restrict__ slab,
                      const int* __restrict__ tile_row0,
                      const int* __restrict__ class_tiles,
                      const int* __restrict__ col_deg,
                      const float* __restrict__ col_scale,
                      float* __restrict__ s_dst, float* __restrict__ n_dst,
                      const Sched s, bool vec_x, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const rmm::Smem lay = rmm::smem_layout<T>(s, false);
  T* slab_s = reinterpret_cast<T*>(smem + lay.slab);
  T* xs = reinterpret_cast<T*>(smem + lay.x);
  float* vs = reinterpret_cast<float*>(smem + lay.b);
  float* zs = reinterpret_cast<float*>(smem + lay.z);
  float* ps = reinterpret_cast<float*>(smem + lay.p);

  int blk = blockIdx.x;
  const int dvg = blk % s.n_dvgroups;
  blk /= s.n_dvgroups;
  const int fg = blk % s.n_fgroups;
  blk /= s.n_fgroups;
  const int split = blk % s.splits;
  const int bh = blk / s.splits;

  const int cg0 = fg * s.ct_per_group;
  const int cg1 = min(s.n_ct, cg0 + s.ct_per_group);
  const int c0 = dvg * s.dv_per_group;
  const int w = min(s.dv_per_group, s.dv - c0);
  const int nt = (w + 1 + 7) / 8;                   // value tiles + ones
  const int mt = ((cg1 - cg0) * rmm::kColTile + 15) / 16;
  const int tiles = (s.t + kRows - 1) / kRows;
  const int tile0 = split * s.tiles_per_split;
  const int tile1 = min(tiles, tile0 + s.tiles_per_split);
  const int grow0 = __ldg(tile_row0 + cg0);
  // d tiled (dk < dp, its own instance of the kernel): the featurize
  // stages x and the slab a d chunk at a time itself
  // (featurize_tile_dchunks), so nothing is resident
  constexpr bool dchunks = kMode > 0;
  const bool one_chunk =
      !dchunks && __ldg(tile_row0 + cg1) - grow0 <= s.slab_cap;

  const T* kb = k + static_cast<size_t>(bh) * s.t * s.d;
  const float* vb = v + static_cast<size_t>(bh) * s.t * s.dv + c0;
  const float* kvb = kvalid + static_cast<size_t>(bh) * s.t;

  // constant parts: the depth padding of x and of the slab, the ones
  // column and the zero columns of the value tile, and Z (its columns past
  // the group's features feed only discarded state rows)
  if (!dchunks) {
    rmm::zero_cols(xs, s.ldx, kRows, s.d, s.dp);
    rmm::zero_cols(slab_s, s.ldx, s.slab_cap, s.d, s.dp);
  }
  for (int e = threadIdx.x; e < kRows * (8 * nt - w); e += kThreads) {
    const int r = e / (8 * nt - w);
    const int c = e - r * (8 * nt - w);
    vs[r * s.ldb + w + c] = c == 0 ? 1.f : 0.f;
  }
  for (int e = threadIdx.x; e < kRows * s.ldz; e += kThreads) zs[e] = 0.f;

  if (one_chunk)
    rmm::load_rows(slab_s, s.ldx, slab + static_cast<size_t>(grow0) * s.d,
                   s.d, __ldg(tile_row0 + cg1) - grow0,
                   __ldg(tile_row0 + cg1) - grow0, s.d, vec_x);
  if (!dchunks && tile0 < tile1)
    rmm::load_rows(xs, s.ldx, kb + static_cast<size_t>(tile0) * kRows * s.d,
                   s.d, kRows, min(kRows, s.t - tile0 * kRows), s.d, vec_x);
  rmm::cp_async_commit();
  if (tile0 < tile1)
    rmm::load_rows(vs, s.ldb, vb + static_cast<size_t>(tile0) * kRows * s.dv,
                   s.dv, kRows, min(kRows, s.t - tile0 * kRows), w, vec_v);
  rmm::cp_async_commit();

  float acc[rmm::kStateMI][rmm::kStateNI][4];
#pragma unroll
  for (int mi = 0; mi < rmm::kStateMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < rmm::kStateNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int r0 = tile * kRows;
    const int nrows = min(kRows, s.t - r0);
    rmm::cp_async_wait<1>();              // this key tile (and the slab)
    __syncthreads();
    if (one_chunk) {
      rmm::featurize_tile<T, kExactW>(xs, s.ldx, s.dp, slab_s, s.ldx, grow0,
                             tile_row0, class_tiles, col_deg, col_scale, cg0,
                             cg1, cg0,
                             zs, s.ldz, kvb + r0, nrows);
    } else if (dchunks) {
      for (int ca = cg0; ca < cg1;) {
        const int cb = rmm::chunk_end(tile_row0, ca, cg1, s.chunk_ct,
                                      s.slab_cap);
        if (kMode == 2 &&
            __ldg(tile_row0 + cb) - __ldg(tile_row0 + ca) > s.slab_cap)
          rmm::featurize_deep_tile<T, kExactW>(
              kb + static_cast<size_t>(r0) * s.d, nrows, slab, s, xs, slab_s,
              ps, tile_row0, class_tiles, col_deg, col_scale, ca, cg0, zs,
              kvb + r0, nrows, vec_x);
        else
          rmm::featurize_tile_dchunks<T, kExactW>(
              kb + static_cast<size_t>(r0) * s.d, nrows, slab, s, xs, slab_s,
              ps, tile_row0, class_tiles, col_deg, col_scale, ca, cb, cg0, zs,
              kvb + r0, nrows, vec_x);
        ca = cb;
      }
    } else {
      // the group's slab does not fit: bring it in chunk by chunk
      for (int ca = cg0; ca < cg1;) {
        const int cb = rmm::chunk_end(tile_row0, ca, cg1, s.chunk_ct,
                                      s.slab_cap);
        const int ra = __ldg(tile_row0 + ca);
        const int rows = __ldg(tile_row0 + cb) - ra;
        __syncthreads();                  // the last chunk's readers are done
        rmm::load_rows(slab_s, s.ldx, slab + static_cast<size_t>(ra) * s.d,
                       s.d, rows, rows, s.d, vec_x);
        rmm::cp_async_commit();
        rmm::cp_async_wait<0>();
        __syncthreads();
        rmm::featurize_tile<T, kExactW>(xs, s.ldx, s.dp, slab_s, s.ldx, ra,
                               tile_row0, class_tiles, col_deg, col_scale, ca,
                               cb, cg0,
                               zs, s.ldz, kvb + r0, nrows);
        ca = cb;
      }
    }
    __syncthreads();                      // Z is complete, xs is free
    if (!dchunks && tile + 1 < tile1)
      rmm::load_rows(xs, s.ldx, kb + static_cast<size_t>(r0 + kRows) * s.d,
                     s.d, kRows, min(kRows, s.t - r0 - kRows), s.d, vec_x);
    rmm::cp_async_commit();
    rmm::cp_async_wait<1>();              // this value tile
    __syncthreads();
    contract(zs, s.ldz, vs, s.ldb, mt, nt, acc);
    __syncthreads();                      // Z and vs are free
    if (tile + 1 < tile1)
      rmm::load_rows(vs, s.ldb, vb + static_cast<size_t>(r0 + kRows) * s.dv,
                     s.dv, kRows, min(kRows, s.t - r0 - kRows), w, vec_v);
    rmm::cp_async_commit();
  }
  rmm::cp_async_wait<0>();

  // the block's (partial) state: rows of the group's features, the value
  // columns of its group; the ones column is n (written by value group 0)
  const size_t row = static_cast<size_t>(bh) * s.splits + split;
  float* sd = s_dst + row * s.f * s.dv + c0;
  float* nd = n_dst + row * s.f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int f_end = min(s.f, cg1 * rmm::kColTile);
#pragma unroll
  for (int mi = 0; mi < rmm::kStateMI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < rmm::kStateNI; ++ni) {
      const int m = warp / 4 + 4 * mi, n = warp % 4 + 4 * ni;
      if (m >= mt || n >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = cg0 * rmm::kColTile + 16 * m + g + 8 * h;
        if (f >= f_end) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          const float val = acc[mi][ni][2 * h + e];
          if (c < w)
            sd[static_cast<size_t>(f) * s.dv + c] = val;
          else if (c == w && dvg == 0)
            nd[f] = val;
        }
      }
    }
  }
}

// The second pass: S and n as the sum of the splits' partials, in split
// order.
__global__ void reduce_splits_kernel(const float* __restrict__ s_part,
                                     const float* __restrict__ n_part,
                                     float* __restrict__ s_out,
                                     float* __restrict__ n_out, int bh,
                                     int splits, int f, int dv) {
  const size_t per_s = static_cast<size_t>(f) * dv;
  const size_t total_s = static_cast<size_t>(bh) * per_s;
  const size_t total = total_s + static_cast<size_t>(bh) * f;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (idx < total_s) {
      const size_t b = idx / per_s;
      const float* p = s_part + b * splits * per_s + (idx - b * per_s);
      float sum = p[0];
      for (int sp = 1; sp < splits; ++sp) sum += p[sp * per_s];
      s_out[idx] = sum;
    } else {
      const size_t j = idx - total_s;
      const size_t b = j / f;
      const float* p = n_part + b * splits * f + (j - b * f);
      float sum = p[0];
      for (int sp = 1; sp < splits; ++sp) sum += p[sp * static_cast<size_t>(f)];
      n_out[j] = sum;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kExactW>
int launch(const void* k, const float* v, const float* kvalid,
           const void* slab, const int* tile_row0, const int* class_tiles,
           const int* col_deg,
           const float* col_scale, float* s_out, float* n_out,
           float* s_part, float* n_part, const Sched& s,
           cudaStream_t stream) {
  if (rmm::smem_layout<T>(s, false).total !=
      static_cast<size_t>(s.smem_bytes))
    return (int)cudaErrorInvalidValue;
  const bool vec_x = (s.d * sizeof(T)) % 16 == 0 && aligned16(k) &&
                     aligned16(slab);
  const bool vec_v = s.dv % 4 == 0 && aligned16(v);
  // d whole (the encoder's instance), d tiled, or d tiled with a column
  // tile deeper than the shared memory holds (slot_rows > 0)
  auto kernel = s.dk == s.dp       ? rm_fused_state_kernel<T, kExactW, 0>
                : s.slot_rows == 0 ? rm_fused_state_kernel<T, kExactW, 1>
                                   : rm_fused_state_kernel<T, kExactW, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = static_cast<long long>(s.bh) * s.splits *
                           s.n_fgroups * s.n_dvgroups;
  const bool split = s.splits > 1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, s.smem_bytes, stream>>>(
      static_cast<const T*>(k), v, kvalid, static_cast<const T*>(slab),
      tile_row0, class_tiles, col_deg, col_scale, split ? s_part : s_out,
      split ? n_part : n_out, s, vec_x, vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const size_t total = static_cast<size_t>(s.bh) * s.f * (s.dv + 1);
  size_t grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;   // a grid-stride loop does the rest
  reduce_splits_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(s_part, n_part, s_out,
                                                 n_out, s.bh, s.splits, s.f,
                                                 s.dv);
  return (int)cudaGetLastError();
}

}  // namespace

// sched: n_sched ints, the fields of repro_torch.kernels.common
// NoncausalSchedule; s_part [BH, splits, F, dv] and n_part [BH, splits, F]
// fp32 scratch when splits > 1 (else unused). dtype (k and the slab): 0 =
// fp32, 1 = bf16, 2 = fp32 with every slab value a TF32 number. Returns
// cudaGetLastError() of the last launch.
extern "C" int rm_fused_state_launch(
    const void* k, const float* v, const float* kvalid, const void* slab,
    const int* tile_row0, const int* class_tiles, const int* col_deg,
    const float* col_scale, float* s_out, float* n_out, float* s_part,
    float* n_part,
    const int* sched, int n_sched, int dtype, void* stream) {
  if (n_sched != rmm::kSchedFields) return (int)cudaErrorInvalidValue;
  Sched s;
  memcpy(&s, sched, sizeof(Sched));
  if (s.bh < 1 || s.t < 1 || s.f < 1 || s.dv < 1 || s.d < 1 ||
      s.n_ct != (s.f + rmm::kColTile - 1) / rmm::kColTile ||
      s.splits < 1 || s.tiles_per_split < 1 || s.n_fgroups < 1 ||
      s.n_dvgroups < 1 || s.ct_per_group < 1 || s.dv_per_group < 1 ||
      s.b_rows != kRows || s.chunk_ct < 1 || s.dk < 1 || s.dk > s.dp ||
      (s.dk < s.dp && s.ldp < s.slab_cap) ||
      s.slot_rows < 0 || s.slot_rows % rmm::kColTile != 0 ||
      s.slot_rows > s.slab_cap || (s.slot_rows > 0 && s.dk == s.dp) ||
      (s.dv_per_group + 8) / 8 > 4 * rmm::kStateNI ||
      (s.ct_per_group * rmm::kColTile + 15) / 16 > 4 * rmm::kStateMI ||
      (s.splits > 1 && (s_part == nullptr || n_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(k, v, kvalid, slab, tile_row0, class_tiles,
                                col_deg, col_scale, s_out, n_out, s_part,
                                n_part, s, st);
  if (dtype == 2)
    return launch<float, true>(k, v, kvalid, slab, tile_row0, class_tiles,
                               col_deg, col_scale, s_out, n_out, s_part,
                               n_part, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(k, v, kvalid, slab, tile_row0,
                                        class_tiles, col_deg, col_scale,
                                        s_out, n_out, s_part, n_part, s, st);
  return (int)cudaErrorInvalidValue;
}
