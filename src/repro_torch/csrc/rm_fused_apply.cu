// rm_fused_apply: non-causal RM attention outputs from a given key state,
// for Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_attention/fused.py
// rm_fused_apply_pallas (body _fused_apply_kernel, helpers _featurize_block
// and _clamp). With zq = Z(q) and the state (S [F, dv], n [F]) of all keys
// (kernel rm_fused_state) it computes, per batch*head row,
//
//     out = (zq S) / clamp(zq n)
//
// without writing zq to device memory. clamp(den) = sign(den) * max(|den|,
// eps) with den >= 0 -> +eps (DESIGN.md section 7).
//
// Design. A block owns one (batch*head row, query split, value group) and
// walks its split's 64-query tiles. It loads the omega slab and its row's
// state [S | n] (n as one more column, padded to whole mma tiles) into
// shared memory once. Per tile:
//   1. featurize (rm_featurize_mma.cuh): the query tile against the slab,
//      on the tensor cores, each 8-column tile to its own depth, into the
//      shared feature tile Z [64, F];
//   2. contract: [num | den] = Z [S | n] on the tensor cores (3xTF32), the
//      (16 x 8) tiles of the [64, dv + 1] product dealt out to a 4 x 4 grid
//      of warps (one query tile by up to 3 value tiles a warp); the warp
//      holding the den column hands it over through shared memory and
//      every warp divides its own tiles.
// The next query tile arrives by cp.async while this one contracts. The
// feature sums finish inside the block: no second pass, no atomics.
//
// A slab or state too large for shared memory (a wide d or F) is brought
// in chunks of column tiles for every query tile; the sums stay in the
// same registers. A d too deep for the query tile and a column tile's slab
// rows to share shared memory is tiled too (Sched::dk < dp): the featurize
// then stages both a d chunk at a time (featurize_tile_dchunks).
//
// What bounds it on the card: operations (the featurize of every query
// row, 2 d per used slot, and the numerator and denominator, 2 F (dv + 1)
// per row) on the tensor cores, 3xTF32 for fp32 and bf16 mma for the bf16
// featurize. Shared memory holds one block an SM.
//
// Layouts: q [BH, T, d] fp32 or bf16; S [BH, F, dv], n [BH, F] fp32; slab
// [rows, d] of q's type, tile_row0 [n_ct + 1], class_tiles, col_deg /
// col_scale [8 n_ct] (noncausal.pack_noncausal) -> out [BH, T, dv] fp32.
// T, F, d and dv are ragged (masked).
#include <string.h>

#include "rm_featurize_mma.cuh"

namespace {

using rmm::kRows;
using rmm::kThreads;
using rmm::kWarps;
using rmm::Sched;

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

// acc[ni] += Z [S | n] over ksteps * 8 features for the warp's output
// tiles: query tile wm = warp % 4 by value tiles n = warp / 4 + 4 ni (an
// index past the last tile is clamped to it and never stored). A (m =
// query, k = feature) is Z, B (k = feature, n = column) the state rows;
// the three 3xTF32 terms go in three passes over the warp's tiles.
__device__ __forceinline__ void contract(const float* zs, int ldz,
                                         const float* ss, int ldb,
                                         int ksteps, int nt,
                                         float acc[rmm::kApplyNI][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* za = zs + (16 * (warp % 4) + rmm::ldsm_a_row(lane)) * ldz +
                    4 * rmm::ldsm_a_half(lane);
  int noff[rmm::kApplyNI];
#pragma unroll
  for (int ni = 0; ni < rmm::kApplyNI; ++ni)
    noff[ni] = 8 * min(warp / 4 + 4 * ni, nt - 1);
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = 8 * ks;
    uint32_t a[4], ah[4], al[4], bh[rmm::kApplyNI][2], bl[rmm::kApplyNI][2];
    rmm::ldsm_x4(a, za + k0);
    rmm::split_words<4>(a, ah, al);
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni)
      rmm::frag_b(ss + k0 * ldb + noff[ni], ldb, 1, lane, bh[ni], bl[ni]);
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni)
      rmm::mma_tf32(acc[ni], al, bh[ni]);
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni)
      rmm::mma_tf32(acc[ni], ah, bl[ni]);
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni)
      rmm::mma_tf32(acc[ni], ah, bh[ni]);
  }
}

template <typename T, bool kExactW, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
rm_fused_apply_kernel(const T* __restrict__ q,
                      const float* __restrict__ s_in,
                      const float* __restrict__ n_in,
                      const T* __restrict__ slab,
                      const int* __restrict__ tile_row0,
                      const int* __restrict__ class_tiles,
                      const int* __restrict__ col_deg,
                      const float* __restrict__ col_scale,
                      float* __restrict__ out, const Sched s, float eps,
                      bool vec_x, bool vec_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const rmm::Smem lay = rmm::smem_layout<T>(s, true);
  T* slab_s = reinterpret_cast<T*>(smem + lay.slab);
  T* xs = reinterpret_cast<T*>(smem + lay.x);
  float* ss = reinterpret_cast<float*>(smem + lay.b);
  float* zs = reinterpret_cast<float*>(smem + lay.z);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* dens = reinterpret_cast<float*>(smem + lay.den);

  int blk = blockIdx.x;
  const int dvg = blk % s.n_dvgroups;
  blk /= s.n_dvgroups;
  const int split = blk % s.splits;
  const int bh = blk / s.splits;

  const int c0 = dvg * s.dv_per_group;
  const int w = min(s.dv_per_group, s.dv - c0);
  const int nt = (w + 1 + 7) / 8;                   // value tiles + den
  const int tiles = (s.t + kRows - 1) / kRows;
  const int tile0 = split * s.tiles_per_split;
  const int tile1 = min(tiles, tile0 + s.tiles_per_split);
  const int total_rows = __ldg(tile_row0 + s.n_ct);
  // d tiled (dk < dp, its own instance of the kernel): the featurize
  // stages x and the slab a d chunk at a time itself
  // (featurize_tile_dchunks), so nothing is resident
  constexpr bool dchunks = kMode > 0;
  const bool one_chunk =
      !dchunks && s.n_ct <= s.chunk_ct && total_rows <= s.slab_cap;

  const T* qb = q + static_cast<size_t>(bh) * s.t * s.d;
  const float* s_bh = s_in + static_cast<size_t>(bh) * s.f * s.dv + c0;
  const float* n_bh = n_in + static_cast<size_t>(bh) * s.f;
  float* ob = out + static_cast<size_t>(bh) * s.t * s.dv + c0;

  if (!dchunks) {
    rmm::zero_cols(xs, s.ldx, kRows, s.d, s.dp);
    rmm::zero_cols(slab_s, s.ldx, s.slab_cap, s.d, s.dp);
  }
  if (one_chunk) {
    rmm::load_rows(slab_s, s.ldx, slab, s.d, total_rows, total_rows, s.d,
                   vec_x);
    rmm::load_state(ss, s.ldb, s_bh, n_bh, s.f, s.dv, w, nt, 0,
               s.n_ct * rmm::kColTile, vec_s);
  }
  if (!dchunks && tile0 < tile1)
    rmm::load_rows(xs, s.ldx, qb + static_cast<size_t>(tile0) * kRows * s.d,
                   s.d, kRows, min(kRows, s.t - tile0 * kRows), s.d, vec_x);
  rmm::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % 4, wn = warp / 4;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int r0 = tile * kRows;
    const int nrows = min(kRows, s.t - r0);
    float acc[rmm::kApplyNI][4];
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ni][j] = 0.f;
    rmm::cp_async_wait<0>();              // this query tile (and the slab)
    __syncthreads();
    if (one_chunk) {
      rmm::featurize_tile<T, kExactW>(xs, s.ldx, s.dp, slab_s, s.ldx, 0, tile_row0,
                             class_tiles, col_deg, col_scale, 0, s.n_ct, 0,
                             zs, s.ldz, nullptr, kRows);
      __syncthreads();                    // Z is complete, xs is free
      if (tile + 1 < tile1)
        rmm::load_rows(xs, s.ldx, qb + static_cast<size_t>(r0 + kRows) * s.d,
                       s.d, kRows, min(kRows, s.t - r0 - kRows), s.d, vec_x);
      rmm::cp_async_commit();
      contract(zs, s.ldz, ss, s.ldb, s.n_ct, nt, acc);
    } else {
      // the slab or the state does not fit: chunk by chunk of column tiles
      for (int ca = 0; ca < s.n_ct;) {
        const int cb = rmm::chunk_end(tile_row0, ca, s.n_ct, s.chunk_ct,
                                      s.slab_cap);
        const int ra = __ldg(tile_row0 + ca);
        const int rows = __ldg(tile_row0 + cb) - ra;
        __syncthreads();                  // the last chunk's readers are done
        if (!dchunks)
          rmm::load_rows(slab_s, s.ldx, slab + static_cast<size_t>(ra) * s.d,
                         s.d, rows, rows, s.d, vec_x);
        rmm::load_state(ss, s.ldb, s_bh, n_bh, s.f, s.dv, w, nt,
                   ca * rmm::kColTile, (cb - ca) * rmm::kColTile, vec_s);
        rmm::cp_async_commit();
        rmm::cp_async_wait<0>();
        __syncthreads();
        if (kMode == 2 && rows > s.slab_cap)
          rmm::featurize_deep_tile<T, kExactW>(
              qb + static_cast<size_t>(r0) * s.d, nrows, slab, s, xs, slab_s,
              ps, tile_row0, class_tiles, col_deg, col_scale, ca, ca, zs,
              nullptr, kRows, vec_x);
        else if (dchunks)
          rmm::featurize_tile_dchunks<T, kExactW>(
              qb + static_cast<size_t>(r0) * s.d, nrows, slab, s, xs, slab_s,
              ps, tile_row0, class_tiles, col_deg, col_scale, ca, cb, ca, zs,
              nullptr, kRows, vec_x);
        else
          rmm::featurize_tile<T, kExactW>(xs, s.ldx, s.dp, slab_s, s.ldx, ra, tile_row0,
                               class_tiles, col_deg, col_scale, ca, cb, ca,
                               zs, s.ldz, nullptr, kRows);
        __syncthreads();
        if (!dchunks && cb == s.n_ct && tile + 1 < tile1)
          rmm::load_rows(xs, s.ldx,
                         qb + static_cast<size_t>(r0 + kRows) * s.d, s.d,
                         kRows, min(kRows, s.t - r0 - kRows), s.d, vec_x);
        rmm::cp_async_commit();
        contract(zs, s.ldz, ss, s.ldb, cb - ca, nt, acc);
        ca = cb;
      }
    }
    // the denominators: column w of the product, held by one lane pair of
    // the warps owning value tile w / 8
    const int nd = w / 8, ed = w % 8;
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni) {
      if (wn + 4 * ni == nd && 2 * t4 == (ed & ~1)) {
        // selects, not an index: acc stays in registers
        const bool odd = ed & 1;
        const int row = 16 * wm + g;
        dens[row] = clamp_den(odd ? acc[ni][1] : acc[ni][0], eps);
        dens[row + 8] = clamp_den(odd ? acc[ni][3] : acc[ni][2], eps);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ni = 0; ni < rmm::kApplyNI; ++ni) {
      const int n = wn + 4 * ni;
      if (n >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wm + g + 8 * h;
        if (row >= nrows) continue;
        const float dn = dens[row];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          if (c < w)
            ob[static_cast<size_t>(r0 + row) * s.dv + c] =
                acc[ni][2 * h + e] / dn;
        }
      }
    }
  }
  rmm::cp_async_wait<0>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kExactW>
int launch(const void* q, const float* s_in, const float* n_in,
           const void* slab, const int* tile_row0, const int* class_tiles,
           const int* col_deg,
           const float* col_scale, float* out, const Sched& s, float eps,
           cudaStream_t stream) {
  if (rmm::smem_layout<T>(s, true).total !=
      static_cast<size_t>(s.smem_bytes))
    return (int)cudaErrorInvalidValue;
  const bool vec_x = (s.d * sizeof(T)) % 16 == 0 && aligned16(q) &&
                     aligned16(slab);
  const bool vec_s = s.dv % 4 == 0 && aligned16(s_in);
  // d whole (the encoder's instance), d tiled, or d tiled with a column
  // tile deeper than the shared memory holds (slot_rows > 0)
  auto kernel = s.dk == s.dp       ? rm_fused_apply_kernel<T, kExactW, 0>
                : s.slot_rows == 0 ? rm_fused_apply_kernel<T, kExactW, 1>
                                   : rm_fused_apply_kernel<T, kExactW, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      static_cast<long long>(s.bh) * s.splits * s.n_dvgroups;
  kernel<<<static_cast<unsigned>(blocks), kThreads, s.smem_bytes, stream>>>(
      static_cast<const T*>(q), s_in, n_in, static_cast<const T*>(slab),
      tile_row0, class_tiles, col_deg, col_scale, out, s, eps, vec_x, vec_s);
  return (int)cudaGetLastError();
}

}  // namespace

// sched: n_sched ints, the fields of repro_torch.kernels.common
// NoncausalSchedule. dtype (q and the slab): 0 = fp32, 1 = bf16, 2 = fp32
// with every slab value a TF32 number. Returns cudaGetLastError().
extern "C" int rm_fused_apply_launch(
    const void* q, const float* s_in, const float* n_in, const void* slab,
    const int* tile_row0, const int* class_tiles, const int* col_deg,
    const float* col_scale, float* out, const int* sched, int n_sched,
    float eps, int dtype, void* stream) {
  if (n_sched != rmm::kSchedFields) return (int)cudaErrorInvalidValue;
  Sched s;
  memcpy(&s, sched, sizeof(Sched));
  if (s.bh < 1 || s.t < 1 || s.f < 1 || s.dv < 1 || s.d < 1 ||
      s.n_ct != (s.f + rmm::kColTile - 1) / rmm::kColTile ||
      s.splits < 1 || s.tiles_per_split < 1 || s.n_fgroups != 1 ||
      s.n_dvgroups < 1 || s.dv_per_group < 1 || s.chunk_ct < 1 ||
      s.b_rows != s.chunk_ct * rmm::kColTile || s.dk < 1 || s.dk > s.dp ||
      (s.dk < s.dp && s.ldp < s.slab_cap) ||
      s.slot_rows < 0 || s.slot_rows % rmm::kColTile != 0 ||
      s.slot_rows > s.slab_cap || (s.slot_rows > 0 && s.dk == s.dp) ||
      (s.dv_per_group + 8) / 8 > 4 * rmm::kApplyNI)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, s_in, n_in, slab, tile_row0, class_tiles,
                                col_deg, col_scale, out, s, eps, st);
  if (dtype == 2)
    return launch<float, true>(q, s_in, n_in, slab, tile_row0, class_tiles,
                               col_deg, col_scale, out, s, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, s_in, n_in, slab, tile_row0,
                                        class_tiles, col_deg, col_scale, out,
                                        s, eps, st);
  return (int)cudaErrorInvalidValue;
}
