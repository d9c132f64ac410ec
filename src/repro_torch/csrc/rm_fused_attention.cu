// rm_fused_attention: featurize + causal linear attention + final state,
// for Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_attention/fused.py
// rm_fused_attention_pallas (body _fused_causal_kernel, helpers
// _featurize_block and _clamp). With zq = Z(q), zk = Z(k) * kvalid it
// computes, per batch*head row and chunk of 64 positions,
//
//     scores = tril(zq zk^T)                    (mask once, after the F sum)
//     out    = (scores v + zq S_prev) / clamp(rowsum(scores) + zq n_prev)
//
// with (S_prev, n_prev) the key state of the chunks before this one, and
// writes the whole-prefix (S, n), so prefill gets its decode state from
// the same call. clamp(den) = sign(den) * max(|den|, eps) with den >= 0 ->
// +eps.
//
// Split. The TPU grid runs the chunks in order and carries the state in
// scratch; Hopper's blocks run in no order. So the call is three kernels,
// each parallel over chunks:
//   A. one block per (batch*head, chunk, group of 64-feature tiles, value
//      group): featurize the chunk's keys tile by tile (64 features at a
//      time) and write the chunk's own state dS = zk^T v [F, dv] and dn =
//      colsum(zk) in fp32 (the value tile carries a column of ones, so dn
//      is one more column of the product);
//   P. the exclusive prefix over chunks, in place and in chunk order 0, 1,
//      ...: dS[c] becomes S_prev of chunk c, and the sum of all chunks is
//      the whole-prefix (S, n);
//   B. one block per (batch*head, chunk, value group): for each 64-feature
//      tile, featurize the chunk's queries and keys again (Z never reaches
//      device memory), and add zq zk^T to the scores and zq [S_prev | n_prev]
//      to the numerator; then mask the scores, add tril(scores) [v | 1],
//      and divide.
// The three kernels run on a segment of at most seg_chunks chunks at a time
// (32, 2048 positions: kernels.common.CAUSAL_SEGMENT_CHUNKS), segment after
// segment; the prefix pass of a segment starts from the whole-prefix state
// that the one before wrote. So the scratch of chunk states is seg_chunks
// states a row, not T / 64, and the sums run in the same chunk order as in
// one segment: the result does not depend on the segment length.
// Every sum runs in a fixed order (no atomics), so two calls are bitwise
// equal. The feature axis is tiled, so any F fits; the featurize reads x
// and w from device memory with a loop over d, so any d does too.
//
// Products. The featurize is rm_featurize_mma.cuh's chain: one warp, 16
// rows x one 8-column tile, one mma a degree slot to the tile's own depth;
// fp32 runs 3xTF32 (the omegas' remainder term only where a warp vote finds
// one), bf16 runs bf16 mma. The contractions (dS, the scores, zq S_prev,
// tril(scores) v) run 3xTF32 on fp32 operands in shared memory (mma3).
//
// What bounds it on the card: operations (the featurize of q and k rows,
// the scores over F and the state terms), on the tensor cores; at T 256
// the grid is small (128 pass-B blocks at BH 16, dv 128), so the pass-B
// featurize of a chunk is the critical path.
//
// Layouts: q, k [BH, T, d] fp32 or bf16, T a multiple of 64 (the wrapper
// pads); v [BH, T, dv] fp32; kvalid [BH / heads, T] fp32 (row bh reads
// kvalid row bh / heads); w [kdeg, F, d] of q's type; col_deg [F] int32;
// col_scale [F] fp32 -> out [BH, T, dv], S [BH, F, dv], n [BH, F], all
// fp32; scratch ds [BH, seg_chunks, F, dv], dn [BH, seg_chunks, F] fp32. F,
// d and dv are ragged (masked).
#include <string.h>

#include "rm_featurize_mma.cuh"

namespace {

constexpr int kChunk = 64;             // positions of a chunk
constexpr int kFtCols = 64;            // features of a feature tile
constexpr int kFtTiles = kFtCols / rmm::kColTile;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Z's row strides: pass A reads Z transposed (= 8 mod 32), pass B by rows
// (= 4 mod 8); both conflict-free for the mma fragments
constexpr int kLdzA = 72;
constexpr int kLdzB = 68;
// a pass-B warp's numerator n-tiles (strided by 2 over <= 10)
constexpr int kOutNI = 5;
// a pass-A warp's state n-tiles at a time (strided by 2 over <= 18)
constexpr int kStateNB = 3;

// The plan, field for field repro_torch.kernels.common.CausalSchedule
// (passed as an int array).
struct CSched {
  int bh, heads, t, d, dv, f, n_ct, n_chunks, seg_chunks, n_ftiles,
      ftiles_per_agroup,
      n_agroups, dva_per_group, n_dvagroups, lda, dvb_per_group,
      n_dvbgroups, ldb, smem_a, smem_b;
};
constexpr int kCSchedFields = sizeof(CSched) / sizeof(int);

size_t smem_a_bytes(const CSched& s) {
  return static_cast<size_t>(kChunk) * (kLdzA + s.lda) * 4;
}
size_t smem_b_bytes(const CSched& s) {
  return static_cast<size_t>(kChunk) * (2 * kLdzB + 2 * s.ldb + 1) * 4;
}

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

// The value tile [64 x w] of columns [c0, c0 + w) into vs (row stride ld),
// a column of ones at w and zeros up to 8 nt.
__device__ __forceinline__ void load_values(float* vs, int ld,
                                            const float* __restrict__ vb,
                                            int dv, int w, int nt,
                                            bool vec) {
  rmm::load_rows<float, kThreads>(vs, ld, vb, dv, kChunk, kChunk, w, vec);
  const int extra = 8 * nt - w;
  for (int e = threadIdx.x; e < kChunk * extra; e += kThreads) {
    const int r = e / extra;
    const int c = e - r * extra;
    vs[r * ld + w + c] = c == 0 ? 1.f : 0.f;
  }
}

// z (a chain's fragment) times the rows' multipliers into Z at row group
// rg, column tile ct of the feature tile.
__device__ __forceinline__ void store_z(float* zs, int ldz, int rg, int ct,
                                        const float z[4], float m0, float m8,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* zr = zs + (16 * rg + g) * ldz + ct * rmm::kColTile + 2 * t;
  zr[0] = z[0] * m0;
  zr[1] = z[1] * m0;
  zr[8 * ldz] = z[2] * m8;
  zr[8 * ldz + 1] = z[3] * m8;
}

// ---- pass A: each chunk's own key state
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_state_kernel(const T* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ kvalid, const T* __restrict__ w,
                   const int* __restrict__ col_deg,
                   const float* __restrict__ col_scale, int kdeg,
                   float* __restrict__ ds, float* __restrict__ dn,
                   const CSched s, int chunk0, int n_seg, bool vec_x,
                   bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);          // [64][kLdzA]
  float* vs = zs + kChunk * kLdzA;                      // [64][lda]

  int blk = blockIdx.x;
  const int dvg = blk % s.n_dvagroups;
  blk /= s.n_dvagroups;
  const int ag = blk % s.n_agroups;
  blk /= s.n_agroups;
  const int lc = blk % n_seg;                  // the chunk in its segment
  const int chunk = chunk0 + lc;
  const int bh = blk / n_seg;

  const int c0 = dvg * s.dva_per_group;
  const int wa = min(s.dva_per_group, s.dv - c0);
  const int nt = (wa + 1 + 7) / 8;                     // value tiles + ones
  const size_t row = static_cast<size_t>(bh) * s.t + chunk * kChunk;
  const T* kb = k + row * s.d;
  const float* kvb =
      kvalid + static_cast<size_t>(bh / s.heads) * s.t + chunk * kChunk;
  load_values(vs, s.lda, v + row * s.dv + c0, s.dv, wa, nt, vec_v);
  rmm::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp % 4;
  const float m0 = __ldg(kvb + 16 * rg + g), m8 = __ldg(kvb + 16 * rg + g + 8);
  const size_t state_row = static_cast<size_t>(bh) * s.seg_chunks + lc;
  float* dsb = ds + state_row * s.f * s.dv + c0;
  float* dnb = dn + state_row * s.f;

  const int ft0 = ag * s.ftiles_per_agroup;
  const int ft1 = min(s.n_ftiles, ft0 + s.ftiles_per_agroup);
  for (int ft = ft0; ft < ft1; ++ft) {
    const int nct = min(kFtTiles, s.n_ct - ft * kFtTiles);
    // featurize: warp (rg, half) takes column tiles half, half + 2, ...
    for (int ct = warp / 4; ct < nct; ct += 2) {
      float z[4];
      rmm::chain_z<T>(kb, s.d, 16 * rg, kChunk, w, s.f, s.d, kdeg, col_deg,
                      col_scale, ft * kFtTiles + ct, vec_x, lane, z);
      store_z(zs, kLdzA, rg, ct, z, m0, m8, lane);
    }
    rmm::cp_async_wait<0>();
    __syncthreads();
    // [dS | dn] rows of the tile: feature m-tile m = warp % 4 (if the tile
    // has it) by value n-tiles warp / 4 + 2 i, kStateNB at a time
    const int m = warp % 4;
    if (16 * m < 8 * nct) {
      for (int i0 = 0; 2 * i0 + warp / 4 < nt; i0 += kStateNB) {
        int noff[kStateNB];
#pragma unroll
        for (int i = 0; i < kStateNB; ++i)
          noff[i] = 8 * min(warp / 4 + 2 * (i0 + i), nt - 1);
        float acc[kStateNB][4];
#pragma unroll
        for (int i = 0; i < kStateNB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        rmm::mma3<kStateNB>(zs + 16 * m, 1, kLdzA, vs, s.lda, 1, noff,
                            kChunk, lane, acc);
#pragma unroll
        for (int i = 0; i < kStateNB; ++i) {
          const int n = warp / 4 + 2 * (i0 + i);
          if (n >= nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = ft * kFtCols + 16 * m + g + 8 * h;
            if (f >= s.f) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * n + 2 * t4 + e;
              const float val = acc[i][2 * h + e];
              if (c < wa)
                dsb[static_cast<size_t>(f) * s.dv + c] = val;
              else if (c == wa && dvg == 0)
                dnb[f] = val;
            }
          }
        }
      }
    }
    __syncthreads();                      // Z is free for the next tile
  }
}

// ---- pass P: exclusive prefix over a segment's chunks (in place), from
// the state before the segment (0 for the first, else the (S, n) the last
// segment wrote), and the state after it
__global__ void chunk_prefix_kernel(float* __restrict__ ds,
                                    float* __restrict__ dn,
                                    float* __restrict__ s_out,
                                    float* __restrict__ n_out, int bh,
                                    int seg_chunks, int n_seg, int f, int dv,
                                    bool first) {
  const size_t per_s = static_cast<size_t>(f) * dv;
  const size_t total_s = static_cast<size_t>(bh) * per_s;
  const size_t total = total_s + static_cast<size_t>(bh) * f;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float* p;
    size_t stride;
    float* dst;
    if (idx < total_s) {
      const size_t b = idx / per_s;
      p = ds + b * seg_chunks * per_s + (idx - b * per_s);
      stride = per_s;
      dst = s_out + idx;
    } else {
      const size_t j = idx - total_s;
      const size_t b = j / f;
      p = dn + b * seg_chunks * f + (j - b * f);
      stride = f;
      dst = n_out + j;
    }
    float run = first ? 0.f : *dst;
    for (int c = 0; c < n_seg; ++c) {
      const float val = p[c * stride];
      p[c * stride] = run;
      run += val;
    }
    *dst = run;
  }
}

// ---- pass B: the outputs
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ kvalid, const T* __restrict__ w,
                 const int* __restrict__ col_deg,
                 const float* __restrict__ col_scale, int kdeg,
                 const float* __restrict__ s_prev,
                 const float* __restrict__ n_prev, float* __restrict__ out,
                 const CSched s, int chunk0, int n_seg, float eps,
                 bool vec_x, bool vec_v, bool vec_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zq = reinterpret_cast<float*>(smem);          // [64][kLdzB]
  float* zk = zq + kChunk * kLdzB;                      // [64][kLdzB]
  float* ss = zk + kChunk * kLdzB;                      // [64][ldb]
  float* vs = ss + kChunk * s.ldb;                      // [64][ldb]
  float* dens = vs + kChunk * s.ldb;                    // [64]
  float* sc = zq;                     // the masked scores, after the loop

  int blk = blockIdx.x;
  const int dvg = blk % s.n_dvbgroups;
  blk /= s.n_dvbgroups;
  const int lc = blk % n_seg;
  const int chunk = chunk0 + lc;
  const int bh = blk / n_seg;

  const int c0 = dvg * s.dvb_per_group;
  const int wb = min(s.dvb_per_group, s.dv - c0);
  const int nt = (wb + 1 + 7) / 8;                     // value tiles + den
  const size_t row = static_cast<size_t>(bh) * s.t + chunk * kChunk;
  const T* qb = q + row * s.d;
  const T* kb = k + row * s.d;
  const float* kvb =
      kvalid + static_cast<size_t>(bh / s.heads) * s.t + chunk * kChunk;
  const size_t state_row = static_cast<size_t>(bh) * s.seg_chunks + lc;
  const float* sp = s_prev + state_row * s.f * s.dv + c0;
  const float* np_ = n_prev + state_row * s.f;
  load_values(vs, s.ldb, v + row * s.dv + c0, s.dv, wb, nt, vec_v);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m = warp % 4, half = warp / 4;
  // the featurize: warp (rg = m, half) forms q (half 0) or k (half 1)
  const T* xb = half ? kb : qb;
  float* zdst = half ? zk : zq;
  const float m0 = half ? __ldg(kvb + 16 * m + g) : 1.f;
  const float m8 = half ? __ldg(kvb + 16 * m + g + 8) : 1.f;
  // the scores' n-tiles (keys) and the numerator's (values, den column)
  int noff_sc[4], noff_num[kOutNI];
#pragma unroll
  for (int i = 0; i < 4; ++i) noff_sc[i] = 8 * (4 * half + i);
#pragma unroll
  for (int i = 0; i < kOutNI; ++i)
    noff_num[i] = 8 * min(half + 2 * i, nt - 1);
  float acc_sc[4][4], acc[kOutNI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_sc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kOutNI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int ft = 0; ft < s.n_ftiles; ++ft) {
    const int nct = min(kFtTiles, s.n_ct - ft * kFtTiles);
    __syncthreads();                      // the last tile's readers are done
    rmm::load_state<kThreads>(ss, s.ldb, sp, np_, s.f, s.dv, wb, nt,
                              ft * kFtCols, kFtCols, vec_s);
    rmm::cp_async_commit();
    for (int ct = 0; ct < nct; ++ct) {
      float z[4];
      rmm::chain_z<T>(xb, s.d, 16 * m, kChunk, w, s.f, s.d, kdeg, col_deg,
                      col_scale, ft * kFtTiles + ct, vec_x, lane, z);
      store_z(zdst, kLdzB, m, ct, z, m0, m8, lane);
    }
    rmm::cp_async_wait<0>();
    __syncthreads();
    const int kf = rmm::kColTile * nct;
    // scores += zq zk^T; [num | den] += zq [S_prev | n_prev]
    rmm::mma3<4>(zq + 16 * m * kLdzB, kLdzB, 1, zk, 1, kLdzB, noff_sc, kf,
                 lane, acc_sc);
    rmm::mma3<kOutNI>(zq + 16 * m * kLdzB, kLdzB, 1, ss, s.ldb, 1, noff_num,
                      kf, lane, acc);
  }
  __syncthreads();                        // zq is free: it takes the scores
  // the causal mask, once, after the feature sum
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = 16 * m + g + 8 * h;
        const int key = noff_sc[i] + 2 * t4 + e;
        sc[qr * kLdzB + key] = key <= qr ? acc_sc[i][2 * h + e] : 0.f;
      }
  __syncthreads();
  // [num | den] += tril(scores) [v | 1]
  rmm::mma3<kOutNI>(sc + 16 * m * kLdzB, kLdzB, 1, vs, s.ldb, 1, noff_num,
                    kChunk, lane, acc);
  // the denominators: column wb, held by one lane pair of the warps owning
  // value tile wb / 8
  const int nd = wb / 8, ed = wb % 8;
#pragma unroll
  for (int i = 0; i < kOutNI; ++i) {
    if (half + 2 * i == nd && 2 * t4 == (ed & ~1)) {
      const bool odd = ed & 1;
      dens[16 * m + g] = clamp_den(odd ? acc[i][1] : acc[i][0], eps);
      dens[16 * m + g + 8] = clamp_den(odd ? acc[i][3] : acc[i][2], eps);
    }
  }
  __syncthreads();
  float* ob = out + row * s.dv + c0;
#pragma unroll
  for (int i = 0; i < kOutNI; ++i) {
    const int n = half + 2 * i;
    if (n >= nt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      const float dn = dens[r];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e;
        if (c < wb) ob[static_cast<size_t>(r) * s.dv + c] = acc[i][2 * h + e] / dn;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const float* v, const float* kvalid,
           const void* w, const int* col_deg, const float* col_scale,
           int kdeg, float* out, float* s_out, float* n_out, float* ds,
           float* dn, const CSched& s, float eps, cudaStream_t stream) {
  if (smem_a_bytes(s) != static_cast<size_t>(s.smem_a) ||
      smem_b_bytes(s) != static_cast<size_t>(s.smem_b))
    return (int)cudaErrorInvalidValue;
  const bool vec_x = (static_cast<size_t>(s.d) * sizeof(T)) % 16 == 0 &&
                     aligned16(q) && aligned16(k) && aligned16(w);
  const bool vec_v = s.dv % 4 == 0 && aligned16(v);
  const bool vec_s = s.dv % 4 == 0 && aligned16(ds);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s.smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             s.smem_b);
  if (err != cudaSuccess) return (int)err;
  const size_t total = static_cast<size_t>(s.bh) * s.f * (s.dv + 1);
  size_t grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;   // a grid-stride loop does the rest
  for (int chunk0 = 0; chunk0 < s.n_chunks; chunk0 += s.seg_chunks) {
    const int n_seg = s.n_chunks - chunk0 < s.seg_chunks
                          ? s.n_chunks - chunk0 : s.seg_chunks;
    const long long blocks_a =
        static_cast<long long>(s.bh) * n_seg * s.n_agroups * s.n_dvagroups;
    chunk_state_kernel<T><<<static_cast<unsigned>(blocks_a), kThreads,
                            s.smem_a, stream>>>(
        static_cast<const T*>(k), v, kvalid, static_cast<const T*>(w),
        col_deg, col_scale, kdeg, ds, dn, s, chunk0, n_seg, vec_x, vec_v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunk_prefix_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
        ds, dn, s_out, n_out, s.bh, s.seg_chunks, n_seg, s.f, s.dv,
        chunk0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks_b =
        static_cast<long long>(s.bh) * n_seg * s.n_dvbgroups;
    chunk_out_kernel<T><<<static_cast<unsigned>(blocks_b), kThreads,
                          s.smem_b, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), v, kvalid,
        static_cast<const T*>(w), col_deg, col_scale, kdeg, ds, dn, out, s,
        chunk0, n_seg, eps, vec_x, vec_v, vec_s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// sched: n_sched ints, the fields of repro_torch.kernels.common
// CausalSchedule; ds [BH, seg_chunks, F, dv] and dn [BH, seg_chunks, F]
// fp32 scratch. dtype (q, k and w): 0 = fp32, 1 = bf16. Returns
// cudaGetLastError() of the last launch (or of the first that failed).
extern "C" int rm_fused_causal_launch(
    const void* q, const void* k, const float* v, const float* kvalid,
    const void* w, const int* col_deg, const float* col_scale, float* out,
    float* s_out, float* n_out, float* ds, float* dn, const int* sched,
    int n_sched, int kdeg, float eps, int dtype, void* stream) {
  if (n_sched != kCSchedFields) return (int)cudaErrorInvalidValue;
  CSched s;
  memcpy(&s, sched, sizeof(CSched));
  if (s.bh < 1 || s.heads < 1 || s.bh % s.heads != 0 || s.t < kChunk ||
      s.t % kChunk != 0 || s.d < 1 ||
      s.dv < 1 || s.f < 1 || kdeg < 1 ||
      s.n_ct != (s.f + rmm::kColTile - 1) / rmm::kColTile ||
      s.n_chunks != s.t / kChunk || s.seg_chunks < 1 ||
      s.seg_chunks > s.n_chunks ||
      s.n_ftiles != (s.n_ct + kFtTiles - 1) / kFtTiles ||
      s.ftiles_per_agroup < 1 || s.n_agroups < 1 ||
      s.n_agroups * s.ftiles_per_agroup < s.n_ftiles ||
      s.n_dvagroups < 1 || s.dva_per_group < 1 ||
      s.n_dvagroups * s.dva_per_group < s.dv ||
      (s.dva_per_group + 8) / 8 > 2 * 9 ||
      s.n_dvbgroups < 1 || s.dvb_per_group < 1 ||
      s.n_dvbgroups * s.dvb_per_group < s.dv ||
      (s.dvb_per_group + 8) / 8 > 2 * kOutNI)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kvalid, w, col_deg, col_scale, kdeg, out,
                         s_out, n_out, ds, dn, s, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kvalid, w, col_deg, col_scale,
                                 kdeg, out, s_out, n_out, ds, dn, s, eps,
                                 st);
  return (int)cudaErrorInvalidValue;
}
