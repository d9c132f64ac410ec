// The tensor-core featurize of the Random Maclaurin map, shared by every
// RM kernel: B1 (rm_feature.cu), B2 (rm_fused_attention.cu), B3
// (rm_fused_state.cu), B4 (rm_fused_apply.cu) and B9 (rm_feature_bucket.cu).
//
// The mma products (Proj, Chain) and the precision rules below are shared;
// B3 and B4 drive them through featurize_tile, B2 and B1's decode-sized
// batches through chain_z, B9's small batches through chain_product (the
// same chain over any omega row address), and B1's Gram-sized batches call
// Proj on a staged x tile (rm_feature.cu). B9's Gram-sized batches use the
// fragments, ldmatrix layouts and precision rules here with the x
// fragments held in registers (rm_feature_bucket.cu).
//
// B3 and B4 (featurize_tile): for a 64-row tile x (keys or queries) it
// forms
//
//     z[r][f] = col_scale[f] * prod_{j < col_deg[f]} <w[j, f, :], x[r, :]>
//
// one 8-column *column tile* at a time, reading the omegas from the slab
// (repro_torch.kernels.rm_attention.noncausal): column tile c's slot j is
// the 8 slab rows tile_row0[c] + 8 j .. + 7. Each slot is one [16 x dp] x
// [dp x 8] mma product of a warp, and the running product over slots stays
// in the mma's accumulator registers, so a tile costs its own depth (the
// largest degree of its 8 columns), not the depth of 64 columns.
//
// Precision. fp32 inputs run 3xTF32: each operand is split into a TF32
// high part and a TF32 remainder, and hi*lo + lo*hi + hi*hi accumulate in
// fp32 on the tensor cores (lo*lo, about 2^-22 of the product, is
// dropped), which keeps fp32-level sums at up to a third of the TF32 rate.
// Where every slab value is a TF32 number (kExactW: the rm plans' +-1 and
// one-hot omegas), its remainder is 0 and hi(x)*lo(w) is skipped.
// bf16 inputs run bf16 m16n8k16 mma with fp32 accumulation: the products
// are exact. The contractions that follow (B3's S, B4's numerator) always
// run 3xTF32: Z and v are fp32.
//
// Why mma.sync and not wgmma: 3xTF32 needs both halves of both operands;
// with wgmma the B operand must sit in shared memory, so a general slab's
// remainder would double the 102 KB (fp32) slab the block keeps resident
// (the point of the design), and the contractions' B operands (v, S) are
// general fp32. mma.sync takes both operands from registers, so the split
// happens as a fragment is loaded. wgmma for the exact-TF32 slab is later
// work (ROADMAP queue B).
//
// Warp layout (16 warps, 512 threads: four to a scheduler, to hide the
// latency of dependent mma): in the featurize, warp w owns rows 32 (w % 2)
// .. + 31 of the tile (two 16-row groups, which share each B fragment) and
// the column tiles of class w / 2 (dealt out by the pack so that the eight
// classes carry about equal depth), whose slots it projects two at a time
// (sharing each A fragment); each writes its z fragments to the shared
// feature tile Z (64 x ldz fp32), from which the contraction reads them in
// the layout its warps need. Every product runs as several
// independent accumulator chains (two row groups x two slots x the large
// and small 3xTF32 terms), so a warp has work while an mma is in flight.
//
// Masking: rows past the data load as zero; a column past F carries
// degree 0 and scale 0, so its z is 0; slots past a column's degree
// multiply by 1 (their slab rows are zero and are never used).
//
// Depth d past shared memory (featurize_tile_dchunks): where the 64-row x
// tile and one column tile's slab rows do not fit together, the schedule
// sets Sched::dk < dp, and the projections accumulate over chunks of dk
// columns of d, the x tile and the slab rows staged one chunk at a time,
// in a shared projection tile P (64 rows x the chunk's slab rows, fp32);
// the running products are then formed from P. A column tile deeper than
// that (its slab rows and their P rows do not fit even at the narrowest
// chunk: depth above about 80) is featurized a piece of Sched::slot_rows
// slab rows at a time (featurize_deep_tile), the running product carried
// across the pieces in registers.
//
// B1 and B2 (chain_z): one warp forms z of 16 rows x one 8-column tile,
// reading x and w [kdeg, F, d] straight from device memory (no pack: the
// columns of w are the features, so a column tile's slot j is the 8 rows
// w[j, 8 c .. 8 c + 7]), to the tile's own depth (the largest degree of
// its 8 columns), with a loop over d. Each lane loads 32 contiguous bytes
// of a row per step (two 16-byte loads): the mma's k index is permuted
// within each 32-byte run per lane, the same way for x and w, which
// leaves every dot product unchanged. fp32 runs 3xTF32; the hi(x) lo(w)
// term is skipped for a step where a warp vote finds every omega word of
// the step a TF32 number (the rm plans' +-1 are), which adds exact zeros
// where it runs, so the result does not depend on the vote.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmm {

constexpr int kRows = 64;        // rows of a tile
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kColTile = 8;      // feature columns of a column tile
// The featurize: a warp takes kWarpRowGroups 16-row groups (half of the
// tile) and one of kColClasses classes of column tiles.
constexpr int kWarpRowGroups = 2;
constexpr int kRowHalves = kRows / (16 * kWarpRowGroups);
constexpr int kColClasses = kWarps / kRowHalves;
// B3: a warp's (16 x 8) state tiles, kStateMI feature tiles by kStateNI
// value tiles, strided by 4 over a 4 x 4 grid of warps
constexpr int kStateMI = 3;
constexpr int kStateNI = 3;
// B4: a warp's (16 x 8) output tiles: one query tile by kApplyNI value
// tiles, strided by 4
constexpr int kApplyNI = 3;

// The work and shared-memory plan, field for field
// repro_torch.kernels.common.NoncausalSchedule (passed as an int array).
struct Sched {
  int bh, t, d, dv, f, n_ct, splits, tiles_per_split, ct_per_group,
      n_fgroups, dv_per_group, n_dvgroups, dp, ldx, slab_cap, ldb, b_rows,
      ldz, chunk_ct, dk, ldp, smem_bytes, slot_rows;
};
constexpr int kSchedFields = sizeof(Sched) / sizeof(int);

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory regions (the order of
// NoncausalSchedule's docstring).
struct Smem {
  size_t slab, x, b, z, p, den, total;
};

template <typename T>
__host__ __device__ inline Smem smem_layout(const Sched& s, bool with_den) {
  Smem m;
  m.slab = 0;
  m.x = round16(static_cast<size_t>(s.slab_cap) * s.ldx * sizeof(T));
  m.b = m.x + round16(static_cast<size_t>(kRows) * s.ldx * sizeof(T));
  m.z = m.b + static_cast<size_t>(s.b_rows) * s.ldb * 4;
  m.p = m.z + static_cast<size_t>(kRows) * s.ldz * 4;
  m.den = m.p + static_cast<size_t>(kRows) * s.ldp * 4;
  m.total = m.den + (with_den ? kRows * 4 : 0);
  return m;
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ---- asynchronous copies (cp.async, 16 bytes, zero-filled past the data)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [0, rows) x columns [0, cols) of a row-major global array (row
// stride gld elements) into shared memory (row stride sld); rows >=
// valid_rows come in as zeros, columns >= cols are left alone. vec: 16-byte
// cp.async (cols and gld multiples of 16 bytes, src 16-byte aligned);
// otherwise plain loads and stores. NT: the block's threads.
template <typename T, int NT = kThreads>
__device__ __forceinline__ void load_rows(T* dst, int sld, const T* src,
                                          size_t gld, int rows,
                                          int valid_rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = cols / kPer;
    for (int e = threadIdx.x; e < rows * chunks; e += NT) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * kPer;
      const bool ok = r < valid_rows;
      cp_async16(dst + r * sld + c, ok ? src + r * gld + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[r * sld + c] = r < valid_rows ? src[r * gld + c] : zero_of<T>();
    }
  }
}

// Zero columns [c0, c1) of rows [0, rows) (the MMA depth padding past d).
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int sld, int rows, int c0,
                                          int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < rows * w; e += kThreads) {
    const int r = e / w;
    dst[r * sld + c0 + (e - r * w)] = zero_of<T>();
  }
}

// Rows [f0, f0 + rows) of [S | n | 0] for value columns [c0, c0 + w) (the
// caller offsets s_bh by c0): S in columns [0, w) (by cp.async when vec: w
// and the row stride in whole 16 bytes), n in column w, zeros up to 8 nt;
// rows past F are zero.
template <int NT = kThreads>
__device__ __forceinline__ void load_state(float* ss, int ldb,
                                           const float* __restrict__ s_bh,
                                           const float* __restrict__ n_bh,
                                           int f, int dv, int w, int nt,
                                           int f0, int rows, bool vec) {
  const int first = vec ? w : 0;         // the columns of the plain path
  if (vec)
    load_rows<float, NT>(ss, ldb, s_bh + static_cast<size_t>(f0) * dv, dv,
                         rows, f - f0, w, true);
  const int cols = 8 * nt - first;
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols;
    const int c = first + e - r * cols;
    const int fr = f0 + r;
    float val = 0.f;
    if (fr < f) {
      if (c < w)
        val = __ldg(s_bh + static_cast<size_t>(fr) * dv + c);
      else if (c == w)
        val = __ldg(n_bh + fr);
    }
    ss[r * ldb + c] = val;
  }
}

// ---- tensor-core products
// x = hi + lo: hi rounded to TF32, lo = x - hi exactly in fp32. lo goes to
// the mma as it is: a .tf32 operand's low 13 bits are not read, which
// truncates lo to TF32 at a cost of about 2^-22 of x, the size of the lo*lo
// term 3xTF32 drops anyway.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16n8k8 fragment of A (16 x 8) whose element (m, k) is p[m * sm + k *
// sk], split into TF32 high and low parts: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) for lane = 4 g + t.
__device__ __forceinline__ void frag_a(const float* p, int sm, int sk,
                                       int lane, uint32_t hi[4],
                                       uint32_t lo[4]) {
  const float* q = p + (lane >> 2) * sm + (lane & 3) * sk;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[8 * sm], hi[1], lo[1]);
  split_tf32(q[4 * sk], hi[2], lo[2]);
  split_tf32(q[8 * sm + 4 * sk], hi[3], lo[3]);
}

// An m16n8k8 fragment of B (8 x 8) whose element (k, n) is p[k * sk + n *
// sn]: (t, g), (t + 4, g).
__device__ __forceinline__ void frag_b(const float* p, int sk, int sn,
                                       int lane, uint32_t hi[2],
                                       uint32_t lo[2]) {
  const float* q = p + (lane & 3) * sk + (lane >> 2) * sn;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[4 * sk], hi[1], lo[1]);
}

// ldmatrix: four (x4) or two (x2) 8 x 8 matrices of 16-bit elements, that
// is 8 rows of 16 bytes each, from the row addresses of lanes 0-31 (0-15);
// lane 4 g + t receives word t of row g of each matrix. On fp32 rows (4 to
// a matrix row) that is the tf32 mma fragment layout, on bf16 rows the
// bf16 one, in one instruction instead of four or two loads.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// The row a lane addresses for ldsm_x4 on a 16-row A tile (m16 x 16
// bytes x 2): row (lane % 8) + 8 ((lane / 8) % 2), 16-byte half lane / 16;
// for ldsm_x2 on an 8-row B tile: row lane % 8, half (lane / 8) % 2.
__device__ __forceinline__ int ldsm_a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldsm_a_half(int lane) { return lane >> 4; }
__device__ __forceinline__ int ldsm_b_half(int lane) {
  return (lane >> 3) & 1;
}

// Split loaded fp32 words into TF32 high and low parts, in place.
template <int N>
__device__ __forceinline__ void split_words(const uint32_t w[N],
                                            uint32_t hi[N], uint32_t lo[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(w[i]), hi[i], lo[i]);
}

// p[s][r] = X_r[16 x dp] W_s[8 x dp]^T for the kWarpRowGroups groups r of
// 16 rows at x (stride ldx; group r at row 16 r) and NW sets s of 8 slab
// rows at w[s] (stride lds), as m16n8 accumulator fragments. Each A
// fragment serves all NW slab tiles and each B fragment both row groups;
// the products run in 2 NW kWarpRowGroups independent accumulator chains.
template <typename T> struct Proj;

template <> struct Proj<float> {
  // kExactW: every slab value is a TF32 number (the Rademacher +-1 and
  // one-hot omegas of the rm plans are), so its low part is 0 and the
  // hi(x) * lo(w) term, exactly 0, is skipped.
  template <int NW, bool kExactW>
  static __device__ __forceinline__ void run(
      const float* x, int ldx, const float* const w[NW], int lds, int dp,
      int lane, float p[NW][kWarpRowGroups][4]) {
    // per slab tile and row group: the large term hi*hi in one chain, the
    // two small terms hi*lo and lo*hi in another
    float big[NW][kWarpRowGroups][4], small[NW][kWarpRowGroups][4];
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[t][r][i] = small[t][r][i] = 0.f;
    const float* xl = x + ldsm_a_row(lane) * ldx + 4 * ldsm_a_half(lane);
    const float* wl[NW];
#pragma unroll
    for (int t = 0; t < NW; ++t)
      wl[t] = w[t] + (lane & 7) * lds + 4 * ldsm_b_half(lane);
#pragma unroll 2
    for (int k0 = 0; k0 < dp; k0 += 8) {
      uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
      for (int t = 0; t < NW; ++t) {
        uint32_t b[2];
        ldsm_x2(b, wl[t] + k0);
        if (kExactW) {
          bh[t][0] = b[0];
          bh[t][1] = b[1];
        } else {
          split_words<2>(b, bh[t], bl[t]);
        }
      }
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a, xl + 16 * r * ldx + k0);
        split_words<4>(a, ah, al);
#pragma unroll
        for (int t = 0; t < NW; ++t) mma_tf32(small[t][r], al, bh[t]);
        if (!kExactW) {
#pragma unroll
          for (int t = 0; t < NW; ++t) mma_tf32(small[t][r], ah, bl[t]);
        }
#pragma unroll
        for (int t = 0; t < NW; ++t) mma_tf32(big[t][r], ah, bh[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[t][r][i] = small[t][r][i] + big[t][r][i];
  }
};

template <> struct Proj<__nv_bfloat16> {
  // one k-step of 16 into accumulator set c: m16n8k16 bf16 fragments by
  // ldmatrix
  template <int NW>
  static __device__ __forceinline__ void step(
      const __nv_bfloat16* xl, int ldx, const __nv_bfloat16* const wl[NW],
      int k0, float c[NW][kWarpRowGroups][4]) {
    uint32_t b[NW][2];
#pragma unroll
    for (int t = 0; t < NW; ++t) ldsm_x2(b[t], wl[t] + k0);
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      uint32_t a[4];
      ldsm_x4(a, xl + 16 * r * ldx + k0);
#pragma unroll
      for (int t = 0; t < NW; ++t) mma_bf16(c[t][r], a, b[t]);
    }
  }
  template <int NW, bool kExactW>
  static __device__ __forceinline__ void run(
      const __nv_bfloat16* x, int ldx, const __nv_bfloat16* const w[NW],
      int lds, int dp, int lane, float p[NW][kWarpRowGroups][4]) {
    const __nv_bfloat16* xl =
        x + ldsm_a_row(lane) * ldx + 8 * ldsm_a_half(lane);
    const __nv_bfloat16* wl[NW];
#pragma unroll
    for (int t = 0; t < NW; ++t)
      wl[t] = w[t] + (lane & 7) * lds + 8 * ldsm_b_half(lane);
    // alternate k-steps go to two accumulator sets
    float c0[NW][kWarpRowGroups][4], c1[NW][kWarpRowGroups][4];
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) c0[t][r][i] = c1[t][r][i] = 0.f;
    int k0 = 0;
    for (; k0 + 32 <= dp; k0 += 32) {
      step<NW>(xl, ldx, wl, k0, c0);
      step<NW>(xl, ldx, wl, k0 + 16, c1);
    }
    if (k0 < dp) step<NW>(xl, ldx, wl, k0, c0);
#pragma unroll
    for (int t = 0; t < NW; ++t)
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[t][r][i] = c0[t][r][i] + c1[t][r][i];
  }
};

// The last column tile (exclusive) of the chunk that starts at ca: as many
// tiles as fit chunk_ct tiles and slab_cap slab rows (at least one).
__device__ __forceinline__ int chunk_end(const int* __restrict__ tile_row0,
                                         int ca, int c_hi, int chunk_ct,
                                         int slab_cap) {
  const int r0 = __ldg(tile_row0 + ca);
  int cb = ca + 1;
  while (cb < c_hi && cb + 1 - ca <= chunk_ct &&
         __ldg(tile_row0 + cb + 1) - r0 <= slab_cap)
    ++cb;
  return cb;
}

// Z of the 64-row tile xs (stride ldx, d padded with zeros to dp) for the
// column tiles in [c_lo, c_hi), whose slab rows start at slab row
// slab_row_base of slab_s (stride lds). Warp w takes rows 32 (w % 2) .. +
// 31 and the column tiles of class w / 2: class_tiles holds the classes'
// starts (kColClasses + 1 ints), then each class's tiles in order
// (noncausal.pack_noncausal). The warp walks its (column tile, slot)
// pairs two at a time, so each k-step's x fragments serve two slab tiles.
// Column tile c goes to columns (c - zc0) * 8 .. + 7 of zs (64 x ldz
// fp32). Row r is multiplied by rowmul[r] for r < valid_rows and by 0 past
// them when rowmul is given (B3's kvalid), by 1 otherwise.
template <typename T, bool kExactW>
__device__ __forceinline__ void featurize_tile(
    const T* xs, int ldx, int dp, const T* slab_s, int lds,
    int slab_row_base, const int* __restrict__ tile_row0,
    const int* __restrict__ class_tiles, const int* __restrict__ col_deg,
    const float* __restrict__ col_scale, int c_lo, int c_hi, int zc0,
    float* zs, int ldz, const float* __restrict__ rowmul, int valid_rows) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * kWarpRowGroups * (warp % kRowHalves);
  const int cls = warp / kRowHalves;
  // the multiplier of rows row0 + g + 8 h, h < 2 kWarpRowGroups
  float mul[2 * kWarpRowGroups];
#pragma unroll
  for (int h = 0; h < 2 * kWarpRowGroups; ++h) {
    const int r = row0 + g + 8 * h;
    mul[h] = rowmul == nullptr ? 1.f
                               : (r < valid_rows ? __ldg(rowmul + r) : 0.f);
  }
  const T* xw = xs + row0 * ldx;
  // z of column tile c (its running product) to Z, times scale and rows
  auto store = [&](int c, const float z[kWarpRowGroups][4]) {
    const int f = c * kColTile + 2 * t;
    const float s0 = __ldg(col_scale + f), s1 = __ldg(col_scale + f + 1);
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      float* zr = zs + (row0 + 16 * r + g) * ldz + (c - zc0) * kColTile +
                  2 * t;
      zr[0] = z[r][0] * s0 * mul[2 * r];
      zr[1] = z[r][1] * s1 * mul[2 * r];
      zr[8 * ldz] = z[r][2] * s0 * mul[2 * r + 1];
      zr[8 * ldz + 1] = z[r][3] * s1 * mul[2 * r + 1];
    }
  };
  // the stream of (column tile, slot) pairs: position (c, j) in a tile of
  // `depth` slots whose slab rows start at r0; c = -1 at the end. A tile
  // of depth 0 is stored (its scale) as the stream passes it.
  int i = __ldg(class_tiles + cls);
  const int i_end = __ldg(class_tiles + cls + 1);
  int c = -1, depth = 0, j = 0, r0 = 0;
  auto next_tile = [&]() {
    c = -1;
    for (; i < i_end; ++i) {
      const int cc = __ldg(class_tiles + kColClasses + 1 + i);
      if (cc < c_lo || cc >= c_hi) continue;
      const int ra = __ldg(tile_row0 + cc);
      const int dd = (__ldg(tile_row0 + cc + 1) - ra) / kColTile;
      if (dd == 0) {
        float z1[kWarpRowGroups][4];
#pragma unroll
        for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) z1[r][e] = 1.f;
        store(cc, z1);
        continue;
      }
      c = cc;
      depth = dd;
      j = 0;
      r0 = ra;
      ++i;
      return;
    }
  };
  // the product being built: column tile zc (-1: none) and its degrees
  int zc = -1, deg0 = 0, deg1 = 0;
  float z[kWarpRowGroups][4];
  auto fold = [&](int cc, int jj, const float pr[kWarpRowGroups][4]) {
    if (cc != zc) {
      if (zc >= 0) store(zc, z);
      zc = cc;
      deg0 = __ldg(col_deg + cc * kColTile + 2 * t);
      deg1 = __ldg(col_deg + cc * kColTile + 2 * t + 1);
#pragma unroll
      for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[r][e] = 1.f;
    }
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      if (jj < deg0) {
        z[r][0] *= pr[r][0];
        z[r][2] *= pr[r][2];
      }
      if (jj < deg1) {
        z[r][1] *= pr[r][1];
        z[r][3] *= pr[r][3];
      }
    }
  };
  next_tile();
  while (c >= 0) {
    const int ca = c, ja = j;
    const T* wa = slab_s +
                  static_cast<size_t>(r0 - slab_row_base + kColTile * j) * lds;
    if (++j == depth) next_tile();
    if (c < 0) {
      const T* w1[1] = {wa};
      float p1[1][kWarpRowGroups][4];
      Proj<T>::template run<1, kExactW>(xw, ldx, w1, lds, dp, lane, p1);
      fold(ca, ja, p1[0]);
      break;
    }
    const int cb = c, jb = j;
    const T* w2[2] = {
        wa, slab_s +
                static_cast<size_t>(r0 - slab_row_base + kColTile * j) * lds};
    if (++j == depth) next_tile();
    float p2[2][kWarpRowGroups][4];
    Proj<T>::template run<2, kExactW>(xw, ldx, w2, lds, dp, lane, p2);
    fold(ca, ja, p2[0]);
    fold(cb, jb, p2[1]);
  }
  if (zc >= 0) store(zc, z);
}


// Z of featurize_tile when d is tiled (Sched::dk < Sched::dp): for the
// column tiles [ca, cb) of the warp's class, whose slab rows [ra, rb) fit
// slab_cap, each chunk of dk columns of d brings in that chunk of the x
// tile (xg: row 0 of the tile in device memory, row stride d, nrows rows;
// rows past them load as zeros) and of the slab rows (slab_g: the whole
// slab), and every warp adds its (column tile, slot) projections over the
// chunk into the shared projection tile P (ps: 64 x ldp fp32, column =
// slab row - ra). Each lane adds to the places of its own mma fragments
// and reads only those back, so the chunks sum in the order 0, 1, ...
// with no barrier of their own. Then each warp forms its tiles' running
// products from P into Z, as featurize_tile does. Starts and ends with a
// barrier's worth of ordering: it first waits for the block (the last
// readers of xs and slab_s), and Z is the caller's to publish.
template <typename T, bool kExactW>
__device__ void featurize_tile_dchunks(
    const T* __restrict__ xg, int nrows, const T* __restrict__ slab_g,
    const Sched& s, T* xs, T* slab_s, float* ps,
    const int* __restrict__ tile_row0, const int* __restrict__ class_tiles,
    const int* __restrict__ col_deg, const float* __restrict__ col_scale,
    int ca, int cb, int zc0, float* zs, const float* __restrict__ rowmul,
    int valid_rows, bool vec) {
  constexpr int kDepthStep = sizeof(T) == 4 ? 8 : 16;   // one mma's k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * kWarpRowGroups * (warp % kRowHalves);
  const int cls = warp / kRowHalves;
  const int i0 = __ldg(class_tiles + cls), i1 = __ldg(class_tiles + cls + 1);
  const int ra = __ldg(tile_row0 + ca);
  const int rows = __ldg(tile_row0 + cb) - ra;
  const T* xw = xs + row0 * s.ldx;
  // P += (or =) one slot tile's projections at P column pc
  auto add = [&](int pc, const float pr[kWarpRowGroups][4], bool first) {
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      float* q = ps + (row0 + 16 * r + g) * s.ldp + pc + 2 * t;
      if (first) {
        q[0] = pr[r][0];
        q[1] = pr[r][1];
        q[8 * s.ldp] = pr[r][2];
        q[8 * s.ldp + 1] = pr[r][3];
      } else {
        q[0] += pr[r][0];
        q[1] += pr[r][1];
        q[8 * s.ldp] += pr[r][2];
        q[8 * s.ldp + 1] += pr[r][3];
      }
    }
  };
  for (int k0 = 0; k0 < s.d; k0 += s.dk) {
    const int kw = min(s.dk, s.d - k0);
    const int kp = (kw + kDepthStep - 1) / kDepthStep * kDepthStep;
    __syncthreads();                    // the last chunk's readers are done
    load_rows(xs, s.ldx, xg + k0, s.d, kRows, nrows, kw, vec);
    load_rows(slab_s, s.ldx, slab_g + static_cast<size_t>(ra) * s.d + k0,
              s.d, rows, rows, kw, vec);
    zero_cols(xs, s.ldx, kRows, kw, kp);
    zero_cols(slab_s, s.ldx, rows, kw, kp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = i0; i < i1; ++i) {
      const int c = __ldg(class_tiles + kColClasses + 1 + i);
      if (c < ca || c >= cb) continue;
      const int pc = __ldg(tile_row0 + c) - ra;
      const int depth = (__ldg(tile_row0 + c + 1) - __ldg(tile_row0 + c)) /
                        kColTile;
      int j = 0;
      for (; j + 1 < depth; j += 2) {
        const T* w2[2] = {slab_s + (pc + kColTile * j) * s.ldx,
                          slab_s + (pc + kColTile * (j + 1)) * s.ldx};
        float p2[2][kWarpRowGroups][4];
        Proj<T>::template run<2, kExactW>(xw, s.ldx, w2, s.ldx, kp, lane,
                                          p2);
        add(pc + kColTile * j, p2[0], k0 == 0);
        add(pc + kColTile * (j + 1), p2[1], k0 == 0);
      }
      if (j < depth) {
        const T* w1[1] = {slab_s + (pc + kColTile * j) * s.ldx};
        float p1[1][kWarpRowGroups][4];
        Proj<T>::template run<1, kExactW>(xw, s.ldx, w1, s.ldx, kp, lane,
                                          p1);
        add(pc + kColTile * j, p1[0], k0 == 0);
      }
    }
  }
  // the running products of the warp's tiles, from P
  float mul[2 * kWarpRowGroups];
#pragma unroll
  for (int h = 0; h < 2 * kWarpRowGroups; ++h) {
    const int r = row0 + g + 8 * h;
    mul[h] = rowmul == nullptr ? 1.f
                               : (r < valid_rows ? __ldg(rowmul + r) : 0.f);
  }
  for (int i = i0; i < i1; ++i) {
    const int c = __ldg(class_tiles + kColClasses + 1 + i);
    if (c < ca || c >= cb) continue;
    const int pc = __ldg(tile_row0 + c) - ra;
    const int depth = (__ldg(tile_row0 + c + 1) - __ldg(tile_row0 + c)) /
                      kColTile;
    const int f = c * kColTile + 2 * t;
    const int deg0 = __ldg(col_deg + f), deg1 = __ldg(col_deg + f + 1);
    const float s0 = __ldg(col_scale + f), s1 = __ldg(col_scale + f + 1);
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      float z0 = 1.f, z1 = 1.f, z2 = 1.f, z3 = 1.f;
      const float* q = ps + (row0 + 16 * r + g) * s.ldp + pc + 2 * t;
      for (int j = 0; j < depth; ++j) {
        const float* qj = q + kColTile * j;
        if (j < deg0) {
          z0 *= qj[0];
          z2 *= qj[8 * s.ldp];
        }
        if (j < deg1) {
          z1 *= qj[1];
          z3 *= qj[8 * s.ldp + 1];
        }
      }
      float* zr = zs + (row0 + 16 * r + g) * s.ldz + (c - zc0) * kColTile +
                  2 * t;
      zr[0] = z0 * s0 * mul[2 * r];
      zr[1] = z1 * s1 * mul[2 * r];
      zr[8 * s.ldz] = z2 * s0 * mul[2 * r + 1];
      zr[8 * s.ldz + 1] = z3 * s1 * mul[2 * r + 1];
    }
  }
}

// featurize_tile_dchunks for one column tile c whose slab rows exceed
// slab_cap (the schedule's slot_rows > 0): its slots go a piece of
// slot_rows / 8 at a time, each piece a d chunk at a time as above (the x
// chunk and the piece's slab rows staged, the projections summed in P),
// and the tile's warps (the two of its class) fold each piece into the
// running product, which they keep in registers across the pieces; then
// they write z to Z as featurize_tile_dchunks does. Every thread keeps
// the barriers. The same ordering contract as featurize_tile_dchunks.
template <typename T, bool kExactW>
__device__ void featurize_deep_tile(
    const T* __restrict__ xg, int nrows, const T* __restrict__ slab_g,
    const Sched& s, T* xs, T* slab_s, float* ps,
    const int* __restrict__ tile_row0, const int* __restrict__ class_tiles,
    const int* __restrict__ col_deg, const float* __restrict__ col_scale,
    int c, int zc0, float* zs, const float* __restrict__ rowmul,
    int valid_rows, bool vec) {
  constexpr int kDepthStep = sizeof(T) == 4 ? 8 : 16;   // one mma's k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * kWarpRowGroups * (warp % kRowHalves);
  const int cls = warp / kRowHalves;
  bool mine = false;
  for (int i = __ldg(class_tiles + cls); i < __ldg(class_tiles + cls + 1);
       ++i)
    mine |= __ldg(class_tiles + kColClasses + 1 + i) == c;
  const int ra = __ldg(tile_row0 + c);
  const int depth = (__ldg(tile_row0 + c + 1) - ra) / kColTile;
  const int piece = s.slot_rows / kColTile;        // slots a piece
  const int f = c * kColTile + 2 * t;
  const int deg0 = __ldg(col_deg + f), deg1 = __ldg(col_deg + f + 1);
  const T* xw = xs + row0 * s.ldx;
  float z[kWarpRowGroups][4];
#pragma unroll
  for (int r = 0; r < kWarpRowGroups; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[r][e] = 1.f;
  // P = (or +=) one slot tile's projections at P column pc
  auto add = [&](int pc, const float pr[kWarpRowGroups][4], bool first) {
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      float* q = ps + (row0 + 16 * r + g) * s.ldp + pc + 2 * t;
      q[0] = first ? pr[r][0] : q[0] + pr[r][0];
      q[1] = first ? pr[r][1] : q[1] + pr[r][1];
      q[8 * s.ldp] = first ? pr[r][2] : q[8 * s.ldp] + pr[r][2];
      q[8 * s.ldp + 1] = first ? pr[r][3] : q[8 * s.ldp + 1] + pr[r][3];
    }
  };
  for (int j0 = 0; j0 < depth; j0 += piece) {
    const int ns = min(piece, depth - j0);
    const int rows = kColTile * ns;
    for (int k0 = 0; k0 < s.d; k0 += s.dk) {
      const int kw = min(s.dk, s.d - k0);
      const int kp = (kw + kDepthStep - 1) / kDepthStep * kDepthStep;
      __syncthreads();                    // the last chunk's readers are done
      load_rows(xs, s.ldx, xg + k0, s.d, kRows, nrows, kw, vec);
      load_rows(slab_s, s.ldx,
                slab_g + static_cast<size_t>(ra + kColTile * j0) * s.d + k0,
                s.d, rows, rows, kw, vec);
      zero_cols(xs, s.ldx, kRows, kw, kp);
      zero_cols(slab_s, s.ldx, rows, kw, kp);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!mine) continue;
      int j = 0;
      for (; j + 1 < ns; j += 2) {
        const T* w2[2] = {slab_s + kColTile * j * s.ldx,
                          slab_s + kColTile * (j + 1) * s.ldx};
        float p2[2][kWarpRowGroups][4];
        Proj<T>::template run<2, kExactW>(xw, s.ldx, w2, s.ldx, kp, lane, p2);
        add(kColTile * j, p2[0], k0 == 0);
        add(kColTile * (j + 1), p2[1], k0 == 0);
      }
      if (j < ns) {
        const T* w1[1] = {slab_s + kColTile * j * s.ldx};
        float p1[1][kWarpRowGroups][4];
        Proj<T>::template run<1, kExactW>(xw, s.ldx, w1, s.ldx, kp, lane, p1);
        add(kColTile * j, p1[0], k0 == 0);
      }
    }
    if (!mine) continue;
    // fold the piece's slots j0 .. j0 + ns - 1 (each lane its own P places)
#pragma unroll
    for (int r = 0; r < kWarpRowGroups; ++r) {
      const float* q = ps + (row0 + 16 * r + g) * s.ldp + 2 * t;
      for (int j = 0; j < ns; ++j) {
        const float* qj = q + kColTile * j;
        if (j0 + j < deg0) {
          z[r][0] *= qj[0];
          z[r][2] *= qj[8 * s.ldp];
        }
        if (j0 + j < deg1) {
          z[r][1] *= qj[1];
          z[r][3] *= qj[8 * s.ldp + 1];
        }
      }
    }
  }
  if (!mine) return;
  const float s0 = __ldg(col_scale + f), s1 = __ldg(col_scale + f + 1);
#pragma unroll
  for (int r = 0; r < kWarpRowGroups; ++r) {
    float mul[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * r + g + 8 * h;
      mul[h] = rowmul == nullptr ? 1.f
                                 : (row < valid_rows ? __ldg(rowmul + row)
                                                     : 0.f);
    }
    float* zr = zs + (row0 + 16 * r + g) * s.ldz + (c - zc0) * kColTile +
                2 * t;
    zr[0] = z[r][0] * s0 * mul[0];
    zr[1] = z[r][1] * s1 * mul[0];
    zr[8 * s.ldz] = z[r][2] * s0 * mul[1];
    zr[8 * s.ldz + 1] = z[r][3] * s1 * mul[1];
  }
}

// ---- B1, B2 and B9: a warp's chain (16 rows x one 8-column tile) ---------

// Bits of one element, in the low bits of a word.
__device__ __forceinline__ uint32_t elem_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ uint32_t elem_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The 32 bytes of a row of device memory that start at element k (8 fp32
// or 16 bf16 elements), as 8 words (two bf16 a word, the lower k in the
// low half); elements at or past d, and the whole run of a row that is
// not valid, are zeros. vec: 16-byte loads (the row 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int k,
                                         int d, bool valid, bool vec,
                                         uint32_t w[8]) {
  constexpr int kPer = 32 / sizeof(T);
  if (valid && vec && k + kPer <= d) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + k));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + k + kPer / 2));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
  if (!valid) return;
  constexpr int kPerWord = 4 / sizeof(T);
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (k + e < d)
      w[e / kPerWord] |= elem_bits(row + k + e) << (16 * (e % kPerWord));
}

// p[n] = X[16 x d] W_n[8 x d]^T for the 16 rows x0 (rows 0-7) and x8 (rows
// 8-15) of a warp (valid0 / valid8: the lane's row of each half exists)
// and NW slot tiles w[n] (the lane's omega row; wvalid: it exists), as
// m16n8 accumulator fragments. Per step each lane takes one 32-byte run
// of its rows (load_run); the k index of the mma runs over the run in the
// order that makes the words of a run the fragments of consecutive steps.
template <typename T> struct Chain;

template <> struct Chain<float> {
  template <int NW>
  static __device__ __forceinline__ void run(
      const float* x0, const float* x8, bool valid0, bool valid8,
      const float* const w[NW], bool wvalid, int d, bool vec, int lane,
      float p[NW][4]) {
    const int t = lane & 3;
    float big[NW][4], small[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[n][i] = small[n][i] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < d; k0 += 32) {
      const int k = k0 + 8 * t;
      uint32_t a0[8], a8[8], b[NW][8];
      load_run(x0, k, d, valid0, vec, a0);
      load_run(x8, k, d, valid8, vec, a8);
      // a TF32 number has its low 13 bits 0 (then its remainder is 0)
      uint32_t lo_bits = 0u;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        load_run(w[n], k, d, wvalid, vec, b[n]);
#pragma unroll
        for (int i = 0; i < 8; ++i) lo_bits |= b[n][i] & 0x1FFFu;
      }
      // warp-uniform: an omega word of this step with a TF32 remainder
      const bool w_lo = __any_sync(0xffffffffu, lo_bits != 0u);
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t a[4] = {a0[2 * st], a8[2 * st], a0[2 * st + 1],
                               a8[2 * st + 1]};
        uint32_t ah[4], al[4], bh[NW][2], bl[NW][2];
        split_words<4>(a, ah, al);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const uint32_t bw[2] = {b[n][2 * st], b[n][2 * st + 1]};
          split_words<2>(bw, bh[n], bl[n]);
        }
#pragma unroll
        for (int n = 0; n < NW; ++n) mma_tf32(small[n], al, bh[n]);
        if (w_lo) {
#pragma unroll
          for (int n = 0; n < NW; ++n) mma_tf32(small[n], ah, bl[n]);
        }
#pragma unroll
        for (int n = 0; n < NW; ++n) mma_tf32(big[n], ah, bh[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[n][i] = small[n][i] + big[n][i];
  }
};

template <> struct Chain<__nv_bfloat16> {
  template <int NW>
  static __device__ __forceinline__ void run(
      const __nv_bfloat16* x0, const __nv_bfloat16* x8, bool valid0,
      bool valid8, const __nv_bfloat16* const w[NW], bool wvalid, int d,
      bool vec, int lane, float p[NW][4]) {
    const int t = lane & 3;
    // alternate k-steps go to two accumulator sets
    float c0[NW][4], c1[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c0[n][i] = c1[n][i] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < d; k0 += 64) {
      const int k = k0 + 16 * t;
      uint32_t a0[8], a8[8], b[NW][8];
      load_run(x0, k, d, valid0, vec, a0);
      load_run(x8, k, d, valid8, vec, a8);
#pragma unroll
      for (int n = 0; n < NW; ++n) load_run(w[n], k, d, wvalid, vec, b[n]);
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t a[4] = {a0[2 * st], a8[2 * st], a0[2 * st + 1],
                               a8[2 * st + 1]};
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const uint32_t bs[2] = {b[n][2 * st], b[n][2 * st + 1]};
          mma_bf16(st % 2 ? c1[n] : c0[n], a, bs);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[n][i] = c0[n][i] + c1[n][i];
  }
};

// The running product of one chain: rows row0 .. row0 + 15 (those below
// nrows exist) of x (row stride ldx elements) against the lane's omega row
// wr (the row of feature 8 c + g of the lane's column tile; wvalid: that
// feature exists), whose slot j is the row at wr + j * slot, for slots 0 ..
// depth - 1 (slot 0 first), as the m16n8 fragment of the lane (rows row0 +
// g and + 8, columns 2 t and 2 t + 1 of the tile): a column takes the slots
// below its degree, deg0 and deg1. Slots are projected NW at a time (then
// two, then one), sharing each x run. The omegas' layout is the caller's:
// B1 and B2 read w [kdeg, F, d] (chain_z), B9 the feature-major rows of
// one bucket.
template <typename T, int NW = 2>
__device__ __forceinline__ void chain_product(
    const T* __restrict__ x, size_t ldx, int row0, int nrows,
    const T* __restrict__ wr, bool wvalid, size_t slot, int d, int depth,
    int deg0, int deg1, bool vec, int lane, float z[4]) {
  const int g = lane >> 2;
  const T* x0 = x + static_cast<size_t>(row0 + g) * ldx;
  const T* x8 = x0 + 8 * ldx;
  const bool valid0 = row0 + g < nrows, valid8 = row0 + g + 8 < nrows;
  z[0] = z[1] = z[2] = z[3] = 1.f;
  auto fold = [&](int j, const float pr[4]) {
    if (j < deg0) {
      z[0] *= pr[0];
      z[2] *= pr[2];
    }
    if (j < deg1) {
      z[1] *= pr[1];
      z[3] *= pr[3];
    }
  };
  int j = 0;
  if constexpr (NW > 2) {
    for (; j + NW <= depth; j += NW) {
      const T* wn[NW];
#pragma unroll
      for (int n = 0; n < NW; ++n) wn[n] = wr + (j + n) * slot;
      float pn[NW][4];
      Chain<T>::template run<NW>(x0, x8, valid0, valid8, wn, wvalid, d,
                                 vec, lane, pn);
#pragma unroll
      for (int n = 0; n < NW; ++n) fold(j + n, pn[n]);
    }
  }
  for (; j + 1 < depth; j += 2) {
    const T* w2[2] = {wr + j * slot, wr + (j + 1) * slot};
    float p2[2][4];
    Chain<T>::template run<2>(x0, x8, valid0, valid8, w2, wvalid, d, vec,
                              lane, p2);
    fold(j, p2[0]);
    fold(j + 1, p2[1]);
  }
  if (j < depth) {
    const T* w1[1] = {wr + j * slot};
    float p1[1][4];
    Chain<T>::template run<1>(x0, x8, valid0, valid8, w1, wvalid, d, vec,
                              lane, p1);
    fold(j, p1[0]);
  }
}

// z of one chain of B1 and B2: chain_product against column tile c of w
// [kdeg, F, d] (feature f's slot j at w[j, f, :]), to the tile's depth (the
// largest degree of its 8 columns), times each column's scale; a column
// past F has z 0.
template <typename T>
__device__ __forceinline__ void chain_z(
    const T* __restrict__ x, size_t ldx, int row0, int nrows,
    const T* __restrict__ w, int f, int d, int kdeg,
    const int* __restrict__ col_deg, const float* __restrict__ col_scale,
    int c, bool vec, int lane, float z[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int fa = c * kColTile + 2 * t;
  const int deg0 = fa < f ? min(__ldg(col_deg + fa), kdeg) : 0;
  const int deg1 = fa + 1 < f ? min(__ldg(col_deg + fa + 1), kdeg) : 0;
  const int fl = c * kColTile + (lane & 7);
  const int depth = __reduce_max_sync(
      0xffffffffu, fl < f ? min(__ldg(col_deg + fl), kdeg) : 0);
  const int wrow = c * kColTile + g;
  chain_product<T>(x, ldx, row0, nrows, w + static_cast<size_t>(wrow) * d,
                   wrow < f, static_cast<size_t>(f) * d, d, depth, deg0,
                   deg1, vec, lane, z);
  const float s0 = fa < f ? __ldg(col_scale + fa) : 0.f;
  const float s1 = fa + 1 < f ? __ldg(col_scale + fa + 1) : 0.f;
  z[0] *= s0;
  z[1] *= s1;
  z[2] *= s0;
  z[3] *= s1;
}

// acc[i] += A[16 x K] B_i[K x 8] in 3xTF32 for the warp's 16-row m-tile
// and NB n-tiles of fp32 operands in shared memory: A's element (m, k) at
// a[m * am + k * ak], B's (k, n) at b[k * bk + n * bn], n-tile i's first
// column noff[i]; K a multiple of 8. The three terms go in three passes
// over the tiles, so no mma waits on the one before it.
template <int NB>
__device__ __forceinline__ void mma3(const float* a, int am, int ak,
                                     const float* b, int bk, int bn,
                                     const int noff[NB], int kdim, int lane,
                                     float acc[NB][4]) {
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
    frag_a(a + k0 * ak, am, ak, lane, ah, al);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      frag_b(b + k0 * bk + noff[i] * bn, bk, bn, lane, bh[i], bl[i]);
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(acc[i], al, bh[i]);
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(acc[i], ah, bl[i]);
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(acc[i], ah, bh[i]);
  }
}

}  // namespace rmm
