// The tensor-core featurize shared by the non-causal RM kernels B3
// (rm_fused_state.cu) and B4 (rm_fused_apply.cu).
//
// For a 64-row tile x (keys or queries) it forms
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
      ldz, chunk_ct, smem_bytes;
};
constexpr int kSchedFields = sizeof(Sched) / sizeof(int);

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory regions (the order of
// NoncausalSchedule's docstring).
struct Smem {
  size_t slab, x, b, z, den, total;
};

template <typename T>
__host__ __device__ inline Smem smem_layout(const Sched& s, bool with_den) {
  Smem m;
  m.slab = 0;
  m.x = round16(static_cast<size_t>(s.slab_cap) * s.ldx * sizeof(T));
  m.b = m.x + round16(static_cast<size_t>(kRows) * s.ldx * sizeof(T));
  m.z = m.b + static_cast<size_t>(s.b_rows) * s.ldb * 4;
  m.den = m.z + static_cast<size_t>(kRows) * s.ldz * 4;
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
// otherwise plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int sld, const T* src,
                                          size_t gld, int rows,
                                          int valid_rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = cols / kPer;
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * kPer;
      const bool ok = r < valid_rows;
      cp_async16(dst + r * sld + c, ok ? src + r * gld + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
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

}  // namespace rmm
