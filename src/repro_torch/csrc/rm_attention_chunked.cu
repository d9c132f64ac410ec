// rm_attention_chunked: pass B of the two-launch causal RM attention, on
// Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_attention/rm_attention.py
// rm_attention_chunked_pallas (body _rm_attn_kernel). Given features
// zq, zk [BH, T, F], values v [BH, T, dv] and the exclusive chunk prefixes
// s_prev [BH, T/C, F, dv], n_prev [BH, T/C, F] (pass A and the prefix sums
// run before the launch, in PyTorch), it computes for every chunk of C rows
//
//     scores = tril(zq zk^T)                  (mask once, after the F sum)
//     out    = (scores v + zq S_prev) / clamp(rowsum(scores) + zq n_prev)
//
// with clamp(den) = sign(den) * max(|den|, eps), den >= 0 -> +eps. zq, zk
// fp32 or bf16; v, s_prev, n_prev, out fp32. T is a multiple of C (the
// wrapper pads); F, dv and C are ragged (masked here).
//
// Split. The cells (BH, chunk) are independent, as on the TPU. A query tile
// of R = 16 rows (one mma m-tile) of one chunk is one cluster of two blocks
// (__cluster_dims__(2)): block rank 0 forms the scores and tril(scores) [v
// | 1], block rank 1 the state term zq [S_prev | n_prev] and leaves it in
// its shared memory; rank 0 reads it there (distributed shared memory),
// adds it and divides. At the bucket-256 prefill (BH 16, T 256, C 128)
// that is 256 clusters of 16 rows, 512 blocks of 4 warps, four to an SM.
// The denominator is one more column of each product (ones beside v,
// n_prev beside S_prev), as in B2. Value columns go in groups of at most
// 156 (dv 128 is one group); the scores of the query tile stay in shared
// memory for every group (up to a window of 512 keys: past that a group
// forms its window's scores again).
//
// Products. All three run on mma.sync m16n8k8: fp32 operands in 3xTF32
// (hi*lo + lo*hi + hi*hi, hi the operand rounded to TF32, lo the rest), so
// fp32 results keep fp32-level accuracy; bf16 zq / zk take bf16 m16n8k16
// mma for the scores, and zq's exact TF32 copy (no low part) in the state
// term. Every accumulator sits in registers (a warp's n-tiles: keys, or
// value columns strided by 4 over the warps), and each 8-deep step's terms
// go into a fresh fragment that joins the accumulator by an fp32 add. The
// tensor cores' accumulation does not round to nearest: with a chain of
// 32 steps in one accumulator the rows with a near-zero denominator fell
// further from the float64 value than plain fp32 arithmetic does; with
// the fp32 adds they do not. A warp's count of real n-tiles picks a
// branch-free instance of the product.
//
// Loads. F is staged in slices of 32 features, the zq and zk (or zq and
// [S_prev | n_prev]) slices by cp.async one slice ahead of the products, a
// pass scoring up to 128 keys at once; the value tiles (32 keys) one tile
// ahead: 16-byte copies where rows are whole 16 bytes, 4-byte copies, or
// plain loads (bf16 rows of odd F).
//
// Repeatable: every sum runs in a fixed order and nothing uses atomics, so
// two calls are bitwise equal.
//
// What bounds it on the card: bytes. At the prefill shape (BH 16, T 256, C
// 128, F 256, dv 128) the inputs and the output are 16.8 MB, 5.0 us at
// 3.35 TB/s, against 474 MFLOP (2.9 us at 3xTF32's 165 TFLOP/s). It runs
// about 7x that (PERF.md): a block's 32-feature slices are bound by their
// staged copies and by the chains of a step's dependent mma (the compiler
// keeps a tile's three terms in one chain at the 128-register cap that
// four blocks an SM leave, with spills); a deeper copy pipeline did not
// change it.
#include <cooperative_groups.h>
#include <string.h>

#include "rm_featurize_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kFs = 32;          // features of a staged slice
constexpr int kRows = 16;        // rows of a query tile: one m-tile
constexpr int kMT = kRows / 16;
constexpr int kKeyGroup = 128;   // keys scored in one pass over F
constexpr int kKeyNI = kKeyGroup / 8 / kWarps;   // a warp's key n-tiles
constexpr int kVTile = 32;       // keys of a staged value tile
constexpr int kNI = 5;           // a warp's value n-tiles, strided by kWarps
constexpr int kGroupCols = 156;  // value columns of a group (+ den <= 160)

// The plan, field for field repro_torch.kernels.common.ChunkedSchedule
// (passed as an int array).
struct BSched {
  int bh, t, f, dv, chunk, rows, q_tiles, n_groups, group_cols, win_keys,
      ldq, ldv, lds, smem;
};
constexpr int kBSchedFields = sizeof(BSched) / sizeof(int);

// Byte offsets of the shared-memory regions: region A, staging (zq slices
// at 0, then zk or [S_prev | n_prev] slices; the value tiles at 0 in the
// scores' second phase) and, once a block's loops are done, the partial
// [num | den] tile that rank 0 reads; region B, the scores (ranks 0 and 1);
// the denominators.
struct Smem {
  size_t kv, region_b, dens, total;
};
__host__ __device__ inline Smem smem_layout(const BSched& s, int item) {
  using rmm::round16;
  Smem m;
  const size_t q = round16(2ull * s.rows * s.ldq * item);
  const size_t k = round16(2ull * kKeyGroup * s.ldq * item);
  const size_t sp = round16(2ull * kFs * s.ldv * 4);
  const size_t vt = round16(2ull * kVTile * s.ldv * 4);
  const size_t tile = round16(static_cast<size_t>(s.rows) * s.ldv * 4);
  size_t a = q + k;
  if (vt > a) a = vt;
  if (q + sp > a) a = q + sp;
  if (tile > a) a = tile;
  m.kv = q;
  m.region_b = a;
  m.dens = a + round16(static_cast<size_t>(s.rows) * s.lds * 4);
  m.total = m.dens + round16(static_cast<size_t>(s.rows) * 4);
  return m;
}

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Copy modes: 2 = 16-byte cp.async, 1 = 4-byte cp.async, 0 = plain loads.
//
// Rows [0, rows) x columns [c0, c0 + kFs) of a row-major array with ncols
// columns (src: its row 0) into dst (row stride ld); rows >= nvalid and
// columns >= ncols come in as zeros. A thread copies one piece of kPer
// elements of every kStep-th row (no division by a run-time number).
template <typename T, int MODE>
__device__ __forceinline__ void stage_slice(T* dst, int ld,
                                            const T* __restrict__ src,
                                            int ncols, int rows, int nvalid,
                                            int c0) {
  constexpr int kPer = MODE == 2 ? 16 / static_cast<int>(sizeof(T))
                       : MODE == 1 ? 4 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kPieces = kFs / kPer;
  constexpr int kStep = kThreads / kPieces;
  const int c = (threadIdx.x % kPieces) * kPer;
  const bool col_ok = c0 + c < ncols;
  for (int r = threadIdx.x / kPieces; r < rows; r += kStep) {
    const bool ok = r < nvalid && col_ok;
    const T* g = ok ? src + static_cast<size_t>(r) * ncols + c0 + c : src;
    if (MODE == 2)
      rmm::cp_async16(dst + r * ld + c, g, ok ? 16 : 0);
    else if (MODE == 1)
      cp_async4(dst + r * ld + c, g, ok ? 4 : 0);
    else
      dst[r * ld + c] = ok ? *g : rmm::zero_of<T>();
  }
}

template <typename T>
__device__ __forceinline__ void stage_slice(int mode, T* dst, int ld,
                                            const T* __restrict__ src,
                                            int ncols, int rows, int nvalid,
                                            int c0) {
  if (mode == 2)
    stage_slice<T, 2>(dst, ld, src, ncols, rows, nvalid, c0);
  else if (mode == 1)
    stage_slice<T, 1>(dst, ld, src, ncols, rows, nvalid, c0);
  else
    stage_slice<T, 0>(dst, ld, src, ncols, rows, nvalid, c0);
}

// Rows [0, rows) of [X | e | 0] into dst (row stride ld): X the w columns
// of a row-major array at src (its row 0 and first column; row stride
// gld), e the per-row column extra[r] (nullptr: ones), zeros up to 8 nt;
// rows >= nvalid are zeros. X by 16-byte (MODE 2: w and gld multiples of
// 4) or 4-byte copies, e by a 4-byte copy; a warp takes a row at a time.
template <int MODE>
__device__ __forceinline__ void stage_cols(float* dst, int ld,
                                           const float* __restrict__ src,
                                           size_t gld, int rows, int nvalid,
                                           int w, int nt,
                                           const float* __restrict__ extra) {
  constexpr int kPer = MODE == 2 ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const int pieces = w / kPer;
  const int tail = 8 * nt - w;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const bool ok = r < nvalid;
    for (int c = lane * kPer; c < pieces * kPer; c += 32 * kPer) {
      const float* g = ok ? src + r * gld + c : src;
      if (MODE == 2)
        rmm::cp_async16(dst + r * ld + c, g, ok ? 16 : 0);
      else
        cp_async4(dst + r * ld + c, g, ok ? 4 : 0);
    }
    // the e column (ones where there is no extra) and the zeros past it
    if (lane < tail && (lane > 0 || !extra))
      dst[r * ld + w + lane] = (ok && lane == 0) ? 1.f : 0.f;
  }
  // extra[0 .. rows) is contiguous: one warp copies it (rows <= 32)
  if (extra && threadIdx.x < rows) {
    const int r = threadIdx.x;
    const bool ok = r < nvalid;
    cp_async4(dst + r * ld + w, ok ? extra + r : extra, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void stage_cols(int mode, float* dst, int ld,
                                           const float* __restrict__ src,
                                           size_t gld, int rows, int nvalid,
                                           int w, int nt,
                                           const float* __restrict__ extra) {
  if (mode == 2)
    stage_cols<2>(dst, ld, src, gld, rows, nvalid, w, nt, extra);
  else
    stage_cols<1>(dst, ld, src, gld, rows, nvalid, w, nt, extra);
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: the half
// unit of its 13 dropped bits added to the bit pattern, then cleared),
// lo = x - hi exactly in fp32. For finite x this is cvt.rna.tf32.f32 (as
// rm_featurize_mma.cuh's split_tf32), in two integer instructions where
// that conversion compiles to four (it also guards inf and NaN, which
// features never are); the mma reads lo as TF32 at a cost of about 2^-22
// |x|.
__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An m16n8k8 A fragment (16 x 8, row stride ld) as TF32 high and low parts
// (split_rna); a bf16 element is a TF32 number, so its low part is 0.
__device__ __forceinline__ void frag_rows(const float* p, int ld, int lane,
                                          uint32_t hi[4], uint32_t lo[4]) {
  const float* q = p + (lane >> 2) * ld + (lane & 3);
  split_rna(q[0], hi[0], lo[0]);
  split_rna(q[8 * ld], hi[1], lo[1]);
  split_rna(q[4], hi[2], lo[2]);
  split_rna(q[8 * ld + 4], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_rows(const __nv_bfloat16* p, int ld,
                                          int lane, uint32_t hi[4],
                                          uint32_t lo[4]) {
  const __nv_bfloat16* q = p + (lane >> 2) * ld + (lane & 3);
  hi[0] = __float_as_uint(__bfloat162float(q[0]));
  hi[1] = __float_as_uint(__bfloat162float(q[8 * ld]));
  hi[2] = __float_as_uint(__bfloat162float(q[4]));
  hi[3] = __float_as_uint(__bfloat162float(q[8 * ld + 4]));
  lo[0] = lo[1] = lo[2] = lo[3] = 0u;
}

// An m16n8k8 B fragment (8 x 8) whose element (k, n) is p[k * sk + n * sn],
// split as split_rna: (t, g), (t + 4, g).
__device__ __forceinline__ void frag_cols(const float* p, int sk, int sn,
                                          int lane, uint32_t hi[2],
                                          uint32_t lo[2]) {
  const float* q = p + (lane & 3) * sk + (lane >> 2) * sn;
  split_rna(q[0], hi[0], lo[0]);
  split_rna(q[4 * sk], hi[1], lo[1]);
}

// d = a b (an m16n8k8 TF32 mma with a zero accumulator in).
__device__ __forceinline__ void mma_tf32_z(float d[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

template <typename TA> struct ExactA { static constexpr bool value = false; };
template <> struct ExactA<__nv_bfloat16> {
  static constexpr bool value = true;
};

// acc[mt][i] += A_mt[16 x K] B_i[K x 8] in 3xTF32 for the n-tiles i < NB
// of acc's NMAX: A's rows at a (row stride lda; m-tile mt at row 16 mt),
// B's element (k, n) at b[k * bk + n * bn], n-tile i's first column
// noff[i]; K a multiple of 8. Each B fragment serves the MT m-tiles. Each
// 8-deep step's three terms (lo*hi, hi*lo, then hi*hi; a bf16 A has no
// lo*hi term) go into a fresh fragment, which joins acc by an fp32 add:
// the tensor cores' accumulation does not round to nearest, so a chain of
// many steps in one accumulator drifts, where the fp32 adds keep the sum
// as exact as plain fp32 arithmetic (the rows of a near-zero denominator
// need it).
template <typename TA, int MT, int NB, int NMAX>
__device__ __forceinline__ void mma_rows(const TA* a, int lda, const float* b,
                                         int bk, int bn, const int noff[NMAX],
                                         int kdim, int lane,
                                         float acc[MT][NMAX][4]) {
#pragma unroll 1
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      frag_cols(b + k0 * bk + noff[i] * bn, bk, bn, lane, bh[i], bl[i]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ah[4], al[4];
      frag_rows(a + 16 * mt * lda + k0, lda, lane, ah, al);
      float p[NB][4];
      if (!ExactA<TA>::value) {
#pragma unroll
        for (int i = 0; i < NB; ++i) mma_tf32_z(p[i], al, bh[i]);
#pragma unroll
        for (int i = 0; i < NB; ++i) rmm::mma_tf32(p[i], ah, bl[i]);
      } else {
#pragma unroll
        for (int i = 0; i < NB; ++i) mma_tf32_z(p[i], ah, bl[i]);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) rmm::mma_tf32(p[i], ah, bh[i]);
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] += p[i][e];
    }
  }
}

// mma_rows for the first nb (1 .. NMAX, warp-uniform) n-tiles: one
// branch-free instance for each count.
template <typename TA, int MT, int NMAX>
__device__ __forceinline__ void mma_rows_n(int nb, const TA* a, int lda,
                                           const float* b, int bk, int bn,
                                           const int noff[NMAX], int kdim,
                                           int lane, float acc[MT][NMAX][4]) {
  switch (nb) {
    case 1:
      mma_rows<TA, MT, 1, NMAX>(a, lda, b, bk, bn, noff, kdim, lane, acc);
      break;
    case 2:
      if constexpr (NMAX >= 2)
        mma_rows<TA, MT, 2, NMAX>(a, lda, b, bk, bn, noff, kdim, lane, acc);
      break;
    case 3:
      if constexpr (NMAX >= 3)
        mma_rows<TA, MT, 3, NMAX>(a, lda, b, bk, bn, noff, kdim, lane, acc);
      break;
    case 4:
      if constexpr (NMAX >= 4)
        mma_rows<TA, MT, 4, NMAX>(a, lda, b, bk, bn, noff, kdim, lane, acc);
      break;
    case 5:
      if constexpr (NMAX >= 5)
        mma_rows<TA, MT, 5, NMAX>(a, lda, b, bk, bn, noff, kdim, lane, acc);
      break;
    default:
      break;
  }
}

// acc[mt][i] += zq_mt[16 x kFs] zk_i[8 x kFs]^T over one staged slice, for
// the warp's first nbv key n-tiles: fp32 in 3xTF32, bf16 in bf16 m16n8k16
// mma (each step's fragment joined by an fp32 add, as in mma_rows).
template <int MT>
__device__ __forceinline__ void score_slice(const float* zq, const float* zk,
                                            int ld, const int noff[kKeyNI],
                                            int nbv, int lane,
                                            float acc[MT][kKeyNI][4]) {
  mma_rows_n<float, MT, kKeyNI>(nbv, zq, ld, zk, 1, ld, noff, kFs, lane,
                                acc);
}
template <int MT, int NB>
__device__ __forceinline__ void score_bf16(const __nv_bfloat16* zq,
                                           const __nv_bfloat16* zk, int ld,
                                           const int noff[kKeyNI], int lane,
                                           float acc[MT][kKeyNI][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kFs; k0 += 16) {
    uint32_t b[NB][2];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const __nv_bfloat16* p = zk + (noff[i] + g) * ld + k0 + 2 * t;
      b[i][0] = *reinterpret_cast<const uint32_t*>(p);
      b[i][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const __nv_bfloat16* p = zq + (16 * mt + g) * ld + k0 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
      float q[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) q[i][e] = 0.f;
        rmm::mma_bf16(q[i], a, b[i]);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] += q[i][e];
    }
  }
}
template <int MT>
__device__ __forceinline__ void score_slice(const __nv_bfloat16* zq,
                                            const __nv_bfloat16* zk, int ld,
                                            const int noff[kKeyNI], int nbv,
                                            int lane,
                                            float acc[MT][kKeyNI][4]) {
  switch (nbv) {
    case 1: score_bf16<MT, 1>(zq, zk, ld, noff, lane, acc); break;
    case 2:
      if constexpr (kKeyNI >= 2)
        score_bf16<MT, 2>(zq, zk, ld, noff, lane, acc);
      break;
    case 3:
      if constexpr (kKeyNI >= 3)
        score_bf16<MT, 3>(zq, zk, ld, noff, lane, acc);
      break;
    case 4:
      if constexpr (kKeyNI >= 4)
        score_bf16<MT, 4>(zq, zk, ld, noff, lane, acc);
      break;
    default: break;
  }
}

// A value group: columns [c0, c0 + w) of dv, its n-tiles (values and the
// den column w), a warp's n-tile offsets (clamped to the last tile) and how
// many of them are real.
struct Group {
  int c0, w, nt, nbv;
  int noff[kNI];
};
__device__ __forceinline__ Group value_group(const BSched& s, int gi,
                                             int warp) {
  Group gr;
  gr.c0 = gi * s.group_cols;
  gr.w = min(s.group_cols, s.dv - gr.c0);
  gr.nt = (gr.w + 1 + 7) / 8;
  gr.nbv = 0;
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    gr.noff[i] = 8 * min(warp + kWarps * i, gr.nt - 1);
    gr.nbv += warp + kWarps * i < gr.nt;
  }
  return gr;
}

// The pipeline of one staged phase: stage(0); then for each step i, stage
// i + 1 into the other buffer, wait for step i's copies, compute(i).
template <typename Stage, typename Compute>
__device__ __forceinline__ void pipeline(int n, Stage stage,
                                         Compute compute) {
  stage(0);
  rmm::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) stage(i + 1);
    rmm::cp_async_commit();
    rmm::cp_async_wait<1>();
    __syncthreads();
    compute(i);
    __syncthreads();
  }
}

// Rank 0 of a cluster: the scores and tril(scores) [v | 1] of the query
// tile; rank 1: its state term, left as an [R x 8 nt] partial tile in
// shared memory, which rank 0 adds before it divides and writes.
template <typename T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 4)
rm_attention_chunked_kernel(const T* __restrict__ zq, const T* __restrict__ zk,
                            const float* __restrict__ v,
                            const float* __restrict__ s_prev,
                            const float* __restrict__ n_prev,
                            float* __restrict__ out, const BSched s,
                            float eps, int fmode, int vmode) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = kMT, R = kRows;
  const Smem lay = smem_layout(s, sizeof(T));
  T* const qs = reinterpret_cast<T*>(smem);                 // [2][R][ldq]
  T* const ks = reinterpret_cast<T*>(smem + lay.kv);        // [2][128][ldq]
  float* const ps = reinterpret_cast<float*>(smem + lay.kv);  // [2][32][ldv]
  float* const vs = reinterpret_cast<float*>(smem);         // [2][32][ldv]
  float* const part = reinterpret_cast<float*>(smem);       // [R][ldv]
  float* const sc = reinterpret_cast<float*>(smem + lay.region_b);  // [R][lds]
  float* const dens = reinterpret_cast<float*>(smem + lay.dens);  // [R]
  constexpr int ldq = sizeof(T) == 4 ? kFs + 4 : kFs + 8;
  const int ldv = s.ldv, lds = s.lds;
  const int F = s.f, dv = s.dv, chunk = s.chunk;

  cg::cluster_group cluster = cg::this_cluster();
  const int role = static_cast<int>(cluster.block_rank());
  int cell = blockIdx.x >> 1;
  const int qt = cell % s.q_tiles;
  cell /= s.q_tiles;
  const int n_chunks = s.t / chunk;
  const int ci = cell % n_chunks;
  const int bh = cell / n_chunks;
  const int q0 = qt * R;
  const int nq = min(R, chunk - q0);
  const int q_end = q0 + nq;                   // keys at or past it are masked
  const size_t row0 = static_cast<size_t>(bh) * s.t + ci * chunk;
  const T* const zq_b = zq + (row0 + q0) * F;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nfs = (F + kFs - 1) / kFs;
  const size_t state_row = static_cast<size_t>(bh) * n_chunks + ci;
  const int n_win = (q_end + s.win_keys - 1) / s.win_keys;

  for (int gi = 0; gi < s.n_groups; ++gi) {
    const Group gr = value_group(s, gi, warp);
    float acc[MT][kNI][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < kNI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

    if (role == 1) {
      // ---- the state term: acc = zq [S_prev | n_prev], F a slice at a time
      const float* const sp = s_prev + state_row * F * dv + gr.c0;
      const float* const np_ = n_prev + state_row * F;
      pipeline(
          nfs,
          [=](int fs) {
            const int b = fs & 1;
            stage_slice<T>(fmode, qs + b * R * ldq, ldq, zq_b, F, R, nq,
                           fs * kFs);
            stage_cols(vmode, ps + b * kFs * ldv, ldv,
                       sp + static_cast<size_t>(fs) * kFs * dv, dv, kFs,
                       F - fs * kFs, gr.w, gr.nt, np_ + fs * kFs);
          },
          [&](int fs) {
            const int b = fs & 1;
            mma_rows_n<T, MT, kNI>(gr.nbv, qs + b * R * ldq, ldq,
                                   ps + b * kFs * ldv, ldv, 1, gr.noff, kFs,
                                   lane, acc);
          });
      // the partial tile rank 0 reads: [R x 8 nt] at region A (row stride
      // ldv; the loop is done with it)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          if (i >= gr.nbv) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* p = part + (16 * mt + g + 8 * h) * ldv + gr.noff[i] +
                       2 * t4;
            p[0] = acc[mt][i][2 * h];
            p[1] = acc[mt][i][2 * h + 1];
          }
        }
      cluster.sync();                     // rank 0 may read the tile
      cluster.sync();                     // rank 0 is done with it
      continue;
    }

    // ---- rank 0: the scores and tril(scores) [v | 1]
    for (int win = 0; win < n_win; ++win) {
      const int kw0 = win * s.win_keys;
      const int kw1 = min(kw0 + s.win_keys, q_end);
      if (gi == 0 || n_win > 1) {
        // scores of keys [kw0, kw1) over all of F, kKeyGroup keys a pass:
        // warp w takes the key n-tiles w, w + 4, ...; a pass's keys are
        // staged and scored 32 at a time (the rows past them are not read)
        const int n_kg = (kw1 - kw0 + kKeyGroup - 1) / kKeyGroup;
        int noff_sc[kKeyNI];
#pragma unroll
        for (int i = 0; i < kKeyNI; ++i) noff_sc[i] = 8 * (warp + kWarps * i);
        for (int kg = 0; kg < n_kg; ++kg) {
          const int k0 = kw0 + kg * kKeyGroup;
          const int kg_rows =
              (min(kKeyGroup, kw1 - k0) + kVTile - 1) / kVTile * kVTile;
          int nbv = 0;
#pragma unroll
          for (int i = 0; i < kKeyNI; ++i) nbv += noff_sc[i] < kg_rows;
          float acc_sc[MT][kKeyNI][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < kKeyNI; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc_sc[mt][i][e] = 0.f;
          const T* const zk_b = zk + (row0 + k0) * F;
          pipeline(
              nfs,
              [=](int fs) {
                const int b = fs & 1;
                stage_slice<T>(fmode, qs + b * R * ldq, ldq, zq_b, F, R, nq,
                               fs * kFs);
                stage_slice<T>(fmode, ks + b * kKeyGroup * ldq, ldq, zk_b, F,
                               kg_rows, chunk - k0, fs * kFs);
              },
              [&](int fs) {
                const int b = fs & 1;
                score_slice<MT>(qs + b * R * ldq, ks + b * kKeyGroup * ldq,
                                ldq, noff_sc, nbv, lane, acc_sc);
              });
          // the causal mask, once, after the whole F sum
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < kKeyNI; ++i) {
              if (i >= nbv) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int r = 16 * mt + g + 8 * h;
                  const int kc = k0 - kw0 + noff_sc[i] + 2 * t4 + e;
                  sc[r * lds + kc] =
                      kw0 + kc <= q0 + r ? acc_sc[mt][i][2 * h + e] : 0.f;
                }
            }
        }
        __syncthreads();
      }
      // acc += tril(scores) [v | 1] over keys [kw0, kw1), 32 at a time
      const float* const vb = v + (row0 + kw0) * dv + gr.c0;
      pipeline(
          (kw1 - kw0 + kVTile - 1) / kVTile,
          [=](int j) {
            stage_cols(vmode, vs + (j & 1) * kVTile * ldv, ldv,
                       vb + static_cast<size_t>(j) * kVTile * dv, dv, kVTile,
                       chunk - kw0 - j * kVTile, gr.w, gr.nt, nullptr);
          },
          [&](int j) {
            mma_rows_n<float, MT, kNI>(gr.nbv, sc + j * kVTile, lds,
                                       vs + (j & 1) * kVTile * ldv, ldv, 1,
                                       gr.noff, kVTile, lane, acc);
          });
    }
    // [num | den] += rank 1's state term, then the denominators: column w,
    // held by one lane pair of the warp that owns n-tile w / 8
    cluster.sync();
    const float* const st = cluster.map_shared_rank(part, 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i >= gr.nbv) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* p = st + (16 * mt + g + 8 * h) * ldv + gr.noff[i] +
                           2 * t4;
          acc[mt][i][2 * h] += p[0];
          acc[mt][i][2 * h + 1] += p[1];
        }
      }
    const int nd = gr.w / 8, ed = gr.w % 8;
    const bool odd = ed & 1;
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      if (warp + kWarps * i != nd || 2 * t4 != (ed & ~1)) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        dens[16 * mt + g] =
            clamp_den(odd ? acc[mt][i][1] : acc[mt][i][0], eps);
        dens[16 * mt + g + 8] =
            clamp_den(odd ? acc[mt][i][3] : acc[mt][i][2], eps);
      }
    }
    __syncthreads();
    float* const ob = out + (row0 + q0) * dv + gr.c0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i >= gr.nbv) continue;
        const int n = warp + kWarps * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          if (r >= nq) continue;
          const float dn = dens[r];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * n + 2 * t4 + e;
            if (c < gr.w)
              ob[static_cast<size_t>(r) * dv + c] =
                  acc[mt][i][2 * h + e] / dn;
          }
        }
      }
    cluster.sync();                       // rank 1 may reuse its tile
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T>
int launch(const void* zq, const void* zk, const float* v,
           const float* s_prev, const float* n_prev, float* out,
           const BSched& s, float eps, cudaStream_t stream) {
  const int item = sizeof(T);
  const size_t smem = smem_layout(s, item).total;
  if (smem != static_cast<size_t>(s.smem) || s.rows != kRows ||
      s.ldq != (item == 4 ? kFs + 4 : kFs + 8))
    return (int)cudaErrorInvalidValue;
  const size_t fbytes = static_cast<size_t>(s.f) * item;
  const int fmode = (fbytes % 16 == 0 && aligned(zq, 16) && aligned(zk, 16))
                        ? 2
                        : (fbytes % 4 == 0 && aligned(zq, 4) &&
                           aligned(zk, 4))
                              ? 1
                              : 0;
  const int vmode = (s.dv % 4 == 0 && aligned(v, 16) && aligned(s_prev, 16))
                        ? 2 : 1;
  cudaError_t err = cudaFuncSetAttribute(
      rm_attention_chunked_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  const long long blocks = 2LL * s.bh * (s.t / s.chunk) * s.q_tiles;
  rm_attention_chunked_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(
      static_cast<const T*>(zq), static_cast<const T*>(zk), v, s_prev, n_prev,
      out, s, eps, fmode, vmode);
  return (int)cudaGetLastError();
}

}  // namespace

// sched: n_sched ints, the fields of repro_torch.kernels.common
// ChunkedSchedule. dtype (zq and zk): 0 = fp32, 1 = bf16. Returns
// cudaGetLastError().
extern "C" int rm_attention_chunked_launch(
    const void* zq, const void* zk, const float* v, const float* s_prev,
    const float* n_prev, float* out, const int* sched, int n_sched,
    float eps, int dtype, void* stream) {
  if (n_sched != kBSchedFields) return (int)cudaErrorInvalidValue;
  BSched s;
  memcpy(&s, sched, sizeof(BSched));
  const int w0 = s.dv < s.group_cols ? s.dv : s.group_cols;
  if (s.bh < 1 || s.chunk < 1 || s.t < s.chunk || s.t % s.chunk != 0 ||
      s.f < 1 || s.dv < 1 || s.group_cols != kGroupCols ||
      s.q_tiles != (s.chunk + s.rows - 1) / s.rows ||
      s.n_groups != (s.dv + s.group_cols - 1) / s.group_cols ||
      s.win_keys < 64 || s.win_keys % 64 != 0 ||
      s.lds != s.win_keys + 4 || s.ldv < 8 * ((w0 + 8) / 8) ||
      (s.ldv % 32 != 8 && s.ldv % 32 != 24) ||
      2LL * s.bh * (s.t / s.chunk) * s.q_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(zq, zk, v, s_prev, n_prev, out, s, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(zq, zk, v, s_prev, n_prev, out, s, eps, st);
  return (int)cudaErrorInvalidValue;
}
