// rm_feature_bucket: one degree bucket of a Random Maclaurin map, for
// Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_feature/rm_feature.py
// rm_feature_bucket_pallas (body _rm_feature_kernel):
//
//     out[b, i] = scale * prod_{j < degree} <omega[i * degree + j, :], x[b, :]>
//
// x [B, d] fp32 or bf16, omega [count * degree, d] of the same type, scale a
// float -> out [B, count] fp32, written at row stride ldo (so a bucket can
// land in place in a whole map's columns). Accumulation is fp32 throughout,
// and the running product is taken in the reference's order, j = 0, 1, ...
//
// omega is read in place, in its feature-major layout (the rows of
// RMFeatureMap.bucket_omegas): an 8-column tile's `degree` slots are ONE
// contiguous run of 8 * degree rows. The TPU wrapper pads and transposes
// omega to [degree, F, d] on every call; nothing here is packed or copied
// through device memory.
//
// Design: one mma product a (16 rows, 8-column tile, degree slot), the
// running product in the accumulator registers (rm_featurize_mma.cuh's
// fragments and precision rules: fp32 runs 3xTF32, with the hi(x) lo(w)
// term only where the omegas have a TF32 remainder, which the rm plans'
// +-1 do not; bf16 runs bf16 mma with fp32 accumulation). Two kernels,
// picked by kernels.common.bucket_schedule:
//   chain (small batches and narrow buckets, and any d): a block of 4
//     warps takes one 16-row group, each warp one 8-column tile at a time
//     (rmm::chain_product over the bucket's row address: slot j of feature
//     f at (f * degree + j) * d, four slots a pass over d), x and omega
//     read straight from device memory. Spambase's deg-8 x1 bucket at 1840
//     rows is 115 independent warps; the CUDA-core tile this replaces ran
//     29 blocks of `degree` serial staged passes, so its time grew with
//     the degree.
//   tile (Gram-sized batches): one block an SM of 16 warps stages a
//     256-row x tile, each warp keeps its 16 rows' x fragments in registers
//     (d up to 64 fp32 / 128 bf16; past that it reads them from the tile
//     each k-step), and the block walks runs of ct_per_warp column tiles:
//     a run's omega rows, contiguous in device memory, are staged with
//     cp.async (16-, 8- or 4-byte pieces, rows to warps, a row's pieces to
//     lanes), slot-major within each column tile, while the run before it
//     multiplies (two buffers; one where two do not fit). Every warp takes
//     every (tile, slot) item of a run, two at a time, and folds each
//     tile's running product in order. Outputs are streaming stores. d up
//     to where the x tile and a run fit shared memory (208 fp32 at degree
//     2); the schedule takes the chain kernel past that.
// Ragged B, count and d are masked here (rows and features past the edge
// load as zero and are never stored; d pads with zeros to the mma depth),
// so the wrapper pads nothing. No atomics: two calls give the same bits.
//
// Bound, at the paper's one large bucket (homog10 at D 4000: 20000 rows x
// 4000 features x 10 dot products of d 50, 8.08e10 operations; 320 MB of
// fp32 output): fp32 on the tensor cores 0.327 ms (two TF32 terms at
// 495 TFLOP/s), bytes 0.097 ms; bf16 0.097 ms (the output bytes). The
// CUDA-core tile this replaces ran fp32 FMAs at 4.7 ms. This design runs
// it in 1.7 ms (bf16 1.0) on an H100 (PERF.md); the rest of that time
// goes to staging every run again for every 256 rows (0.7 GB through L2
// in fp32), the barriers around each run and the 32-byte stores. The
// small buckets are latency-bound chains of a few microseconds.
#include "rm_featurize_mma.cuh"

namespace {

constexpr int kChainWarps = 4;
constexpr int kChainThreads = 32 * kChainWarps;
// degree slots a chain projects at a time (each pass over d a dependent
// round of loads: four slots a pass halve the rounds of B1's two)
constexpr int kChainSlots = 4;
constexpr int kTileRows = 256;                       // rows of a tile block
constexpr int kTileWarps = kTileRows / 16;           // a warp takes 16 rows
constexpr int kTileThreads = 32 * kTileWarps;
// k-steps of x fragments a tile warp holds in registers (8 x 8 fp32, 8 x
// 16 bf16 values of d); past that it reads them from shared memory
constexpr int kRegSteps = 8;

// A lane's m16n8 fragment z (rows r and r + 8, columns f and f + 1) times
// scale into out (row stride ldo), where the row is below B and the column
// below count; as one 8-byte store a row where pair (ldo even, out 8-byte
// aligned: f is even). Streaming stores (evict first): the map is written
// once and not read here, and it would push the omegas out of L2.
__device__ __forceinline__ void store_frag(float* __restrict__ out,
                                           size_t ldo, int B, int count,
                                           int r, int f, const float z[4],
                                           float scale, bool pair) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= B) continue;
    float* o = out + static_cast<size_t>(row) * ldo + f;
    const float a = z[2 * h] * scale, b = z[2 * h + 1] * scale;
    if (pair && f + 1 < count) {
      __stcs(reinterpret_cast<float2*>(o), make_float2(a, b));
    } else {
      if (f < count) __stcs(o, a);
      if (f + 1 < count) __stcs(o + 1, b);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kChainThreads)
rm_feature_bucket_chain_kernel(const T* __restrict__ x,
                               const T* __restrict__ omega,
                               float* __restrict__ out, size_t ldo, int B,
                               int count, int d, int degree, float scale,
                               int ct_per_warp, bool vec, bool pair) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ct = (count + rmm::kColTile - 1) / rmm::kColTile;
  const int row0 = blockIdx.x * 16;
  const int cbase = blockIdx.y * kChainWarps * ct_per_warp;
  const size_t feature = static_cast<size_t>(degree) * d;
  for (int i = 0; i < ct_per_warp; ++i) {
    const int c = cbase + i * kChainWarps + warp;
    if (c >= n_ct) break;
    const int wrow = c * rmm::kColTile + g;
    float z[4];
    rmm::chain_product<T, kChainSlots>(x, d, row0, B, omega + wrow * feature,
                                       wrow < count, d, d, degree, degree,
                                       degree, vec, lane, z);
    store_frag(out, ldo, B, count, row0 + g, c * rmm::kColTile + 2 * t, z,
               scale, pair);
  }
}

// ---- the tile kernel's staging: rows to warps, a row's pieces to lanes

// The widest piece (16, 8 or 4 bytes, or one bf16 element) that rows of d
// elements starting at p, p + d, ... allow.
template <typename T>
int piece_bytes(const void* p, int d) {
  const size_t row = static_cast<size_t>(d) * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int b = 16; b >= 4; b /= 2)
    if (row % b == 0 && a % b == 0) return b;
  return sizeof(T);
}

// One piece of `bytes` (16, 8 or 4: cp.async, zero-filled where !live;
// less: one element through registers) from `from` to shared `to`.
template <typename T>
__device__ __forceinline__ void copy_piece(T* to, const T* from, bool live,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(to));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(from), "r"(live ? 16 : 0));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(from), "r"(live ? 8 : 0));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(from), "r"(live ? 4 : 0));
  else
    *to = live ? *from : rmm::zero_of<T>();
}

// A row of d elements (from src; ok: it exists) into the shared row dst,
// zeros past d up to dp and for a row that does not exist: the lane's
// pieces of `bytes` (each within the row: d and the row starts are
// multiples of bytes), consecutive lanes on consecutive pieces.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, bool ok, int d,
                                         int dp, int bytes, const T* base) {
  const int per = bytes / static_cast<int>(sizeof(T));
  for (int k = (threadIdx.x & 31) * per; k < dp; k += 32 * per) {
    const bool live = ok && k < d;
    copy_piece<T>(dst + k, live ? src + k : base, live, bytes);
  }
}

// f(q, shared offset) for the rows q = w, w + kTileWarps, ... of a run of
// run_rows omega rows that warp w stages: source row q = ui degree + j
// (slot j of the run's feature ui) goes to shared row (u degree + j) 8 + i
// for ui = 8 u + i (slot-major within each column tile u, so a (tile,
// slot) item's 8 rows are adjacent). (ui, j) advance without a division.
template <typename F>
__device__ __forceinline__ void for_run_rows(int run_rows, int degree,
                                             int ldx, F f) {
  const int warp = threadIdx.x >> 5;
  int ui = warp / degree, j = warp - ui * degree;
  for (int q = warp; q < run_rows; q += kTileWarps) {
    f(q, ((ui >> 3) * degree + j) * (rmm::kColTile * ldx) + (ui & 7) * ldx);
    j += kTileWarps;
    while (j >= degree) {
      j -= degree;
      ++ui;
    }
  }
}

// ---- the tile kernel's products

// p[n] = X[16 x dp] W_n[8 x dp]^T for a warp's 16 rows and NW slot tiles
// (8 staged omega rows each, at w[n], row stride ldx), as m16n8 fragments.
// The x fragments come from the registers (kRegA: all of d within
// kRegSteps k-steps, loaded once a block by load_x) or from the x tile in
// shared memory, one k-step at a time. fp32 runs 3xTF32 (the hi(x) lo(w)
// term only where the omegas need it: run); bf16 one bf16 mma a k-step of
// 16.
template <typename T> struct TileProj;

template <> struct TileProj<float> {
  static constexpr int kStep = 8;
  uint32_t ah[kRegSteps][4], al[kRegSteps][4];

  __device__ __forceinline__ void load_x(const float* xl, int dp) {
#pragma unroll
    for (int s = 0; s < kRegSteps; ++s) {
      if (kStep * s >= dp) break;
      uint32_t a[4];
      rmm::ldsm_x4(a, xl + kStep * s);
      rmm::split_words<4>(a, ah[s], al[s]);
    }
  }

  // one k-step; kExactW: the omegas taken as TF32 numbers (no hi(x) lo(w)
  // term), their words' low 13 bits OR-ed into lo
  template <int NW, bool kExactW>
  static __device__ __forceinline__ void step(
      const uint32_t ah[4], const uint32_t al[4], const float* const wl[NW],
      int k, float big[NW][4], float small[NW][4], uint32_t& lo) {
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      uint32_t b[2];
      rmm::ldsm_x2(b, wl[n] + k);
      if (kExactW) {
        bh[n][0] = b[0];
        bh[n][1] = b[1];
        lo |= b[0] | b[1];
      } else {
        rmm::split_words<2>(b, bh[n], bl[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) rmm::mma_tf32(small[n], al, bh[n]);
    if (!kExactW) {
#pragma unroll
      for (int n = 0; n < NW; ++n) rmm::mma_tf32(small[n], ah, bl[n]);
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) rmm::mma_tf32(big[n], ah, bh[n]);
  }

  // the products over d into big and small (zeroed here); returns the low
  // bits of the omega words a kExactW pass read
  template <int NW, bool kRegA, bool kExactW>
  __device__ __forceinline__ uint32_t pass(const float* xl,
                                           const float* const wl[NW], int dp,
                                           float big[NW][4],
                                           float small[NW][4]) const {
    uint32_t lo = 0u;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[n][i] = small[n][i] = 0.f;
    if (kRegA) {
#pragma unroll
      for (int s = 0; s < kRegSteps; ++s) {
        if (kStep * s >= dp) break;
        step<NW, kExactW>(ah[s], al[s], wl, kStep * s, big, small, lo);
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < dp; k += kStep) {
        uint32_t a[4], h[4], l[4];
        rmm::ldsm_x4(a, xl + k);
        rmm::split_words<4>(a, h, l);
        step<NW, kExactW>(h, l, wl, k, big, small, lo);
      }
    }
    return lo & 0x1FFFu;
  }

  // The omegas are taken as TF32 numbers (the rm plans' +-1 are) in a first
  // pass that also ORs their low bits; where a warp vote finds one with a
  // TF32 remainder (a general omega), the products are taken again with
  // its term and the first pass's sums are dropped.
  template <int NW, bool kRegA>
  __device__ __forceinline__ void run(const float* xl,
                                      const float* const wl[NW], int dp,
                                      float p[NW][4]) const {
    float big[NW][4], small[NW][4];
    const uint32_t lo = pass<NW, kRegA, true>(xl, wl, dp, big, small);
    if (__any_sync(0xffffffffu, lo != 0u))
      pass<NW, kRegA, false>(xl, wl, dp, big, small);
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[n][i] = small[n][i] + big[n][i];
  }
};

template <> struct TileProj<__nv_bfloat16> {
  static constexpr int kStep = 16;
  uint32_t a[kRegSteps][4];

  __device__ __forceinline__ void load_x(const __nv_bfloat16* xl, int dp) {
#pragma unroll
    for (int s = 0; s < kRegSteps; ++s) {
      if (kStep * s >= dp) break;
      rmm::ldsm_x4(a[s], xl + kStep * s);
    }
  }

  template <int NW>
  static __device__ __forceinline__ void step(
      const uint32_t a[4], const __nv_bfloat16* const wl[NW], int k,
      float c[NW][4]) {
    uint32_t b[NW][2];
#pragma unroll
    for (int n = 0; n < NW; ++n) rmm::ldsm_x2(b[n], wl[n] + k);
#pragma unroll
    for (int n = 0; n < NW; ++n) rmm::mma_bf16(c[n], a, b[n]);
  }

  // alternate k-steps go to two accumulator sets
  template <int NW, bool kRegA>
  __device__ __forceinline__ void run(const __nv_bfloat16* xl,
                                      const __nv_bfloat16* const wl[NW],
                                      int dp, float p[NW][4]) const {
    float c0[NW][4], c1[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c0[n][i] = c1[n][i] = 0.f;
    if (kRegA) {
#pragma unroll
      for (int s = 0; s < kRegSteps; ++s) {
        if (kStep * s >= dp) break;
        step<NW>(a[s], wl, kStep * s, s % 2 ? c1 : c0);
      }
    } else {
      int k = 0;
      for (; k + 2 * kStep <= dp; k += 2 * kStep) {
        uint32_t a0[4], a1[4];
        rmm::ldsm_x4(a0, xl + k);
        rmm::ldsm_x4(a1, xl + k + kStep);
        step<NW>(a0, wl, k, c0);
        step<NW>(a1, wl, k + kStep, c1);
      }
      if (k < dp) {
        uint32_t a0[4];
        rmm::ldsm_x4(a0, xl + k);
        step<NW>(a0, wl, k, c0);
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[n][i] = c0[n][i] + c1[n][i];
  }
};

// The tile kernel: block = 128 rows (warp w: rows 16 w .. + 15), walking
// runs s0 .. s1 - 1 of `run_tiles` column tiles; kRegA: d within
// kRegSteps k-steps, the warp's x fragments held in registers.
template <typename T, bool kRegA>
__global__ void __launch_bounds__(kTileThreads, 1)
rm_feature_bucket_tile_kernel(const T* __restrict__ x,
                              const T* __restrict__ omega,
                              float* __restrict__ out, size_t ldo, int B,
                              int count, int d, int degree, float scale,
                              int dp, int ldx, int run_tiles,
                              int runs_per_block, int buffers, int xbytes,
                              int wbytes, bool pair) {
  constexpr int kNW = kRegA ? 2 : 4;     // slot tiles a product takes
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                  // [kTileRows][ldx]
  const int run_rows = run_tiles * rmm::kColTile * degree;
  T* wbuf = xs + kTileRows * ldx;                      // buffers x run_rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, B - row0);
  const int n_ct = (count + rmm::kColTile - 1) / rmm::kColTile;
  const int n_runs = (n_ct + run_tiles - 1) / run_tiles;
  const int s0 = blockIdx.y * runs_per_block;
  const int s1 = min(n_runs, s0 + runs_per_block);
  for (int r = warp; r < kTileRows; r += kTileWarps)
    copy_row<T>(xs + r * ldx, x + static_cast<size_t>(row0 + r) * d,
                r < nrows, d, dp, xbytes, x);
  rmm::cp_async_commit();
  // Run s: column tiles [s run_tiles, (s + 1) run_tiles), whose omega rows
  // are one contiguous run (for_run_rows: its rows' places in shared
  // memory); rows past the bucket's count * degree are zeros.
  auto stage = [&](int s, T* buf) {
    const T* run = omega + static_cast<size_t>(s) * run_rows * d;
    const int valid = (count - s * run_tiles * rmm::kColTile) * degree;
    for_run_rows(run_rows, degree, ldx, [&](int q, int off) {
      copy_row<T>(buf + off, run + static_cast<size_t>(q) * d, q < valid,
                  d, dp, wbytes, omega);
    });
    rmm::cp_async_commit();
  };
  auto buffer = [&](int s) {
    return wbuf + static_cast<size_t>(buffers == 2 ? (s - s0) & 1 : 0) *
                      run_rows * ldx;
  };
  if (buffers == 2) stage(s0, buffer(s0));
  // the warp's ldmatrix addresses: its x rows, and an 8-row omega tile
  const T* xl = xs + (16 * warp + rmm::ldsm_a_row(lane)) * ldx +
                (16 / static_cast<int>(sizeof(T))) * rmm::ldsm_a_half(lane);
  const int wlane = (lane & 7) * ldx +
                    (16 / static_cast<int>(sizeof(T))) * rmm::ldsm_b_half(lane);
  const bool live = 16 * warp < nrows;
  TileProj<T> proj;
  for (int s = s0; s < s1; ++s) {
    T* buf = buffer(s);
    if (buffers == 1) {
      stage(s, buf);
      rmm::cp_async_wait<0>();
    } else if (s + 1 < s1) {
      stage(s + 1, buffer(s + 1));
      rmm::cp_async_wait<1>();
    } else {
      rmm::cp_async_wait<0>();
    }
    __syncthreads();         // the run (and, at the first, the x tile)
    if (kRegA && s == s0) proj.load_x(xl, dp);
    const int c0 = s * run_tiles;
    const int items = min(run_tiles, n_ct - c0) * degree;
    if (live) {
      // items k = u degree + j (column tile u, slot j) in order, item k's
      // 8 omega rows at buf + 8 k ldx; the running product of tile zu
      int zu = -1;
      float z[4];
      int u = 0, j = 0;                              // the next item
      for (int k = 0; k < items; k += kNW) {
        const T* wl[kNW];
        int us[kNW];
#pragma unroll
        for (int n = 0; n < kNW; ++n) {
          // past the last item: the last item again, its product dropped
          wl[n] = buf + static_cast<size_t>(rmm::kColTile) *
                            min(k + n, items - 1) * ldx + wlane;
          us[n] = u;
          if (k + n < items && ++j == degree) j = 0, ++u;
        }
        float p[kNW][4];
        proj.template run<kNW, kRegA>(xl, wl, dp, p);
#pragma unroll
        for (int n = 0; n < kNW; ++n) {
          if (k + n >= items) break;
          if (us[n] != zu) {
            if (zu >= 0)
              store_frag(out, ldo, B, count, row0 + 16 * warp + g,
                         (c0 + zu) * rmm::kColTile + 2 * t, z, scale, pair);
            zu = us[n];
            z[0] = z[1] = z[2] = z[3] = 1.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) z[e] *= p[n][e];
        }
      }
      if (zu >= 0)
        store_frag(out, ldo, B, count, row0 + 16 * warp + g,
                   (c0 + zu) * rmm::kColTile + 2 * t, z, scale, pair);
    }
    __syncthreads();                      // the run's readers are done
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* xv, const void* omegav, float* out, size_t ldo, int B,
           int count, int d, int degree, float scale, int kernel,
           int ct_per_warp, int runs_per_block, int buffers,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* omega = static_cast<const T*>(omegav);
  const int n_ct = (count + rmm::kColTile - 1) / rmm::kColTile;
  const bool pair = ldo % 2 == 0 && aligned(out, 8);
  if (kernel == 0) {
    const int per_block = kChainWarps * ct_per_warp;
    const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                     aligned(x, 16) && aligned(omega, 16);
    dim3 grid((B + 15) / 16, (n_ct + per_block - 1) / per_block);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    rm_feature_bucket_chain_kernel<T><<<grid, kChainThreads, 0, stream>>>(
        x, omega, out, ldo, B, count, d, degree, scale, ct_per_warp, vec,
        pair);
    return (int)cudaGetLastError();
  }
  // the mma depth pads d to 8 (fp32) or 16 (bf16); rows of 16-byte
  // multiples, 16 bytes past a multiple of 32 (ldmatrix, no conflicts)
  const int step = sizeof(T) == 4 ? 8 : 16;
  const int dp = (d + step - 1) / step * step;
  const int ldx = dp + step / 2;
  const int run_tiles = ct_per_warp;
  const size_t smem = (kTileRows + static_cast<size_t>(buffers) * run_tiles *
                                       rmm::kColTile * degree) *
                      ldx * sizeof(T);
  if (buffers < 1 || buffers > 2 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int n_runs = (n_ct + run_tiles - 1) / run_tiles;
  dim3 grid((B + kTileRows - 1) / kTileRows,
            (n_runs + runs_per_block - 1) / runs_per_block);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel_fn = dp <= kRegSteps * step
                       ? rm_feature_bucket_tile_kernel<T, true>
                       : rm_feature_bucket_tile_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  kernel_fn<<<grid, kTileThreads, smem, stream>>>(
      x, omega, out, ldo, B, count, d, degree, scale, dp, ldx, run_tiles,
      runs_per_block, buffers, piece_bytes<T>(x, d), piece_bytes<T>(omega, d),
      pair);
  return (int)cudaGetLastError();
}

}  // namespace

// out: column 0 of the bucket in the map (row stride ldo >= count). kernel:
// 0 chain, 1 tile; ct_per_warp (the tile kernel: column tiles a run),
// runs_per_block and buffers as repro_torch.kernels.common.bucket_schedule
// gives them (the tile kernel's dynamic shared memory follows from them:
// bucket_tile_smem there). dtype:
// 0 = fp32, 1 = bf16 (x and omega). Returns cudaGetLastError().
extern "C" int rm_feature_bucket_launch(const void* x, const void* omega,
                                        float* out, long long ldo, int B,
                                        int count, int d, int degree,
                                        float scale, int kernel,
                                        int ct_per_warp, int runs_per_block,
                                        int buffers, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || count < 1 || d < 1 || degree < 1 || ldo < count ||
      ct_per_warp < 1 || runs_per_block < 1 || (kernel != 0 && kernel != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, omega, out, static_cast<size_t>(ldo), B, count,
                         d, degree, scale, kernel, ct_per_warp,
                         runs_per_block, buffers, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, omega, out, static_cast<size_t>(ldo), B,
                                 count, d, degree, scale, kernel,
                                 ct_per_warp, runs_per_block, buffers, s);
  return (int)cudaErrorInvalidValue;
}
