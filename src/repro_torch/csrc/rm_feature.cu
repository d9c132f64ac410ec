// rm_feature: the whole Random Maclaurin map in one launch, for Hopper's
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/rm_feature/rm_feature.py
// rm_feature_fused_pallas (body _rm_fused_kernel):
//
//     out[b, f] = col_scale[f] * prod_{j < col_deg[f]} <w[j, f, :], x[b, :]>
//
// x [B, d] fp32 or bf16, w [kdeg, F, d] of the same type, col_deg [F] int32,
// col_scale [F] fp32 -> out [B, F] fp32, fp32 accumulation throughout.
//
// Design: one mma product a (16 rows, 8-column tile, degree slot), to the
// tile's own depth (the largest degree of its 8 columns; the rest of a
// tile's columns multiply by 1), the running product in the accumulator
// registers. fp32 runs 3xTF32 (the omegas' remainder term only where the
// warp finds one: the rm plans' +-1 have none), bf16 runs bf16 mma with
// fp32 accumulation (rm_featurize_mma.cuh). w is read as it is: nothing is
// packed or copied per call. Two kernels, by the number of rows
// (kernels.common.pick_feature_tiles):
//   chain (decode-sized batches): a block of 4 warps takes one 16-row
//     group, each warp one 8-column tile at a time (chain_z), x and w read
//     straight from device memory with a loop over d (any d). At the decode
//     shape of the serving path (x = the stacked q and k rows of every slot
//     and head, [2 * slots * 16, 128], w = [5, 163, 128]) the kernel moves
//     about 0.3 MB and does about 8 MFLOP: launch latency and the chains'
//     dependent loads and mma bound it, so the 168 chains spread over 48
//     blocks (the earlier CUDA-core tile gave 6 blocks of serial staged
//     rounds).
//   tile (Gram-sized batches): a block of 4 warps stages a 64-row x tile in
//     shared memory once; each warp walks column tiles, stages the 8 omega
//     rows of two degree slots at a time (coalesced, cp.async) in its own
//     buffer, and
//     projects both 32-row halves of the x tile against them (the Proj
//     products of B3 and B4, ldmatrix fragments): each staged row serves 64
//     x rows and each x fragment two slots. Bound by the products, on the
//     tensor cores; d up to where the x tile and the buffers fit shared
//     memory (448 fp32, 896 bf16), the chain kernel past that.
#include "rm_featurize_mma.cuh"

namespace {

constexpr int kWarpsB1 = 4;
constexpr int kThreadsB1 = 32 * kWarpsB1;
constexpr int kTileRows = 64;             // rows of the tile kernel's block

template <typename T>
__global__ void __launch_bounds__(kThreadsB1)
rm_feature_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ col_deg,
                  const float* __restrict__ col_scale,
                  float* __restrict__ out, int B, int F, int d, int kdeg,
                  int ct_per_warp, bool vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ct = (F + rmm::kColTile - 1) / rmm::kColTile;
  const int row0 = blockIdx.x * 16;
  const int cbase = blockIdx.y * kWarpsB1 * ct_per_warp;
  for (int i = 0; i < ct_per_warp; ++i) {
    const int c = cbase + i * kWarpsB1 + warp;
    if (c >= n_ct) break;
    float z[4];
    rmm::chain_z<T>(x, d, row0, B, w, F, d, kdeg, col_deg, col_scale, c,
                    vec, lane, z);
    const int f = c * rmm::kColTile + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r >= B) continue;
      float* o = out + static_cast<size_t>(r) * F + f;
      if (f < F) o[0] = z[2 * h];
      if (f + 1 < F) o[1] = z[2 * h + 1];
    }
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Copy rows [0, rows) of d elements (row r at src(r); ok(r): it exists;
// base: any valid address of the array, the source of the zero-filling
// copies) into shared memory (row stride ldx), zeros past d up to dp and
// for rows that do not exist, by NT threads (thread id tid) over consecutive
// elements. The copies are asynchronous (16-byte cp.async on aligned rows,
// 4-byte on fp32 ones), so they overlap one another; bf16 rows of odd
// alignment go through registers, 16 elements a thread at a time. Commits
// one cp.async group; the caller waits and syncs.
template <typename T, int NT, typename Src, typename Ok>
__device__ __forceinline__ void copy_rows(T* dst, int ldx, const T* base,
                                          Src src, Ok ok, int rows, int d,
                                          int dp, bool vec, int tid) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = dp / kPer;
    for (int e = tid; e < rows * per_row; e += NT) {
      const int r = e / per_row;
      const int k = (e - r * per_row) * kPer;
      const bool live = ok(r) && k < d;
      rmm::cp_async16(dst + r * ldx + k, live ? src(r) + k : base,
                      live ? 16 : 0);
    }
  } else if (sizeof(T) == 4) {
    for (int e = tid; e < rows * dp; e += NT) {
      const int r = e / dp;
      const int k = e - r * dp;
      const bool live = ok(r) && k < d;
      cp_async4(dst + r * ldx + k, live ? src(r) + k : base, live ? 4 : 0);
    }
  } else {
    constexpr int kBatch = 16;
    for (int e0 = 0; e0 < rows * dp; e0 += NT * kBatch) {
      uint32_t v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + NT * b + tid;
        const int r = e / dp;
        const int k = e - r * dp;
        v[b] = e < rows * dp && ok(r) && k < d ? rmm::elem_bits(src(r) + k)
                                               : 0u;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + NT * b + tid;
        const int r = e / dp;
        if (e < rows * dp)
          reinterpret_cast<unsigned short*>(dst + r * ldx)[e - r * dp] =
              static_cast<unsigned short>(v[b]);
      }
    }
  }
  rmm::cp_async_commit();
}

// The omega rows of slots j .. j + nw - 1 of column tile c, 8 a slot (row
// 8 s + i: w[j + s, 8 c + i, :]), into the warp's buffer wb (copy_rows).
template <typename T>
__device__ __forceinline__ void stage_slots(T* wb, int ldx,
                                            const T* __restrict__ w, int f,
                                            int d, int dp, int c, int j,
                                            int nw, bool vec, int lane) {
  copy_rows<T, 32>(
      wb, ldx, w,
      [&](int r) {
        return w + (static_cast<size_t>(j + (r >> 3)) * f +
                    c * rmm::kColTile + (r & 7)) * d;
      },
      [&](int r) { return c * rmm::kColTile + (r & 7) < f; },
      rmm::kColTile * nw, d, dp, vec, lane);
}

// Whether any staged fp32 omega has a TF32 remainder (its low 13 bits are
// not 0), warp-uniform; read after the staging is waited for and the warp
// synced.
template <typename T>
__device__ __forceinline__ bool staged_has_remainder(const T* wb, int ldx,
                                                     int dp, int nw,
                                                     int lane) {
  if (sizeof(T) != 4) return false;
  uint32_t lo_bits = 0u;
  const int per_row = dp / 4;              // dp is a multiple of 8
  for (int e = lane; e < rmm::kColTile * nw * per_row; e += 32) {
    const int r = e / per_row;
    const uint4 v =
        reinterpret_cast<const uint4*>(wb + r * ldx)[e - r * per_row];
    lo_bits |= (v.x | v.y | v.z | v.w) & 0x1FFFu;
  }
  return __any_sync(0xffffffffu, lo_bits != 0u);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsB1)
rm_feature_kernel_tile(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ col_deg,
                       const float* __restrict__ col_scale,
                       float* __restrict__ out, int B, int F, int d, int dp,
                       int ldx, int kdeg, int ct_per_warp, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                  // [64][ldx]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* wb = xs + (kTileRows + 2 * rmm::kColTile * warp) * ldx;   // [16][ldx]
  const int n_ct = (F + rmm::kColTile - 1) / rmm::kColTile;
  const int row0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, B - row0);
  copy_rows<T, kThreadsB1>(
      xs, ldx, x,
      [&](int r) { return x + static_cast<size_t>(row0 + r) * d; },
      [&](int r) { return r < nrows; }, kTileRows, d, dp, vec, threadIdx.x);
  rmm::cp_async_wait<0>();
  __syncthreads();
  const int halves = (nrows + 31) / 32;
  const int cbase = blockIdx.y * kWarpsB1 * ct_per_warp;
  for (int i = 0; i < ct_per_warp; ++i) {
    const int c = cbase + i * kWarpsB1 + warp;
    if (c >= n_ct) break;
    const int fa = c * rmm::kColTile + 2 * t;
    const int deg0 = fa < F ? min(__ldg(col_deg + fa), kdeg) : 0;
    const int deg1 = fa + 1 < F ? min(__ldg(col_deg + fa + 1), kdeg) : 0;
    const int fl = c * rmm::kColTile + (lane & 7);
    const int depth = __reduce_max_sync(
        0xffffffffu, fl < F ? min(__ldg(col_deg + fl), kdeg) : 0);
    float z[2][rmm::kWarpRowGroups][4];   // the tile's two 32-row halves
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < rmm::kWarpRowGroups; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[h][r][e] = 1.f;
    auto fold = [&](int h, int jj, const float pr[rmm::kWarpRowGroups][4]) {
#pragma unroll
      for (int r = 0; r < rmm::kWarpRowGroups; ++r) {
        if (jj < deg0) {
          z[h][r][0] *= pr[r][0];
          z[h][r][2] *= pr[r][2];
        }
        if (jj < deg1) {
          z[h][r][1] *= pr[r][1];
          z[h][r][3] *= pr[r][3];
        }
      }
    };
    for (int j = 0; j < depth; j += 2) {
      const int nw = min(2, depth - j);
      __syncwarp();                       // the last slots' readers are done
      stage_slots<T>(wb, ldx, w, F, d, dp, c, j, nw, vec, lane);
      rmm::cp_async_wait<0>();
      __syncwarp();
      const bool w_lo = staged_has_remainder<T>(wb, ldx, dp, nw, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= halves) break;
        const T* xh = xs + 32 * h * ldx;
        if (nw == 2) {
          const T* w2[2] = {wb, wb + rmm::kColTile * ldx};
          float p2[2][rmm::kWarpRowGroups][4];
          if (w_lo)
            rmm::Proj<T>::template run<2, false>(xh, ldx, w2, ldx, dp, lane,
                                                 p2);
          else
            rmm::Proj<T>::template run<2, true>(xh, ldx, w2, ldx, dp, lane,
                                                p2);
          fold(h, j, p2[0]);
          fold(h, j + 1, p2[1]);
        } else {
          const T* w1[1] = {wb};
          float p1[1][rmm::kWarpRowGroups][4];
          if (w_lo)
            rmm::Proj<T>::template run<1, false>(xh, ldx, w1, ldx, dp, lane,
                                                 p1);
          else
            rmm::Proj<T>::template run<1, true>(xh, ldx, w1, ldx, dp, lane,
                                                p1);
          fold(h, j, p1[0]);
        }
      }
    }
    const float s0 = fa < F ? __ldg(col_scale + fa) : 0.f;
    const float s1 = fa + 1 < F ? __ldg(col_scale + fa + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < rmm::kWarpRowGroups; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 32 * h + 16 * r + g + 8 * hh;
          if (h >= halves || row >= B) continue;
          float* o = out + static_cast<size_t>(row) * F + fa;
          if (fa < F) o[0] = z[h][r][2 * hh] * s0;
          if (fa + 1 < F) o[1] = z[h][r][2 * hh + 1] * s1;
        }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared memory of a tile block: the x tile and 4 warps' slot buffers, 64
// + 4 x 16 rows of ldx elements.
template <typename T>
size_t tile_smem(int ldx) {
  return static_cast<size_t>(kTileRows + kWarpsB1 * 2 * rmm::kColTile) *
         ldx * sizeof(T);
}

template <typename T>
int launch(const void* x, const void* w, const int* col_deg,
           const float* col_scale, float* out, int B, int F, int d, int kdeg,
           int row_tile, int ct_per_warp, cudaStream_t stream) {
  const int n_ct = (F + rmm::kColTile - 1) / rmm::kColTile;
  const int per_block = kWarpsB1 * ct_per_warp;
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                   aligned16(x) && aligned16(w);
  if (row_tile == kTileRows) {
    // the MMA depth pads d to 8 (fp32) or 16 (bf16); rows of 16-byte
    // multiples, 16 bytes past a multiple of 32 (ldmatrix, no conflicts)
    const int step = sizeof(T) == 4 ? 8 : 16;
    const int dp = (d + step - 1) / step * step;
    const int ldx = dp + step / 2;
    const size_t smem = tile_smem<T>(ldx);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rm_feature_kernel_tile<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + kTileRows - 1) / kTileRows,
              (n_ct + per_block - 1) / per_block);
    rm_feature_kernel_tile<T><<<grid, kThreadsB1, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), col_deg,
        col_scale, out, B, F, d, dp, ldx, kdeg, ct_per_warp, vec);
    return (int)cudaGetLastError();
  }
  dim3 grid((B + 15) / 16, (n_ct + per_block - 1) / per_block);
  rm_feature_kernel<T><<<grid, kThreadsB1, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), col_deg, col_scale,
      out, B, F, d, kdeg, ct_per_warp, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x and w). row_tile: 16 (the chain kernel) or
// 64 (the tile kernel); ct_per_warp: the column tiles each warp walks
// (repro_torch.kernels.common.pick_feature_tiles). Returns
// cudaGetLastError().
extern "C" int rm_feature_fused_launch(const void* x, const void* w,
                                       const int* col_deg,
                                       const float* col_scale, float* out,
                                       int B, int F, int d, int kdeg,
                                       int row_tile, int ct_per_warp,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ct = (F + rmm::kColTile - 1) / rmm::kColTile;
  if (B < 1 || F < 1 || d < 1 || kdeg < 1 || ct_per_warp < 1 ||
      (row_tile != 16 && row_tile != kTileRows) ||
      (n_ct + kWarpsB1 * ct_per_warp - 1) / (kWarpsB1 * ct_per_warp) > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, col_deg, col_scale, out, B, F, d, kdeg,
                         row_tile, ct_per_warp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, col_deg, col_scale, out, B, F, d,
                                 kdeg, row_tile, ct_per_warp, s);
  return (int)cudaErrorInvalidValue;
}
