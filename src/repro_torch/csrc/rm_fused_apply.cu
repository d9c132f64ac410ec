// rm_fused_apply: non-causal RM attention outputs from a given key state,
// for Hopper.
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
// Split. The TPU grid (BH, chunk, feature block) runs the feature-block
// axis innermost and in order, carrying num and den in VMEM. Here one
// block owns one (batch*head row, 64-row query tile, value slice of up to
// 128 columns) and loops over the feature tiles: featurize the query tile
// against the tile (rm_featurize.cuh), stage that tile's rows of S and n in
// shared memory, and accumulate num [64, dv] in fp32 registers (4 query
// rows x up to 8 value columns a thread) and den in the registers of 64
// threads. The divide happens once, after the last tile: the feature sums
// finish inside the block, with no second pass and no atomics.
//
// What bounds it on the card: operations, as for rm_fused_state (the
// featurize of every query row and the num product, 2 F dv per row, on the
// fp32 CUDA cores). Grid = BH x ceil(T / 64) x ceil(dv / 128); each block
// runs every feature tile, so there is no tail across blocks. wgmma tiles
// are later work.
//
// Layouts: q [BH, T, d] fp32 or bf16; S [BH, F, dv], n [BH, F] fp32; w
// [kdeg, F, d] of q's type; col_deg [F] int32; col_scale [F] fp32 -> out
// [BH, T, dv] fp32. T, F and dv are ragged (masked).
#include "rm_featurize.cuh"

namespace {

constexpr int kColSlots = 8;                 // value columns a thread: 8 x 16
constexpr int kMaxDvBlock = 16 * kColSlots;  // value columns a block
constexpr int kLdz = rmf::kTile + 1;         // padded row of the zq tile

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

template <typename T>
__global__ void __launch_bounds__(rmf::kThreads)
rm_fused_apply_kernel(const T* __restrict__ q, const float* __restrict__ s_in,
                      const float* __restrict__ n_in,
                      const T* __restrict__ w,
                      const int* __restrict__ col_deg,
                      const float* __restrict__ col_scale,
                      float* __restrict__ out, int T_len, int d, int dv,
                      int kdeg, int F, int dv_block, float eps) {
  extern __shared__ float smem[];
  float* stage = smem;                              // featurize staging
  float* zq = stage + rmf::kStageFloats;            // [kTile][kLdz]
  float* ss = zq + rmf::kTile * kLdz;               // [kTile][dv_block]
  float* ns = ss + rmf::kTile * dv_block;           // [kTile]
  float* dens = ns + rmf::kTile;                    // [kTile]

  const int t0 = blockIdx.y * rmf::kTile;
  const int nrows = min(rmf::kTile, T_len - t0);
  const int dv0 = blockIdx.z * dv_block;
  const int ncols = min(dv_block, dv - dv0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row0 = (size_t)blockIdx.x * T_len + t0;
  const size_t srow0 = (size_t)blockIdx.x * F;

  float num[4][kColSlots];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kColSlots; ++jj) num[i][jj] = 0.f;
  float den = 0.f;

  for (int f0 = 0; f0 < F; f0 += rmf::kTile) {
    const int nf = min(rmf::kTile, F - f0);
    float acc[4][4];
    rmf::featurize_tile<T>(q + row0 * d, d, nrows, d, w, kdeg, F, col_deg,
                           col_scale, f0, stage, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) zq[r * kLdz + tx + 16 * jj] = acc[i][jj];
    }
    for (int e = tid; e < rmf::kTile * dv_block; e += rmf::kThreads) {
      const int fr = e / dv_block;
      const int c = e % dv_block;
      ss[e] = (fr < nf && c < ncols) ? s_in[(srow0 + f0 + fr) * dv + dv0 + c] : 0.f;
    }
    if (tid < rmf::kTile) ns[tid] = tid < nf ? n_in[srow0 + f0 + tid] : 0.f;
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = zq[(ty + 16 * i) * kLdz + f];
#pragma unroll
      for (int jj = 0; jj < kColSlots; ++jj) {
        if (16 * jj < dv_block) {                   // uniform in the block
          const float b = ss[f * dv_block + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) num[i][jj] = fmaf(a[i], b, num[i][jj]);
        }
      }
    }
    if (tid < rmf::kTile)
      for (int f = 0; f < nf; ++f) den = fmaf(zq[tid * kLdz + f], ns[f], den);
    // the next tile rewrites zq, ss and ns (and a depth-0 featurize has no
    // barrier of its own)
    __syncthreads();
  }

  if (tid < rmf::kTile) dens[tid] = clamp_den(den, eps);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nrows) {
      const float dn = dens[r];
#pragma unroll
      for (int jj = 0; jj < kColSlots; ++jj) {
        const int c = tx + 16 * jj;
        if (c < ncols) out[(row0 + r) * dv + dv0 + c] = num[i][jj] / dn;
      }
    }
  }
}

template <typename T>
int launch(const void* q, const float* s_in, const float* n_in,
           const void* w, const int* col_deg, const float* col_scale,
           float* out, int BH, int T_len, int d, int dv, int kdeg, int F,
           int dv_block, float eps, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rm_fused_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (T_len + rmf::kTile - 1) / rmf::kTile,
            (dv + dv_block - 1) / dv_block);
  rm_fused_apply_kernel<T><<<grid, rmf::kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), s_in, n_in, static_cast<const T*>(w),
      col_deg, col_scale, out, T_len, d, dv, kdeg, F, dv_block, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q and w). dv_block (a multiple of 16, at most
// 128) and smem_bytes come from repro_torch.kernels.common
// noncausal_blocks. Returns cudaGetLastError().
extern "C" int rm_fused_apply_launch(
    const void* q, const float* s_in, const float* n_in, const void* w,
    const int* col_deg, const float* col_scale, float* out, int BH,
    int T_len, int d, int dv, int kdeg, int F, int dv_block, float eps,
    int smem_bytes, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || T_len < 1 || F < 1 || dv < 1 || dv_block < 16 ||
      dv_block > kMaxDvBlock || dv_block % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, s_in, n_in, w, col_deg, col_scale, out, BH,
                         T_len, d, dv, kdeg, F, dv_block, eps, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, s_in, n_in, w, col_deg, col_scale, out,
                                 BH, T_len, d, dv, kdeg, F, dv_block, eps,
                                 smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
