// rm_fused_state: the whole-sequence RM key state (S, n) of non-causal
// attention, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rm_attention/fused.py
// rm_fused_state_pallas (body _fused_state_kernel, helper _featurize_block).
// With zk = Z(k) * kvalid it computes, per batch*head row,
//
//     S = zk^T v   [F, dv],     n = colsum(zk)   [F]
//
// over all T keys, without writing zk to device memory.
//
// Split. The TPU grid (BH, feature block, chunk) runs the chunk axis
// innermost and in order, carrying a [block_f, dv] state in VMEM. Hopper
// blocks run unordered, so here one block owns one (batch*head row,
// 64-column feature tile, value slice of up to 128 columns) and loops over
// all of T in 64-row key tiles: featurize the tile (rm_featurize.cuh), mask
// it by kvalid, put it in shared memory beside the value tile, and
// accumulate S_tile [64, dv] in fp32 registers (4 feature rows x up to 8
// value columns a thread) and n_tile in the registers of 64 threads. Each
// key row is featurized once per feature tile (and value slice, when dv >
// 128). S and n are written once at the end: no atomics and no second pass,
// so the sums run in the same order on every run.
//
// What bounds it on the card: operations. The featurize (a d-long dot
// product per degree slot a column uses, per key row) and the S product
// (2 F dv per key row) both run on the fp32 CUDA cores. Grid = BH x
// ceil(F / 64) x ceil(dv / 128). The degrees are sorted, so the last feature
// tile runs the most slots and its blocks finish last (a tail); a long
// sequence with few rows gives few blocks (a T split with a deterministic
// second reduction is later work). wgmma tiles are later work too.
//
// Layouts: k [BH, T, d] fp32 or bf16; v [BH, T, dv] fp32; kvalid [BH, T]
// fp32; w [kdeg, F, d] of k's type; col_deg [F] int32; col_scale [F] fp32
// -> S [BH, F, dv], n [BH, F], fp32. T, F and dv are ragged (masked).
#include "rm_featurize.cuh"

namespace {

constexpr int kColSlots = 8;                 // value columns a thread: 8 x 16
constexpr int kMaxDvBlock = 16 * kColSlots;  // value columns a block
constexpr int kLdz = rmf::kTile + 1;         // padded row of the zk tile

template <typename T>
__global__ void __launch_bounds__(rmf::kThreads)
rm_fused_state_kernel(const T* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ kvalid,
                      const T* __restrict__ w,
                      const int* __restrict__ col_deg,
                      const float* __restrict__ col_scale,
                      float* __restrict__ s_out, float* __restrict__ n_out,
                      int T_len, int d, int dv, int kdeg, int F,
                      int dv_block) {
  extern __shared__ float smem[];
  float* stage = smem;                              // featurize staging
  float* zk = stage + rmf::kStageFloats;            // [kTile][kLdz]
  float* vs = zk + rmf::kTile * kLdz;               // [kTile][dv_block]

  const int f0 = blockIdx.y * rmf::kTile;
  const int dv0 = blockIdx.z * dv_block;
  const int ncols = min(dv_block, dv - dv0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row0 = (size_t)blockIdx.x * T_len;

  float s_acc[4][kColSlots];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kColSlots; ++jj) s_acc[i][jj] = 0.f;
  float n_acc = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += rmf::kTile) {
    const int nrows = min(rmf::kTile, T_len - t0);
    float acc[4][4];
    rmf::featurize_tile<T>(k + (row0 + t0) * d, d, nrows, d, w, kdeg, F,
                           col_deg, col_scale, f0, stage, acc);
    // rows past T carry the degree-0 column's scale, so mask them too
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float kv = r < nrows ? kvalid[row0 + t0 + r] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) zk[r * kLdz + tx + 16 * jj] = acc[i][jj] * kv;
    }
    for (int e = tid; e < rmf::kTile * dv_block; e += rmf::kThreads) {
      const int r = e / dv_block;
      const int c = e % dv_block;
      vs[e] = (r < nrows && c < ncols) ? v[(row0 + t0 + r) * dv + dv0 + c] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nrows; ++r) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = zk[r * kLdz + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < kColSlots; ++jj) {
        if (16 * jj < dv_block) {                   // uniform in the block
          const float b = vs[r * dv_block + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) s_acc[i][jj] = fmaf(a[i], b, s_acc[i][jj]);
        }
      }
    }
    if (tid < rmf::kTile)
      for (int r = 0; r < nrows; ++r) n_acc += zk[r * kLdz + tid];
    // the next tile rewrites zk and vs (and a depth-0 featurize has no
    // barrier of its own)
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f < F)
#pragma unroll
      for (int jj = 0; jj < kColSlots; ++jj) {
        const int c = tx + 16 * jj;
        if (c < ncols) s_out[(blockIdx.x * (size_t)F + f) * dv + dv0 + c] = s_acc[i][jj];
      }
  }
  if (blockIdx.z == 0 && tid < rmf::kTile && f0 + tid < F)
    n_out[blockIdx.x * (size_t)F + f0 + tid] = n_acc;
}

template <typename T>
int launch(const void* k, const float* v, const float* kvalid, const void* w,
           const int* col_deg, const float* col_scale, float* s_out,
           float* n_out, int BH, int T_len, int d, int dv, int kdeg, int F,
           int dv_block, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rm_fused_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (F + rmf::kTile - 1) / rmf::kTile,
            (dv + dv_block - 1) / dv_block);
  rm_fused_state_kernel<T><<<grid, rmf::kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(k), v, kvalid, static_cast<const T*>(w), col_deg,
      col_scale, s_out, n_out, T_len, d, dv, kdeg, F, dv_block);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (k and w). dv_block (a multiple of 16, at most
// 128) and smem_bytes come from repro_torch.kernels.common
// noncausal_blocks. Returns cudaGetLastError().
extern "C" int rm_fused_state_launch(
    const void* k, const float* v, const float* kvalid, const void* w,
    const int* col_deg, const float* col_scale, float* s_out, float* n_out,
    int BH, int T_len, int d, int dv, int kdeg, int F, int dv_block,
    int smem_bytes, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || T_len < 1 || F < 1 || dv < 1 || dv_block < 16 ||
      dv_block > kMaxDvBlock || dv_block % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(k, v, kvalid, w, col_deg, col_scale, s_out, n_out,
                         BH, T_len, d, dv, kdeg, F, dv_block, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(k, v, kvalid, w, col_deg, col_scale, s_out,
                                 n_out, BH, T_len, d, dv, kdeg, F, dv_block,
                                 smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
