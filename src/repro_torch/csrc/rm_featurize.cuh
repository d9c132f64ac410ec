// The Random Maclaurin featurize tile shared by the rm_feature and the
// fused causal attention kernels.
//
// For a 64-row by 64-feature tile it forms
//
//     z[r][c] = col_scale[f0 + c] * prod_{j < col_deg[f0 + c]} <w[j, f0 + c, :], x[r, :]>
//
// as back-to-back [64 x d] x [d x 64] products, one per degree slot j, with
// the running product held in fp32 registers. The slot loop stops at the
// largest degree in THIS tile: the packed layout sorts columns by degree,
// so low-degree tiles exit early. 256 threads, each owning a 4x4 register
// tile (rows ty + 16 i, columns tx + 16 j); x and the omega slices are
// staged 32 wide along d in shared memory, converted to fp32 on load, so
// bf16 inputs still multiply and accumulate in fp32.
//
// Ragged edges are masked here: rows >= nrows load as zero, and a column
// f >= F acts as a padding column (degree 0, scale 0), so its value is
// 1 * 0 = 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmf {

constexpr int kTile = 64;      // rows and feature columns of a tile
constexpr int kStageK = 32;    // width of the staged d slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Staging area: xs then ws, each kTile x (kStageK + 1) floats.
constexpr int kStageFloats = 2 * kTile * (kStageK + 1);

template <typename T>
__device__ __forceinline__ void featurize_tile(
    const T* __restrict__ x,        // row 0 of the tile; rows ldx apart
    int ldx, int nrows, int d,
    const T* __restrict__ w,        // [kdeg, F, d]
    int kdeg, int F,
    const int* __restrict__ col_deg,
    const float* __restrict__ col_scale,
    int f0,
    float* __restrict__ stage,      // kStageFloats of shared memory
    float acc[4][4]) {
  float (*xs)[kStageK + 1] = reinterpret_cast<float (*)[kStageK + 1]>(stage);
  float (*ws)[kStageK + 1] =
      reinterpret_cast<float (*)[kStageK + 1]>(stage + kTile * (kStageK + 1));
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // tile-local product depth (identical in every thread: all read the
  // same degrees, so the barriers below stay uniform)
  int depth = 0;
  for (int c = 0; c < kTile; ++c) {
    if (f0 + c < F) depth = max(depth, col_deg[f0 + c]);
  }
  depth = min(depth, kdeg);

  int my_deg[4];
  float my_scale[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int f = f0 + tx + 16 * jj;
    my_deg[jj] = f < F ? col_deg[f] : 0;
    my_scale[jj] = f < F ? col_scale[f] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 1.f;

  for (int j = 0; j < depth; ++j) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) p[i][jj] = 0.f;
    const T* wj = w + (size_t)j * F * d;
    for (int k0 = 0; k0 < d; k0 += kStageK) {
      for (int e = tid; e < kTile * kStageK; e += kThreads) {
        const int r = e / kStageK;
        const int kk = e % kStageK;
        const bool kin = k0 + kk < d;
        xs[r][kk] = (r < nrows && kin) ? to_f32(x[(size_t)r * ldx + k0 + kk]) : 0.f;
        ws[r][kk] = (f0 + r < F && kin) ? to_f32(wj[(size_t)(f0 + r) * d + k0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kStageK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[jj] = ws[tx + 16 * jj][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) p[i][jj] = fmaf(a[i], b[jj], p[i][jj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j < my_deg[jj]) acc[i][jj] *= p[i][jj];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= my_scale[jj];
}

}  // namespace rmf
