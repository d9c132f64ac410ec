// The CUDA-core tile of the per-bucket kernel B9 (rm_feature_bucket.cu):
// 64 rows by 64 features a block of 256 threads, each owning a 4x4 fp32
// register tile (rows ty + 16 i, columns tx + 16 j), with x and the omega
// rows staged 32 wide along d in shared memory and converted to fp32 on
// load, so bf16 inputs still multiply and accumulate in fp32. (The whole
// map, B1, and the attention kernels B2-B4 featurize on the tensor cores:
// rm_featurize_mma.cuh.)
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

}  // namespace rmf
