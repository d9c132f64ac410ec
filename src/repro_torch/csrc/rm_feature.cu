// rm_feature: the whole Random Maclaurin map in one launch, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rm_feature/rm_feature.py
// rm_feature_fused_pallas (body _rm_fused_kernel):
//
//     out[b, f] = col_scale[f] * prod_{j < col_deg[f]} <w[j, f, :], x[b, :]>
//
// x [B, d] fp32 or bf16, w [kdeg, F, d] of the same type, col_deg [F] int32,
// col_scale [F] fp32 -> out [B, F] fp32, fp32 accumulation throughout.
//
// Grid: (row tiles, feature tiles) of 64 x 64, one tile a block (see
// rm_featurize.cuh). At the decode shape of the serving path (x = the
// stacked q and k rows of every slot and head, [2 * slots * 16, 128],
// w = [5, 163, 128]) the kernel moves about 0.6 MB and does about 8 MFLOP,
// a fraction of a microsecond of the card's bytes or fp32 FLOPs: it is
// bound by launch latency, and its design only keeps to one launch per
// decode step and layer and one pass over x and w. At Gram shapes (4096
// rows) it is bound by fp32 FMA issue: the products run on the CUDA cores,
// not the tensor cores (wgmma is later work).
#include "rm_featurize.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rmf::kThreads)
rm_feature_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ col_deg,
                  const float* __restrict__ col_scale,
                  float* __restrict__ out, int B, int F, int d, int kdeg) {
  __shared__ float stage[rmf::kStageFloats];
  const int r0 = blockIdx.x * rmf::kTile;
  const int f0 = blockIdx.y * rmf::kTile;
  float acc[4][4];
  rmf::featurize_tile<T>(x + (size_t)r0 * d, d, min(rmf::kTile, B - r0), d,
                         w, kdeg, F, col_deg, col_scale, f0, stage, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = f0 + tx + 16 * jj;
      if (f < F) out[(size_t)r * F + f] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* col_deg,
           const float* col_scale, float* out, int B, int F, int d, int kdeg,
           cudaStream_t stream) {
  dim3 grid((B + rmf::kTile - 1) / rmf::kTile, (F + rmf::kTile - 1) / rmf::kTile);
  rm_feature_kernel<T><<<grid, rmf::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), col_deg, col_scale,
      out, B, F, d, kdeg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x and w). Returns cudaGetLastError().
extern "C" int rm_feature_fused_launch(const void* x, const void* w,
                                       const int* col_deg,
                                       const float* col_scale, float* out,
                                       int B, int F, int d, int kdeg,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, col_deg, col_scale, out, B, F, d, kdeg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, col_deg, col_scale, out, B, F, d, kdeg, s);
  return (int)cudaErrorInvalidValue;
}
