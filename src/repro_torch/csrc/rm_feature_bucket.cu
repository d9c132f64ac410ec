// rm_feature_bucket: one degree bucket of a Random Maclaurin map, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rm_feature/rm_feature.py
// rm_feature_bucket_pallas (body _rm_feature_kernel):
//
//     out[b, i] = scale * prod_{j < degree} <omega[i * degree + j, :], x[b, :]>
//
// x [B, d] fp32 or bf16, omega [count * degree, d] of the same type, scale a
// float -> out [B, count] fp32. Accumulation is fp32 throughout, and the
// products are taken in the reference's order, j = 0, 1, ...
//
// omega is read in its flat feature-major layout (the rows of
// RMFeatureMap.bucket_omegas, in place: feature stride degree * d, slot
// stride d). The TPU wrapper pads and transposes it to [degree, F, d] on
// every call; that is a copy through device memory which this kernel does
// not need.
//
// Grid: (row tiles, feature tiles) of 64 x 64, one tile a block: the tile
// of rm_featurize.cuh, 256 threads each holding a 4 x 4 fp32 register tile
// (rows ty + 16 i, features tx + 16 jj), x and slot j's omega rows staged
// 32 wide along d in shared memory and converted to fp32 on load. A bucket
// has one degree, so every column of a tile runs all `degree` slots and
// there is no per-column depth mask. Ragged B, count and d are masked here:
// rows and features past the edge load as zero and are never stored, and d
// past its end loads as zero, so the wrapper pads nothing.
//
// Bound: at the paper's one large bucket (homog10 at D 4000: 20000 rows x
// 4000 features x 10 dot products of d = 50, about 80 GFLOP over 2 MB of x
// and omega) the work is fp32 FMAs on the CUDA cores, about 1.2 ms at
// 67 TFLOP/s; the tile re-reads x from L2 for every slot and feeds 16 FMAs
// from 8 shared-memory loads, so it runs well below that rate (tensor cores
// are later work). The small buckets of the paper's maps (count 1 to 125)
// are one or two feature tiles: there the launch and the chain of `degree`
// staged passes set the time.
#include "rm_featurize.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rmf::kThreads)
rm_feature_bucket_kernel(const T* __restrict__ x, const T* __restrict__ omega,
                         float* __restrict__ out, int B, int count, int d,
                         int degree, float scale) {
  __shared__ float xs[rmf::kTile][rmf::kStageK + 1];
  __shared__ float ws[rmf::kTile][rmf::kStageK + 1];
  const int r0 = blockIdx.x * rmf::kTile;
  const int f0 = blockIdx.y * rmf::kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t feature_stride = (size_t)degree * d;

  float acc[4][4];
  for (int j = 0; j < degree; ++j) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) p[i][jj] = 0.f;
    const T* wj = omega + (size_t)j * d;
    for (int k0 = 0; k0 < d; k0 += rmf::kStageK) {
      for (int e = tid; e < rmf::kTile * rmf::kStageK; e += rmf::kThreads) {
        const int r = e / rmf::kStageK;
        const int kk = e % rmf::kStageK;
        const bool kin = k0 + kk < d;
        xs[r][kk] = (r0 + r < B && kin)
                        ? rmf::to_f32(x[(size_t)(r0 + r) * d + k0 + kk]) : 0.f;
        ws[r][kk] = (f0 + r < count && kin)
                        ? rmf::to_f32(wj[(size_t)(f0 + r) * feature_stride + k0 + kk])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < rmf::kStageK; ++kk) {
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
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = j == 0 ? p[i][jj] : acc[i][jj] * p[i][jj];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = f0 + tx + 16 * jj;
      if (f < count) out[(size_t)r * count + f] = acc[i][jj] * scale;
    }
  }
}

template <typename T>
int launch(const void* x, const void* omega, float* out, int B, int count,
           int d, int degree, float scale, cudaStream_t stream) {
  dim3 grid((B + rmf::kTile - 1) / rmf::kTile,
            (count + rmf::kTile - 1) / rmf::kTile);
  rm_feature_bucket_kernel<T><<<grid, rmf::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(omega), out, B, count, d,
      degree, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x and omega). degree >= 1. Returns
// cudaGetLastError().
extern "C" int rm_feature_bucket_launch(const void* x, const void* omega,
                                        float* out, int B, int count, int d,
                                        int degree, float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (degree < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, omega, out, B, count, d, degree, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, omega, out, B, count, d, degree, scale, s);
  return (int)cudaErrorInvalidValue;
}
