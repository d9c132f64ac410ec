// ctr_feature: the complex-to-real (CtR) map in one launch, for Hopper.
//
// Replaces the TPU kernel repro/kernels/ctr_feature/ctr_feature.py
// ctr_feature_fused_pallas (body _ctr_fused_kernel). On the packed tensors
// of repro_torch.ctr.plan.pack_ctr it computes, for every complex column f,
//
//   (Ar, Ai) <- (Ar Pr - Ai Pi, Ar Pi + Ai Pr)  for slots j < col_deg[f],
//   P_j = x (Wr_j + i Wi_j)^T,  from (Ar, Ai) = (1, 0),
//
// then writes col_scale[f] Ar to column f and col_scale[f] Ai to column
// Fc + f of one [B, 2 Fc] output: the TPU kernel's two outputs and its
// wrapper's concat become one write.
//
// x [B, d] fp32 or bf16; wr, wi [kdeg, Fc, d] of the same type (values
// {0, +-1}, exact in bf16); col_deg [Fc] int32; col_scale [Fc] fp32 ->
// out [B, 2 Fc] fp32. Every element is converted to fp32 on load; products
// and sums are fp32.
//
// Grid: (row tiles, complex-column tiles) of 64 x 64, one tile a block, as
// the rm_feature kernel (B1): 256 threads, each holding four 4 x 4 fp32
// register tiles (the running product Ar, Ai and the slot's projection Pr,
// Pi: twice B1's accumulators). x and the wr / wi slot rows are staged 32
// wide along d in shared memory. The slot loop stops at the tile's own
// largest degree (pack_ctr sorts columns by degree); the j < col_deg mask
// is per column. Rows past B load as zero and are never stored; a column
// past Fc is a padding column (degree 0, scale 0) and is never stored.
//
// What bounds it on the card: at the decode shape of the serving path (x =
// q or k of 4 slots x 16 heads, [64, 128]; wr / wi [5, 127, 128]) the work
// is about 7 MFLOP over 0.3 MB, well under a microsecond of fp32 FLOPs or
// bytes, so the launch is latency-bound: its time is the chain of staged
// steps of the deepest tile (5 slots x 4 d slices, each a round of global
// loads and two barriers; a thread issues a round's loads together). At a
// bucket-256 prefill (x [4096, 128]) it is bound by fp32 FMA issue on the
// CUDA cores; wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows and complex columns of a tile
constexpr int kStageK = 32;    // width of the staged d slice
constexpr int kLd = kStageK + 1;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (kThreads, 1): one block an SM is enough for the path's grids (2 blocks
// at decode, 128 at a 4096-row prefill), so ptxas may keep all four register
// tiles without spilling.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ctr_feature_kernel(const T* __restrict__ x, const T* __restrict__ wr,
                   const T* __restrict__ wi, const int* __restrict__ col_deg,
                   const float* __restrict__ col_scale,
                   float* __restrict__ out, int B, int Fc, int d, int kdeg) {
  __shared__ float xs[kTile][kLd];
  __shared__ float wrs[kTile][kLd];
  __shared__ float wis[kTile][kLd];
  const int r0 = blockIdx.x * kTile;
  const int f0 = blockIdx.y * kTile;
  const int nrows = min(kTile, B - r0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // tile-local product depth (the same in every thread, so the barriers
  // below stay uniform)
  int depth = 0;
  for (int c = 0; c < kTile; ++c) {
    if (f0 + c < Fc) depth = max(depth, col_deg[f0 + c]);
  }
  depth = min(depth, kdeg);

  int my_deg[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int f = f0 + tx + 16 * jj;
    my_deg[jj] = f < Fc ? col_deg[f] : 0;
  }
  float ar[4][4], ai[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      ar[i][jj] = 1.f;
      ai[i][jj] = 0.f;
    }

  for (int j = 0; j < depth; ++j) {
    float pr[4][4], pi[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pr[i][jj] = 0.f;
        pi[i][jj] = 0.f;
      }
    const T* wrj = wr + (size_t)j * Fc * d;
    const T* wij = wi + (size_t)j * Fc * d;
    for (int k0 = 0; k0 < d; k0 += kStageK) {
      // a constant trip count, unrolled: all 24 global loads of a thread
      // are in flight before the first shared-memory store
#pragma unroll
      for (int it = 0; it < kTile * kStageK / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int r = e / kStageK;
        const int kk = e % kStageK;
        const bool kin = k0 + kk < d;
        const bool fin = f0 + r < Fc && kin;
        xs[r][kk] = (r < nrows && kin) ? to_f32(x[(size_t)(r0 + r) * d + k0 + kk]) : 0.f;
        wrs[r][kk] = fin ? to_f32(wrj[(size_t)(f0 + r) * d + k0 + kk]) : 0.f;
        wis[r][kk] = fin ? to_f32(wij[(size_t)(f0 + r) * d + k0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kStageK; ++kk) {
        float a[4], br[4], bi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          br[jj] = wrs[tx + 16 * jj][kk];
          bi[jj] = wis[tx + 16 * jj][kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            pr[i][jj] = fmaf(a[i], br[jj], pr[i][jj]);
            pi[i][jj] = fmaf(a[i], bi[jj], pi[i][jj]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j < my_deg[jj]) {
          const float nr = ar[i][jj] * pr[i][jj] - ai[i][jj] * pi[i][jj];
          const float ni = ar[i][jj] * pi[i][jj] + ai[i][jj] * pr[i][jj];
          ar[i][jj] = nr;
          ai[i][jj] = ni;
        }
  }

  const size_t ld = 2 * (size_t)Fc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = f0 + tx + 16 * jj;
      if (f >= Fc) continue;
      const float s = col_scale[f];
      out[(size_t)r * ld + f] = ar[i][jj] * s;
      out[(size_t)r * ld + Fc + f] = ai[i][jj] * s;
    }
  }
}

template <typename T>
int launch(const void* x, const void* wr, const void* wi, const int* col_deg,
           const float* col_scale, float* out, int B, int Fc, int d, int kdeg,
           cudaStream_t stream) {
  dim3 grid((B + kTile - 1) / kTile, (Fc + kTile - 1) / kTile);
  ctr_feature_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wr),
      static_cast<const T*>(wi), col_deg, col_scale, out, B, Fc, d, kdeg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, wr and wi). Returns cudaGetLastError().
extern "C" int ctr_feature_launch(const void* x, const void* wr,
                                  const void* wi, const int* col_deg,
                                  const float* col_scale, float* out, int B,
                                  int Fc, int d, int kdeg, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Fc < 1 || d < 1 || kdeg < 1 || Fc > 65535 * kTile)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, wr, wi, col_deg, col_scale, out, B, Fc, d, kdeg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wr, wi, col_deg, col_scale, out, B, Fc, d,
                                 kdeg, s);
  return (int)cudaErrorInvalidValue;
}
