// ctr_feature: the complex-to-real (CtR) map in one launch, on Hopper's
// tensor cores.
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
// x [B, d] fp32 or bf16; wr, wi [kdeg, Fc, d] of the same type (the plans'
// values are {0, +-1}: TF32 and bf16 numbers); col_deg [Fc] int32;
// col_scale [Fc] fp32 -> out [B, 2 Fc] fp32, fp32 accumulation.
//
// Design (complex_mma.cuh): a block of 4 warps owns 16 rows of x and 4
// column tiles of 8, one a warp; each warp runs its tile's complex chain on
// the tensor cores to the block's depth (pack_ctr sorts columns by degree,
// so a block's tiles have about one depth), two slots a pass over d, x and
// the weight rows read straight from device memory into mma fragments, the
// running product in the accumulator fragments. fp32 runs 3xTF32 with the
// hi(x) lo(w) term skipped where a warp vote finds a step's weights TF32
// numbers (always, on the plans' {0, +-1}: two mma a product; the vote
// stays, since the wrapper takes any weights); bf16 runs bf16 mma.
//
// Grid: (16-row groups, groups of 4 column tiles). At the serving path's
// decode (x [64, 128], Fc 127: 4 x 4 blocks, 64 warps) the CUDA-core
// kernel before ran 2 blocks of staged rounds.
//
// What bounds it on the card: at decode about 7 MFLOP over 0.3 MB, well
// under a microsecond either way, so launch latency and the chain of the
// deepest tile (5 slots: 3 passes over d) bound it; at x [4096, 128] the
// 0.42 GFLOP take about 1.7 us at two TF32 terms and the 6.5 MB about 2
// us at the HBM rate: bound by bytes in principle, by the chains' loads
// (each warp reads its 16 x rows again for every pass) in practice.
#include "complex_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kGroupCols = kWarps * cmm::kColTile;   // columns of a block

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
ctr_feature_kernel(const T* __restrict__ x, const T* __restrict__ wr,
                   const T* __restrict__ wi, const int* __restrict__ col_deg,
                   const float* __restrict__ col_scale,
                   float* __restrict__ out, int B, int Fc, int d, int kdeg,
                   bool vec) {
  const int r0 = blockIdx.x * 16;
  const int col_base = blockIdx.y * kGroupCols;
  const int depth = cmm::block_depth<kWarps>(
      col_deg, col_base, min(Fc, col_base + kGroupCols), kdeg);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ld = 2 * static_cast<size_t>(Fc);
  cmm::complex_rounds<T, kWarps>(
      x, B, r0, wr, wi, Fc, d, col_base, Fc, 1, depth, col_deg, vec,
      [](int) {}, [&](int, int cw, const float zr[4], const float zi[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = cw + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (f >= Fc || row >= B) continue;
          const float s = __ldg(col_scale + f);
          out[row * ld + f] = zr[e] * s;
          out[row * ld + Fc + f] = zi[e] * s;
        }
      });
}

template <typename T>
int launch(const void* x, const void* wr, const void* wi, const int* col_deg,
           const float* col_scale, float* out, int B, int Fc, int d, int kdeg,
           cudaStream_t stream) {
  const bool vec = cmm::vec16(static_cast<size_t>(d) * sizeof(T), x, wr, wi);
  dim3 grid((B + 15) / 16, (Fc + kGroupCols - 1) / kGroupCols);
  ctr_feature_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wr),
      static_cast<const T*>(wi), col_deg, col_scale, out, B, Fc, d, kdeg, vec);
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
  if (B < 1 || Fc < 1 || d < 1 || kdeg < 1 ||
      (Fc + kGroupCols - 1) / kGroupCols > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, wr, wi, col_deg, col_scale, out, B, Fc, d, kdeg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wr, wi, col_deg, col_scale, out, B, Fc, d,
                                 kdeg, s);
  return (int)cudaErrorInvalidValue;
}
