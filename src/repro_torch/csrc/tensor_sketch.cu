// tensor_sketch: the fused TensorSketch map in one launch, on Hopper's
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/tensor_sketch/tensor_sketch.py
// tensor_sketch_fused_pallas (body _ts_fused_kernel). On the packed
// frequency-domain tensors of repro_torch.sketch.plan.pack_sketch it computes
//
//   stage 1  (Ar, Ai) <- (Ar Pr - Ai Pi, Ar Pi + Ai Pr) for slots j < col_deg,
//            P_j = x (Wr_j + i Wi_j)^T, from (Ar, Ai) = (1, 0);
//   stage 2  z = Ar Mr^T - Ai Mi^T, then z *= col_scale.
//
// x [B, d] fp32 or bf16; wr, wi [kdeg, Fs, d], mr, mi [Fs, Fs] of the same
// type; col_deg [Fs] int32; col_scale [Fs] fp32 -> out [B, Fs] fp32, fp32
// accumulation.
//
// Split. pack_sketch builds mr / mi block-diagonal by degree block, and
// inside a block every column has one degree, so stage 2 needs only the
// block's own [c, c] inverse DFT (sum c^2 = 28,339 entries at qwen3-1.7b's
// head, Fs 255, 44% of the dense 65,025; entries off the blocks are never
// read). One thread block owns one *item* (16 rows, a degree block, a group
// of at most 160 output columns of that block; kernels.common.
// sketch_schedule, the items in device memory, so any number of blocks
// fits) and walks the degree block in rounds of 8 W columns, W = 8 warps
// on decode-sized batches (fewer rounds on the longest item's path), 4
// past them (more blocks an SM):
//   stage 1: each warp runs one 8-column tile's complex chain on the
//     tensor cores (complex_mma.cuh), x and the weight rows read straight
//     from device memory into mma fragments;
//   the round's Mr / Mi slices (the group's rows x the round's columns,
//     inside the block's diagonal only) are copied to shared memory by
//     cp.async while the chains run;
//   stage 2: the round's Ar, Ai [16, 8 W] go to shared memory and the
//     warps form Ar Mr[G, :]^T - Ai Mi[G, :]^T for the round in mma
//     fragments and add it to z[:, G], held in registers across rounds,
//     by fp32 adds.
// No block holds more than a round of Ar / Ai, so a degree block of any
// width fits (the paper's exp map at D 4000 has one of 2000 columns).
// Every item of a degree block recomputes that block's stage 1: cheap next
// to stage 2 on the wide low-degree blocks, and what turns the widest
// block into several thread blocks at decode. Each output element is
// written by one thread, in one order: a call is bitwise repeatable.
//
// Precision: stage 1 runs 3xTF32 on fp32 inputs and bf16 mma on bf16
// inputs; stage 2 always runs 3xTF32, since Ar / Ai are fp32 (the TPU
// kernel computes it in fp32 for bf16 inputs too); bf16 Mr / Mi convert
// exactly.
//
// What bounds it on the card: at the decode shape (x [64, 128], a 4-slot
// batch of 16 heads) the work is about 20 MFLOP over 0.6 MB, under a
// microsecond either way, so launch latency and the longest item's rounds
// (its chains, then its stage-2 share, with two barriers) bound it: the
// schedule then takes the narrowest groups, for the most blocks in flight.
// At x [4096, 128] the 1.31 GFLOP take about 8 us in 3xTF32 on the tensor
// cores (2 us of bytes); the schedule takes wide groups there, so less of
// stage 1 is recomputed, and the chains' loads (each warp reads its x rows
// again for every pass) bound it in practice.
#include "complex_mma.cuh"

namespace {

// The widest group an item takes: the Mr / Mi slices it stages (two of
// 160 rows) and the accumulator tiles its W warps hold.
constexpr int kMaxGroup = 160;
constexpr int kItemInts = 3;      // c0, c, g0 of an item

// Rows [0, m_rows) x columns [0, 8 W) of one round's slice of m (row g0 +
// gg, column f0 + k of the block at c0, Fs the row stride) into dst (fp32,
// stride 8 W + 4): live iff gg < gw and f0 + k < c, zeros otherwise. fp32
// by 4-byte cp.async; bf16 converts through registers.
template <typename T, int W>
__device__ __forceinline__ void stage_m(float* dst, const T* __restrict__ m,
                                        int c0, int c, int g0, int gw, int f0,
                                        int Fs, int m_rows) {
  constexpr int kRoundCols = 8 * W, kLd = kRoundCols + 4;
  for (int e = threadIdx.x; e < m_rows * kRoundCols; e += 32 * W) {
    const int gg = e / kRoundCols;
    const int k = e - gg * kRoundCols;
    const bool live = gg < gw && f0 + k < c;
    const T* src = m + static_cast<size_t>(c0 + g0 + gg) * Fs + c0 + f0 + k;
    if constexpr (sizeof(T) == 4) {
      const uint32_t s =
          static_cast<uint32_t>(__cvta_generic_to_shared(dst + gg * kLd + k));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                   "l"(live ? src : m), "r"(live ? 4 : 0));
    } else {
      dst[gg * kLd + k] = live ? __bfloat162float(__ldg(src)) : 0.f;
    }
  }
}

template <int W>
size_t smem_bytes(int m_rows) {
  return static_cast<size_t>(2 * 16 + 2 * m_rows) * (8 * W + 4) * 4;
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
tensor_sketch_kernel(const T* __restrict__ x, const T* __restrict__ wr,
                     const T* __restrict__ wi, const int* __restrict__ col_deg,
                     const T* __restrict__ mr, const T* __restrict__ mi,
                     const float* __restrict__ col_scale,
                     float* __restrict__ out, const int* __restrict__ items,
                     int group, int B, int Fs, int d, int kdeg, bool vec) {
  constexpr int kRoundCols = 8 * W;       // columns a round
  constexpr int kLd = kRoundCols + 4;      // fp32 row stride of the tiles
  constexpr int kMaxNTiles = (kMaxGroup / 8 + W - 1) / W;
  extern __shared__ __align__(16) float smem[];
  const int m_rows = (group + 7) / 8 * 8;
  float* as_r = smem;                      // [16][kLd]  the round's Ar
  float* as_i = as_r + 16 * kLd;           // [16][kLd]  Ai
  float* ms_r = as_i + 16 * kLd;           // [m_rows][kLd]  Mr slice
  float* ms_i = ms_r + m_rows * kLd;       // [m_rows][kLd]  Mi slice
  const int* it = items + kItemInts * blockIdx.y;
  const int c0 = __ldg(it), c = __ldg(it + 1), g0 = __ldg(it + 2);
  const int gw = min(group, c - g0);          // this item's output columns
  const int r0 = blockIdx.x * 16;
  const int depth = cmm::block_depth<W>(col_deg, c0, c0 + c, kdeg);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // stage 2: warp w takes the output tiles n = w + W q of the item
  const int n_tiles = (gw + 7) / 8;
  float acc[kMaxNTiles][4];
#pragma unroll
  for (int q = 0; q < kMaxNTiles; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  cmm::complex_rounds<T, W>(
      x, B, r0, wr, wi, Fs, d, c0, c0 + c, (c + kRoundCols - 1) / kRoundCols,
      depth, col_deg, vec,
      [&](int i) {
        stage_m<T, W>(ms_r, mr, c0, c, g0, gw, i * kRoundCols, Fs, m_rows);
        stage_m<T, W>(ms_i, mi, c0, c, g0, gw, i * kRoundCols, Fs, m_rows);
      },
      [&](int i, int cw, const float zr[4], const float zi[4]) {
        // the round's Ar / Ai; a column off the block is 0
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1);
          const int col = warp * cmm::kColTile + 2 * t + (e & 1);
          const bool ok = cw + 2 * t + (e & 1) < c0 + c;
          as_r[row * kLd + col] = ok ? zr[e] : 0.f;
          as_i[row * kLd + col] = ok ? zi[e] : 0.f;
        }
        __syncthreads();          // Ar / Ai and the Mr / Mi slices are in
        const float* mlr = ms_r + (lane & 7) * kLd + 4 * ((lane >> 3) & 1);
        const float* mli = ms_i + (lane & 7) * kLd + 4 * ((lane >> 3) & 1);
        // the round's k-steps up to the block's last column, into a
        // partial sum that joins z by an fp32 add (the tensor cores'
        // accumulation does not round to nearest: over a 2000-column
        // block's 32 rounds in one accumulator its error grew to 2e-5)
        const int k_steps = min(kRoundCols / 8, (c - i * kRoundCols + 7) / 8);
        float part[kMaxNTiles][4];
#pragma unroll
        for (int q = 0; q < kMaxNTiles; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < k_steps; ++ks) {
          uint32_t ah[4], al[4], nh[4], nl[4];
          rmm::frag_a(as_r + 8 * ks, kLd, 1, lane, ah, al);
          rmm::frag_a(as_i + 8 * ks, kLd, 1, lane, nh, nl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {     // -Ai: flip the signs, exactly
            nh[e] ^= 0x80000000u;
            nl[e] ^= 0x80000000u;
          }
#pragma unroll
          for (int q = 0; q < kMaxNTiles; ++q) {
            const int n = warp + W * q;
            if (n >= n_tiles) continue;
            uint32_t b[2], brh[2], brl[2], bih[2], bil[2];
            rmm::ldsm_x2(b, mlr + 8 * n * kLd + 8 * ks);
            rmm::split_words<2>(b, brh, brl);
            rmm::ldsm_x2(b, mli + 8 * n * kLd + 8 * ks);
            rmm::split_words<2>(b, bih, bil);
            rmm::mma_tf32(part[q], al, brh);
            rmm::mma_tf32(part[q], ah, brl);
            rmm::mma_tf32(part[q], nl, bih);
            rmm::mma_tf32(part[q], nh, bil);
            rmm::mma_tf32(part[q], ah, brh);
            rmm::mma_tf32(part[q], nh, bih);
          }
        }
#pragma unroll
        for (int q = 0; q < kMaxNTiles; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
        __syncthreads();          // the round's readers are done
      });
  // z times the scales, the item's columns and the rows that exist
#pragma unroll
  for (int q = 0; q < kMaxNTiles; ++q) {
    const int n = warp + W * q;
    if (n >= n_tiles) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gc = g0 + 8 * n + 2 * t + (e & 1);
      const int row = r0 + g + 8 * (e >> 1);
      if (gc < g0 + gw && row < B)
        out[static_cast<size_t>(row) * Fs + c0 + gc] =
            acc[q][e] * __ldg(col_scale + c0 + gc);
    }
  }
}

template <typename T, int W>
int launch(const void* x, const void* wr, const void* wi, const int* col_deg,
           const void* mr, const void* mi, const float* col_scale, float* out,
           const int* items, int n_items, int group, int B, int Fs, int d,
           int kdeg, cudaStream_t stream) {
  const size_t smem = smem_bytes<W>((group + 7) / 8 * 8);
  static size_t attr_bytes = 0;      // the instance's dynamic-smem limit set
  if (smem > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        tensor_sketch_kernel<T, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
    attr_bytes = smem;
  }
  const bool vec = cmm::vec16(static_cast<size_t>(d) * sizeof(T), x, wr, wi);
  dim3 grid((B + 15) / 16, n_items);
  tensor_sketch_kernel<T, W><<<grid, 32 * W, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wr),
      static_cast<const T*>(wi), col_deg, static_cast<const T*>(mr),
      static_cast<const T*>(mi), col_scale, out, items, group, B, Fs, d, kdeg,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warps(int warps, const void* x, const void* wr, const void* wi,
                 const int* col_deg, const void* mr, const void* mi,
                 const float* col_scale, float* out, const int* items,
                 int n_items, int group, int B, int Fs, int d, int kdeg,
                 cudaStream_t s) {
  if (warps == 8)
    return launch<T, 8>(x, wr, wi, col_deg, mr, mi, col_scale, out, items,
                        n_items, group, B, Fs, d, kdeg, s);
  if (warps == 4)
    return launch<T, 4>(x, wr, wi, col_deg, mr, mi, col_scale, out, items,
                        n_items, group, B, Fs, d, kdeg, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// items: device memory, n_items x (c0, c, g0): the degree block [c0, c0 +
// c) and its output columns [g0, g0 + group) (block-relative, cut at c),
// group at most 160; warps: 8 or 4 a block (rounds of 64 or 32 columns);
// both from repro_torch.kernels.common.sketch_schedule. dtype: 0 = fp32,
// 1 = bf16 (x, wr, wi, mr, mi). Returns cudaGetLastError().
extern "C" int tensor_sketch_launch(
    const void* x, const void* wr, const void* wi, const int* col_deg,
    const void* mr, const void* mi, const float* col_scale, float* out,
    const int* items, int n_items, int group, int B, int Fs, int d, int kdeg,
    int warps, int dtype, void* stream) {
  if (B < 1 || Fs < 1 || d < 1 || kdeg < 1 || group < 1 ||
      group > kMaxGroup || n_items < 1 || n_items > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_warps<float>(warps, x, wr, wi, col_deg, mr, mi, col_scale,
                               out, items, n_items, group, B, Fs, d, kdeg, s);
  if (dtype == 1)
    return launch_warps<__nv_bfloat16>(warps, x, wr, wi, col_deg, mr, mi,
                                       col_scale, out, items, n_items, group,
                                       B, Fs, d, kdeg, s);
  return (int)cudaErrorInvalidValue;
}
