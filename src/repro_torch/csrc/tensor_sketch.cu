// tensor_sketch: the fused TensorSketch map in one launch, for Hopper.
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
// type; col_deg [Fs] int32; col_scale [Fs] fp32 -> out [B, Fs] fp32. Every
// element is converted to fp32 on load; products and sums are fp32.
//
// Split. The TPU kernel tiles the batch only and keeps all Fs columns and
// the dense [Fs, Fs] inverse DFT resident. On Hopper that does not fit (at
// qwen3-1.7b's head, Fs = 255: wr + wi are 1.3 MB and mr + mi 0.52 MB in
// fp32). pack_sketch builds mr / mi block-diagonal by degree block, and
// inside a block every column has one degree, so here one thread block owns
// one (row tile, degree block): stage 1 runs the block's c columns over its
// own slots, in 64-column tiles, and leaves Ar, Ai [rows, c] in shared
// memory; stage 2 multiplies them by the block's [c, c] inverse DFT only
// (sum c^2 = 28,339 products a row at Fs = 255, 44% of the dense 65,025).
// The block bounds come from the plan (SketchPlan.block_starts) through the
// launch arguments; entries of mr / mi outside the blocks are never read.
//
// What bounds it on the card: at the decode shape (x [64, 128], a 4-slot
// batch of 16 heads) the work is about 20 MFLOP over 0.6 MB, well under a
// microsecond of fp32 FLOPs or bytes, so the launch is latency-bound: its
// time is the chain of staged steps of the widest block (stage 1: column
// tiles x slots x d / 32; stage 2: column tiles x c / 32), each a global
// load and two barriers. The row tile is chosen for blocks in flight
// (repro_torch.kernels.common.pick_sketch_rows). Products run on the fp32
// CUDA cores; wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;       // feature columns of a tile
constexpr int kStage = 32;      // width of a staged d (or f) slice
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMaxBlocks = 64;  // degree blocks a launch may carry

struct Blocks {
  int start[kMaxBlocks + 1];    // first column of each block, then Fs
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// RI rows a thread: a block covers BM = 16 * RI rows. Thread (ty, tx) owns
// rows ty + 16 i (i < RI) and columns tx + 16 jj (jj < 4) of each tile.
template <typename T, int RI>
__global__ void __launch_bounds__(kThreads)
tensor_sketch_kernel(const T* __restrict__ x, const T* __restrict__ wr,
                     const T* __restrict__ wi, const int* __restrict__ col_deg,
                     const T* __restrict__ mr, const T* __restrict__ mi,
                     const float* __restrict__ col_scale,
                     float* __restrict__ out, const Blocks blocks, int B,
                     int Fs, int d, int kdeg, int c_ld) {
  constexpr int BM = 16 * RI;
  constexpr int LS = kStage + 1;
  extern __shared__ float smem[];
  float* xs = smem;                       // [BM][LS]    x slice
  float* as = xs + BM * LS;               // [kCols][LS] wr slice / mr slice
  float* bs = as + kCols * LS;            // [kCols][LS] wi slice / mi slice
  float* Ar = bs + kCols * LS;            // [BM][c_ld]  running product, real
  float* Ai = Ar + BM * c_ld;             // [BM][c_ld]  imag

  const int r0 = blockIdx.x * BM;
  const int c0 = blocks.start[blockIdx.y];
  const int c = blocks.start[blockIdx.y + 1] - c0;
  const int nrows = min(BM, B - r0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // product depth of this degree block (uniform across the block, so the
  // barriers below are reached by every thread)
  int depth = 0;
  for (int f = 0; f < c; ++f) depth = max(depth, col_deg[c0 + f]);
  depth = min(depth, kdeg);

  // -- stage 1: complex running product, one 64-column tile at a time ------
  for (int t0 = 0; t0 < c; t0 += kCols) {
    float ar[RI][4], ai[RI][4];
    int my_deg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = t0 + tx + 16 * jj;
      my_deg[jj] = f < c ? col_deg[c0 + f] : 0;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ar[i][jj] = 1.f;
        ai[i][jj] = 0.f;
      }
    for (int j = 0; j < depth; ++j) {
      float pr[RI][4], pi[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          pr[i][jj] = 0.f;
          pi[i][jj] = 0.f;
        }
      const T* wrj = wr + (size_t)j * Fs * d;
      const T* wij = wi + (size_t)j * Fs * d;
      for (int k0 = 0; k0 < d; k0 += kStage) {
        for (int e = tid; e < BM * kStage; e += kThreads) {
          const int r = e / kStage;
          const int kk = e % kStage;
          xs[r * LS + kk] = (r < nrows && k0 + kk < d)
                                ? to_f32(x[(size_t)(r0 + r) * d + k0 + kk]) : 0.f;
        }
        for (int e = tid; e < kCols * kStage; e += kThreads) {
          const int cc = e / kStage;
          const int kk = e % kStage;
          const bool in = t0 + cc < c && k0 + kk < d;
          const size_t off = (size_t)(c0 + t0 + cc) * d + k0 + kk;
          as[cc * LS + kk] = in ? to_f32(wrj[off]) : 0.f;
          bs[cc * LS + kk] = in ? to_f32(wij[off]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kStage; ++kk) {
          float a[RI], br[4], bi[4];
#pragma unroll
          for (int i = 0; i < RI; ++i) a[i] = xs[(ty + 16 * i) * LS + kk];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            br[jj] = as[(tx + 16 * jj) * LS + kk];
            bi[jj] = bs[(tx + 16 * jj) * LS + kk];
          }
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              pr[i][jj] = fmaf(a[i], br[jj], pr[i][jj]);
              pi[i][jj] = fmaf(a[i], bi[jj], pi[i][jj]);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (j < my_deg[jj]) {
            const float nr = ar[i][jj] * pr[i][jj] - ai[i][jj] * pi[i][jj];
            const float ni = ar[i][jj] * pi[i][jj] + ai[i][jj] * pr[i][jj];
            ar[i][jj] = nr;
            ai[i][jj] = ni;
          }
    }
    // every column of the tile is written (past c: the finite (1, 0)), so
    // stage 2 never reads uninitialized shared memory
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int idx = (ty + 16 * i) * c_ld + t0 + tx + 16 * jj;
        Ar[idx] = ar[i][jj];
        Ai[idx] = ai[i][jj];
      }
  }
  __syncthreads();

  // -- stage 2: the block's inverse DFT, then the scales --------------------
  for (int g0 = 0; g0 < c; g0 += kCols) {
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
    for (int f0 = 0; f0 < c; f0 += kStage) {
      for (int e = tid; e < kCols * kStage; e += kThreads) {
        const int gg = e / kStage;
        const int ff = e % kStage;
        const bool in = g0 + gg < c && f0 + ff < c;
        const size_t off = (size_t)(c0 + g0 + gg) * Fs + c0 + f0 + ff;
        as[gg * LS + ff] = in ? to_f32(mr[off]) : 0.f;
        bs[gg * LS + ff] = in ? to_f32(mi[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int ff = 0; ff < kStage; ++ff) {
        float a_r[RI], a_i[RI], m_r[4], m_i[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          a_r[i] = Ar[(ty + 16 * i) * c_ld + f0 + ff];
          a_i[i] = Ai[(ty + 16 * i) * c_ld + f0 + ff];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          m_r[jj] = as[(tx + 16 * jj) * LS + ff];
          m_i[jj] = bs[(tx + 16 * jj) * LS + ff];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = fmaf(a_r[i], m_r[jj], fmaf(-a_i[i], m_i[jj], acc[i][jj]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int g = g0 + tx + 16 * jj;
        if (g < c)
          out[(size_t)(r0 + r) * Fs + c0 + g] = acc[i][jj] * col_scale[c0 + g];
      }
    }
  }
}

template <typename T, int RI>
int launch(const void* x, const void* wr, const void* wi, const int* col_deg,
           const void* mr, const void* mi, const float* col_scale, float* out,
           const Blocks& blocks, int n_blocks, int B, int Fs, int d, int kdeg,
           int c_ld, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tensor_sketch_kernel<T, RI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + 16 * RI - 1) / (16 * RI), n_blocks);
  tensor_sketch_kernel<T, RI><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wr),
      static_cast<const T*>(wi), col_deg, static_cast<const T*>(mr),
      static_cast<const T*>(mi), col_scale, out, blocks, B, Fs, d, kdeg, c_ld);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* x, const void* wr, const void* wi,
                const int* col_deg, const void* mr, const void* mi,
                const float* col_scale, float* out, const Blocks& blocks,
                int n_blocks, int B, int Fs, int d, int kdeg, int c_ld,
                int smem_bytes, cudaStream_t stream) {
  if (rows == 64)
    return launch<T, 4>(x, wr, wi, col_deg, mr, mi, col_scale, out, blocks,
                        n_blocks, B, Fs, d, kdeg, c_ld, smem_bytes, stream);
  if (rows == 32)
    return launch<T, 2>(x, wr, wi, col_deg, mr, mi, col_scale, out, blocks,
                        n_blocks, B, Fs, d, kdeg, c_ld, smem_bytes, stream);
  if (rows == 16)
    return launch<T, 1>(x, wr, wi, col_deg, mr, mi, col_scale, out, blocks,
                        n_blocks, B, Fs, d, kdeg, c_ld, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// block_starts: host array of n_blocks + 1 ints (0, ..., Fs), strictly
// increasing. rows: 64, 32 or 16. c_ld >= round_up(widest block, 64) and
// smem_bytes come from repro_torch.kernels.common (pick_sketch_rows,
// sketch_smem_bytes). dtype: 0 = fp32, 1 = bf16 (x, wr, wi, mr, mi).
// Returns cudaGetLastError().
extern "C" int tensor_sketch_launch(
    const void* x, const void* wr, const void* wi, const int* col_deg,
    const void* mr, const void* mi, const float* col_scale, float* out,
    const int* block_starts, int n_blocks, int B, int Fs, int d, int kdeg,
    int rows, int c_ld, int smem_bytes, int dtype, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || block_starts[0] != 0 ||
      block_starts[n_blocks] != Fs)
    return (int)cudaErrorInvalidValue;
  Blocks blocks;
  for (int i = 0; i <= n_blocks; ++i) {
    blocks.start[i] = block_starts[i];
    if (i > 0 && (block_starts[i] <= block_starts[i - 1] ||
                  c_ld < ((block_starts[i] - block_starts[i - 1] + kCols - 1) / kCols) * kCols))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(rows, x, wr, wi, col_deg, mr, mi, col_scale,
                              out, blocks, n_blocks, B, Fs, d, kdeg, c_ld,
                              smem_bytes, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, x, wr, wi, col_deg, mr, mi,
                                      col_scale, out, blocks, n_blocks, B, Fs,
                                      d, kdeg, c_ld, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
