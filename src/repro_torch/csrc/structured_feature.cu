// structured_feature: the Hadamard-structured map in one launch, for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/structured_feature/structured_feature.py
// structured_feature_fused_pallas (body _structured_fused_kernel, helper
// _wht). On the packed sign tensors of
// repro_torch.structured.plan.pack_structured it computes, for every stack
// s and every column c of it (output column f = s * m + c),
//
//   acc <- acc * (d2_j o WHT(d1_j o x))_c   for slots j < col_deg[f],
//   out[:, f] = col_scale[f] * acc,         from acc = 1,
//
// where WHT is the unnormalized Walsh-Hadamard transform of size m = d_pad
// in Sylvester order: stage h = 1, 2, ..., m/2 maps each pair (i, i + h)
// with i & h == 0 to (a + b, a - b) in place, as _wht does. No matmul.
//
// x [B, d] fp32 or bf16 with d <= m (columns d..m-1 read as zero, so an
// input narrower than the Hadamard size needs no padded copy); d1, d2
// [kdeg, S, m] of x's type (values +-1, exact in bf16); col_deg [S m]
// int32; col_scale [S m] fp32 -> out [B, S m] fp32. Every element is
// converted to fp32 on load; the transform, products and sums are fp32.
//
// Grid: (row tiles, stacks). A block owns R rows of one stack, E = R m <=
// 8192 elements: thread t holds elements t + 256 q (q < PT, the smallest
// power of two with 256 PT >= E) in registers — x, the running product and
// the column's degree — and the transform runs in a dynamic shared-memory
// buffer of E floats (32 KB at most), log2(m) butterfly stages, each pair
// once, a barrier between stages. PT is a template argument, so a small
// tile holds few registers and several blocks share an SM. One code path
// covers every power of two m from 1 (no stage: the identity) to 8192
// (R = 1); the wrapper raises above that. R is chosen by
// repro_torch.kernels.common.pick_structured_rows: at d_pad 128 blocks of
// at most 8 rows (1024 elements, PT 4, 48 registers), many to an SM.
// The slot loop stops at the stack's largest column degree; the mask is
// per column. Rows past B are never stored.
//
// What bounds it on the card: at a bucket-256 prefill (x [4096, 128], 6
// stacks at qwen3-1.7b's head) the output is 12.6 MB of fp32 against
// about 0.1 GFLOP of adds, so it is bound by bytes (4 us at the HBM rate);
// at decode (x [64, 128]) by latency: the chain of 5 slots x (7 stages + 3)
// barriers of one block. The 512 surplus columns of 768 computed (scale
// 0) are computed and written as the reference computes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxElems = 8192;                  // R * m of one block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
structured_feature_kernel(const T* __restrict__ x, const T* __restrict__ d1,
                          const T* __restrict__ d2,
                          const int* __restrict__ col_deg,
                          const float* __restrict__ col_scale,
                          float* __restrict__ out, int B, int d, int S,
                          int lgm, int R, int kdeg) {
  extern __shared__ float u[];                   // E floats
  __shared__ int s_depth;
  const int m = 1 << lgm;
  const int E = R * m;
  const int r0 = blockIdx.x * R;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t ncols = (size_t)S * m;

  float xr[PT], acc[PT];
  int deg[PT];
  int depth = 0;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int e = tid + kThreads * q;
    const int row = e >> lgm;
    const int c = e & (m - 1);
    const bool in = e < E;
    xr[q] = (in && r0 + row < B && c < d)
                ? to_f32(x[(size_t)(r0 + row) * d + c]) : 0.f;
    acc[q] = 1.f;
    deg[q] = in ? col_deg[(size_t)s * m + c] : 0;
    depth = max(depth, deg[q]);
  }
  // the stack's depth, the same in every thread: E >= m, so the block's
  // elements cover every column of the stack
  if (tid == 0) s_depth = 0;
  __syncthreads();
  atomicMax(&s_depth, depth);
  __syncthreads();
  depth = min(s_depth, kdeg);

  for (int j = 0; j < depth; ++j) {
    const T* d1j = d1 + ((size_t)j * S + s) * m;
    const T* d2j = d2 + ((size_t)j * S + s) * m;
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int e = tid + kThreads * q;
      if (e < E) u[e] = xr[q] * to_f32(d1j[e & (m - 1)]);
    }
    // butterfly, Sylvester order: pair p of stage h is (lo, lo + h) of its
    // row, lo = (p / h) 2h + p % h within the row's m / 2 pairs
    for (int lgh = 0; lgh < lgm; ++lgh) {
      __syncthreads();
      const int h = 1 << lgh;
      for (int p = tid; p < E / 2; p += kThreads) {
        const int row = p >> (lgm - 1);
        const int pq = p & ((m >> 1) - 1);
        const int lo = (row << lgm) + ((pq >> lgh) << (lgh + 1)) + (pq & (h - 1));
        const float a = u[lo];
        const float b = u[lo + h];
        u[lo] = a + b;
        u[lo + h] = a - b;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int e = tid + kThreads * q;
      if (e < E && j < deg[q]) acc[q] *= u[e] * to_f32(d2j[e & (m - 1)]);
    }
    __syncthreads();    // u is rewritten by the next slot
  }

#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int e = tid + kThreads * q;
    const int row = e >> lgm;
    const int c = e & (m - 1);
    if (e < E && r0 + row < B) {
      const size_t f = (size_t)s * m + c;
      out[(size_t)(r0 + row) * ncols + f] = acc[q] * col_scale[f];
    }
  }
}

template <typename T, int PT>
int launch_pt(const void* x, const void* d1, const void* d2,
              const int* col_deg, const float* col_scale, float* out, int B,
              int d, int S, int lgm, int R, int kdeg, cudaStream_t stream) {
  dim3 grid((B + R - 1) / R, S);
  const size_t smem = ((size_t)R << lgm) * sizeof(float);
  structured_feature_kernel<T, PT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d1),
      static_cast<const T*>(d2), col_deg, col_scale, out, B, d, S, lgm, R,
      kdeg);
  return (int)cudaGetLastError();
}

// the smallest register-slot count PT (a power of two) with 256 PT >= E
template <typename T>
int launch(const void* x, const void* d1, const void* d2, const int* col_deg,
           const float* col_scale, float* out, int B, int d, int S, int lgm,
           int R, int kdeg, cudaStream_t stream) {
  const int E = R << lgm;
#define STRUCTURED_LAUNCH(PT)                                                \
  if (E <= (PT) * kThreads)                                                  \
    return launch_pt<T, PT>(x, d1, d2, col_deg, col_scale, out, B, d, S, lgm, \
                            R, kdeg, stream);
  STRUCTURED_LAUNCH(1)
  STRUCTURED_LAUNCH(2)
  STRUCTURED_LAUNCH(4)
  STRUCTURED_LAUNCH(8)
  STRUCTURED_LAUNCH(16)
  STRUCTURED_LAUNCH(32)
#undef STRUCTURED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// m = 1 << lgm is the Hadamard size d_pad; R the rows a block owns.
// dtype: 0 = fp32, 1 = bf16 (x, d1 and d2). Returns cudaGetLastError().
extern "C" int structured_feature_launch(const void* x, const void* d1,
                                         const void* d2, const int* col_deg,
                                         const float* col_scale, float* out,
                                         int B, int d, int S, int lgm, int R,
                                         int kdeg, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || S > 65535 || kdeg < 1 || lgm < 0 || R < 1 ||
      d < 1 || d > (1 << lgm) || ((long long)R << lgm) > kMaxElems)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, d1, d2, col_deg, col_scale, out, B, d, S, lgm, R,
                         kdeg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, d1, d2, col_deg, col_scale, out, B, d, S,
                                 lgm, R, kdeg, s);
  return (int)cudaErrorInvalidValue;
}
