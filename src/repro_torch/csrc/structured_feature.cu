// structured_feature: the Hadamard-structured map in one launch, for Hopper:
// each transform's butterflies in registers, only the kept columns written.
//
// Replaces the TPU kernel
// repro/kernels/structured_feature/structured_feature.py
// structured_feature_fused_pallas (body _structured_fused_kernel, helper
// _wht). On the packed sign tensors of
// repro_torch.structured.plan.pack_structured it computes, for every stack
// s and every column c of it,
//
//   acc <- acc * (d2_j o WHT(d1_j o x))_c   for slots j < col_deg[s m + c],
//   z[:, s m + c] = col_scale[s m + c] * acc,   from acc = 1,
//
// where WHT is the unnormalized Walsh-Hadamard transform of size m = d_pad
// in Sylvester order: stage h = 1, 2, ..., m/2 maps each pair (i, i + h)
// with i & h == 0 to (a + b, a - b), as _wht does. No matmul.
//
// x [B, d] fp32 or bf16 with d <= m (columns d..m-1 read as zero, so an
// input narrower than the Hadamard size needs no padded copy); d1, d2
// [kdeg, S, m] of x's type (values +-1, exact in bf16); col_deg [S m]
// int32; col_scale [S m] fp32. The destination: out fp32 with row stride
// ldo, and per stack s its first column dst_col[s] and its count of kept
// columns dst_count[s]: columns c < dst_count[s] of stack s go to out[row,
// dst_col[s] + c], and nothing else is written. The reference function's
// [B, S m] output is dst_col[s] = s m, dst_count[s] = m;
// apply_structured_plan passes its buckets' places in the final
// [rows, output_dim] map and drops each bucket's surplus tail unwritten.
//
// Warp path (m <= 1024). One warp owns one row of one stack (32 / m rows
// where m < 32). Point i of the row sits in lane i % 32, register i / 32:
// stages h < 32 run by __shfl_xor_sync, a lane taking b + a or b - a by
// its bit h; stages h >= 32 pair a thread's own registers. No shared
// memory, no barrier. The slot loop stops at the stack's largest column
// degree (a warp reduction). A block's warps take consecutive rows of one
// stack, so they share the slot's d1 / d2 rows in L1. Warps a block:
// repro_torch.kernels.common.structured_schedule.
//
// Block path (m = 2048 .. 8192). A block of 256 threads owns one row of one
// stack, point i in thread i % 256, register i / 256: shuffles for h < 32,
// a shared-memory exchange with a barrier on each side for h = 32 .. 128,
// registers for h >= 256.
//
// Every element is converted to fp32 on load; the transform, products and
// sums are fp32, each output written by one thread in one order, so two
// calls are bitwise equal.
//
// What bounds it on the card: bytes. At a bucket-256 prefill (x [4096, 128],
// qwen3-1.7b's head: 6 stacks, 16 slots) the full-width output is 12.6 MB
// (14.7 MB with x and the signs: 4.4 us at 3.35 TB/s) against 0.1 GFLOP of
// adds; through apply_structured_plan only the 255 kept random columns are
// written (6.3 MB with x and the prefix column). The warp shuffles (5 of
// the 7 stages, 20 a warp a slot at m 128) are the next limit. At decode (x
// [64, 128]) it is bound by latency: 5 dependent slots a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWideThreads = 256;
constexpr int kWarpMaxLg = 10;                   // m <= 1024: the warp path
constexpr int kMaxLg = 13;                       // m <= 8192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The sign a lane takes at each lane stage h = 1, 2, ..., 16: -1 where its
// bit h is set (it keeps b - a), +1 where it is clear (a + b).
__device__ __forceinline__ void lane_signs(float sg[5], int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) sg[k] = (lane >> k) & 1 ? -1.f : 1.f;
}

// Stages h = 1 .. 2^(lgl - 1) of the points a lane holds in u[0..E), lanes
// xor h apart: fmaf(sg, a, b) with b the partner's point rounds as a + b
// and b - a do.
template <int E>
__device__ __forceinline__ void lane_stages(float u[E], int lgl,
                                            const float sg[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= lgl) break;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float b = __shfl_xor_sync(0xffffffffu, u[e], 1 << k);
      u[e] = fmaf(sg[k], u[e], b);
    }
  }
}

template <int E> struct kLgE;
template <> struct kLgE<1> { static constexpr int value = 0; };
template <> struct kLgE<2> { static constexpr int value = 1; };
template <> struct kLgE<4> { static constexpr int value = 2; };
template <> struct kLgE<8> { static constexpr int value = 3; };
template <> struct kLgE<16> { static constexpr int value = 4; };
template <> struct kLgE<32> { static constexpr int value = 5; };

// The stages on a thread's own registers: points e and e + hr.
template <int E>
__device__ __forceinline__ void register_stages(float u[E]) {
#pragma unroll
  for (int hr = 1; hr < E; hr <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & hr) == 0) {
        const float a = u[e], b = u[e + hr];
        u[e] = a + b;
        u[e + hr] = a - b;
      }
}

template <typename T, int E>
__global__ void __launch_bounds__(256)
structured_feature_kernel_warp(const T* __restrict__ x,
                               const T* __restrict__ d1,
                               const T* __restrict__ d2,
                               const int* __restrict__ col_deg,
                               const float* __restrict__ col_scale,
                               float* __restrict__ out, long long ldo,
                               const int* __restrict__ dst_col,
                               const int* __restrict__ dst_count, int B,
                               int d, int S, int lgm, int kdeg) {
  const int m = 1 << lgm;
  const int lane = threadIdx.x & 31;
  const int lgl = lgm - kLgE<E>::value;          // lanes a row: 2^lgl
  const int row = ((blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))
                   << (5 - lgl)) + (lane >> lgl);
  const int s = blockIdx.y;
  const int i0 = lane & ((1 << lgl) - 1);        // point of register e:
  const int step = 1 << lgl;                     //   i0 + e 2^lgl
  const bool valid = row < B;
  const size_t cs0 = static_cast<size_t>(s) * m;

  float xr[E], acc[E];
  int deg[E];
  int depth = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = i0 + step * e;
    xr[e] = (valid && i < d) ? to_f32(x[static_cast<size_t>(row) * d + i])
                             : 0.f;
    acc[e] = 1.f;
    deg[e] = __ldg(col_deg + cs0 + i);
    depth = max(depth, deg[e]);
  }
  // the stack's depth: every lane holds columns of the same stack; where
  // every column has that depth (a plan's stacks do), no per-column mask
  const int top = __reduce_max_sync(0xffffffffu, depth);
  bool same = true;
#pragma unroll
  for (int e = 0; e < E; ++e) same = same && deg[e] == top;
  same = __all_sync(0xffffffffu, same);
  depth = min(top, kdeg);
  float sg[5];
  lane_signs(sg, lane);

  // the slot's signs, loaded a slot ahead where a lane holds few points
  constexpr bool kAhead = E <= 4;
  float n1[E], n2[E];
  auto load_signs = [&](int j) {
    const T* d1j = d1 + (static_cast<size_t>(j) * S + s) * m + i0;
    const T* d2j = d2 + (static_cast<size_t>(j) * S + s) * m + i0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      n1[e] = to_f32(d1j[step * e]);
      n2[e] = to_f32(d2j[step * e]);
    }
  };
  if (kAhead && depth > 0) load_signs(0);
  for (int j = 0; j < depth; ++j) {
    if (!kAhead) load_signs(j);
    float u[E], sg2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      u[e] = xr[e] * n1[e];
      sg2[e] = n2[e];
    }
    if (kAhead && j + 1 < depth) load_signs(j + 1);
    lane_stages<E>(u, lgl, sg);
    register_stages<E>(u);
    if (same) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= u[e] * sg2[e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (j < deg[e]) acc[e] *= u[e] * sg2[e];
    }
  }

  if (!valid) return;
  const int count = __ldg(dst_count + s);
  float* ob = out + row * ldo + __ldg(dst_col + s);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = i0 + step * e;
    if (c < count) ob[c] = acc[e] * __ldg(col_scale + cs0 + c);
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kWideThreads)
structured_feature_kernel_wide(const T* __restrict__ x,
                               const T* __restrict__ d1,
                               const T* __restrict__ d2,
                               const int* __restrict__ col_deg,
                               const float* __restrict__ col_scale,
                               float* __restrict__ out, long long ldo,
                               const int* __restrict__ dst_col,
                               const int* __restrict__ dst_count, int B,
                               int d, int S, int lgm, int kdeg) {
  extern __shared__ float buf[];                 // m floats
  __shared__ int warp_depth[kWideThreads / 32];
  const int m = 1 << lgm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = blockIdx.x;
  const int s = blockIdx.y;
  const size_t cs0 = static_cast<size_t>(s) * m;

  float xr[E], acc[E];
  int deg[E];
  int depth = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + kWideThreads * e;
    xr[e] = i < d ? to_f32(x[static_cast<size_t>(row) * d + i]) : 0.f;
    acc[e] = 1.f;
    deg[e] = __ldg(col_deg + cs0 + i);
    depth = max(depth, deg[e]);
  }
  depth = __reduce_max_sync(0xffffffffu, depth);
  if (lane == 0) warp_depth[tid >> 5] = depth;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w)
    depth = max(depth, warp_depth[w]);
  depth = min(depth, kdeg);
  float sg[5];
  lane_signs(sg, lane);

  for (int j = 0; j < depth; ++j) {
    const T* d1j = d1 + (static_cast<size_t>(j) * S + s) * m;
    const T* d2j = d2 + (static_cast<size_t>(j) * S + s) * m;
    float u[E], sg2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      u[e] = xr[e] * to_f32(d1j[tid + kWideThreads * e]);
      sg2[e] = to_f32(d2j[tid + kWideThreads * e]);
    }
    lane_stages<E>(u, 5, sg);
    // stages 32, 64, 128: across the warps, through shared memory
    for (int h = 32; h < kWideThreads; h <<= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) buf[tid + kWideThreads * e] = u[e];
      __syncthreads();
      const float sgn = (tid & h) ? -1.f : 1.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        u[e] = fmaf(sgn, u[e], buf[(tid ^ h) + kWideThreads * e]);
      __syncthreads();
    }
    register_stages<E>(u);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j < deg[e]) acc[e] *= u[e] * sg2[e];
  }

  const int count = __ldg(dst_count + s);
  float* ob = out + row * ldo + __ldg(dst_col + s);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = tid + kWideThreads * e;
    if (c < count) ob[c] = acc[e] * __ldg(col_scale + cs0 + c);
  }
}

struct Args {
  const void *x, *d1, *d2;
  const int* col_deg;
  const float* col_scale;
  float* out;
  long long ldo;
  const int *dst_col, *dst_count;
  int B, d, S, lgm, kdeg, warps, lgl;
};

template <typename T, int E>
int launch_warp(const Args& a, cudaStream_t stream) {
  const int rows_per_block = a.warps * (32 >> a.lgl);
  dim3 grid((a.B + rows_per_block - 1) / rows_per_block, a.S);
  structured_feature_kernel_warp<T, E><<<grid, 32 * a.warps, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.d1),
      static_cast<const T*>(a.d2), a.col_deg, a.col_scale, a.out, a.ldo,
      a.dst_col, a.dst_count, a.B, a.d, a.S, a.lgm, a.kdeg);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_wide(const Args& a, cudaStream_t stream) {
  dim3 grid(a.B, a.S);
  const size_t smem = (static_cast<size_t>(1) << a.lgm) * sizeof(float);
  structured_feature_kernel_wide<T, E><<<grid, kWideThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.d1),
      static_cast<const T*>(a.d2), a.col_deg, a.col_scale, a.out, a.ldo,
      a.dst_col, a.dst_count, a.B, a.d, a.S, a.lgm, a.kdeg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.lgm > kWarpMaxLg) {
    switch (a.lgm) {
      case 11: return launch_wide<T, 8>(a, stream);
      case 12: return launch_wide<T, 16>(a, stream);
      case 13: return launch_wide<T, 32>(a, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (a.lgm - a.lgl) {           // a lane's points: 2^(lgm - lgl)
    case 0: return launch_warp<T, 1>(a, stream);
    case 1: return launch_warp<T, 2>(a, stream);
    case 2: return launch_warp<T, 4>(a, stream);
    case 3: return launch_warp<T, 8>(a, stream);
    case 4: return launch_warp<T, 16>(a, stream);
    case 5: return launch_warp<T, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// m = 1 << lgm is the Hadamard size d_pad; warps and 2^lgl lanes a row: a
// warp-path block's warps and a row's lanes
// (kernels.common.structured_schedule; not read past m 1024). out: row
// stride ldo floats; dst_col / dst_count [S] int32 (see above). dtype: 0 =
// fp32, 1 = bf16 (x, d1 and d2). Returns cudaGetLastError().
extern "C" int structured_feature_launch(
    const void* x, const void* d1, const void* d2, const int* col_deg,
    const float* col_scale, float* out, long long ldo, const int* dst_col,
    const int* dst_count, int B, int d, int S, int lgm, int kdeg, int warps,
    int lgl, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || S > 65535 || kdeg < 1 || lgm < 0 ||
      lgm > kMaxLg || d < 1 || d > (1 << lgm) || ldo < 1 ||
      (lgm <= kWarpMaxLg &&
       (warps < 1 || warps > 8 || lgl < 0 || lgl > 5 || lgl > lgm ||
        lgm - lgl > 5)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, d1, d2, col_deg, col_scale, out, ldo, dst_col, dst_count,
               B, d, S, lgm, kdeg, warps, lgl};
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
