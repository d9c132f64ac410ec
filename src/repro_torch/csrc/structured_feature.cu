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
// Split path (m >= 16384). One block's registers no longer hold a row's
// transform (256 threads would keep 64+ points each of x, the transform and
// the product, past 255 registers), so the transform is split as
// H_m = H_a (x) H_b over an fp32 scratch [kdeg, S, rows, m] (every slot of
// every stack of a chunk of rows; the wrapper sizes the chunk to its
// budget, kernels.common.STRUCTURED_SCRATCH_BYTES):
//   run pass:    u = x o d1_j over each run of 1024 contiguous points, one
//                warp a run (the warp path's stages h = 1 .. 512), written
//                to the scratch;
//   stride pass: each thread takes 2^k points at stride 2^lo (k <= 5; the
//                stages h = 2^lo .. 2^(lo + k - 1)) in its registers and
//                writes them back in place;
//   last pass:   the remaining stages the same way, then for every slot
//                j the product with d2_j into the running product, and
//                the kept columns written as above.
// Passes after the run pass split lg(m) - 10 into pieces of at most 5 bits
// (split_passes; kernels.common.structured_split_passes). The stages run
// in ascending h as on the other paths, so the transform rounds as theirs.
// Slots past a stack's depth (stack_depth[s], the largest column degree)
// are skipped. Neighbouring threads take neighbouring points in every
// pass, so each scratch access is coalesced.
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
constexpr int kBlockMaxLg = 13;                  // m <= 8192: the block path
constexpr int kMaxLg = 30;                       // past 8192: the split path
constexpr int kRunLg = 10;                       // split: runs of 1024
constexpr int kRunWarps = 8;                     //   points, a warp a run
constexpr int kPassMaxLg = 5;                    // split: <= 32 points a
constexpr int kPassThreads = 256;                //   thread a stride pass
constexpr int kMaxGrid = 65535;                  // grid y and z

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

// Split path, run pass: grid (m / 8192, rows, kdeg * S), 8 warps a block,
// one run of 1024 points a warp (point i of the run in lane i % 32,
// register i / 32). Rows row0 + r of x; the scratch row of slot j of stack
// s is (js * rows + r) * m with js = j * S + s.
template <typename T>
__global__ void __launch_bounds__(32 * kRunWarps)
structured_split_runs(const T* __restrict__ x, const T* __restrict__ d1,
                      const int* __restrict__ stack_depth,
                      float* __restrict__ scratch, int rows, int row0, int d,
                      int S, int lgm) {
  const int js = blockIdx.z;
  if (js / S >= __ldg(stack_depth + js % S)) return;
  const size_t m = static_cast<size_t>(1) << lgm;
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  const int p0 = (run << kRunLg) + lane;
  const T* xr = x + static_cast<size_t>(row0 + r) * d;
  const T* d1j = d1 + js * m;
  float u[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int p = p0 + 32 * e;
    u[e] = (p < d ? to_f32(xr[p]) : 0.f) * to_f32(d1j[p]);
  }
  float sg[5];
  lane_signs(sg, lane);
  lane_stages<32>(u, 5, sg);
  register_stages<32>(u);
  float* o = scratch + (static_cast<size_t>(js) * rows + r) * m + p0;
#pragma unroll
  for (int e = 0; e < 32; ++e) o[32 * e] = u[e];
}

// The first of a thread's E points at stride 2^lo: thread q of a row takes
// points base + e 2^lo, e < E.
template <int E>
__device__ __forceinline__ size_t split_base(size_t q, int lo) {
  return ((q >> lo) << (lo + kLgE<E>::value)) + (q & ((size_t{1} << lo) - 1));
}

// Split path, stride pass (not the last): grid (m / E / 256, rows,
// kdeg * S), in place.
template <int E>
__global__ void __launch_bounds__(kPassThreads)
structured_split_stride(const int* __restrict__ stack_depth,
                        float* __restrict__ scratch, int rows, int S,
                        int lgm, int lo) {
  const int js = blockIdx.z;
  if (js / S >= __ldg(stack_depth + js % S)) return;
  const size_t m = static_cast<size_t>(1) << lgm;
  const size_t q = static_cast<size_t>(blockIdx.x) * kPassThreads
                   + threadIdx.x;
  const size_t t = static_cast<size_t>(1) << lo;
  float* v = scratch + (static_cast<size_t>(js) * rows + blockIdx.y) * m
             + split_base<E>(q, lo);
  float u[E];
#pragma unroll
  for (int e = 0; e < E; ++e) u[e] = v[e * t];
  register_stages<E>(u);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e * t] = u[e];
}

// Split path, last pass: grid (m / E / 256, rows, S); the last stages of
// every slot, the running product with d2_j and the kept columns.
template <typename T, int E>
__global__ void __launch_bounds__(kPassThreads)
structured_split_last(const T* __restrict__ d2,
                      const int* __restrict__ col_deg,
                      const float* __restrict__ col_scale,
                      const int* __restrict__ stack_depth,
                      const float* __restrict__ scratch,
                      float* __restrict__ out, long long ldo,
                      const int* __restrict__ dst_col,
                      const int* __restrict__ dst_count, int rows, int row0,
                      int S, int lgm, int lo) {
  const int s = blockIdx.z;
  const int r = blockIdx.y;
  const size_t m = static_cast<size_t>(1) << lgm;
  const size_t q = static_cast<size_t>(blockIdx.x) * kPassThreads
                   + threadIdx.x;
  const size_t t = static_cast<size_t>(1) << lo;
  const size_t base = split_base<E>(q, lo);
  const size_t cs0 = static_cast<size_t>(s) * m;
  const int depth = __ldg(stack_depth + s);
  float acc[E];
  int deg[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    acc[e] = 1.f;
    deg[e] = __ldg(col_deg + cs0 + base + e * t);
  }
  for (int j = 0; j < depth; ++j) {
    const size_t js = static_cast<size_t>(j) * S + s;
    const float* v = scratch + (js * rows + r) * m + base;
    const T* d2j = d2 + js * m + base;
    float u[E];
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = v[e * t];
    register_stages<E>(u);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j < deg[e]) acc[e] *= u[e] * to_f32(d2j[e * t]);
  }
  const size_t count = static_cast<size_t>(__ldg(dst_count + s));
  float* ob = out + static_cast<long long>(row0 + r) * ldo
              + __ldg(dst_col + s);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const size_t c = base + e * t;
    if (c < count) ob[c] = acc[e] * __ldg(col_scale + cs0 + c);
  }
}

// The split path's passes after the run pass: lg(m) - 10 bits in
// ceil(/ 5) pieces as even as they come, the larger first (as
// kernels.common.structured_split_passes). Returns their count.
inline int split_passes(int lgm, int bits[8]) {
  const int rest = lgm - kRunLg;
  const int n = (rest + kPassMaxLg - 1) / kPassMaxLg;
  for (int i = 0; i < n; ++i) bits[i] = rest / n + (i < rest % n ? 1 : 0);
  return n;
}

struct Args {
  const void *x, *d1, *d2;
  const int* col_deg;
  const float* col_scale;
  float* out;
  long long ldo;
  const int *dst_col, *dst_count;
  int B, d, S, lgm, kdeg, warps, lgl;
  const int* stack_depth;
  float* scratch;
  int chunk_rows;
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

template <int E>
void launch_stride(const Args& a, int rows, int lo, cudaStream_t stream) {
  const size_t m = static_cast<size_t>(1) << a.lgm;
  dim3 grid(static_cast<unsigned>(m / E / kPassThreads), rows, a.S * a.kdeg);
  structured_split_stride<E><<<grid, kPassThreads, 0, stream>>>(
      a.stack_depth, a.scratch, rows, a.S, a.lgm, lo);
}

template <typename T, int E>
void launch_last(const Args& a, int rows, int row0, int lo,
                 cudaStream_t stream) {
  const size_t m = static_cast<size_t>(1) << a.lgm;
  dim3 grid(static_cast<unsigned>(m / E / kPassThreads), rows, a.S);
  structured_split_last<T, E><<<grid, kPassThreads, 0, stream>>>(
      static_cast<const T*>(a.d2), a.col_deg, a.col_scale, a.stack_depth,
      a.scratch, a.out, a.ldo, a.dst_col, a.dst_count, rows, row0, a.S,
      a.lgm, lo);
}

// Every chunk of rows: the run pass, the stride passes, the last pass, all
// on the stream in order (the scratch is reused chunk after chunk).
template <typename T>
int launch_split(const Args& a, cudaStream_t stream) {
  int bits[8];
  const int n = split_passes(a.lgm, bits);
  for (int row0 = 0; row0 < a.B; row0 += a.chunk_rows) {
    const int rows = a.B - row0 < a.chunk_rows ? a.B - row0 : a.chunk_rows;
    dim3 grid(1u << (a.lgm - kRunLg - 3), rows, a.S * a.kdeg);
    structured_split_runs<T><<<grid, 32 * kRunWarps, 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.d1),
        a.stack_depth, a.scratch, rows, row0, a.d, a.S, a.lgm);
    int lo = kRunLg;
    for (int p = 0; p < n; ++p) {
      if (p + 1 < n) {
        switch (bits[p]) {
          case 1: launch_stride<2>(a, rows, lo, stream); break;
          case 2: launch_stride<4>(a, rows, lo, stream); break;
          case 3: launch_stride<8>(a, rows, lo, stream); break;
          case 4: launch_stride<16>(a, rows, lo, stream); break;
          case 5: launch_stride<32>(a, rows, lo, stream); break;
          default: return (int)cudaErrorInvalidValue;
        }
      } else {
        switch (bits[p]) {
          case 1: launch_last<T, 2>(a, rows, row0, lo, stream); break;
          case 2: launch_last<T, 4>(a, rows, row0, lo, stream); break;
          case 3: launch_last<T, 8>(a, rows, row0, lo, stream); break;
          case 4: launch_last<T, 16>(a, rows, row0, lo, stream); break;
          case 5: launch_last<T, 32>(a, rows, row0, lo, stream); break;
          default: return (int)cudaErrorInvalidValue;
        }
      }
      lo += bits[p];
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.lgm > kBlockMaxLg) return launch_split<T>(a, stream);
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
// stride ldo floats; dst_col / dst_count [S] int32 (see above). The split
// path (m > 8192) also takes stack_depth [S] int32 (each stack's largest
// column degree, at most kdeg) and an fp32 scratch of chunk_rows * kdeg *
// S * m floats, and runs the rows chunk_rows at a time; the other paths
// read neither. dtype: 0 = fp32, 1 = bf16 (x, d1 and d2). Returns
// cudaGetLastError().
extern "C" int structured_feature_launch(
    const void* x, const void* d1, const void* d2, const int* col_deg,
    const float* col_scale, float* out, long long ldo, const int* dst_col,
    const int* dst_count, int B, int d, int S, int lgm, int kdeg, int warps,
    int lgl, const int* stack_depth, float* scratch, int chunk_rows,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || S > kMaxGrid || kdeg < 1 || lgm < 0 ||
      lgm > kMaxLg || d < 1 || d > (1 << lgm) || ldo < 1 ||
      (lgm <= kWarpMaxLg &&
       (warps < 1 || warps > 8 || lgl < 0 || lgl > 5 || lgl > lgm ||
        lgm - lgl > 5)) ||
      (lgm > kBlockMaxLg &&
       (stack_depth == nullptr || scratch == nullptr || chunk_rows < 1 ||
        chunk_rows > kMaxGrid ||
        static_cast<long long>(S) * kdeg > kMaxGrid)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, d1, d2, col_deg, col_scale, out, ldo, dst_col, dst_count,
               B, d, S, lgm, kdeg, warps, lgl, stack_depth, scratch,
               chunk_rows};
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
