// rm_attention_chunked: pass B of the two-launch causal RM attention, for
// Hopper.
//
// Replaces the TPU kernel repro/kernels/rm_attention/rm_attention.py
// rm_attention_chunked_pallas (body _rm_attn_kernel). Given features
// zq, zk [BH, T, F], values v [BH, T, dv] and the exclusive chunk prefixes
// s_prev [BH, T/C, F, dv], n_prev [BH, T/C, F] (pass A and the prefix sums
// run before the launch, in PyTorch), it computes for every chunk of C rows
//
//     scores = tril(zq zk^T)                  (mask once, after the F sum)
//     out    = (scores v + zq S_prev) / clamp(rowsum(scores) + zq n_prev)
//
// with clamp(den) = sign(den) * max(|den|, eps), den >= 0 -> +eps. zq, zk
// fp32 or bf16 (converted to fp32 on load); v, s_prev, n_prev, out fp32;
// every product and sum is fp32. T is a multiple of C (the wrapper pads);
// F, dv and C are ragged (masked here).
//
// Split. The grid cells (BH, chunk) are independent, as on the TPU. One
// chunk's zq alone is C x F x 4 = 128 KB at C = 128, F = 256, so a block
// owns a 64-row query tile of one chunk and a 64-column value tile:
// grid = (BH, chunks x ceil(C / 64), ceil(dv / 64)). It streams F in
// 32-wide slices twice over: once against S_prev / n_prev (the carried
// state), and once per 64-key tile at or before its query rows, summing
// the [64, 64] scores over ALL of F before the causal mask is applied;
// then it multiplies the masked tile by the staged v tile. 256 threads,
// each with a 4 x 4 register tile of scores and of the numerator; each
// thread's partial denominator (its columns only) is summed over the 16
// threads of its row group with warp shuffles at the end. Static shared
// memory, 33.7 KB.
//
// What bounds it on the card: the products ([64, F] x [F, 64] per tile)
// run on the fp32 CUDA cores, and a value tile of 128 columns recomputes
// its scores once per 64-column half; at the prefill shape (BH 16, T 256,
// F 256, dv 128) it issues about 0.6 GFLOP against a ~7 us bound.
// wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows, keys and value columns a tile
constexpr int kStage = 32;     // features (or keys) staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LS = kStage + 1;
constexpr int LT = kTile + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rm_attention_chunked_kernel(const T* __restrict__ zq, const T* __restrict__ zk,
                            const float* __restrict__ v,
                            const float* __restrict__ s_prev,
                            const float* __restrict__ n_prev,
                            float* __restrict__ out, int T_len, int F, int dv,
                            int chunk, int q_tiles, float eps) {
  // [qs | ks] while scores accumulate; vs while they multiply v
  __shared__ float ab[2 * kTile * LS];
  __shared__ float sc[kTile * LT];      // masked scores / S_prev slice
  __shared__ float ns[kStage];          // n_prev slice
  float* qs = ab;                       // [64][LS]  zq slice
  float* ks = ab + kTile * LS;          // [64][LS]  zk slice
  float* vs = ab;                       // [64][LT]  v tile
  float* ss = sc;                       // [kStage][LT] S_prev slice

  const int bh = blockIdx.x;
  const int ci = blockIdx.y / q_tiles;
  const int q0 = (blockIdx.y % q_tiles) * kTile;
  const int d0 = blockIdx.z * kTile;
  const int nq = min(kTile, chunk - q0);
  const int nchunks = T_len / chunk;
  const size_t row0 = (size_t)bh * T_len + (size_t)ci * chunk;
  const float* sp = s_prev + ((size_t)bh * nchunks + ci) * F * dv;
  const float* np_ = n_prev + ((size_t)bh * nchunks + ci) * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4], den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  }

  // -- the carried state: acc = zq S_prev, den = zq n_prev -------------------
  for (int f0 = 0; f0 < F; f0 += kStage) {
    for (int e = tid; e < kTile * kStage; e += kThreads) {
      const int r = e / kStage;
      const int ff = e % kStage;
      qs[r * LS + ff] = (r < nq && f0 + ff < F)
                            ? to_f32(zq[(row0 + q0 + r) * F + f0 + ff]) : 0.f;
    }
    for (int e = tid; e < kStage * kTile; e += kThreads) {
      const int ff = e / kTile;
      const int cc = e % kTile;
      ss[ff * LT + cc] = (f0 + ff < F && d0 + cc < dv)
                             ? sp[(size_t)(f0 + ff) * dv + d0 + cc] : 0.f;
    }
    if (tid < kStage) ns[tid] = f0 + tid < F ? np_[f0 + tid] : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int ff = 0; ff < kStage; ++ff) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LS + ff];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = ss[ff * LT + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    // this thread's share of zq n_prev: features tx and tx + 16
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* qrow = qs + (ty + 16 * i) * LS;
      den[i] = fmaf(qrow[tx], ns[tx], fmaf(qrow[tx + 16], ns[tx + 16], den[i]));
    }
    __syncthreads();
  }

  // -- the chunk itself: key tiles at or before this query tile -------------
  const int kend = q0 + nq;             // keys past the last query row are masked
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kStage) {
      for (int e = tid; e < kTile * kStage; e += kThreads) {
        const int r = e / kStage;
        const int ff = e % kStage;
        const bool fin = f0 + ff < F;
        qs[r * LS + ff] = (r < nq && fin)
                              ? to_f32(zq[(row0 + q0 + r) * F + f0 + ff]) : 0.f;
        ks[r * LS + ff] = (k0 + r < chunk && fin)
                              ? to_f32(zk[(row0 + k0 + r) * F + f0 + ff]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int ff = 0; ff < kStage; ++ff) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LS + ff];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[jj] = ks[(tx + 16 * jj) * LS + ff];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
      }
      __syncthreads();
    }
    // causal mask after the whole feature sum; row sums into den
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        const float val = (kj <= qi && kj < chunk) ? s[i][jj] : 0.f;
        sc[(ty + 16 * i) * LT + tx + 16 * jj] = val;
        den[i] += val;
      }
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile;
      const int cc = e % kTile;
      vs[r * LT + cc] = (k0 + r < chunk && d0 + cc < dv)
                            ? v[(row0 + k0 + r) * dv + d0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sc[(ty + 16 * i) * LT + kk];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = vs[kk * LT + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  // each row's denominator: sum the partials of its 16 threads (tx is the
  // low four bits of the lane)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float inv = 1.f / clamp_den(den[i], eps);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = d0 + tx + 16 * jj;
      if (col < dv) out[(row0 + q0 + r) * dv + col] = acc[i][jj] * inv;
    }
  }
}

template <typename T>
int launch(const void* zq, const void* zk, const float* v,
           const float* s_prev, const float* n_prev, float* out, int BH,
           int T_len, int F, int dv, int chunk, float eps,
           cudaStream_t stream) {
  const int q_tiles = (chunk + kTile - 1) / kTile;
  dim3 grid(BH, (T_len / chunk) * q_tiles, (dv + kTile - 1) / kTile);
  rm_attention_chunked_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(zq), static_cast<const T*>(zk), v, s_prev,
      n_prev, out, T_len, F, dv, chunk, q_tiles, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (zq and zk). T_len must be a multiple of
// chunk. Returns cudaGetLastError().
extern "C" int rm_attention_chunked_launch(
    const void* zq, const void* zk, const float* v, const float* s_prev,
    const float* n_prev, float* out, int BH, int T_len, int F, int dv,
    int chunk, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || T_len % chunk != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(zq, zk, v, s_prev, n_prev, out, BH, T_len, F, dv,
                         chunk, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(zq, zk, v, s_prev, n_prev, out, BH, T_len,
                                 F, dv, chunk, eps, s);
  return (int)cudaErrorInvalidValue;
}
