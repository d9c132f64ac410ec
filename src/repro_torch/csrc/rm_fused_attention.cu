// rm_fused_attention: featurize + causal linear attention + final state in
// one launch, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rm_attention/fused.py
// rm_fused_attention_pallas (body _fused_causal_kernel, helpers
// _featurize_block and _clamp). With zq = Z(q), zk = Z(k) * kvalid it
// computes, per batch*head row and chunk of C positions,
//
//     scores = tril(zq zk^T)                    (mask once, after the F sum)
//     out    = (scores v + zq S) / clamp(rowsum(scores) + zq n)
//     S     += zk^T v,   n += colsum(zk)       (state BEFORE the chunk is read)
//
// and writes the whole-prefix (S, n) once at the end, so prefill gets its
// decode state from the same launch. clamp(den) = sign(den) * max(|den|, eps)
// with den >= 0 -> +eps.
//
// Split. The TPU grid is sequential, so its state scratch carries across
// the chunk axis and the score/num/den sums carry across the feature-block
// axis. Hopper blocks run unordered, so here one block owns ALL F feature
// columns of one (batch*head, dv slice): the chunk loop runs inside the
// block carrying S[F, dv_block] and n[F] in shared memory, and the feature
// sums finish inside the block (no second pass, no atomics). Grid =
// (BH, dv / dv_block); each dv slice recomputes the featurize of its
// chunk, which buys dv / dv_block times more blocks in flight.
//
// What bounds it on the card: the featurize (2 x C x F x d FMAs per degree
// slot, on the fp32 CUDA cores) dominates; with BH = 16 and dv_block = 32,
// 64 blocks fill about half the 132 SMs. wgmma tiles and a featurize shared
// across the dv slices are later work.
//
// Layouts: q, k [BH, T, d] fp32 or bf16; v [BH, T, dv] fp32; kvalid [BH, T]
// fp32; w [kdeg, F, d] same type as q; col_deg [F] int32; col_scale [F]
// fp32 -> out [BH, T, dv], S [BH, F, dv], n [BH, F], all fp32. T is a
// multiple of the chunk (the wrapper pads it); F is ragged (masked).
#include "rm_featurize.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float clamp_den(float den, float eps) {
  return fabsf(den) < eps ? (den >= 0.f ? eps : -eps) : den;
}

template <typename T>
__global__ void __launch_bounds__(rmf::kThreads)
rm_fused_causal_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ kvalid,
                       const T* __restrict__ w,
                       const int* __restrict__ col_deg,
                       const float* __restrict__ col_scale,
                       float* __restrict__ out, float* __restrict__ s_out,
                       float* __restrict__ n_out, int T_len, int d, int dv,
                       int kdeg, int F, int F_pad, int chunk, int dv_block,
                       float eps) {
  extern __shared__ float smem[];
  const int ldz = F_pad + 1;
  float* zq = smem;                                   // [chunk][ldz]
  float* zk = zq + chunk * ldz;                       // [chunk][ldz]
  float* S = zk + chunk * ldz;                        // [F_pad][dv_block]
  float* nn = S + F_pad * dv_block;                   // [F_pad]
  float* stage = nn + F_pad;                          // featurize / scores
  const int stage_floats = max(rmf::kStageFloats, chunk * (chunk + 1));
  float* vs = stage + stage_floats;                   // [chunk][dv_block]
  float* sc = stage;                                  // [chunk][chunk + 1]

  const int bh = blockIdx.x;
  const int dv0 = blockIdx.y * dv_block;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % kWarp;
  const int wid = tid / kWarp;
  const int nwarps = rmf::kThreads / kWarp;
  const bool col_ok = lane < dv_block && dv0 + lane < dv;

  for (int e = tid; e < F_pad * dv_block; e += rmf::kThreads) S[e] = 0.f;
  for (int e = tid; e < F_pad; e += rmf::kThreads) nn[e] = 0.f;

  const size_t row0 = (size_t)bh * T_len;
  for (int t0 = 0; t0 < T_len; t0 += chunk) {
    // featurize the q and k chunk against every feature tile
    for (int f0 = 0; f0 < F_pad; f0 += rmf::kTile) {
      float acc[4][4];
      rmf::featurize_tile<T>(q + (row0 + t0) * d, d, chunk, d, w, kdeg, F,
                             col_deg, col_scale, f0, stage, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < chunk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) zq[r * ldz + f0 + tx + 16 * jj] = acc[i][jj];
      }
      __syncthreads();
      rmf::featurize_tile<T>(k + (row0 + t0) * d, d, chunk, d, w, kdeg, F,
                             col_deg, col_scale, f0, stage, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < chunk) {
          const float kv = kvalid[row0 + t0 + r];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) zk[r * ldz + f0 + tx + 16 * jj] = acc[i][jj] * kv;
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < chunk * dv_block; e += rmf::kThreads) {
      const int r = e / dv_block;
      const int c = e % dv_block;
      vs[e] = dv0 + c < dv ? v[(row0 + t0 + r) * dv + dv0 + c] : 0.f;
    }
    // chunk-local scores over the whole feature axis, causal mask once
    for (int e = tid; e < chunk * chunk; e += rmf::kThreads) {
      const int r = e / chunk;
      const int c = e % chunk;
      float s = 0.f;
      if (c <= r) {
        const float* a = zq + r * ldz;
        const float* b = zk + c * ldz;
        for (int f = 0; f < F_pad; ++f) s = fmaf(a[f], b[f], s);
      }
      sc[r * (chunk + 1) + c] = s;
    }
    __syncthreads();
    // outputs: intra-chunk term + carried state (chunks before this one)
    for (int r = wid; r < chunk; r += nwarps) {
      const float* srow = sc + r * (chunk + 1);
      const float* zrow = zq + r * ldz;
      float num = 0.f, den = 0.f;
      for (int c = 0; c <= r; ++c) {
        const float s = srow[c];
        den += s;
        if (col_ok) num = fmaf(s, vs[c * dv_block + lane], num);
      }
      for (int f = 0; f < F_pad; ++f) {
        const float z = zrow[f];
        den = fmaf(z, nn[f], den);
        if (col_ok) num = fmaf(z, S[f * dv_block + lane], num);
      }
      if (col_ok) out[(row0 + t0 + r) * dv + dv0 + lane] = num / clamp_den(den, eps);
    }
    __syncthreads();
    // fold the chunk into the carried state
    for (int e = tid; e < F_pad * dv_block; e += rmf::kThreads) {
      const int f = e / dv_block;
      const int c = e % dv_block;
      float s = S[e];
      for (int r = 0; r < chunk; ++r) s = fmaf(zk[r * ldz + f], vs[r * dv_block + c], s);
      S[e] = s;
    }
    for (int f = tid; f < F_pad; f += rmf::kThreads) {
      float s = nn[f];
      for (int r = 0; r < chunk; ++r) s += zk[r * ldz + f];
      nn[f] = s;
    }
    __syncthreads();
  }
  // the whole-prefix state, written once
  for (int e = tid; e < F * dv_block; e += rmf::kThreads) {
    const int f = e / dv_block;
    const int c = e % dv_block;
    if (dv0 + c < dv) s_out[((size_t)bh * F + f) * dv + dv0 + c] = S[f * dv_block + c];
  }
  if (blockIdx.y == 0)
    for (int f = tid; f < F; f += rmf::kThreads) n_out[(size_t)bh * F + f] = nn[f];
}

template <typename T>
int launch(const void* q, const void* k, const float* v, const float* kvalid,
           const void* w, const int* col_deg, const float* col_scale,
           float* out, float* s_out, float* n_out, int BH, int T_len, int d,
           int dv, int kdeg, int F, int chunk, int dv_block, float eps,
           int smem_bytes, cudaStream_t stream) {
  const int F_pad = (F + rmf::kTile - 1) / rmf::kTile * rmf::kTile;
  cudaError_t err = cudaFuncSetAttribute(
      rm_fused_causal_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (dv + dv_block - 1) / dv_block);
  rm_fused_causal_kernel<T><<<grid, rmf::kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), v, kvalid,
      static_cast<const T*>(w), col_deg, col_scale, out, s_out, n_out, T_len,
      d, dv, kdeg, F, F_pad, chunk, dv_block, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k and w). smem_bytes comes from
// repro_torch.kernels.common.attention_smem_bytes. Returns cudaGetLastError().
extern "C" int rm_fused_causal_launch(
    const void* q, const void* k, const float* v, const float* kvalid,
    const void* w, const int* col_deg, const float* col_scale, float* out,
    float* s_out, float* n_out, int BH, int T_len, int d, int dv, int kdeg,
    int F, int chunk, int dv_block, float eps, int smem_bytes, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > rmf::kTile || dv_block < 1 || dv_block > kWarp ||
      T_len % chunk != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, kvalid, w, col_deg, col_scale, out, s_out,
                         n_out, BH, T_len, d, dv, kdeg, F, chunk, dv_block,
                         eps, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kvalid, w, col_deg, col_scale, out,
                                 s_out, n_out, BH, T_len, d, dv, kdeg, F,
                                 chunk, dv_block, eps, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
