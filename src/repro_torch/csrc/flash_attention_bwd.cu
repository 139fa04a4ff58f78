// The backward of blockwise flash attention, for Hopper (sm_90a).
//
// For out = softmax(scale * q k^T, masked) v (csrc/flash_attention.cu,
// whose forward also wrote each row's log-sum-exp lse) and the output's
// gradient dO, it computes dq, dk and dv in three passes:
//
//   1. D_i = sum_d dO_id O_id (one warp a row);
//   2. one block per (64-key tile, KV head, batch) walks the G query heads
//      of its KV head in order and, for each, the query tiles that the
//      masks leave any key of the tile: P_ij = exp(scale q_i.k_j - lse_i)
//      where kept (else 0), dP_ij = dO_i.v_j, dS_ij = P_ij (dP_ij - D_i),
//      then dV_j += sum_i P_ij dO_i and dK_j += scale sum_i dS_ij q_i;
//   3. one block per (64-row query tile, head, batch) walks the K/V tiles
//      of the forward's loop bounds and accumulates dQ_i += scale
//      sum_j dS_ij k_j.
//
// The forward's semantics exactly: -1e30 logits where masked (so P = 0
// there), j <= i when causal, i - j < window when window > 0 whether or
// not causal, scale = 1/sqrt(dh), rows and keys past S skipped.  GQA: query
// head h reads KV head h / G, and a KV head's dk and dv sum over its G
// query heads inside one block.  No atomics and every sum in a fixed
// order: the same inputs give the same bits at any batch size.
//
// Replaces no TPU kernel: the JAX package differentiates its plain XLA
// attention (src/repro/models/attention.py); this is the backward of the
// function that src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas computes, so that a loss through the port's
// forward kernel trains on the card.  The first design: float32 products
// on the CUDA cores (csrc/simt_tile.cuh) from padded shared memory, q, k,
// v, O and dO read as float32 from bf16 or float32, gradients written in
// the inputs' type.
//
// Bound on this card, at the Zamba2 LM training step's (B 4, H 32, S
// 1024, dh 64, bf16, causal): q, k, v, O, dO and lse read once, dq, dk, dv
// written once, 135 MB, 40.2 us at 3.35 TB/s; the five products over the
// kept (query, key) pairs (S = q k^T, dP = dO v^T, dV, dK, dQ) are 10 dh
// flops a pair, 43.0 GFLOP, 43.5 us at the bf16 tensor rate: operations
// bind (chip_smoke.py flash_bwd_bound).  Passes 2 and 3 both recompute S
// and dP (14 dh flops a pair done) on the CUDA cores, whose float32 rate
// is a fifteenth of the tensor rate: 5.2 ms a launch on an H100 80GB HBM3
// at 700 W, 0.8% of the bound's rate.  A wgmma redesign is later work.

#include "simt_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using simt::gemm;
using simt::kThreads;
using simt::load_rows;
using simt::to_f32;

constexpr int kBK = 64;                  // keys a K/V tile
constexpr int kBQ = 64;                  // query rows a dQ block
constexpr int kLdP = kBK + 1;            // stride of the P and dS tiles
constexpr int kMaxD = 128;

// query rows a dK/dV step: 64, or 32 above head dim 64 (shared memory)
__host__ __device__ constexpr int dkdv_rows(int dh) {
  return dh <= 64 ? 64 : 32;
}
__host__ __device__ constexpr size_t dkdv_floats(int dh) {
  return (size_t)(4 * kBK + 2 * dkdv_rows(dh)) * (dh + 1) +
         (size_t)2 * dkdv_rows(dh) * kLdP + 2 * dkdv_rows(dh);
}
__host__ __device__ constexpr size_t dq_floats(int dh) {
  return (size_t)5 * kBQ * (dh + 1) + (size_t)2 * kBQ * kLdP + 2 * kBQ;
}

__device__ __forceinline__ bool kept(int i, int j, int S, int causal,
                                     int window) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || i - j < window);
}

// P and dS of a tile of `rows` queries from q0 and kBK keys from k0, in
// place: ps holds scale q.k, dps holds dO.v on entry
__device__ __forceinline__ void probs(float* ps, float* dps, int rows,
                                      const float* lse_s, const float* d_s,
                                      int q0, int k0, int S, int causal,
                                      int window) {
  for (int e = threadIdx.x; e < rows * kBK; e += kThreads) {
    const int r = e / kBK, c = e % kBK;
    const int idx = r * kLdP + c;
    const float p = kept(q0 + r, k0 + c, S, causal, window)
                        ? expf(ps[idx] - lse_s[r]) : 0.f;
    ps[idx] = p;
    dps[idx] = p * (dps[idx] - d_s[r]);
  }
}

// lse and D of rows [q0, q0 + rows) of one head (0 past S)
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int rows, int S) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool ok = q0 + r < S;
    lse_s[r] = ok ? lse[q0 + r] : 0.f;
    d_s[r] = ok ? delta[q0 + r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                float* __restrict__ delta, int64_t rows, int dh) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;              // whole warps leave together
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc += to_f32(out[row * dh + d]) * to_f32(dout[row * dh + d]);
  acc = simt::group_sum(acc, 32);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S,
               int dh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1, bq = dkdv_rows(dh);
  float* ks = smem;
  float* vs = ks + kBK * ld;
  float* dks = vs + kBK * ld;
  float* dvs = dks + kBK * ld;
  float* qs = dvs + kBK * ld;
  float* dos = qs + bq * ld;
  float* ps = dos + bq * ld;
  float* dps = ps + bq * kLdP;
  float* lse_s = dps + bq * kLdP;
  float* d_s = lse_s + bq;

  const int hk = blockIdx.y, b = blockIdx.z, G = H / Hkv;
  const int k0 = blockIdx.x * kBK;
  const int64_t kv_off = ((int64_t)(b * Hkv + hk) * S + k0) * dh;
  const int k_valid = min(kBK, S - k0);
  load_rows(ks, ld, k + kv_off, dh, kBK, k_valid, dh);
  load_rows(vs, ld, v + kv_off, dh, kBK, k_valid, dh);
  for (int e = threadIdx.x; e < kBK * ld; e += kThreads)
    dks[e] = dvs[e] = 0.f;
  // the query rows that keep any key of the tile
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kBK - 1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const int64_t row0 = (int64_t)(b * H + hk * G + g) * S;
    for (int q0 = i_lo / bq * bq; q0 < i_hi; q0 += bq) {
      __syncthreads();                   // the last step's reads are done
      const int q_valid = min(bq, S - q0);
      load_rows(qs, ld, q + (row0 + q0) * dh, dh, bq, q_valid, dh);
      load_rows(dos, ld, dout + (row0 + q0) * dh, dh, bq, q_valid, dh);
      load_stats(lse_s, d_s, lse + row0, delta + row0, q0, bq, S);
      __syncthreads();
      gemm(ps, kLdP, qs, ld, 1, ks, 1, ld, bq, kBK, dh, scale, false);
      gemm(dps, kLdP, dos, ld, 1, vs, 1, ld, bq, kBK, dh, 1.f, false);
      __syncthreads();
      probs(ps, dps, bq, lse_s, d_s, q0, k0, S, causal, window);
      __syncthreads();
      gemm(dvs, ld, ps, 1, kLdP, dos, ld, 1, kBK, dh, bq, 1.f, true);
      gemm(dks, ld, dps, 1, kLdP, qs, ld, 1, kBK, dh, bq, scale, true);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k_valid * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    dk[kv_off + e] = simt::from_f32<T>(dks[r * ld + d]);
    dv[kv_off + e] = simt::from_f32<T>(dvs[r * ld + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int Hkv, int S, int dh, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;
  float* dos = qs + kBQ * ld;
  float* ks = dos + kBQ * ld;
  float* vs = ks + kBQ * ld;
  float* dqs = vs + kBQ * ld;
  float* ps = dqs + kBQ * ld;
  float* dps = ps + kBQ * kLdP;
  float* lse_s = dps + kBQ * kLdP;
  float* d_s = lse_s + kBQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int64_t row0 = (int64_t)(b * H + h) * S;
  const int64_t kv0 = (int64_t)(b * Hkv + h / (H / Hkv)) * S;
  const int q_valid = min(kBQ, S - q0);
  load_rows(qs, ld, q + (row0 + q0) * dh, dh, kBQ, q_valid, dh);
  load_rows(dos, ld, dout + (row0 + q0) * dh, dh, kBQ, q_valid, dh);
  load_stats(lse_s, d_s, lse + row0, delta + row0, q0, kBQ, S);
  for (int e = threadIdx.x; e < kBQ * ld; e += kThreads) dqs[e] = 0.f;
  // the forward's loop bounds
  const int n_tiles = (S + kBK - 1) / kBK;
  const int stop = causal ? min((q0 + kBQ + kBK - 1) / kBK, n_tiles)
                          : n_tiles;
  const int start = window > 0 ? max((q0 - window + 1) / kBK, 0) : 0;

  for (int kt = start; kt < stop; ++kt) {
    const int k0 = kt * kBK, k_valid = min(kBK, S - k0);
    __syncthreads();                     // the last tile's reads are done
    load_rows(ks, ld, k + (kv0 + k0) * dh, dh, kBK, k_valid, dh);
    load_rows(vs, ld, v + (kv0 + k0) * dh, dh, kBK, k_valid, dh);
    __syncthreads();
    gemm(ps, kLdP, qs, ld, 1, ks, 1, ld, kBQ, kBK, dh, scale, false);
    gemm(dps, kLdP, dos, ld, 1, vs, 1, ld, kBQ, kBK, dh, 1.f, false);
    __syncthreads();
    probs(ps, dps, kBQ, lse_s, d_s, q0, k0, S, causal, window);
    __syncthreads();
    gemm(dqs, ld, dps, kLdP, 1, ks, ld, 1, kBQ, dh, kBK, scale, true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < q_valid * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    dq[(row0 + q0) * dh + e] = simt::from_f32<T>(dqs[r * ld + d]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int dh, int causal, int window,
                   float scale, cudaStream_t stream) {
  static bool configured = false;        // one attribute set per type
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(dkdv_floats(kMaxD) * sizeof(float)));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(dq_floats(kMaxD) * sizeof(float)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t rows = (int64_t)B * H * S;
  const int warps = kThreads / 32;
  flash_bwd_delta<T><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                       stream>>>((const T*)out, (const T*)dout, delta, rows,
                                 dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((unsigned)((S + kBK - 1) / kBK), (unsigned)Hkv,
                     (unsigned)B);
  flash_bwd_dkdv<T><<<kv_grid, kThreads, dkdv_floats(dh) * sizeof(float),
                      stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, Hkv, S, dh, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H,
                    (unsigned)B);
  flash_bwd_dq<T><<<q_grid, kThreads, dq_floats(dh) * sizeof(float),
                    stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, H, Hkv, S, dh, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out, dout and dq are (B, H, S,
// dh), k, v, dk and dv (B, Hkv, S, dh), lse and delta (B, H, S) float32,
// all contiguous; delta is scratch for D.  H % Hkv == 0, 1 <= dh <= 128,
// S >= 1, B and H <= 65535 (checked by the Python wrapper).  Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int dh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (dh < 1 || dh > kMaxD || Hkv < 1 || H % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, dout, (const float*)lse,
                              (float*)delta, dq, dk, dv, B, H, Hkv, S, dh,
                              causal, window, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse,
                                      (float*)delta, dq, dk, dv, B, H, Hkv,
                                      S, dh, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
