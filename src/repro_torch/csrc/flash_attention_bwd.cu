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
// forward kernel trains on the card.
//
// Bound on this card, at the Zamba2 LM training step's (B 4, H 32, S
// 1024, dh 64, bf16, causal): q, k, v, O, dO and lse read once, dq, dk, dv
// written once, 135 MB, 40.2 us at 3.35 TB/s; the five products over the
// kept (query, key) pairs (S = q k^T, dP = dO v^T, dV, dK, dQ) are 10 dh
// flops a pair, 43.0 GFLOP, 43.5 us at the bf16 tensor rate: operations
// bind (chip_smoke.py flash_bwd_bound).
//
// Two variants; kernel.py's ``choose_variant_backward`` picks one from
// dtype, shape and alignment alone:
//
// * wgmma (bf16 at the forward's wgmma head dims 16, 32, 64 and 128,
//   16-byte aligned q, k, v and dO: LM training and the DiT's gradient).
//   Passes 2 and 3 are one warpgroup of 128 threads a block, 64 keys
//   (dK/dV) or 64 query rows (dQ) as wgmma's M.  The dK/dV block loads
//   its k and v tiles once and each step's q and dO tiles (step = query
//   head of the KV head, query tile) into a two-stage mbarrier ring by
//   TMA with the forward's tensor maps (dO through q's).  S^T = k q^T and
//   dP^T = v dO^T are wgmma from shared memory (both K-major, exact bf16
//   inputs, float32 sums); the scale, the masks, P^T = exp(scale S^T -
//   lse) and dS^T = P^T (dP^T - D) run on the accumulator fragments,
//   with lse and D read per column; P^T and dS^T become wgmma's A
//   operand in registers for dV += P^T dO and dK += dS^T q (dO and q
//   MN-major from the same ring stage).  The dQ block walks the K/V
//   tiles of the forward's loop bounds through the ring: S = q k^T, dP
//   = dO v^T, then dQ += dS k (k MN-major).  Precision: the inputs go to
//   the tensor cores as they are; P and dS, float32 intermediates, go as
//   a bf16 hi part plus a bf16 lo part (two wgmmas; 16 of the 24
//   significant bits): the CPU rounding model
//   (tests/test_torch_bwd_variants.py) puts every gradient row within
//   2.7e-3 of the float32 plain version at the sweep's shapes, where one
//   bf16 part would read up to 5.8e-3 of chip_smoke.py's 1e-2.  The
//   scale multiplies the float32 sums.  S and dP are formed in both
//   passes (14 dh flops a pair on the tensor cores, 20 dh with the lo
//   parts) to keep one writer per output and no atomics.
// * simt (float32, or bf16 at other head dims or misaligned): the first
//   design, kept as it was.  Float32 products on the CUDA cores
//   (csrc/simt_tile.cuh) from padded shared memory, q, k, v, O and dO
//   read as float32, gradients written in the inputs' type.
//
// Measured on an H100 80GB HBM3 at 700 W at the step's shapes (PERF.md
// section 6, row 3b; chip_smoke.py and scripts/torch_bwd_kernel_profile.py):
// wgmma 0.442 ms a launch (dK/dV 0.258 ms, dQ 0.150 ms, D 0.027 ms),
// 9.8% of the bound's rate and 2.0x SDPA's backward; simt 5.21 ms, 0.8%.

#include "hopper.cuh"
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


// ---- bfloat16: wgmma, TMA ----------------------------------------------------
namespace wg {

constexpr int kRows = 64;                // keys a dK/dV block, rows a dQ block
constexpr int kThreads = 128;            // one warpgroup

template <int DH>
struct Geo {
  static constexpr int kRowBytes = DH * 2 < 128 ? DH * 2 : 128;  // swizzle
  static constexpr int kBoxBytes = kRows * kRowBytes;   // one TMA box
  static constexpr int kBoxes = DH * 2 / kRowBytes;     // boxes a tile
  static constexpr int kTileBytes = kRows * DH * 2;
  // two tiles held by the block, a ring of two stages of two tiles, three
  // mbarriers
  static constexpr size_t kSmem = 1024 + 6 * (size_t)kTileBytes + 3 * 8;
};

// D(64 x dh) += A(64 x 16, registers) B(16 x dh, MN-major)
template <int DH>
__device__ __forceinline__ void acc_k16(float (&d)[DH / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 16) hopper::wgmma_m64n16k16_rs_t1(d, a, db);
  else if constexpr (DH == 32) hopper::wgmma_m64n32k16_rs_t1(d, a, db);
  else if constexpr (DH == 64) hopper::wgmma_m64n64k16_rs_t1(d, a, db);
  else hopper::wgmma_m64n128k16_rs_t1(d, a, db);
}

// D += A B over a 64-row depth, A the hi and lo fragments of a float32
// tile (64 x 64), B the MN-major tile ``b``
template <int DH>
__device__ __forceinline__ void acc_split(float (&d)[DH / 2],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          const unsigned char* b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    acc_k16<DH>(d, hi[t], hopper::mnmajor_desc<Geo<DH>::kRowBytes>(b, t));
    acc_k16<DH>(d, lo[t], hopper::mnmajor_desc<Geo<DH>::kRowBytes>(b, t));
  }
}

template <int DH>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int z) {
  using G = Geo<DH>;
#pragma unroll
  for (int j = 0; j < G::kBoxes; ++j)
    hopper::tma_load_3d(dst + j * G::kBoxBytes, map, bar,
                        j * (G::kRowBytes / 2), row, z);
}

// two tiles at the same rows of two tensors into ``dst`` and the tile
// after it, completing on ``bar``
template <int DH>
__device__ __forceinline__ void load_pair(unsigned char* dst,
                                          const CUtensorMap* a_map,
                                          const CUtensorMap* b_map,
                                          uint64_t* bar, int row, int z) {
  using G = Geo<DH>;
  hopper::mbar_expect_tx(bar, 2 * G::kTileBytes);
  load_tile<DH>(dst, a_map, bar, row, z);
  load_tile<DH>(dst + G::kTileBytes, b_map, bar, row, z);
}

// S (or its transpose) and dP of one 64 x 64 tile: s += A1 B1^T over dh,
// dp += A2 B2^T, all four K-major tiles in shared memory
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32],
                                       const unsigned char* a1,
                                       const unsigned char* b1,
                                       const unsigned char* a2,
                                       const unsigned char* b2) {
  using namespace hopper;
  using G = Geo<DH>;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < DH / 16; ++t)
    wgmma_m64n64k16_ss_t0(s, kmajor_desc<G::kRowBytes>(a1, t),
                          kmajor_desc<G::kRowBytes>(b1, t));
#pragma unroll
  for (int t = 0; t < DH / 16; ++t)
    wgmma_m64n64k16_ss_t0(dp, kmajor_desc<G::kRowBytes>(a2, t),
                          kmajor_desc<G::kRowBytes>(b2, t));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// rows of a 64-row tile of a (., S, DH) bf16 tensor at z from the m64nDH
// accumulator times ``scale``; rows at or past S are not written
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t z,
                                           int S, int row0,
                                           const float (&d)[DH / 2],
                                           float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (z * S + row) * DH + 8 * j +
                                   2 * (lane % 4)) =
          hopper::pack_bf16(d[4 * j + 2 * r] * scale,
                            d[4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV: one block per (64-key tile, KV head, batch), the keys as M.
// Step n of the block is query head hk G + n / tiles, query tile t_lo + n
// % tiles; its q and dO tiles arrive by TMA in a two-stage ring.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S,
                  int causal, int window, float scale) {
  using namespace hopper;
  using G = Geo<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + G::kTileBytes;
  unsigned char* ring = vs + G::kTileBytes;        // (q, dO) x two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 4 * G::kTileBytes);

  const int hk = blockIdx.y, b = blockIdx.z, groups = H / Hkv;
  const int k0 = blockIdx.x * kRows, kz = b * Hkv + hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the query rows that keep any key of the tile, in 64-row tiles
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kRows - 1 + window) : S;
  const int t_lo = i_lo / kRows;
  const int tiles = (i_hi + kRows - 1) / kRows - t_lo;
  const int steps = groups * tiles;
  const CUtensorMap *qm = &q_map, *dom = &do_map;
  auto issue = [&](int n) {
    const int qz = b * H + hk * groups + n / tiles;
    load_pair<DH>(ring + (n & 1) * 2 * G::kTileBytes, qm, dom,
                  &bar[1 + (n & 1)], (t_lo + n % tiles) * kRows, qz);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<DH>(ks, &k_map, &v_map, &bar[0], k0, kz);
    for (int n = 0; n < 2 && n < steps; ++n) issue(n);
  }

  // accumulator rows (keys) key0 and key0 + 8; columns (queries)
  // 8j + cq + {0, 1} of the step's tile
  const int key0 = k0 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int n = 0; n < steps; ++n) {
    const int st = n & 1;
    const int q0 = (t_lo + n % tiles) * kRows;
    const int64_t row0 = (int64_t)(b * H + hk * groups + n / tiles) * S;
    const unsigned char* qt = ring + st * 2 * G::kTileBytes;
    const unsigned char* dot = qt + G::kTileBytes;
    float lq[16], dq[16];                // lse and D of the 16 columns
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = q0 + 8 * j + cq + c;
        const bool ok = col < S;
        lq[2 * j + c] = ok ? lse[row0 + col] : 0.f;
        dq[2 * j + c] = ok ? delta[row0 + col] : 0.f;
      }
    mbar_wait(&bar[1 + st], (n >> 1) & 1);
    // S^T = k q^T and dP^T = v dO^T, keys as rows
    float s[32], dp[32];
    scores<DH>(s, dp, ks, qt, vs, dot);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * r + c;
          const int key = key0 + 8 * r, qry = q0 + 8 * j + cq + c;
          const bool keep = qry < S && key < S && (!causal || key <= qry) &&
                            (window <= 0 || qry - key < window);
          const float p = keep ? expf(s[idx] * scale - lq[2 * j + c]) : 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - dq[2 * j + c]);
        }
    // dV += P^T dO and dK += dS^T q, P^T and dS^T as hi + lo bf16 A
    // fragments, dO and q MN-major
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    split_frags(s, ph, pl);
    split_frags(dp, sh, sl);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    acc_split<DH>(dva, ph, pl, dot);
    acc_split<DH>(dka, sh, sl, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sh);
    fence_regs(sl);
    if (n + 2 < steps) {                 // refill the stage just consumed
      __syncthreads();
      if (tid == 0) issue(n + 2);
    }
  }
  store_rows<DH>(dk, kz, S, key0, dka, scale);
  store_rows<DH>(dv, kz, S, key0, dva, 1.f);
}

// dQ: one block per (64-row query tile, head, batch), the rows as M,
// walking the K/V tiles of the forward's loop bounds through a two-stage
// ring
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S,
                int causal, int window, float scale) {
  using namespace hopper;
  using G = Geo<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + G::kTileBytes;
  unsigned char* ring = dos + G::kTileBytes;       // (k, v) x two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 4 * G::kTileBytes);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int qz = b * H + h, kz = b * Hkv + h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (S + kRows - 1) / kRows;
  const int stop = causal ? min((q0 + 2 * kRows - 1) / kRows, n_tiles)
                          : n_tiles;
  const int start = window > 0 ? max((q0 - window + 1) / kRows, 0) : 0;
  const CUtensorMap *km = &k_map, *vm = &v_map;
  auto issue = [&](int kt, int st) {
    load_pair<DH>(ring + st * 2 * G::kTileBytes, km, vm, &bar[1 + st],
                  kt * kRows, kz);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<DH>(qs, &q_map, &do_map, &bar[0], q0, qz);
    for (int st = 0; st < 2 && start + st < stop; ++st) issue(start + st, st);
  }

  // rows row0 and row0 + 8; columns (keys) 8j + cq + {0, 1} of the tile
  const int row0 = q0 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < S;
    lr[r] = ok ? lse[(int64_t)qz * S + row0 + 8 * r] : 0.f;
    dr[r] = ok ? delta[(int64_t)qz * S + row0 + 8 * r] : 0.f;
  }
  float dqa[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int kt = start, i = 0; kt < stop; ++kt, ++i) {
    const int st = i & 1, k0 = kt * kRows;
    mbar_wait(&bar[1 + st], (i >> 1) & 1);
    const unsigned char* kt_s = ring + st * 2 * G::kTileBytes;
    const unsigned char* vt_s = kt_s + G::kTileBytes;
    float s[32], dp[32];
    scores<DH>(s, dp, qs, kt_s, dos, vt_s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * r + c;
          const int row = row0 + 8 * r, col = k0 + 8 * j + cq + c;
          const bool keep = row < S && col < S && (!causal || col <= row) &&
                            (window <= 0 || row - col < window);
          const float p = keep ? expf(s[idx] * scale - lr[r]) : 0.f;
          dp[idx] = p * (dp[idx] - dr[r]);
        }
    // dQ += dS k, dS as hi + lo bf16 A fragments, k MN-major
    uint32_t sh[4][4], sl[4][4];
    split_frags(dp, sh, sl);
    fence_regs(dqa);
    wgmma_fence();
    acc_split<DH>(dqa, sh, sl, kt_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(sh);
    fence_regs(sl);
    if (kt + 2 < stop) {                 // refill the stage just consumed
      __syncthreads();
      if (tid == 0) issue(kt + 2, st);
    }
  }
  store_rows<DH>(dq, qz, S, row0, dqa, scale);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int causal, int window, float scale,
                   const long long* q_geometry, const long long* kv_geometry,
                   cudaStream_t stream) {
  static bool configured = false;        // one attribute set per head dim
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_wg<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Geo<DH>::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_wg<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Geo<DH>::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!hopper::encode_map(&q_map, q, q_geometry) ||
      !hopper::encode_map(&k_map, k, kv_geometry) ||
      !hopper::encode_map(&v_map, v, kv_geometry) ||
      !hopper::encode_map(&do_map, dout, q_geometry))
    return cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * H * S;
  const int warps = simt::kThreads / 32;
  flash_bwd_delta<__nv_bfloat16><<<(unsigned)((rows + warps - 1) / warps),
                                   simt::kThreads, 0, stream>>>(
      (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, delta, rows,
      DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((unsigned)((S + kRows - 1) / kRows), (unsigned)Hkv,
                     (unsigned)B);
  flash_bwd_dkdv_wg<DH><<<kv_grid, kThreads, Geo<DH>::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, H, Hkv, S, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 q_grid((unsigned)((S + kRows - 1) / kRows), (unsigned)H,
                    (unsigned)B);
  flash_bwd_dq_wg<DH><<<q_grid, kThreads, Geo<DH>::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, (__nv_bfloat16*)dq, H, Hkv,
      S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = simt (bfloat16), 2 = wgmma (bfloat16,
// dh 16, 32, 64 or 128).  q, out, dout and dq are (B, H, S, dh), k, v, dk
// and dv (B, Hkv, S, dh), lse and delta (B, H, S) float32, all contiguous;
// delta is scratch for D.  H % Hkv == 0, 1 <= dh <= 128, S >= 1, B and H
// <= 65535 (checked by the Python wrapper).  For wgmma, q_map (also
// dout's) and kv_map are the tensor maps' geometry (hopper.cuh
// ``encode_map``), computed by kernel.py, as for the forward.  Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int dh, int causal, int window,
    float scale, int variant, const long long* q_map,
    const long long* kv_map, void* stream) {
  if (dh < 1 || dh > kMaxD || Hkv < 1 || H % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)delta;
  if (variant == 0)
    return (int)launch<float>(q, k, v, out, dout, l, d, dq, dk, dv, B, H,
                              Hkv, S, dh, causal, window, scale, s);
  if (variant == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, dout, l, d, dq, dk, dv,
                                      B, H, Hkv, S, dh, causal, window,
                                      scale, s);
  if (variant == 2 && q_map != nullptr && kv_map != nullptr) {
    switch (dh) {
      case 16: return (int)wg::launch<16>(q, k, v, out, dout, l, d, dq, dk,
                                          dv, B, H, Hkv, S, causal, window,
                                          scale, q_map, kv_map, s);
      case 32: return (int)wg::launch<32>(q, k, v, out, dout, l, d, dq, dk,
                                          dv, B, H, Hkv, S, causal, window,
                                          scale, q_map, kv_map, s);
      case 64: return (int)wg::launch<64>(q, k, v, out, dout, l, d, dq, dk,
                                          dv, B, H, Hkv, S, causal, window,
                                          scale, q_map, kv_map, s);
      case 128: return (int)wg::launch<128>(q, k, v, out, dout, l, d, dq,
                                            dk, dv, B, H, Hkv, S, causal,
                                            window, scale, q_map, kv_map, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
