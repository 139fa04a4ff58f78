// Grouped (per-expert) matrix product for the MoE FFN, for Hopper (sm_90a).
//
//   out[e, c, f] = sum_d tokens[e, c, d] * weights[e, d, f]
//
// tokens (E, C, D) with any expert and row strides (an expert stride of 0
// is the MoE's broadcast of one token set to every expert) and a unit
// inner stride; weights (E, D, F) and out (E, C, F) contiguous.  The sum
// is taken in float32 and rounded once to the tokens' type.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/grouped_matmul/kernel.py::grouped_matmul_pallas.
// There the grid (E, C/bc, F/bf, D/bd) ran in order on one core and the
// last axis carried an fp32 VMEM accumulator from one step to the next;
// the operands were padded with jnp.pad to whole blocks.  Here one block
// owns one (C-tile, F-tile, expert) and a loop inside it walks D, so the
// accumulator lives in registers; tiles of tokens and weights are staged
// through shared memory, and the ragged C, D and F edges are zero-filled
// while staging and masked when storing, with no padded copies.
//
// bfloat16: 128 x 128 output tiles, 8 warps of 64 x 32, on the tensor
// cores through nvcuda::wmma 16x16x16 bf16 fragments with float32
// accumulators; K-tiles of 32 move through a 3-stage cp.async ring (16-byte
// copies, zero-fill past an edge) when D, F and the token strides are
// multiples of 8 and the pointers 16-byte aligned, else through plain
// masked loads.  float32: 64 x 64 output tiles on the CUDA cores, 4 x 4
// outputs a thread, one fmaf per product in the order of d (no TF32).
//
// Every output row's sum runs over d in one fixed order, in one block,
// with no split of D across blocks and no atomics, so a row's bits depend
// only on that row and the weights, whatever C is and whichever tile the
// row falls in.  The grid puts the C-tiles fastest: the blocks that share
// one weight tile run together, so each weight byte streams from device
// memory about once and the second read hits L2.
//
// Bound on this card: at the MoE path's shape (E 16, C 256, D 6144,
// F 10752, bf16, tokens broadcast) a launch moves 2.21 GB (the weights
// 2.11 GB, the shared tokens 3 MB, the output 88 MB): 0.66 ms at
// 3.35 TB/s, against 541 GFLOP, 0.55 ms at the bf16 tensor rate: bytes
// bind.  mma.sync-class fragments from shared memory reach a fraction of
// the tensor rate, so this first design is compute-bound above the byte
// bound; wgmma with TMA loads, warp specialisation and a persistent grid
// are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---- bfloat16: tensor cores ------------------------------------------------
constexpr int kBM = 128;                 // token rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 32;                  // depth per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;
constexpr int kLdA = kBK + 8;            // padded rows: conflict-free ldmatrix
constexpr int kLdB = kBN + 8;
constexpr int kStageA = kBM * kLdA;      // bf16 elements per stage
constexpr int kStageB = kBK * kLdB;
constexpr size_t kSmemBytes =
    (size_t)kStages * (kStageA + kStageB) * sizeof(__nv_bfloat16);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = pred ? 16 : 0;       // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the K-tile starting at depth k0: tokens rows [c0, c0 + kBM) x
// [k0, k0 + kBK) and weight rows [k0, k0 + kBK) x [f0, f0 + kBN).
template <bool kVec>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* tb,
    const __nv_bfloat16* wb, int C, int D, int F, int64_t sc, int c0, int f0,
    int k0, int tid) {
  if (kVec) {
    // 16-byte chunks: A has kBM x kBK / 8 = 512, B kBK x kBN / 8 = 512
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 8), ch = idx % (kBK / 8);
      const int c = c0 + r, d = k0 + ch * 8;
      const bool ok = c < C && d < D;
      cp_async16(as + r * kLdA + ch * 8,
                 ok ? (const void*)(tb + (int64_t)c * sc + d) : (const void*)tb,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 8), ch = idx % (kBN / 8);
      const int d = k0 + r, f = f0 + ch * 8;
      const bool ok = d < D && f < F;
      cp_async16(bs + r * kLdB + ch * 8,
                 ok ? (const void*)(wb + (int64_t)d * F + f) : (const void*)wb,
                 ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, k = idx % kBK;
      const int c = c0 + r, d = k0 + k;
      as[r * kLdA + k] = (c < C && d < D) ? tb[(int64_t)c * sc + d] : zero;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, n = idx % kBN;
      const int d = k0 + r, f = f0 + n;
      bs[r * kLdB + n] = (d < D && f < F) ? wb[(int64_t)d * F + f] : zero;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ tokens,
                const __nv_bfloat16* __restrict__ weights,
                __nv_bfloat16* __restrict__ out, int C, int D, int F,
                int64_t se, int64_t sc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* as = smem;                          // kStages x kStageA
  __nv_bfloat16* bs = smem + kStages * kStageA;      // kStages x kStageB

  const int c0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN, e = blockIdx.z;
  const __nv_bfloat16* tb = tokens + (int64_t)e * se;
  const __nv_bfloat16* wb = weights + (int64_t)e * D * F;
  __nv_bfloat16* ob = out + (int64_t)e * C * F;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;   // warp's row offset
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;   // and column offset

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_tile<kVec>(as + s * kStageA, bs + s * kStageB, tb, wb, C, D, F, sc,
                      c0, f0, s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();        // tile kt has landed
    __syncthreads();                     // ... and tile kt - 1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_tile<kVec>(as + (nxt % kStages) * kStageA,
                      bs + (nxt % kStages) * kStageB, tb, wb, C, D, F, sc, c0,
                      f0, nxt * kBK, tid);
    cp_async_commit();
    const __nv_bfloat16* a = as + (kt % kStages) * kStageA;
    const __nv_bfloat16* b = bs + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kLdB + wn + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free for the epilogue

  // epilogue: each warp stages one 16 x 16 fragment at a time as float32,
  // rounds it to bf16 and stores the rows and columns inside (C, F)
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, h = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c = c0 + wm + i * 16 + r;
      const int f = f0 + wn + j * 16 + h;
      if (c < C) {
        __nv_bfloat16* dst = ob + (int64_t)c * F + f;
        if (kVec && f + 8 <= F) {         // F % 8 == 0, out 16-byte aligned
          __align__(16) __nv_bfloat16 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16(stage[r * 16 + h + u]);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        } else {
          for (int u = 0; u < 8 && f + u < F; ++u)
            dst[u] = __float2bfloat16(stage[r * 16 + h + u]);
        }
      }
      __syncwarp();
    }
}

// ---- float32: CUDA cores ---------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ tokens,
               const float* __restrict__ weights, float* __restrict__ out,
               int C, int D, int F, int64_t se, int64_t sc) {
  __shared__ float as[kFK][kFM + 4];     // transposed: as[k][row]
  __shared__ float bs[kFK][kFN + 4];
  const int c0 = blockIdx.x * kFM, f0 = blockIdx.y * kFN, e = blockIdx.z;
  const float* tb = tokens + (int64_t)e * se;
  const float* wb = weights + (int64_t)e * D * F;
  float* ob = out + (int64_t)e * C * F;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kFK, k = idx % kFK;
      const int c = c0 + m, d = k0 + k;
      as[k][m] = (c < C && d < D) ? tb[(int64_t)c * sc + d] : 0.f;
      const int kb = idx / kFN, n = idx % kFN;
      const int db = k0 + kb, f = f0 + n;
      bs[kb][n] = (db < D && f < F) ? wb[(int64_t)db * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) ob[(int64_t)c * F + f] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kVec>
cudaError_t launch_bf16(const void* t, const void* w, void* o, int E, int C,
                        int D, int F, int64_t se, int64_t sc,
                        cudaStream_t stream) {
  static bool configured = false;        // one attribute set per variant
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_bf16_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((unsigned)((C + kBM - 1) / kBM),
                  (unsigned)((F + kBN - 1) / kBN), (unsigned)E);
  gmm_bf16_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      (const __nv_bfloat16*)t, (const __nv_bfloat16*)w, (__nv_bfloat16*)o, C,
      D, F, se, sc);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16.  tokens (E, C, D) at element
// strides (stride_e, stride_c, 1); weights (E, D, F) and out (E, C, F)
// contiguous; E <= 65535 and the C- and F-tile counts <= 65535 (checked by
// the Python wrapper).  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int grouped_matmul_launch(const void* tokens, const void* weights,
                                     void* out, int E, int C, int D, int F,
                                     long long stride_e, long long stride_c,
                                     int dtype_code, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || stride_e < 0 || stride_c < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0) {
    const dim3 grid((unsigned)((C + kFM - 1) / kFM),
                    (unsigned)((F + kFN - 1) / kFN), (unsigned)E);
    gmm_f32_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)tokens, (const float*)weights, (float*)out, C, D, F,
        stride_e, stride_c);
    return (int)cudaGetLastError();
  }
  if (dtype_code == 1) {
    const bool vec = D % 8 == 0 && F % 8 == 0 && stride_e % 8 == 0 &&
                     stride_c % 8 == 0 && aligned16(tokens) &&
                     aligned16(weights) && aligned16(out);
    return vec ? (int)launch_bf16<true>(tokens, weights, out, E, C, D, F,
                                        stride_e, stride_c, s)
               : (int)launch_bf16<false>(tokens, weights, out, E, C, D, F,
                                         stride_e, stride_c, s);
  }
  return (int)cudaErrorInvalidValue;
}
