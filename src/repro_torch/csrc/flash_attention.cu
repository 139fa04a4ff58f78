// Blockwise flash attention with an online softmax, for Hopper (sm_90a).
//
//   out[b, h, i] = Σ_j softmax_j(scale · q[b, h, i] · k[b, h / G, j]) v[b, h / G, j]
//
// over the columns j that the mask keeps: j < S; j <= i when causal;
// i - j < window when window > 0, whether or not causal (the JAX kernel's
// and its plain version's semantics).  G = H / Hkv: query head h reads
// key/value head h / G by index arithmetic, with no repeated K/V in memory.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
// There a grid step owned one query tile and mapped the whole K/V of its
// head into VMEM; here one block owns one (query tile, head, batch) and
// walks K/V in 64-row tiles through shared memory, carrying the running
// max m, sum l and accumulator acc of the online softmax in float32
// registers.  The tile range skips tiles that the causal and window masks
// empty entirely, as the TPU kernel's loop bounds did.  The 1/sqrt(dh)
// scale is applied to q before the product; masked logits are -1e30 (not
// -inf) so a tile that is masked whole gives no NaN; the output is
// acc / max(l, 1e-30).  Math is float32 whatever the storage type.
//
// Threads: 256 per block, four per query row.  A row's four threads each
// score 16 of the tile's 64 columns, meet in two warp shuffles for the
// row max and sum, and then each accumulate a quarter of the head dim
// (dh <= 128: 32 float32 registers).  Shared rows are padded to an odd
// float stride so the threads of a warp hit distinct banks.  No atomics
// and no split across blocks: a row's output depends only on its own
// (b, h) slice, the same bits at any batch size.
//
// Bound on this card: at the DiT's shape (B 4, H 32, S 64, dh 64, bf16)
// the function moves 4 MB (q, k, v read once, out written once), 1.3 us
// at 3.35 TB/s, against 134 MFLOP, 0.14 us at the bf16 tensor rate:
// bytes bind.  This first design does its products on the CUDA cores
// from shared memory and is compute-bound well above that; wgmma on
// bf16 tiles with TMA loads is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per tile
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kBQ;   // threads per query row (4)
constexpr int kCols = kBK / kLanes;      // tile columns per thread (16)
constexpr int kMaxD = 128;
constexpr int kAcc = kMaxD / kLanes;     // accumulator registers (32)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr size_t smem_floats(int dh) {
  return (size_t)(kBQ + 2 * kBK) * (dh + 1) + (size_t)kBQ * (kBK + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int S, int dh, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;                 // odd stride: distinct banks
  const int pld = kBK + 1;
  float* qs = smem;                      // kBQ x ld, scaled q
  float* ks = qs + kBQ * ld;             // kBK x ld
  float* vs = ks + kBK * ld;             // kBK x ld
  float* ps = vs + kBK * ld;             // kBQ x pld, probabilities

  const int h = blockIdx.y, b = blockIdx.z;
  const int q_start = blockIdx.x * kBQ;
  const int hk = h / (H / Hkv);
  const T* qb = q + (int64_t)(b * H + h) * S * dh;
  const T* kb = k + (int64_t)(b * Hkv + hk) * S * dh;
  const T* vb = v + (int64_t)(b * Hkv + hk) * S * dh;
  T* ob = out + (int64_t)(b * H + h) * S * dh;

  const int tid = threadIdx.x;
  const int r = tid / kLanes;            // the thread's row in the tile
  const int lane = tid % kLanes;
  const int row = q_start + r;           // its query position

  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int rr = i / dh, d = i % dh;
    const int gr = q_start + rr;
    qs[rr * ld + d] = gr < S ? to_f32(qb[(int64_t)gr * dh + d]) * scale : 0.f;
  }

  const int n_tiles = (S + kBK - 1) / kBK;
  const int stop = causal ? min((q_start + kBQ + kBK - 1) / kBK, n_tiles)
                          : n_tiles;
  const int start = window > 0 ? max((q_start - window + 1) / kBK, 0) : 0;

  float m = kNegInf, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int kt = start; kt < stop; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();                     // q written / last tile consumed
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int rr = i / dh, d = i % dh;
      const int gc = k_start + rr;
      const bool ok = gc < S;
      ks[rr * ld + d] = ok ? to_f32(kb[(int64_t)gc * dh + d]) : 0.f;
      vs[rr * ld + d] = ok ? to_f32(vb[(int64_t)gc * dh + d]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + kLanes * j;
      const int col = k_start + c;
      const float* qr = qs + r * ld;
      const float* kr = ks + c * ld;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qr[d] * kr[d];
      bool keep = col < S;
      if (causal) keep = keep && col <= row;
      if (window > 0) keep = keep && (row - col) < window;
      s[j] = keep ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // the row's four threads are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r * pld + lane + kLanes * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                        // the row's p, written by its warp

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r * pld + c];
      const float* vr = vs + c * ld;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int d = lane + kLanes * i;
        if (d < dh) acc[i] += p * vr[d];
      }
    }
  }

  if (row < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int d = lane + kLanes * i;
      if (d < dh) ob[(int64_t)row * dh + d] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int S, int dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  static bool configured = false;        // one attribute set per type
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(kMaxD) * sizeof(float)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T><<<grid, kThreads, smem_floats(dh) * sizeof(float),
                              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, S, dh, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16.  q is (B, H, S, dh), k and v are
// (B, Hkv, S, dh), all contiguous; H % Hkv == 0, 1 <= dh <= 128, B and H
// <= 65535 (checked by the Python wrapper).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int S, int dh, int causal,
                                      int window, float scale, int dtype_code,
                                      void* stream) {
  if (dh < 1 || dh > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0)
    return (int)launch<float>(q, k, v, out, B, H, Hkv, S, dh, causal, window,
                              scale, s);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, dh, causal,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}
