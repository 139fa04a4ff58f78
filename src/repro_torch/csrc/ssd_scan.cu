// Mamba2 SSD chunked scan from a zero state, for Hopper (sm_90a).
//
// Per (batch b, head h), over chunks of q steps, with L the running sum of
// dt·A inside the chunk (float32, L_t - L_s <= 0 for s <= t):
//
//   y_t    = Σ_{s<=t} (C_t·B_s) e^{L_t - L_s} dt_s x_s     (intra-chunk)
//          + (C_t e^{L_t}) · state                           (inter-chunk)
//   state <- e^{L_q} state + Σ_s (dt_s x_s) ⊗ (B_s e^{L_q - L_s})
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas.  The TPU grid
// walked the chunks of one (b, h) as its innermost, sequential axis and
// carried the (p, n) state in VMEM scratch; blocks of a GPU run in no
// order, so here one block owns one (b, h) and a loop inside it walks the
// chunks in order, with the float32 state in shared memory (16 KB at
// p = n = 64, 32 KB at Mamba2-2.7B's n = 128).  A chunk longer than 64
// steps is walked as 64-step tiles joined by the same state recurrence
// that joins chunks, an exact identity of the SSD form, so only rounding
// differs; this keeps the q x q score tile at 16 KB (at q = 256 it would
// be 256 KB, over the 227 KB a block can hold).  The tail is padded with
// dt = 0 and zero x, B and C, as both JAX functions pad it.  e^{L_t - L_s}
// is evaluated only where s <= t: above the diagonal it overflows, and
// inf·0 is NaN.  Math is float32 whatever the storage type; y is written
// in x's type, the final state in float32.  No atomics and no split across
// blocks: a (b, h) slice's outputs depend on that slice alone.
//
// Bound on this card: at the DiT's shape (b 4, s 64, h 64, p 64, n 64,
// bf16 x, B, C) the function moves 8.2 MB (x, dt, B, C read once, y and
// the float32 final state written once), 2.5 us at 3.35 TB/s, against
// 537 MFLOP of products (CB, (CB ⊙ decay) dtx, C state, dtxᵀB per head
// and chunk), 0.54 us at the bf16 tensor rate: bytes bind.  This first
// design does the products on the CUDA cores in float32 from shared
// memory, where the same products take 8 us at the 67 TFLOP/s float32
// rate; tensor-core tiles (wgmma) and a parallel chunk prefix are the
// later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;             // steps per tile (<= kThreads)
constexpr size_t kMaxSmem = 232448;      // a block's shared memory (227 KB)

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

// shared floats: dt, L, e^L, e^{L_q - L} (4 tq), dt·x (tq x p+1), B and C
// (tq x n+1 each), the score tile (tq x tq+1), the state (p x n+1)
__host__ __device__ constexpr size_t smem_floats(int tq, int p, int n) {
  return (size_t)4 * tq + (size_t)tq * (p + 1) + (size_t)2 * tq * (n + 1) +
         (size_t)tq * (tq + 1) + (size_t)p * (n + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ fs, int S, int H, int P, int N, int tq) {
  extern __shared__ float smem[];
  const int xld = P + 1, bld = N + 1, gld = tq + 1;
  float* dts = smem;                     // tq
  float* Ls = dts + tq;                  // tq
  float* eL = Ls + tq;                   // tq: e^{L_t}
  float* dte = eL + tq;                  // tq: e^{L_last - L_t}
  float* xs = dte + tq;                  // tq x xld: dt·x
  float* bs = xs + tq * xld;             // tq x bld
  float* cs = bs + tq * bld;             // tq x bld
  float* gs = cs + tq * bld;             // tq x gld: (C·B) ⊙ decay
  float* st = gs + tq * gld;             // P x bld: the state

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];

  for (int i = tid; i < P * N; i += kThreads) st[(i / N) * bld + i % N] = 0.f;

  for (int t0 = 0; t0 < S; t0 += tq) {
    __syncthreads();                     // the last tile is consumed
    if (tid < tq) {
      const int t = t0 + tid;
      dts[tid] = t < S ? dt[((int64_t)b * S + t) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                      // L = cumsum(dt·A), in step order
      float run = 0.f;
      for (int t = 0; t < tq; ++t) {
        run += dts[t] * a;
        Ls[t] = run;
      }
    }
    for (int i = tid; i < tq * P; i += kThreads) {
      const int t = i / P, j = i % P;
      const int gt = t0 + t;
      xs[t * xld + j] =
          gt < S ? to_f32(x[(((int64_t)b * S + gt) * H + h) * P + j]) * dts[t]
                 : 0.f;
    }
    for (int i = tid; i < tq * N; i += kThreads) {
      const int t = i / N, j = i % N;
      const int gt = t0 + t;
      const bool ok = gt < S;
      const int64_t off = ((int64_t)b * S + gt) * N + j;
      bs[t * bld + j] = ok ? to_f32(Bm[off]) : 0.f;
      cs[t * bld + j] = ok ? to_f32(Cm[off]) : 0.f;
    }
    __syncthreads();
    const float l_last = Ls[tq - 1];
    if (tid < tq) {
      eL[tid] = expf(Ls[tid]);
      dte[tid] = expf(l_last - Ls[tid]);
    }
    // score tile: (C_t · B_s) e^{L_t - L_s} on and below the diagonal only
    for (int i = tid; i < tq * tq; i += kThreads) {
      const int t = i / tq, s = i % tq;
      float g = 0.f;
      if (s <= t) {
        float cb = 0.f;
        for (int j = 0; j < N; ++j) cb += cs[t * bld + j] * bs[s * bld + j];
        g = cb * expf(Ls[t] - Ls[s]);
      }
      gs[t * gld + s] = g;
    }
    __syncthreads();
    // y = scores @ dt·x + (C ⊙ e^L) @ stateᵀ
    for (int i = tid; i < tq * P; i += kThreads) {
      const int t = i / P, j = i % P;
      const int gt = t0 + t;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra += gs[t * gld + s] * xs[s * xld + j];
      float inter = 0.f;
      const float e = eL[t];
      for (int k = 0; k < N; ++k)
        inter += (cs[t * bld + k] * e) * st[j * bld + k];
      if (gt < S)
        y[(((int64_t)b * S + gt) * H + h) * P + j] = from_f32<T>(intra + inter);
    }
    __syncthreads();
    // state <- e^{L_last} state + (dt·x)ᵀ (B ⊙ e^{L_last - L})
    const float e_last = expf(l_last);
    for (int i = tid; i < P * N; i += kThreads) {
      const int j = i / N, k = i % N;
      float sc = 0.f;
      for (int s = 0; s < tq; ++s)
        sc += xs[s * xld + j] * (bs[s * bld + k] * dte[s]);
      st[j * bld + k] = e_last * st[j * bld + k] + sc;
    }
  }
  __syncthreads();
  float* fb = fs + ((int64_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    fb[i] = st[(i / N) * bld + i % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* fs, int batch,
                   int S, int H, int P, int N, int tq, cudaStream_t stream) {
  const size_t bytes = smem_floats(tq, P, N) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static bool configured = false;        // one attribute set per type
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((unsigned)H, (unsigned)batch);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)fs, S, H, P, N, tq);
  return cudaGetLastError();
}

}  // namespace

// dtype code (of x, B, C and y): 0 = float32, 1 = bfloat16.  x and y are
// (batch, S, H, P), dt (batch, S, H) float32, A (H,) float32, B and C
// (batch, S, N), fs (batch, H, P, N) float32, all contiguous; tq is the
// tile length, 1 <= tq <= 64.  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue when the tiles do not fit shared memory.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* fs, int batch, int S, int H, int P,
                               int N, int tq, int dtype_code, void* stream) {
  if (tq < 1 || tq > kMaxTile || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, fs, batch, S, H, P, N, tq,
                              s);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fs, batch, S, H, P,
                                      N, tq, s);
  return (int)cudaErrorInvalidValue;
}
