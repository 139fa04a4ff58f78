// Fused DDPM reverse step (paper eq. 2) for Hopper (sm_90a).
//
//   out[k, i] = (x[k, i] - coef_k * eps[k, i]) * inv_sqrt_alpha_k
//               + sigma_k * noise[k, i]
//
// Replaces the two Pallas TPU entry points of the JAX package,
// src/repro/kernels/ddpm_step/kernel.py::ddpm_step_pallas (one scalar
// coefficient triple, here K = 1) and ::ddpm_step_pallas_batched (a (K, 3)
// coefficient table, slab k at its own timestep).  The TPU kernel viewed
// each slab as (rows, 128) lanes in 256-row VMEM blocks with the table in
// SMEM scalar prefetch; here block row k (blockIdx.y) reads its own three
// fp32 coefficients from a (K, 3) device table, and each thread moves one
// 16-byte vector (4 fp32 or 8 bf16) per operand.  No lane padding: a slab
// whose length or base is not 16-byte aligned takes the scalar path.
//
// Math is fp32 whatever the storage type; the result is rounded once to
// x's type.  Every product and sum uses the _rn intrinsics, so nvcc cannot
// contract them into FMAs: the kernel performs exactly the roundings of
// the plain PyTorch version (kernels/ddpm_step/ref.py), in the same order.
//
// Bound: device-memory bytes, 4 * K * per * itemsize per launch (three
// reads, one write) against 3.35 TB/s; 5 flops per element is far below
// the compute roof.  At the serve path's sizes (K <= 8 slabs of
// B * 32 * 32 * 3 elements, under 2 MB moved) launch latency dominates the
// ~0.2-0.6 us of bytes; fusing the engine's where(active) mask and the
// noise draw, or capturing the step loop in a CUDA graph, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float step(float x, float e, float n, float a,
                                      float c, float s) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, __fmul_rn(c, e)), a),
                   __fmul_rn(s, n));
}

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

// One thread per element; any alignment, any length.
template <typename T>
__global__ void ddpm_step_scalar(const T* __restrict__ x,
                                 const T* __restrict__ e,
                                 const T* __restrict__ n,
                                 const float* __restrict__ coef,
                                 T* __restrict__ out, int64_t per) {
  const int64_t k = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per) return;
  const float a = coef[3 * k], c = coef[3 * k + 1], s = coef[3 * k + 2];
  const int64_t j = k * per + i;
  out[j] = from_f32<T>(step(to_f32(x[j]), to_f32(e[j]), to_f32(n[j]), a, c, s));
}

// One 16-byte vector per thread: needs per % VEC == 0 and 16-byte aligned
// bases (checked by the launcher), so every slab starts aligned.
template <typename T>
__global__ void ddpm_step_vec(const T* __restrict__ x,
                              const T* __restrict__ e,
                              const T* __restrict__ n,
                              const float* __restrict__ coef,
                              T* __restrict__ out, int64_t per) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t k = blockIdx.y;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v * VEC >= per) return;
  const float a = coef[3 * k], c = coef[3 * k + 1], s = coef[3 * k + 2];
  const int64_t j = (k * per) / VEC + v;
  uint4 xv = reinterpret_cast<const uint4*>(x)[j];
  uint4 ev = reinterpret_cast<const uint4*>(e)[j];
  uint4 nv = reinterpret_cast<const uint4*>(n)[j];
  uint4 ov;
  const T* xs = reinterpret_cast<const T*>(&xv);
  const T* es = reinterpret_cast<const T*>(&ev);
  const T* ns = reinterpret_cast<const T*>(&nv);
  T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
  for (int q = 0; q < VEC; ++q)
    os[q] = from_f32<T>(step(to_f32(xs[q]), to_f32(es[q]), to_f32(ns[q]), a, c, s));
  reinterpret_cast<uint4*>(out)[j] = ov;
}

template <typename T>
cudaError_t launch(const void* x, const void* e, const void* n,
                   const void* coef, void* out, int64_t K, int64_t per,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)e | (uintptr_t)n |
                          (uintptr_t)out;
  const bool vec = (per % VEC == 0) && (bases % 16 == 0);
  const int64_t items = vec ? per / VEC : per;
  dim3 grid((unsigned)((items + kThreads - 1) / kThreads), (unsigned)K);
  if (vec)
    ddpm_step_vec<T><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)e, (const T*)n, (const float*)coef, (T*)out,
        per);
  else
    ddpm_step_scalar<T><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)e, (const T*)n, (const float*)coef, (T*)out,
        per);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success); K must fit grid.y (<= 65535), per must be > 0.
extern "C" int ddpm_step_launch(const void* x, const void* e, const void* n,
                                const void* coef, void* out, int64_t K,
                                int64_t per, int64_t dtype_code,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0) return (int)launch<float>(x, e, n, coef, out, K, per, s);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(x, e, n, coef, out, K, per, s);
  return (int)cudaErrorInvalidValue;
}
