// Fused DDPM reverse step (paper eq. 2) for Hopper (sm_90a).
//
//   out[i] = (x[i] - coef * eps[i]) * inv_sqrt_alpha + sigma * noise[i]
//
// Replaces the two Pallas TPU entry points of the JAX package,
// src/repro/kernels/ddpm_step/kernel.py:43 (ddpm_step_pallas, one scalar
// coefficient triple) and :85 (ddpm_step_pallas_batched, a (K, 3) table,
// slab k at its own timestep).  The TPU kernel viewed each slab as
// (rows, 128) lanes in 256-row VMEM blocks with the table in SMEM scalar
// prefetch, and took its noise as an input that XLA drew and fused into
// the same compiled loop body.  PyTorch runs the loop eagerly, so here the
// step's surroundings move into the launch.  Three entries:
//
// * given   (ddpm_step_launch): the Pallas kernel's own interface, noise
//   given, a (K, 3) table; one 16-byte vector per thread.  It stays because
//   the engine's oracle (core/sampler.sample_plan_reference) steps through
//   it with torch's threefry draw, so the serve contracts hold the two
//   keyed entries' in-kernel draw against torch's, bitwise.
// * keyed   (ddpm_step_keyed_launch): the per-request samplers' step.  The
//   launch takes the chain key k and writes split(k)[0] to a second key
//   buffer (the sampler ping-pongs two, so no launch reads what it
//   writes); the noise is normal(split(k)[1], x.shape) at each flat index.
// * rowwise (ddpm_step_rowwise_launch): the batched engine's step.  Row b
//   of slab k draws normal(fold_in(fold_in(key_k, d), b), row shape), and
//   the result is active_k ? step : x, the engine's where(active) mask.
//
// The keyed entries read their coefficient triple from a device table
// that the caller computes once per sample or per engine stage, draw with
// Threefry-2x32 in registers (threefry.cuh, bit for bit with
// core/prng.py), and so replace ~415 (keyed) or ~765 (rowwise) eager
// launches and the draw's int64 temporaries with one launch.
//
// Math is fp32 whatever the storage type; the result is rounded once to
// x's type.  Every product and sum uses the _rn intrinsics, so nvcc cannot
// contract them into FMAs: each entry performs exactly the roundings of
// its plain PyTorch version (kernels/ddpm_step/ops.py), in the same order.
//
// Bound.  In bytes: the given entry moves 4 * K * per * itemsize, the
// keyed entries 3 * per * itemsize plus keys, a table row and the mask,
// against 3.35 TB/s (0.044 us at (4, 32, 32, 3) fp32, 0.176 us at K = 4).
// The keyed entries' draw costs 82 integer and ~35 float operations an
// element (one Threefry block of 20 rounds, the counter and mantissa, the
// uniform, erfinvf, the step).  Integer add, xor and funnel shift run
// at 64 an SM a clock on sm_90 (a quarter of the 67 TFLOP/s fp32 rate,
// which counts an FMA as two), so the integer work alone takes 0.060 us
// at (4, 32, 32, 3) and 0.241 us at K = 4: operations, not bytes, bind
// the keyed entries (chip_smoke.keyed_bound); the given entry stays
// bytes-bound.  What binds in practice is latency: the launch (~1.5 us)
// and each thread's dependent chain of two (keyed) or three (rowwise)
// Threefry blocks.  So the keyed entries give each thread one element and
// use 128-thread blocks: at 12,288-49,152 elements that is 96-384 blocks
// over 132 SMs, each thread on the shortest chain, and a key that every
// thread derives itself needs no barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;       // given: one 16-byte vector a thread
constexpr int kKeyedThreads = 128;  // keyed, rowwise: one element a thread

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

// The per-request step: key_in is the chain key k; thread 0 writes
// split(k)[0] to key_out (which must not overlap key_in), every thread
// draws with split(k)[1] at its flat index.  At least one block runs, so
// the key advances even for an empty tensor.
template <typename T>
__global__ void __launch_bounds__(kKeyedThreads)
ddpm_step_keyed(const T* __restrict__ x, const T* __restrict__ e,
                const int64_t* __restrict__ key_in,
                const float* __restrict__ coef,
                int64_t* __restrict__ key_out, T* __restrict__ out,
                int64_t per) {
  const threefry::Key k = threefry::load(key_in);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) threefry::store(key_out, threefry::fold_in(k, 0u));
  if (i >= per) return;
  const float n = threefry::normal(threefry::fold_in(k, 1u), (uint64_t)i);
  out[i] = from_f32<T>(step(to_f32(x[i]), to_f32(e[i]), n, coef[0], coef[1],
                            coef[2]));
}

// The batched engine's step over (K, B, row): block (x, b, k) covers
// kKeyedThreads elements of row b of slab k.  Slab k's coefficients are
// coef[k * coef_stride + 0..2], its mask active[k * active_stride].
template <typename T>
__global__ void __launch_bounds__(kKeyedThreads)
ddpm_step_rowwise(const T* __restrict__ x, const T* __restrict__ e,
                  const int64_t* __restrict__ keys, uint32_t datum,
                  const float* __restrict__ coef, int64_t coef_stride,
                  const float* __restrict__ active, int64_t active_stride,
                  T* __restrict__ out, int64_t row) {
  const int64_t k = blockIdx.z, b = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= row) return;
  const int64_t o = (k * gridDim.y + b) * row + j;
  const T xv = x[o];
  if (!(active[k * active_stride] > 0.0f)) {   // where(active > 0, step, x)
    out[o] = xv;
    return;
  }
  const threefry::Key kb = threefry::fold_in(
      threefry::fold_in(threefry::load(keys + 2 * k), datum), (uint32_t)b);
  const float n = threefry::normal(kb, (uint64_t)j);
  const float* c = coef + k * coef_stride;
  out[o] = from_f32<T>(step(to_f32(xv), to_f32(e[o]), n, c[0], c[1], c[2]));
}

template <typename T>
cudaError_t launch_keyed(const void* x, const void* e, const void* key_in,
                         const void* coef, void* key_out, void* out,
                         int64_t per, cudaStream_t stream) {
  const int64_t blocks = per > 0 ? (per + kKeyedThreads - 1) / kKeyedThreads
                                 : 1;
  ddpm_step_keyed<T><<<(unsigned)blocks, kKeyedThreads, 0, stream>>>(
      (const T*)x, (const T*)e, (const int64_t*)key_in, (const float*)coef,
      (int64_t*)key_out, (T*)out, per);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowwise(const void* x, const void* e, const void* keys,
                           uint32_t datum, const void* coef,
                           int64_t coef_stride, const void* active,
                           int64_t active_stride, void* out, int64_t K,
                           int64_t B, int64_t row, cudaStream_t stream) {
  dim3 grid((unsigned)((row + kKeyedThreads - 1) / kKeyedThreads),
            (unsigned)B, (unsigned)K);
  ddpm_step_rowwise<T><<<grid, kKeyedThreads, 0, stream>>>(
      (const T*)x, (const T*)e, (const int64_t*)keys, datum,
      (const float*)coef, coef_stride, (const float*)active, active_stride,
      (T*)out, row);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16.  Each entry returns the
// cudaError_t of its launch (0 on success).

// given: K slabs of per elements, a (K, 3) float32 table; K must fit
// grid.y (<= 65535), per must be > 0.
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

// keyed: per elements, the chain key (2 int64 words) in key_in, split(k)[0]
// to key_out, a (3,) float32 coefficient row.
extern "C" int ddpm_step_keyed_launch(const void* x, const void* e,
                                      const void* key_in, const void* coef,
                                      void* key_out, void* out, int64_t per,
                                      int64_t dtype_code, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0)
    return (int)launch_keyed<float>(x, e, key_in, coef, key_out, out, per, s);
  if (dtype_code == 1)
    return (int)launch_keyed<__nv_bfloat16>(x, e, key_in, coef, key_out, out,
                                            per, s);
  return (int)cudaErrorInvalidValue;
}

// rowwise: (K, B, row) elements, (K, 2) slab keys, the fold-in datum, slab
// k's coefficients at coef + k * coef_stride and its mask at
// active + k * active_stride (float32); K and B must fit grid.z and grid.y
// (<= 65535), row must be > 0.
extern "C" int ddpm_step_rowwise_launch(const void* x, const void* e,
                                        const void* keys, int64_t datum,
                                        const void* coef, int64_t coef_stride,
                                        const void* active,
                                        int64_t active_stride, void* out,
                                        int64_t K, int64_t B, int64_t row,
                                        int64_t dtype_code, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t d = (uint32_t)datum;
  if (dtype_code == 0)
    return (int)launch_rowwise<float>(x, e, keys, d, coef, coef_stride,
                                      active, active_stride, out, K, B, row,
                                      s);
  if (dtype_code == 1)
    return (int)launch_rowwise<__nv_bfloat16>(x, e, keys, d, coef,
                                              coef_stride, active,
                                              active_stride, out, K, B, row,
                                              s);
  return (int)cudaErrorInvalidValue;
}
