// Float32 tile products in shared memory on the CUDA cores, for the SIMT
// backward kernels (flash_attention_bwd.cu, ssd_scan_bwd.cu).
//
// A block of 256 threads computes C = alpha * A B (+ C) for tiles of at
// most a few hundred rows held in shared memory with padded row strides
// (an odd stride puts the rows of a column in distinct banks).  Each
// thread owns a 4 x 4 micro-tile of every 64 x 64 block of C (rows
// ty + 16u, columns tx + 16v), so a step over the depth reads 8 values
// and does 16 fused multiply-adds; the sum over the depth runs in order,
// so the result's bits depend on the operands alone (no atomics, no
// split of the depth across threads).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace simt {

constexpr int kThreads = 256;            // the block size of every user

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

// C[i, j] = (acc ? C[i, j] : 0) + alpha * sum_k A[i, k] B[k, j] for i < M,
// j < N, k < K, with A[i, k] at A[i * a_rs + k * a_cs], B[k, j] at
// B[k * b_rs + j * b_cs] and C[i, j] at C[i * ldc + j].  Strides make a
// transposed operand free.  C must not alias A or B; a thread reads and
// writes only its own elements of C.  The caller synchronises before
// (operands written) and after (C read by other threads).
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A,
                                     int a_rs, int a_cs, const float* B,
                                     int b_rs, int b_cs, int M, int N, int K,
                                     float alpha, bool acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i0 = 0; i0 < M; i0 += 64)
    for (int j0 = 0; j0 < N; j0 += 64) {
      int ia[4], jb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ia[u] = min(i0 + ty + 16 * u, M - 1) * a_rs;   // clamped: the
        jb[u] = min(j0 + tx + 16 * u, N - 1) * b_cs;   // write masks it
      }
      float r[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[u][v] = 0.f;
      for (int k = 0; k < K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = A[ia[u] + k * a_cs];
          b[u] = B[k * b_rs + jb[u]];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) r[u][v] = fmaf(a[u], b[v], r[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
          if (i < M && j < N) {
            float* c = C + i * ldc + j;
            *c = acc ? *c + alpha * r[u][v] : alpha * r[u][v];
          }
        }
    }
}

// rows [0, rows) of a tile in shared memory (stride ld) from global memory
// (row stride src_rs, cols contiguous values), as float32; row r is
// zero unless r < valid
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t src_rs, int rows,
                                          int valid, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] = r < valid ? to_f32(src[r * src_rs + c]) : 0.f;
  }
}

// the sum of v over the `width` adjacent lanes of a group (a power of two
// up to 32), in a fixed order; every lane of the group gets it
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = 1; o < width; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace simt
