// Backward of the grouped (per-expert) matrix product, for Hopper (sm_90a).
//
//   forward:   out[e, c, f]      = sum_d tokens[e, c, d] * weights[e, d, f]
//   dX = dY W^T: dtokens[e, c, d]  = sum_f dout[e, c, f] * weights[e, d, f]
//   dW = X^T dY: dweights[e, d, f] = sum_c tokens[e, c, d] * dout[e, c, f]
//
// tokens (E, C, D) with any expert and row strides (an expert stride of 0
// is the dense MoE's broadcast of one token set to every expert) and a unit
// inner stride; weights (E, D, F), dout (E, C, F), dtokens (E, C, D) and
// dweights (E, D, F) contiguous.  Each sum is taken in float32 and rounded
// once to the inputs' type.  For broadcast tokens dtokens holds one (C, D)
// slab per expert; the sum over the experts is the broadcast's own
// backward (autograd's, outside this file).
//
// Replaces no TPU kernel: the JAX package differentiates the grouped
// matmul's einsum with XLA (src/repro/models/moe.py ``_expert_ffn``), so
// this is the backward of the function that
// src/repro/kernels/grouped_matmul/kernel.py::grouped_matmul_pallas
// computes, written so that the port's MoE trains on the card.  The two
// products run as two kernels on one stream, one output each:
//
// * dX: for each expert the (C, F) @ (F, D) product, M = C, N = D, K = F.
//   A = dout rows as stored; B = W^T, read as W's rows (d) of F
//   contiguous values, i.e. a column-major B.
// * dW: for each expert the (D, C) @ (C, F) product, M = D, N = F, K = C:
//   the sum over the C token rows runs inside one block, in k-tiles in
//   order, so no split-K and no atomics.  A = X^T, read as X's rows (c) of
//   D contiguous values, i.e. a column-major A; B = dout rows as stored.
//
// Every output element is written by one block, every sum runs over its
// depth in one fixed order (k-tiles in order, 16 at a time inside them),
// with no split-K, no stream-K and no atomics, and no tile or instruction
// shape depends on C, so a row of dX depends only on its row of dout and
// the weights, whatever C is; two launches are bitwise equal.
//
// Three variants; kernel.py's ``choose_variant_backward`` picks one from
// dtype, shape, strides and alignment alone:
//
// * wgmma (bf16; D and F multiples of 8 elements, token strides as the
//   forward's wgmma variant takes them, all five pointers 16-byte aligned:
//   every launch of the MoE paths).  Two launches of one kernel template,
//   dX then dW, each a persistent grid of one block per SM walking its
//   256 x 192 output tiles in the order (expert, N-tile, M-tile), M
//   fastest.  Two launches and not one over both tile sets: the two
//   products differ in their operands' major order, so a fused walk would
//   branch per tile on the descriptors and the maps, and each launch
//   alone already fills the card (dX has 512 to 8,192 tiles, dW 21,504).
//   Each block is three warpgroups: one producer thread keeps TMA loads of
//   64-deep k-tiles in flight into a 4-stage ring (a stage: A as four
//   64 x 64 boxes, 32 KB; B as three, 24 KB; all 128-byte swizzled; 225
//   KB in all) completed on ``full`` mbarriers; two consumer warpgroups
//   (setmaxnreg 232, the producer's warpgroup drops to 40) each own 128
//   output rows, issue two wgmma.m64n192k16 per 16 of depth straight from
//   shared memory, keep one wgmma group in flight and hand each stage back
//   on an ``empty`` mbarrier, all but the tile's last stage, which holds
//   the epilogue: each warp rounds its 16 rows of an m64 block to bf16
//   into its warpgroup's A boxes there, 96 columns at a time, and writes
//   them back out as 16-byte stores, 32 of a warp covering whole 192-byte
//   pieces of rows; then the stage goes back, while the producer has
//   already been loading the block's next tile into the other three.
//   (The forward's epilogue, four-byte stores straight from the
//   registers, wrote dW at about 0.95 TB/s on an H100: 2.2 of 3.3 ms at
//   C 80.  A staging tile of its own with TMA stores was tried first: its
//   room cost the ring a stage, and in that build ptxas spilled the
//   accumulators and serialised the wgmma.)
//   - dX: M = C, N = D, K = F.  A = dout rows, K-major (map 3-D over
//     (F, C, E)); B = W's rows d, whose F values are contiguous: K-major
//     too (map 3-D over (F, D, E)), no transpose.  With C fastest the
//     blocks in flight walk one W panel (192 rows d x all of F, 4.1 MB)
//     together, so each panel crosses from device memory about once per
//     group of C-tiles rather than once per tile: W[e] is 132 MB, more
//     than the 50 MB L2.
//   - dW: M = D, N = F, K = C.  A = X^T read as X's rows (MN-major,
//     wgmma's A-transpose flag: map 2-D over (D, C) at the same
//     coordinates for every expert when the expert stride is 0, 3-D over
//     (D, C, E) at the tokens' strides otherwise); B = dout rows, MN-major
//     as the forward's weights.  The sum over C runs inside one block in
//     k-tiles in order.
//   A boxes wholly past M and B boxes wholly past N are not loaded (at
//   C = 80, dX's tile loads 2 of its 4 A boxes); the rows and columns
//   they would feed are computed from stale shared memory and never
//   stored.  Every wgmma is issued whatever M is: one guarded by a
//   branch would be serialised by the compiler.
// * wmma (bf16 otherwise: D or F not a multiple of 8, overlapping token
//   rows, or a misaligned pointer): the first design, kept as it was.
//   128 x 128 output tiles, 8 warps of 64 x 32 on nvcuda::wmma 16x16x16
//   fragments with a float32 accumulator, k-tiles of 32 through a 3-stage
//   cp.async ring (16-byte copies when the strides are multiples of 8
//   elements and the pointers 16-byte aligned, else plain masked loads).
//   wmma fragments take either major order, so W^T and X^T are read in
//   place, with no transposed copy.
// * simt (float32): 64 x 64 output tiles on the CUDA cores, 4 x 4 outputs
//   a thread, one fmaf per product in the order of the depth.  No TF32.
//
// Bound on this card, DBRX-132B's expert shapes (E 16, D 6144, F 10752,
// bf16): both products together read W and dout and the tokens once and
// write dW and dX once, 4·E·C·D·F flops.  What binds the wgmma variant at
// the four C the MoE paths feed it:
// * C 80 (expert-parallel DiT, packed) and C 256 (dense DiT, broadcast):
//   4.3 GB, 1.3 ms at 3.35 TB/s, against 0.34 and 1.08 TFLOP: bytes bind.
//   dX streams W (2.1 GB) through 512 tiles of 168 k-tiles each and is
//   held by that read; dW has only 2 or 4 k-tiles a tile and writes 2.1
//   GB, so its epilogue is as long as its main loop and its write binds:
//   the epilogue's stores are 16-byte and line-filling, and the three
//   stages it leaves free hold the next tile's k-tiles meanwhile, so the
//   loads keep streaming.
// * C 1,280 (expert-parallel LM, packed) and C 4,096 (dense LM,
//   broadcast): 5.4 and 17.3 TFLOP, 5.5 and 17.5 ms at 989 TFLOP/s: the
//   operations bind, and both launches are long k-loops (dX 168 k-tiles,
//   dW 20 and 64) at the forward's tile and ring, so the tensor cores'
//   share of the time is what that design keeps.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ---- bfloat16: tensor cores ------------------------------------------------
constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 32;                  // depth per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;
// shared tiles: a (rows x depth) tile padded to kBK + 8, a (depth x rows)
// tile padded to kBM + 8 (= kBN + 8): 16-byte rows that ldmatrix reads
// without bank conflicts, every fragment pointer 32-byte aligned
constexpr int kLdK = kBK + 8;
constexpr int kLdM = kBM + 8;
constexpr int kTileMK = kBM * kLdK;      // bf16 elements of either layout
constexpr int kTileKM = kBK * kLdM;
// dX: A (rows x depth) and B (columns x depth); dW: both (depth x rows)
constexpr size_t kSmemDx = (size_t)kStages * 2 * kTileMK * sizeof(bf16);
constexpr size_t kSmemDw = (size_t)kStages * 2 * kTileKM * sizeof(bf16);

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

// Stage rows [r0, r0 + R) x columns [c0, c0 + CC) of a row-major matrix
// (nr x nc, row stride ldg elements) into shared memory at row stride lds,
// zero outside the matrix.  kVec: 16-byte copies (nc, ldg multiples of 8,
// the base 16-byte aligned), so a chunk is whole or wholly outside.
template <int R, int CC, bool kVec>
__device__ __forceinline__ void load_rows(bf16* s, int lds, const bf16* g,
                                          int64_t ldg, int r0, int nr, int c0,
                                          int nc, int tid) {
  if (kVec) {
    constexpr int kChunks = R * CC / 8;
#pragma unroll
    for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kChunks) {
        const int r = idx / (CC / 8), ch = idx % (CC / 8);
        const int gr = r0 + r, gc = c0 + ch * 8;
        const bool ok = gr < nr && gc < nc;
        cp_async16(s + r * lds + ch * 8,
                   ok ? (const void*)(g + (int64_t)gr * ldg + gc)
                      : (const void*)g,
                   ok);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < R * CC; idx += kThreads) {
      const int r = idx / CC, c = idx % CC;
      const int gr = r0 + r, gc = c0 + c;
      s[r * lds + c] = (gr < nr && gc < nc) ? g[(int64_t)gr * ldg + gc] : zero;
    }
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Each warp stages one 16 x 16 fragment at a time as float32, rounds it to
// bf16 and stores the rows and columns inside (nr, nc) of the row-major
// output (row stride nc).  The ring must be free (waited and synced).
template <bool kVec>
__device__ __forceinline__ void store_tile(Acc (&acc)[kFragM][kFragN],
                                           unsigned char* smem_raw, bf16* ob,
                                           int nr, int nc, int r0, int c0,
                                           int wm, int wn, int warp,
                                           int lane) {
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, h = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = r0 + wm + i * 16 + r;
      const int col = c0 + wn + j * 16 + h;
      if (row < nr) {
        bf16* dst = ob + (int64_t)row * nc + col;
        if (kVec && col + 8 <= nc) {     // nc % 8 == 0, out 16-byte aligned
          __align__(16) bf16 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = __float2bfloat16(stage[r * 16 + h + u]);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        } else {
          for (int u = 0; u < 8 && col + u < nc; ++u)
            dst[u] = __float2bfloat16(stage[r * 16 + h + u]);
        }
      }
      __syncwarp();
    }
}

// dX[e] = dY[e] (C x F) @ W[e]^T (F x D).  A tile: dY rows c x depth f;
// B tile: W rows d x depth f (column-major B).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_dx_kernel(const bf16* __restrict__ weights,
                  const bf16* __restrict__ dout, bf16* __restrict__ dtok,
                  int C, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = smem;                                   // kStages x kTileMK
  bf16* bs = smem + kStages * kTileMK;               // kStages x kTileMK

  const int c0 = blockIdx.x * kBM, d0 = blockIdx.y * kBN, e = blockIdx.z;
  const bf16* gb = dout + (int64_t)e * C * F;
  const bf16* wb = weights + (int64_t)e * D * F;
  bf16* ob = dtok + (int64_t)e * C * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;

  Acc acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (F + kBK - 1) / kBK;
  auto stage_in = [&](int s, int kt) {
    load_rows<kBM, kBK, kVec>(as + s * kTileMK, kLdK, gb, F, c0, C, kt * kBK,
                              F, tid);
    load_rows<kBN, kBK, kVec>(bs + s * kTileMK, kLdK, wb, F, d0, D, kt * kBK,
                              F, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage_in(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();        // tile kt has landed
    __syncthreads();                     // ... and tile kt - 1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk) stage_in(nxt % kStages, nxt);
    cp_async_commit();
    const bf16* a = as + (kt % kStages) * kTileMK;
    const bf16* b = bs + (kt % kStages) * kTileMK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
          fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + i * 16) * kLdK + kk, kLdK);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn + j * 16) * kLdK + kk, kLdK);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free for the epilogue
  store_tile<kVec>(acc, smem_raw, ob, C, D, c0, d0, wm, wn, warp, lane);
}

// dW[e] = X[e]^T (D x C) @ dY[e] (C x F).  A tile: X rows c (depth) x d;
// B tile: dY rows c (depth) x f.  The depth is the C token rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_dw_kernel(const bf16* __restrict__ tokens,
                  const bf16* __restrict__ dout, bf16* __restrict__ dw,
                  int C, int D, int F, int64_t se, int64_t sc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = smem;                                   // kStages x kTileKM
  bf16* bs = smem + kStages * kTileKM;               // kStages x kTileKM

  const int d0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN, e = blockIdx.z;
  const bf16* tb = tokens + (int64_t)e * se;
  const bf16* gb = dout + (int64_t)e * C * F;
  bf16* ob = dw + (int64_t)e * D * F;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;

  Acc acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (C + kBK - 1) / kBK;
  auto stage_in = [&](int s, int kt) {
    load_rows<kBK, kBM, kVec>(as + s * kTileKM, kLdM, tb, sc, kt * kBK, C, d0,
                              D, tid);
    load_rows<kBK, kBN, kVec>(bs + s * kTileKM, kLdM, gb, F, kt * kBK, C, f0,
                              F, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage_in(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) stage_in(nxt % kStages, nxt);
    cp_async_commit();
    const bf16* a = as + (kt % kStages) * kTileKM;
    const bf16* b = bs + (kt % kStages) * kTileKM;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
          fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(fa[i], a + kk * kLdM + wm + i * 16, kLdM);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kLdM + wn + j * 16, kLdM);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<kVec>(acc, smem_raw, ob, D, F, d0, f0, wm, wn, warp, lane);
}

// ---- float32: CUDA cores ---------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

// dX[e] = dY[e] @ W[e]^T: as[k][m] = dY[c0 + m, k0 + k], bs[k][n] =
// W[d0 + n, k0 + k]; both read along their contiguous depth.
__global__ void __launch_bounds__(kThreads)
gmm_bwd_dx_f32_kernel(const float* __restrict__ weights,
                      const float* __restrict__ dout,
                      float* __restrict__ dtok, int C, int D, int F) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int c0 = blockIdx.x * kFM, d0 = blockIdx.y * kFN, e = blockIdx.z;
  const float* gb = dout + (int64_t)e * C * F;
  const float* wb = weights + (int64_t)e * D * F;
  float* ob = dtok + (int64_t)e * C * D;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kFK, k = idx % kFK, f = k0 + k;
      const int c = c0 + m, d = d0 + m;
      as[k][m] = (c < C && f < F) ? gb[(int64_t)c * F + f] : 0.f;
      bs[k][m] = (d < D && f < F) ? wb[(int64_t)d * F + f] : 0.f;
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
      const int d = d0 + tx * 4 + j;
      if (d < D) ob[(int64_t)c * D + d] = acc[i][j];
    }
  }
}

// dW[e] = X[e]^T @ dY[e]: as[k][m] = X[k0 + k, d0 + m], bs[k][n] =
// dY[k0 + k, f0 + n]; both read along their contiguous rows.
__global__ void __launch_bounds__(kThreads)
gmm_bwd_dw_f32_kernel(const float* __restrict__ tokens,
                      const float* __restrict__ dout, float* __restrict__ dw,
                      int C, int D, int F, int64_t se, int64_t sc) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int d0 = blockIdx.x * kFM, f0 = blockIdx.y * kFN, e = blockIdx.z;
  const float* tb = tokens + (int64_t)e * se;
  const float* gb = dout + (int64_t)e * C * F;
  float* ob = dw + (int64_t)e * D * F;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / kFM, m = idx % kFM, c = k0 + k;
      const int d = d0 + m, f = f0 + m;
      as[k][m] = (c < C && d < D) ? tb[(int64_t)c * sc + d] : 0.f;
      bs[k][m] = (c < C && f < F) ? gb[(int64_t)c * F + f] : 0.f;
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
    const int d = d0 + ty * 4 + i;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) ob[(int64_t)d * F + f] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;         // one attribute set per instance
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <bool kVec>
cudaError_t launch_dx(const void* w, const void* g, void* dx, int E, int C,
                      int D, int F, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(gmm_bwd_dx_kernel<kVec>, kSmemDx, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((C + kBM - 1) / kBM),
                  (unsigned)((D + kBN - 1) / kBN), (unsigned)E);
  gmm_bwd_dx_kernel<kVec><<<grid, kThreads, kSmemDx, stream>>>(
      (const bf16*)w, (const bf16*)g, (bf16*)dx, C, D, F);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_dw(const void* t, const void* g, void* dw, int E, int C,
                      int D, int F, int64_t se, int64_t sc,
                      cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(gmm_bwd_dw_kernel<kVec>, kSmemDw, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((D + kBM - 1) / kBM),
                  (unsigned)((F + kBN - 1) / kBN), (unsigned)E);
  gmm_bwd_dw_kernel<kVec><<<grid, kThreads, kSmemDw, stream>>>(
      (const bf16*)t, (const bf16*)g, (bf16*)dw, C, D, F, se, sc);
  return cudaGetLastError();
}


// ---- bfloat16: wgmma, TMA, warp-specialised, persistent --------------------
namespace wg {

constexpr int kBM = 256;                 // output rows per tile
constexpr int kBN = 192;                 // output columns per tile
constexpr int kBK = 64;                  // depth per stage: one 128-byte row
constexpr int kBox = 64;                 // every map's box: 64 x 64 values
constexpr int kBoxBytes = kBox * 128;    // 8 KB, 128-byte swizzled
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups of 128 output rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABoxes = kBM / kBox, kBBoxes = kBN / kBox;
constexpr int kABytes = kABoxes * kBoxBytes;              // 32 KB a stage
constexpr int kStageBytes = kABytes + kBBoxes * kBoxBytes;  // + 24 KB
constexpr size_t kSmem =
    1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);
static_assert(kSmem <= 232448, "over a block's shared memory");
// the epilogue's staging, per consumer warp: its 16 rows x half of the 192
// columns of an m64 block in bf16, rows padded by 16 bytes (conflict-free
// writes), inside its warpgroup's own two A boxes of the tile's last stage
constexpr int kHalf = kBN / 2;
constexpr int kStageRow = kHalf * 2 + 16;
constexpr int kWarpStage = 16 * kStageRow;
static_assert(4 * kWarpStage <= 2 * kBoxBytes, "staging room");

// kDw = false: dX[e] = dout[e] W[e]^T, M = C, N = D, K = F; A box j of a
// stage holds dout rows m*kBM + 64j.. x 64 of F, B box j W's rows d
// n*kBN + 64j.. x 64 of F: both K-major.  kDw = true: dW[e] = X[e]^T
// dout[e], M = D, N = F, K = C; A box j holds 64 token rows (the depth) x
// 64 values of d, B box j 64 token rows x 64 values of f: both MN-major.
// ``a_rank`` 2: A's map has no expert axis (tokens broadcast to every
// expert).  out: (E, M, N) contiguous.  ``tiles`` counts (expert, N-tile,
// M-tile) with the M-tile fastest; block b takes tiles b, b + gridDim.x,
// ...
template <bool kDw>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     bf16* __restrict__ out, int M, int N, int K,
                     int tiles_m, int tiles_n, int tiles, int a_rank) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], kConsumers * 4);   // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m = t % tiles_m, n = (t / tiles_m) % tiles_n,
                  e = t / (tiles_m * tiles_n);
        // boxes wholly past M or N are not loaded
        const int a_boxes = min(kABoxes, (M - m * kBM + kBox - 1) / kBox);
        const int b_boxes = min(kBBoxes, (N - n * kBN + kBox - 1) / kBox);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * kStageBytes;
          unsigned char* b = a + kABytes;
          mbar_expect_tx(&full[stage], (a_boxes + b_boxes) * kBoxBytes);
          const int k0 = kt * kBK;
          for (int j = 0; j < a_boxes; ++j) {
            const int r = m * kBM + j * kBox;
            if constexpr (!kDw)
              tma_load_3d(a + j * kBoxBytes, &a_map, &full[stage], k0, r, e);
            else if (a_rank == 3)
              tma_load_3d(a + j * kBoxBytes, &a_map, &full[stage], r, k0, e);
            else
              tma_load_2d(a + j * kBoxBytes, &a_map, &full[stage], r, k0);
          }
          for (int j = 0; j < b_boxes; ++j) {
            const int c = n * kBN + j * kBox;
            if constexpr (kDw)
              tma_load_3d(b + j * kBoxBytes, &b_map, &full[stage], c, k0, e);
            else
              tma_load_3d(b + j * kBoxBytes, &b_map, &full[stage], k0, c, e);
          }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 128 output rows each, two m64 blocks ----
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[2][kBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m = t % tiles_m, n = (t / tiles_m) % tiles_n,
                e = t / (tiles_m * tiles_n);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) acc[i][j] = 0.f;
        fence_regs(acc[i]);
      }
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a =
            smem + stage * kStageBytes + wgi * 2 * kBoxBytes;
        const unsigned char* b = smem + stage * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          if constexpr (kDw) {
            // MN-major: 16 rows of depth further down each box, the next
            // 64 columns (B) one box further on
            const uint64_t db =
                make_desc(b + k * 16 * 128, kBoxBytes, 1024, 1);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wgmma_m64n192k16_ss<1, 1>(
                  acc[i],
                  make_desc(a + i * kBoxBytes + k * 16 * 128, kBoxBytes, 1024,
                            1),
                  db);
          } else {
            // K-major: 32 bytes a k16; B's 192 rows are 24 eight-row atoms
            // one after the other across its three boxes
            const uint64_t db = make_desc(b + k * 32, 0, 1024, 1);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wgmma_m64n192k16_ss<0, 0>(
                  acc[i], make_desc(a + i * kBoxBytes + k * 32, 0, 1024, 1),
                  db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();                  // k-tile kt - 1 is consumed
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i) fence_regs(acc[i]);
      // a warp's wait covers its own share of its warpgroup's wgmma: no
      // consumer warp may overwrite the stage before all have finished
      named_barrier(1, kConsumers * 128);

      // epilogue (fp32 -> bf16) in the tile's last stage, which this warp
      // hands back only after it; the producer meanwhile loads the next
      // tile into the other three.  Each warp stages its own 16 rows of an
      // m64 block, 96 columns at a time, in its warpgroup's A boxes, and
      // writes them out as 16-byte stores, a warp's 32 covering whole
      // 192-byte pieces of rows,
      // masked at the M and N edges (N % 8 == 0: a 16-byte chunk is inside
      // or outside).  Rows of an m64 block whose A box was not loaded lie
      // past M.
      bf16* ob = out + (int64_t)e * M * N;
      unsigned char* ws = smem + prev * kStageBytes + wgi * 2 * kBoxBytes +
                          warp * kWarpStage;
      const int q = lane % 4, r = lane / 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row0 = m * kBM + wgi * 128 + i * 64 + warp * 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __syncwarp();                   // the last half's reads are done
#pragma unroll
          for (int j = 0; j < kHalf / 8; ++j) {
            const int jj = h * (kHalf / 8) + j;
            *reinterpret_cast<uint32_t*>(ws + r * kStageRow + 16 * j +
                                         4 * q) =
                pack_bf16(acc[i][4 * jj], acc[i][4 * jj + 1]);
            *reinterpret_cast<uint32_t*>(ws + (r + 8) * kStageRow + 16 * j +
                                         4 * q) =
                pack_bf16(acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < 16 * kHalf / 8 / 32; ++u) {
            const int idx = u * 32 + lane;  // chunk: row idx / 12, column
            const int rr = idx / (kHalf / 8), cc = idx % (kHalf / 8);
            const int row = row0 + rr, col = n * kBN + h * kHalf + 8 * cc;
            const uint4 v = *reinterpret_cast<const uint4*>(
                ws + rr * kStageRow + 16 * cc);
            if (row < M && col < N)
              *reinterpret_cast<uint4*>(ob + (int64_t)row * N + col) = v;
          }
        }
      }
      fence_proxy_async();                // before TMA writes the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
  }
}

template <bool kDw>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
                   void* out, int E, int M, int N, int K, int a_rank,
                   cudaStream_t stream) {
  static bool configured = false;        // one attribute set per product
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_bwd_wgmma_kernel<kDw>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = (long long)E * tiles_m * tiles_n;
  const int sms = hopper::sm_count();
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gmm_bwd_wgmma_kernel<kDw><<<grid, kThreads, kSmem, stream>>>(
      a_map, b_map, (bf16*)out, M, N, K, tiles_m, tiles_n, (int)tiles,
      a_rank);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = wmma (bfloat16), 2 = wgmma
// (bfloat16).  tokens (E, C, D) at element strides (stride_e, stride_c,
// 1); weights (E, D, F), dout (E, C, F), dtokens (E, C, D) and dweights
// (E, D, F) contiguous.  For wgmma, tok_map, w_map and dout_map are the
// tensor maps' geometry (hopper.cuh ``encode_map``), computed by
// kernel.py;
// the other variants ignore it and need E <= 65535 and the D- and F-tile
// counts (64 wide) <= 65535 (checked by the Python wrapper).  Launches dX
// then dW on ``stream`` and returns the cudaError_t of the launches (0 on
// success).
extern "C" int grouped_matmul_bwd_launch(const void* tokens,
                                         const void* weights,
                                         const void* dout, void* dtokens,
                                         void* dweights, int E, int C, int D,
                                         int F, long long stride_e,
                                         long long stride_c, int variant,
                                         const long long* tok_map,
                                         const long long* w_map,
                                         const long long* dout_map,
                                         void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || stride_e < 0 || stride_c < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const dim3 gx((unsigned)((C + kFM - 1) / kFM),
                  (unsigned)((D + kFN - 1) / kFN), (unsigned)E);
    gmm_bwd_dx_f32_kernel<<<gx, kThreads, 0, s>>>(
        (const float*)weights, (const float*)dout, (float*)dtokens, C, D, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gw((unsigned)((D + kFM - 1) / kFM),
                  (unsigned)((F + kFN - 1) / kFN), (unsigned)E);
    gmm_bwd_dw_f32_kernel<<<gw, kThreads, 0, s>>>(
        (const float*)tokens, (const float*)dout, (float*)dweights, C, D, F,
        stride_e, stride_c);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    const bool vx = D % 8 == 0 && F % 8 == 0 && aligned16(weights) &&
                    aligned16(dout) && aligned16(dtokens);
    const bool vw = D % 8 == 0 && F % 8 == 0 && stride_e % 8 == 0 &&
                    stride_c % 8 == 0 && aligned16(tokens) &&
                    aligned16(dout) && aligned16(dweights);
    cudaError_t err = vx ? launch_dx<true>(weights, dout, dtokens, E, C, D, F, s)
                         : launch_dx<false>(weights, dout, dtokens, E, C, D, F,
                                            s);
    if (err != cudaSuccess) return (int)err;
    err = vw ? launch_dw<true>(tokens, dout, dweights, E, C, D, F, stride_e,
                               stride_c, s)
             : launch_dw<false>(tokens, dout, dweights, E, C, D, F, stride_e,
                                stride_c, s);
    return (int)err;
  }
  if (variant == 2) {
    if (D % 8 || F % 8 || !aligned16(tokens) || !aligned16(weights) ||
        !aligned16(dout) || !aligned16(dtokens) || !aligned16(dweights) ||
        tok_map == nullptr || w_map == nullptr || dout_map == nullptr)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tm, wm, dm;
    if (!hopper::encode_map(&tm, tokens, tok_map) ||
        !hopper::encode_map(&wm, weights, w_map) ||
        !hopper::encode_map(&dm, dout, dout_map))
      return (int)cudaErrorInvalidValue;
    // dX = dout W^T over (M, N, K) = (C, D, F), then dW = X^T dout over
    // (D, F, C)
    const cudaError_t err = wg::launch<false>(dm, wm, dtokens, E, C, D, F,
                                              3, s);
    if (err != cudaSuccess) return (int)err;
    return (int)wg::launch<true>(tm, dm, dweights, E, D, F, C,
                                 (int)tok_map[0], s);
  }
  return (int)cudaErrorInvalidValue;
}
