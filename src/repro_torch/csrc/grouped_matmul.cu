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
// There the grid (E, C/bc, F/bf, D/bd) ran in order on one core, the last
// axis carried an fp32 VMEM accumulator from one step to the next, and the
// operands were padded with jnp.pad to whole blocks.  Here one tile of
// output walks D in a loop inside one block with its accumulator in
// registers, and the ragged C, D and F edges are zero-filled by the loads
// (TMA's out-of-bounds fill, or cp.async's) and masked at the stores.
//
// Three variants; kernel.py's ``choose_variant`` picks one from dtype,
// shape, strides and alignment alone:
//
// * wgmma (bf16; D, F and the token strides multiples of 8 elements,
//   pointers 16-byte aligned: every launch of the MoE path).  A persistent
//   grid of one block per SM walks 256 x 192 output tiles in the order
//   (expert, F-tile, C-tile), C fastest, so the blocks in flight read one
//   or two experts' token slabs.  Each block is three warpgroups: one
//   producer thread keeps TMA loads of 64-deep k-tiles in flight into a
//   4-stage ring (a stage: tokens as one 256 x 64 box, 32 KB; weights as
//   three 64 x 64 boxes, 24 KB; all 128-byte swizzled; 225 KB in all)
//   completed on ``full`` mbarriers; two consumer warpgroups (setmaxnreg
//   232, the producer's warpgroup drops to 40) each own 128 token rows and
//   issue two wgmma.m64n192k16 per 16 of depth straight from shared
//   memory, the weights MN-major through wgmma's transpose flag, keep one
//   wgmma group in flight and hand each stage back on an ``empty``
//   mbarrier.  The epilogue (fp32 -> bf16, four-byte stores masked at the C
//   and F edges) overlaps the producer's loads of the block's next tile.
//   Tokens map: 3-D (D, C, E) at the tokens' byte strides, or 2-D (D, C)
//   read at the same coordinates for every expert when the expert stride is
//   0; weights map: 3-D (F, D, E).
// * wmma (bf16 otherwise, e.g. D or F not a multiple of 8, or a misaligned
//   pointer): the first design, kept as it was.  128 x 128 output tiles, 8
//   warps of 64 x 32 on nvcuda::wmma 16x16x16 fragments, K-tiles of 32
//   through a 3-stage cp.async ring (16-byte copies) when D, F and the token
//   strides are multiples of 8 and the pointers 16-byte aligned, else
//   through plain masked loads.
// * simt (float32): 64 x 64 output tiles on the CUDA cores, 4 x 4 outputs a
//   thread, one fmaf per product in the order of d.  No TF32: float32 keeps
//   the JAX package's fp32 tolerance.
//
// Every output row's sum runs over d in one fixed order (k-tiles in order,
// 16 at a time inside them), in one block, with no split of D across
// blocks or warpgroups and no atomics, and no tile or instruction shape
// depends on C; a row's bits depend only on that row and the weights,
// whatever C is.
//
// Bound on this card, at the MoE path's shapes (E 16, C 256, bf16): gate
// and up (D 6144, F 10752, tokens broadcast) move 2.21 GB (the weights
// 2.11 GB, one 3 MB token set, the 88 MB output), 0.66 ms at 3.35 TB/s,
// against 541 GFLOP, 0.55 ms at 989 TFLOP/s; down (D 10752, F 6144,
// tokens contiguous) the same flops and 2.25 GB.  Bytes bind, but only
// just: C = 256 FLOP a weight byte is under the card's ridge of ~295, so
// the kernel has to stream the weights at near the memory rate while the
// tensor cores run near their peak.  Taking all of C in one tile reads
// each weight byte from device memory once; the tokens come from L2, and
// (256 + 192) / 192 = 2.3 times the weights' bytes cross from L2 to SMs.
//
// Tile width and waves on 132 SMs.  A consumer warpgroup holds 128 x 192
// fp32 accumulators, 192 registers a thread, under the 232 of setmaxnreg
// with no spills.  192-wide tiles make 16 x 56 = 896 tiles at gate/up:
// 104 blocks take 7 and 28 take 6, so the blocks are busy 6.79 / 7 = 97%
// of the launch; down makes 16 x 32 = 512 (3.88 / 4, 97%).  128-wide
// tiles would make 1,344 (10.18 / 11, 93%) and 768 (5.82 / 6, 97%), and
// were slower at gate/up on an H100 80GB HBM3.  Stream-K and split-K
// would even out the waves but split D, which the row-bits rule forbids.
// A 2-block cluster that multicasts each token tile to two F-tiles would
// halve the tokens' L2 traffic, but was slower on that card and is not
// used.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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


// ---- bfloat16: wgmma, TMA, warp-specialised, persistent --------------------
namespace wg {

constexpr int kBM = 256;                 // token rows per tile
constexpr int kBN = 192;                 // output columns per tile
constexpr int kBK = 64;                  // depth per stage: one 128-byte row
constexpr int kBoxN = 64;                // weight columns per TMA box
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups of 128 token rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = kBK * 2;       // 128: the swizzle row
constexpr int kAtomBytes = 8 * kRowBytes;  // 1024: eight swizzled rows
constexpr int kABytes = kBM * kRowBytes;   // 32 KB of tokens a stage
constexpr int kBBytes = kBN * kRowBytes;   // 24 KB of weights a stage
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kSmem =
    1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

// ``tiles`` counts (expert, F-tile, C-tile) with the C-tile fastest; block
// b takes tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tok_map,
                 const __grid_constant__ CUtensorMap w_map,
                 __nv_bfloat16* __restrict__ out, int C, int D, int F,
                 int tiles_m, int tiles_n, int tiles, int tok_rank) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int k_tiles = (D + kBK - 1) / kBK;
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
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * kStageBytes;
          unsigned char* b = a + kABytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          if (tok_rank == 3)
            tma_load_3d(a, &tok_map, &full[stage], kt * kBK, m * kBM, e);
          else
            tma_load_2d(a, &tok_map, &full[stage], kt * kBK, m * kBM);
#pragma unroll
          for (int j = 0; j < kBN / kBoxN; ++j)
            tma_load_3d(b + j * kBK * kRowBytes, &w_map, &full[stage],
                        n * kBN + j * kBoxN, kt * kBK, e);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 128 token rows each ----
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
            smem + stage * kStageBytes + wgi * 128 * kRowBytes;
        const unsigned char* b = smem + stage * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          // weights: MN-major; 16 rows of depth further down, the next
          // 64 columns one box (kBK rows) further on
          const uint64_t db = make_desc(b + k * 16 * kRowBytes,
                                        kBK * kRowBytes, kAtomBytes, 1);
#pragma unroll
          for (int i = 0; i < 2; ++i)   // tokens: K-major, 32 bytes a k16
            wgmma_m64n192k16_ss<0, 1>(
                acc[i],
                make_desc(a + i * 64 * kRowBytes + k * 32, 0, kAtomBytes, 1),
                db);
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
      if (lane == 0) mbar_arrive(&empty[prev]);

      __nv_bfloat16* ob = out + (int64_t)e * C * F;
      const int col0 = n * kBN + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = m * kBM + wgi * 128 + i * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = col0 + 8 * j;   // F % 8 == 0: col + 1 < F too
          if (col >= F) continue;
          if (r0 < C)
            *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * F + col) =
                pack_bf16(acc[i][4 * j], acc[i][4 * j + 1]);
          if (r0 + 8 < C)
            *reinterpret_cast<uint32_t*>(ob + (int64_t)(r0 + 8) * F + col) =
                pack_bf16(acc[i][4 * j + 2], acc[i][4 * j + 3]);
        }
      }
    }
  }
}

cudaError_t launch(const void* t, const void* w, void* o, int E, int C,
                   int D, int F, const long long* tok_geometry,
                   const long long* w_geometry, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap tok_map, w_map;
  if (!hopper::encode_map(&tok_map, t, tok_geometry) ||
      !hopper::encode_map(&w_map, w, w_geometry))
    return cudaErrorInvalidValue;
  const int tiles_m = (C + kBM - 1) / kBM, tiles_n = (F + kBN - 1) / kBN;
  const long long tiles = (long long)E * tiles_m * tiles_n;
  const int sms = hopper::sm_count();
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gmm_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      tok_map, w_map, (__nv_bfloat16*)o, C, D, F, tiles_m, tiles_n,
      (int)tiles, (int)tok_geometry[0]);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = wmma (bfloat16), 2 = wgmma (bfloat16).  tokens (E, C, D) at element
// strides (stride_e, stride_c, 1); weights (E, D, F) and out (E, C, F)
// contiguous.  For wgmma, tok_map and w_map are the tensor maps' geometry
// (hopper.cuh ``encode_map``), computed by kernel.py; the other variants
// ignore them and need E <= 65535 and C- and F-tile counts <= 65535
// (checked by the Python wrapper).  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int grouped_matmul_launch(const void* tokens, const void* weights,
                                     void* out, int E, int C, int D, int F,
                                     long long stride_e, long long stride_c,
                                     int variant, const long long* tok_map,
                                     const long long* w_map, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || stride_e < 0 || stride_c < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const dim3 grid((unsigned)((C + kFM - 1) / kFM),
                    (unsigned)((F + kFN - 1) / kFN), (unsigned)E);
    gmm_f32_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)tokens, (const float*)weights, (float*)out, C, D, F,
        stride_e, stride_c);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    const bool vec = D % 8 == 0 && F % 8 == 0 && stride_e % 8 == 0 &&
                     stride_c % 8 == 0 && aligned16(tokens) &&
                     aligned16(weights) && aligned16(out);
    return vec ? (int)launch_bf16<true>(tokens, weights, out, E, C, D, F,
                                        stride_e, stride_c, s)
               : (int)launch_bf16<false>(tokens, weights, out, E, C, D, F,
                                         stride_e, stride_c, s);
  }
  if (variant == 2) {
    if (D % 8 || F % 8 || !aligned16(tokens) || !aligned16(weights) ||
        !aligned16(out) || tok_map == nullptr || w_map == nullptr)
      return (int)cudaErrorInvalidValue;
    return (int)wg::launch(tokens, weights, out, E, C, D, F, tok_map, w_map,
                           s);
  }
  return (int)cudaErrorInvalidValue;
}
