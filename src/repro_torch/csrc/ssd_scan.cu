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
// order, so here a block owns its heads' whole sequence and a loop inside
// it walks the steps in order, carrying the state.  A chunk is walked as
// tiles of at most 64 steps joined by the same state recurrence that joins
// chunks, an exact identity of the SSD form, so only rounding differs; the
// tail is padded with dt = 0 and zero x, B and C, as both JAX functions pad
// it.  e^{L_t - L_s} is evaluated only where s <= t: above the diagonal it
// overflows, and inf·0 is NaN.  y is written in x's type, the final state
// in float32.  No atomics and no split of the step axis across blocks: a
// (b, h) slice's outputs depend on that slice alone, the same bits at any
// batch size.
//
// Bound on this card: at the DiT's shape (b 4, s 64, h 64, p 64, n 64,
// bf16 x, B, C) the function moves 8.5 MB (x, dt, B, C read once, y and
// the float32 final state written once, the state half of it), 2.5 us at
// 3.35 TB/s, against 537 MFLOP of products (CB, (CB ⊙ decay) dtx, C state,
// dtxᵀB per head and tile), 0.54 us at the bf16 tensor rate: bytes bind.
//
// Two variants; kernel.py's ``choose_variant`` picks one from dtype, shape
// and alignment alone:
//
// * wgmma (bf16 x, B and C, head dim 64, state 64 or 128, 16-byte aligned:
//   every launch of the DiT path, and Mamba2-2.7B's shape).  A block owns
//   (b, two heads), one warpgroup of 128 threads each: 128 blocks at the
//   DiT's 256 (b, h) pairs, one wave on 132 SMs.  Thread 0 loads each
//   64-step tile's B and C once for both heads, and each head's x, by TMA
//   (3-D maps over (n, s, b) and (h·p, s, b), boxes of 64 steps x 64
//   values, 128-byte swizzle; steps past s arrive as zeros) into a
//   two-stage mbarrier ring.  Per tile and head, on tensor cores with
//   float32 accumulators:
//     S  = C Bᵀ                      wgmma, both K-major from shared memory
//     y  = (S ⊙ e^{L_t - L_s} dt_s, causal) x
//                                    the weights rounded to bf16 in
//                                    registers as the A operand, x MN-major
//     y += e^{L_t} (C stateᵀ)        state rounded to bf16 into shared
//                                    memory (as JAX rounds it); zero on the
//                                    first tile
//     state = e^{L_last} state + (dt e^{L_last - L} x)ᵀ B
//                                    A operand from the x tile scaled and
//                                    rounded in registers, B MN-major; the
//                                    state stays a float32 accumulator in
//                                    registers across tiles.
//   The per-head scalings sit on x and on the accumulators, so B and C stay
//   unscaled and serve both heads.  L = cumsum(dt·A) is a warp scan.  Tiles
//   are 64 steps whatever the chunk, the SSD form being exact at any tile
//   length.
// * simt (float32, or bf16 at other head dims and states, e.g. the JAX
//   sweep's, or a misaligned pointer): the first design, kept as it was.
//   One block of 256 threads per (b, h), tiles of min(chunk, 64) steps,
//   float32 products on the CUDA cores from padded shared memory, the
//   state in shared memory (16 KB at p = n = 64, 32 KB at n = 128).

#include "hopper.cuh"

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

// ---- bfloat16: wgmma, TMA ----------------------------------------------------
namespace wg {

constexpr int kT = 64;                   // steps a tile
constexpr int kP = 64;                   // head dim
constexpr int kHeads = 2;                // heads a block, one warpgroup each
constexpr int kThreads = 128 * kHeads;
constexpr int kRowBytes = 128;           // 64 bf16 values: the swizzle width
constexpr int kBox = kT * kRowBytes;     // one TMA box, 64 rows (8 KB)

template <int N>
struct Geo {
  static constexpr int kBoxesN = N / 64;                 // boxes across n
  static constexpr int kBC = kBoxesN * kBox;             // a B or C tile
  static constexpr int kStage = 2 * kBC + kHeads * kBox; // B, C, each x
  static constexpr int kState = kBoxesN * kBox;          // bf16 (p, n)
  static constexpr int kFinal = 2 * kState;              // float32 (p, n)
  // alignment slack, two stages, each head's bf16 state and y tile, its L
  // and dt (kT floats each), two mbarriers; the float32 final states are
  // staged in the ring once it is drained
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kStage +
                                  kHeads * (size_t)(kState + kBox) +
                                  kHeads * 2 * kT * 4 + 2 * 8;
  static_assert(kSmem <= kMaxSmem, "ssd wgmma tiles exceed shared memory");
  static_assert(kHeads * kFinal <= 2 * kStage, "final states exceed the ring");
};

template <int N>
__device__ __forceinline__ void state_k16(float (&d)[N / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_m64n64k16_rs_t1(d, a, db);
  else hopper::wgmma_m64n128k16_rs_t1(d, a, db);
}

// tile ``tile``'s B, C and the x of heads h0 .. h0 + heads - 1 into ring
// stage ``st`` (barrier bar[st])
template <int N>
__device__ __forceinline__ void load_stage(unsigned char* ring,
                                           const CUtensorMap* x_map,
                                           const CUtensorMap* b_map,
                                           const CUtensorMap* c_map,
                                           uint64_t* bar, int st, int tile,
                                           int h0, int heads, int b) {
  using G = Geo<N>;
  unsigned char* dst = ring + st * G::kStage;
  hopper::mbar_expect_tx(&bar[st], 2 * G::kBC + heads * kBox);
#pragma unroll
  for (int j = 0; j < G::kBoxesN; ++j) {
    hopper::tma_load_3d(dst + j * kBox, b_map, &bar[st], j * 64, tile * kT, b);
    hopper::tma_load_3d(dst + G::kBC + j * kBox, c_map, &bar[st], j * 64,
                        tile * kT, b);
  }
  for (int g = 0; g < heads; ++g)
    hopper::tma_load_3d(dst + 2 * G::kBC + g * kBox, x_map, &bar[st],
                        (h0 + g) * kP, tile * kT, b);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap c_map,
                 const __grid_constant__ CUtensorMap y_map,
                 const __grid_constant__ CUtensorMap fs_map,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 int S, int H) {
  using namespace hopper;
  using G = Geo<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* states = ring + 2 * G::kStage;
  unsigned char* ytiles = states + kHeads * G::kState;
  float* Ls = reinterpret_cast<float*>(ytiles + kHeads * kBox);
  float* dts = Ls + kHeads * kT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(dts + kHeads * kT);

  const int b = blockIdx.y, h0 = blockIdx.x * kHeads;
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128,
            warp = wtid / 32, lane = tid % 32;
  const int h = h0 + wg;
  const bool active = h < H;             // a last group may hold one head
  const int n_tiles = (S + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < 2 && st < n_tiles; ++st)
      load_stage<N>(ring, &x_map, &b_map, &c_map, bar, st, st, h0,
                    min(kHeads, H - h0), b);

  // this head's L (in log2 units: L log2(e), so e^L = 2^L) and dt of the
  // tile
  float* L = Ls + wg * kT;
  float* dtv = dts + wg * kT;
  unsigned char* st_s = states + wg * G::kState;
  unsigned char* y_s = ytiles + wg * kBox;
  const float a = active ? A[h] * 1.4426950408889634f : 0.f;
  // accumulator rows r0 and r0 + 8; columns 8j + cq + {0, 1}
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float state[N / 2];                    // rows p, columns n
#pragma unroll
  for (int i = 0; i < N / 2; ++i) state[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stg = i & 1, t0 = i * kT;
    const unsigned char* bs = ring + stg * G::kStage;
    const unsigned char* cs = bs + G::kBC;
    const unsigned char* xs = bs + 2 * G::kBC + wg * kBox;
    if (active) {
      if (warp == 0) {                   // L = cumsum(dt·A): a warp scan
        const int t = t0 + 2 * lane;
        const float d0 = t < S ? dt[((int64_t)b * S + t) * H + h] : 0.f;
        const float d1 = t + 1 < S ? dt[((int64_t)b * S + t + 1) * H + h]
                                   : 0.f;
        const float v0 = d0 * a, v1 = d1 * a;
        float run = v0 + v1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, run, o);
          if (lane >= o) run += u;
        }
        const float before = __shfl_up_sync(0xffffffffu, run, 1);
        const float l0 = (lane ? before : 0.f) + v0;
        *reinterpret_cast<float2*>(L + 2 * lane) = make_float2(l0, l0 + v1);
        *reinterpret_cast<float2*>(dtv + 2 * lane) = make_float2(d0, d1);
      }
      {                                  // the state before this tile, bf16
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(
                st_s + (j / 8) * kBox + swz(r0 + 8 * r, 8 * (j % 8) + cq)) =
                pack_bf16(state[4 * j + 2 * r], state[4 * j + 2 * r + 1]);
        fence_proxy_async();
        if (wtid == 0) bulk_wait_read<0>();  // the last y tile is stored
      }

      // S = C Bᵀ as soon as the tiles land, while L may still be summed
      float sc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      fence_regs(sc);
      mbar_wait(&bar[stg], (i >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < N / 16; ++k)
        wgmma_m64n64k16_ss_t0(sc, kmajor_desc<kRowBytes>(cs, k),
                              kmajor_desc<kRowBytes>(bs, k));
      wgmma_commit();
      named_barrier(1 + wg, 128);        // L, dt and the state are written

      // this thread's 16 steps, 8j + cq + {0, 1}: their L and dt, and the
      // state update's weights dt 2^{L_last - L}
      const float l_last = L[kT - 1];
      float ls[16], ws[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(dtv + 8 * j + cq);
        ls[2 * j] = l2.x;
        ls[2 * j + 1] = l2.y;
        ws[2 * j] = d2.x;
        ws[2 * j + 1] = d2.y;
      }
      const float lt[2] = {L[r0], L[r0 + 8]};
      wgmma_wait<0>();
      fence_regs(sc);

      // weights (S ⊙ e^{L_t - L_s} dt_s, s <= t) as bf16 A fragments:
      // steps 16k..16k+15 are the accumulator's column blocks 2k, 2k + 1.
      // Above the diagonal the exponent is clamped to 0 (it would
      // overflow) and the weight selected away.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * r + c;
            const float w = sc[idx] *
                            exp2_ftz(fminf(lt[r] - ls[2 * j + c], 0.f)) *
                            ws[2 * j + c];
            sc[idx] = 8 * j + cq + c <= r0 + 8 * r ? w : 0.f;
          }
      uint32_t pa[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pa[k][u] = pack_bf16(sc[8 * k + 2 * u], sc[8 * k + 2 * u + 1]);

      // state = e^{L_last} state + (dt e^{L_last - L} x)ᵀ B: A fragments
      // (rows p, columns s) from the x tile, scaled and rounded to bf16
#pragma unroll
      for (int k = 0; k < 16; ++k) ws[k] *= exp2_ftz(l_last - ls[k]);
      uint32_t xa[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = 16 * k + 8 * half + cq, iw = 4 * k + 2 * half;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = r0 + 8 * q;
            const float x0 = __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(xs + swz(s, p)));
            const float x1 = __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(xs + swz(s + 1, p)));
            xa[k][2 * half + q] = pack_bf16(ws[iw] * x0, ws[iw + 1] * x1);
          }
        }
      const float e_last = exp2_ftz(l_last);
#pragma unroll
      for (int k = 0; k < N / 2; ++k) state[k] *= e_last;

      // y = weights @ x, C stateᵀ (the state before this tile, from shared
      // memory; zero on the first tile) and the state update: one group
      float yo[32], yi[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) yo[k] = yi[k] = 0.f;
      fence_regs(yo);
      fence_regs(yi);
      fence_regs(state);
      fence_regs(pa);
      fence_regs(xa);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n64k16_rs_t1(yo, pa[k], mnmajor_desc<kRowBytes>(xs, k));
#pragma unroll
      for (int k = 0; k < N / 16; ++k)
        wgmma_m64n64k16_ss_t0(yi, kmajor_desc<kRowBytes>(cs, k),
                              kmajor_desc<kRowBytes>(st_s, k));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        state_k16<N>(state, xa[k], mnmajor_desc<kRowBytes>(bs, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yo);
      fence_regs(yi);
      fence_regs(state);
      fence_regs(pa);                    // A fragments live until the wait
      fence_regs(xa);

      // y = intra + e^{L_t} inter, staged swizzled and stored by TMA (rows
      // past S are not written)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float el = exp2_ftz(lt[r]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(y_s + swz(r0 + 8 * r, 8 * j + cq)) =
              pack_bf16(yo[4 * j + 2 * r] + el * yi[4 * j + 2 * r],
                        yo[4 * j + 2 * r + 1] + el * yi[4 * j + 2 * r + 1]);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (wtid == 0) {
        tma_store_3d(&y_map, y_s, h * kP, t0, b);
        bulk_commit();
      }
    }
    __syncthreads();                     // both heads are done with the stage
    if (tid == 0 && i + 2 < n_tiles)
      load_stage<N>(ring, &x_map, &b_map, &c_map, bar, stg, i + 2, h0,
                    min(kHeads, H - h0), b);
  }

  if (!active) return;
  // the float32 final state, staged in the drained ring as boxes of 64 rows
  // x 32 floats (swizzled) and stored by TMA
  unsigned char* f_s = ring + wg * G::kFinal;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(f_s + (j / 4) * kBox +
                                 swz(r0 + 8 * r, 2 * (8 * (j % 4) + cq))) =
          make_float2(state[4 * j + 2 * r], state[4 * j + 2 * r + 1]);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (wtid == 0) {
#pragma unroll
    for (int k = 0; k < N / 32; ++k)
      tma_store_3d(&fs_map, f_s + k * kBox, k * 64, 0, b * H + h);
    bulk_commit();
    bulk_wait_read<0>();                 // shared memory stays until read
  }
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* fs,
                   int batch, int S, int H, const long long* x_geometry,
                   const long long* bc_geometry,
                   const long long* fs_geometry, cudaStream_t stream) {
  static bool configured = false;        // one attribute set per state size
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Geo<N>::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap x_map, b_map, c_map, y_map, fs_map;
  if (!hopper::encode_map(&x_map, x, x_geometry) ||
      !hopper::encode_map(&b_map, Bm, bc_geometry) ||
      !hopper::encode_map(&c_map, Cm, bc_geometry) ||
      !hopper::encode_map(&y_map, y, x_geometry) ||
      !hopper::encode_map(&fs_map, fs, fs_geometry))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((H + kHeads - 1) / kHeads), (unsigned)batch);
  ssd_wgmma_kernel<N><<<grid, kThreads, Geo<N>::kSmem, stream>>>(
      x_map, b_map, c_map, y_map, fs_map, (const float*)dt, (const float*)A,
      S, H);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = simt (bfloat16), 2 = wgmma (bfloat16,
// P 64, N 64 or 128).  x and y are (batch, S, H, P), dt (batch, S, H)
// float32, A (H,) float32, B and C (batch, S, N), fs (batch, H, P, N)
// float32, all contiguous; tq is the simt tile length, 1 <= tq <= 64.
// For wgmma, x_map (also y's), bc_map and fs_map are the tensor maps'
// geometry (hopper.cuh ``encode_map``; fs as pairs of bf16), computed by
// kernel.py.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue when the simt tiles do not fit shared memory or the
// variant does not take the shape.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* fs, int batch, int S, int H, int P,
                               int N, int tq, int variant,
                               const long long* x_map,
                               const long long* bc_map,
                               const long long* fs_map, void* stream) {
  if (tq < 1 || tq > kMaxTile || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, fs, batch, S, H, P, N, tq,
                              s);
  if (variant == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fs, batch, S, H, P,
                                      N, tq, s);
  if (variant == 2 && P == wg::kP && x_map != nullptr && bc_map != nullptr &&
      fs_map != nullptr) {
    if (N == 64)
      return (int)wg::launch<64>(x, dt, A, Bm, Cm, y, fs, batch, S, H, x_map,
                                 bc_map, fs_map, s);
    if (N == 128)
      return (int)wg::launch<128>(x, dt, A, Bm, Cm, y, fs, batch, S, H, x_map,
                                  bc_map, fs_map, s);
  }
  return (int)cudaErrorInvalidValue;
}
