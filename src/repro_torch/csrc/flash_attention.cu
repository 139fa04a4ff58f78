// Blockwise flash attention with an online softmax, for Hopper (sm_90a).
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//
// over the columns j that the mask keeps: j < S; j <= i when causal;
// i - j < window when window > 0, whether or not causal (the JAX kernel's
// and its plain version's semantics).  G = H / Hkv: query head h reads
// key/value head h / G by index arithmetic, with no repeated K/V in memory.
// scale = 1/sqrt(dh).  Masked logits are -1e30 (not -inf), so a tile that
// is masked whole gives no NaN; the output is acc / max(l, 1e-30); the
// softmax statistics m and l and the accumulator are float32.  Where the
// caller passes a log-sum-exp buffer (B, H, S) float32 (training: the
// backward, csrc/flash_attention_bwd.cu, recomputes the probabilities from
// it), each row also writes lse = m + log(max(l, 1e-30)) in the scaled
// logits' units; a null pointer (serving) writes nothing, and the output's
// bits are the same either way.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
// There a grid step owned one query tile and mapped the whole K/V of its
// head into VMEM; here one block owns one (64-row query tile, head, batch)
// and walks K/V in 64-row tiles, skipping the tiles that the causal and
// window masks empty entirely, as the TPU kernel's loop bounds did.  No
// atomics and no split of the key axis across blocks: a row's output
// depends only on its own (b, h) slice, the same bits at any batch size.
//
// Two variants; kernel.py's ``choose_variant`` picks one from dtype, shape
// and alignment alone:
//
// * wgmma (bf16, dh in {16, 32, 64, 128}, 16-byte aligned pointers: every
//   launch of the DiT and MoE paths).  One warpgroup of 128 threads.  Its
//   first thread loads the q tile and the K and V tiles by TMA (3-D maps
//   over (dh, S, B*H) and (dh, S, B*Hkv), boxes of 64 rows and min(dh, 64)
//   columns, swizzled 2*min(dh, 64) bytes wide; rows past S are filled with
//   zeros) into a two-stage mbarrier ring, the tile after next issued as
//   soon as a stage is consumed.  S = q k^T is wgmma.m64n64k16 with q and k
//   from shared memory (both K-major); the scale, the masks and the online
//   softmax run on the accumulator fragments in registers (a row's 16
//   values a thread sit in a quad of lanes: two shuffles for its max and
//   sum); P is rounded to bf16 in registers and is wgmma's A operand for
//   O += P v, m64n{dh}k16 with v from shared memory through the transpose
//   flag (v is MN-major).  q, k and v stay bf16 in shared memory.
// * simt (float32, or bf16 at other head dims, e.g. the JAX sweep's 8, or a
//   misaligned pointer): the first design, kept as it was.  256 threads,
//   four per query row, float32 products on the CUDA cores from padded
//   shared memory (q pre-scaled), head dims up to 128.
//
// Bound on this card: at the Zamba2 DiT's shape (B 4, H 32, S 64, dh 64,
// bf16) the function moves 4.2 MB (q, k, v read once, out written once),
// 1.25 us at 3.35 TB/s, against 134 MFLOP; at the DBRX block's (B 4, H 48,
// Hkv 8, S 64, dh 128) 7.3 MB, 2.19 us, against 403 MFLOP: bytes bind, and
// at S = 64 a block does one tile, so what remains above the bound is the
// latency of one load and two dependent products, and the host's launch.
// The grid is (S/64, H, B): 128 and 192 blocks of one warpgroup, 40 and
// 80 KB of shared memory (q, two stages of k and v) at dh 64 and 128.

#include "hopper.cuh"

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H,
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
    if (lse != nullptr && lane == 0)
      lse[(int64_t)(b * H + h) * S + row] = m + logf(denom);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int d = lane + kLanes * i;
      if (d < dh) ob[(int64_t)row * dh + d] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int S, int dh,
                   int causal, int window, float scale, cudaStream_t stream) {
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
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, Hkv, S, dh,
      causal, window, scale);
  return cudaGetLastError();
}


// ---- bfloat16: wgmma, TMA ----------------------------------------------------
namespace wg {

constexpr int kRows = 64;                // query rows a block, keys a tile
constexpr int kThreads = 128;            // one warpgroup

template <int DH>
struct Geo {
  static constexpr int kRowBytes = DH * 2 < 128 ? DH * 2 : 128;  // swizzle
  static constexpr int kBoxBytes = kRows * kRowBytes;   // one TMA box
  static constexpr int kBoxes = DH * 2 / kRowBytes;     // boxes a tile
  static constexpr int kTileBytes = kRows * DH * 2;
  // q, two stages of k, two of v, and three mbarriers
  static constexpr size_t kSmem = 1024 + 5 * (size_t)kTileBytes + 3 * 8;
};

template <int DH>
__device__ __forceinline__ void pv_k16(float (&o)[DH / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 16) hopper::wgmma_m64n16k16_rs_t1(o, a, db);
  else if constexpr (DH == 32) hopper::wgmma_m64n32k16_rs_t1(o, a, db);
  else if constexpr (DH == 64) hopper::wgmma_m64n64k16_rs_t1(o, a, db);
  else hopper::wgmma_m64n128k16_rs_t1(o, a, db);
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

// K/V tile kt into ring stage st (barrier bar[1 + st])
template <int DH>
__device__ __forceinline__ void load_kv(unsigned char* ks, unsigned char* vs,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        uint64_t* bar, int st, int kt,
                                        int kz) {
  using G = Geo<DH>;
  hopper::mbar_expect_tx(&bar[1 + st], 2 * G::kTileBytes);
  load_tile<DH>(ks + st * G::kTileBytes, k_map, &bar[1 + st], kt * kRows, kz);
  load_tile<DH>(vs + st * G::kTileBytes, v_map, &bar[1 + st], kt * kRows, kz);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int H, int Hkv, int S, int causal, int window,
                   float scale) {
  using namespace hopper;
  using G = Geo<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + G::kTileBytes;          // two stages
  unsigned char* vs = ks + 2 * G::kTileBytes;      // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + 2 * G::kTileBytes);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q_start = blockIdx.x * kRows;
  const int qz = b * H + h, kz = b * Hkv + h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (S + kRows - 1) / kRows;
  const int stop = causal ? min((q_start + 2 * kRows - 1) / kRows, n_tiles)
                          : n_tiles;
  const int start = window > 0 ? max((q_start - window + 1) / kRows, 0) : 0;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], G::kTileBytes);
    load_tile<DH>(qs, &q_map, &bar[0], q_start, qz);
    for (int st = 0; st < 2 && start + st < stop; ++st)
      load_kv<DH>(ks, vs, &k_map, &v_map, bar, st, start + st, kz);
  }

  // rows row0 and row0 + 8 of the tile; columns 8j + cq + {0, 1}
  const int row0 = q_start + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&bar[0], 0);

  for (int kt = start, i = 0; kt < stop; ++kt, ++i) {
    const int st = i & 1;
    mbar_wait(&bar[1 + st], (i >> 1) & 1);
    const unsigned char* kt_s = ks + st * G::kTileBytes;
    const unsigned char* vt_s = vs + st * G::kTileBytes;

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DH / 16; ++t)
      wgmma_m64n64k16_ss_t0(s, kmajor_desc<G::kRowBytes>(qs, t),
                            kmajor_desc<G::kRowBytes>(kt_s, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = kt * kRows;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * r + c;
          const int col = k0 + 8 * j + cq + c, row = row0 + 8 * r;
          bool keep = col < S;
          if (causal) keep = keep && col <= row;
          if (window > 0) keep = keep && (row - col) < window;
          s[idx] = keep ? s[idx] * scale : kNegInf;
          mx[r] = fmaxf(mx[r], s[idx]);
        }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int r = (idx / 2) % 2;
      s[idx] = expf(s[idx] - m[r]);
      sum[r] += s[idx];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    // P as bf16 A fragments: keys 16t..16t+15 are the accumulator's
    // column blocks 2t and 2t + 1
    uint32_t a[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[t][u] = pack_bf16(s[8 * t + 2 * u], s[8 * t + 2 * u + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      pv_k16<DH>(o, a[t], mnmajor_desc<G::kRowBytes>(vt_s, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (kt + 2 < stop) {                 // refill the stage just consumed
      __syncthreads();
      if (tid == 0) load_kv<DH>(ks, vs, &k_map, &v_map, bar, st, kt + 2, kz);
    }
  }

  __nv_bfloat16* ob = out + (int64_t)qz * S * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane % 4 == 0)  // m, l: one value a lane quad
      lse[(int64_t)qz * S + row] = m[r] + logf(denom);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row * DH + 8 * j + cq) =
          pack_bf16(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int S, int causal,
                   int window, float scale, const long long* q_geometry,
                   const long long* kv_geometry, cudaStream_t stream) {
  static bool configured = false;        // one attribute set per head dim
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Geo<DH>::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  if (!hopper::encode_map(&q_map, q, q_geometry) ||
      !hopper::encode_map(&k_map, k, kv_geometry) ||
      !hopper::encode_map(&v_map, v, kv_geometry))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows), (unsigned)H,
                  (unsigned)B);
  flash_wgmma_kernel<DH><<<grid, kThreads, Geo<DH>::kSmem, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, lse, H, Hkv, S, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = simt (bfloat16), 2 = wgmma (bfloat16,
// dh 16, 32, 64 or 128).  q is (B, H, S, dh), k and v are (B, Hkv, S, dh),
// all contiguous; H % Hkv == 0, 1 <= dh <= 128, B and H <= 65535 (checked
// by the Python wrapper).  lse is null or a (B, H, S) float32 buffer for
// the log-sum-exp of every row.  For wgmma, q_map and kv_map are the
// tensor maps' geometry (hopper.cuh ``encode_map``), computed by
// kernel.py.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse_ptr,
                                      int B, int H, int Hkv, int S, int dh,
                                      int causal, int window, float scale,
                                      int variant, const long long* q_map,
                                      const long long* kv_map, void* stream) {
  if (dh < 1 || dh > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* lse = (float*)lse_ptr;
  if (variant == 0)
    return (int)launch<float>(q, k, v, out, lse, B, H, Hkv, S, dh, causal,
                              window, scale, s);
  if (variant == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, lse, B, H, Hkv, S, dh,
                                      causal, window, scale, s);
  if (variant == 2 && q_map != nullptr && kv_map != nullptr) {
    switch (dh) {
      case 16: return (int)wg::launch<16>(q, k, v, out, lse, B, H, Hkv, S,
                                          causal, window, scale, q_map,
                                          kv_map, s);
      case 32: return (int)wg::launch<32>(q, k, v, out, lse, B, H, Hkv, S,
                                          causal, window, scale, q_map,
                                          kv_map, s);
      case 64: return (int)wg::launch<64>(q, k, v, out, lse, B, H, Hkv, S,
                                          causal, window, scale, q_map,
                                          kv_map, s);
      case 128: return (int)wg::launch<128>(q, k, v, out, lse, B, H, Hkv, S,
                                            causal, window, scale, q_map,
                                            kv_map, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
