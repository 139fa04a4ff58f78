// The Mamba2 mixer's memory-bound glue, fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the elementwise work
// around the mixer's products and its SSD scan (models/ssm.py
// mamba_forward) to XLA, which fuses it.  PyTorch runs that work eagerly,
// about 40 launches a mixer, each pass moving a whole (tokens, channels)
// tensor through device memory, some of them strided.  Three kernels take
// it over where no gradient is needed (kernels/mamba_mixer/ops.py routes):
//
// * mamba_conv_silu_kernel: the causal depthwise conv of width K <= 4 over
//   (B, S, C), then the bias, then SiLU, for x (C = d_inner) and for B/C
//   (C = 2n) in one launch; B and C are written as two contiguous
//   (B, S, n) outputs.  The projections' outputs are read as they lie: a
//   thread owns one 16-byte vector of channels (8 bf16 or 4 float32) and
//   kConvRows steps of one batch row, and loads its K-1 halo rows and its
//   own rows into registers once, so neighbouring threads read
//   neighbouring addresses and each input is read once from device memory
//   (the halo again, mostly from L2).  Four steps a thread ran fastest at
//   the DiT's shape (52 us a launch, against 58 at one or two steps and
//   70-88 at eight or sixteen, whose registers cut the threads in flight).
//   SiLU's exact exponential and division keep the SMs' instruction
//   slots about as busy as the bytes keep memory, so the conv runs at
//   about 40% of its bound.
// * mamba_rmsnorm_kernel: the mixer's input RMSNorm, one block a row, the
//   row kept in shared memory, its float32 sum of squares added up in the
//   order of aten's reduce_kernel, which the eager route's sum runs
//   (norm_row below).
// * mamba_rmsnorm_gated_kernel: the same row kernel with a prologue,
//   u = (y + xs·D[head]) · SiLU(z), the mixer's D skip and gate, then the
//   output RMSNorm of u.
//
// Roundings.  Each kernel rounds to the activation type T wherever the
// eager route (models/ssm.py _causal_conv, models/layers.py rmsnorm) stores
// a T: the conv's float32 sum (aten's depthwise conv accumulates
// w[k]·x[s-K+1+k] in float32 with FMAs, k ascending, as here), then the
// bias add, then SiLU (x / (1 + e^-x) in float32); xs·D with D rounded to
// T, then y + that, then SiLU(z), then the product; the norm's row
// statistic in float32, inv = rsqrt(mean + eps) rounded to T, then u·inv,
// then ·scale.  Products and sums use the _rn intrinsics, so nvcc cannot
// contract two roundings into one FMA, and the sum of squares is added up
// in aten's order.  So the fused route gives the eager route's bits.
//
// Bound on this card: bytes.  At the DiT's shape (4,096 tokens, d 2,048,
// d_inner 4,096, n 64, bf16) a mixer's three launches move 69 MB (conv),
// 34 MB (input norm) and 134 MB (output norm) with each input read once and
// each output written once: 71 us at 3.35 TB/s, against 0.41 GFLOP of
// float32 arithmetic (6 us at 67 TFLOP/s; kernels/mamba_mixer/cost.py).
// The eager route moved about 1.3-1.5 GB for the same work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxWidth = 4;      // the widest conv the configurations carry
constexpr int kConvThreads = 128;
constexpr int kConvRows = 4;      // steps a conv thread walks
constexpr int kNormMaxThreads = 512;  // aten's reduction block
constexpr int kNormThreads = 256;     // a norm block's, one row a block
constexpr int kNormMinWidth = 128;    // narrower rows aten sums unvectorised
constexpr int kNormMaxWidth = 7936;   // wider ones it may split across warps

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
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened again: where the eager route stores a T
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// aten's SiLU in float32: x / (1 + e^-x)
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// one 16-byte vector of T
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// the Vec<T>::N values at p[c ..): one 16-byte load where kVec (every row
// width a multiple of N, every pointer 16-byte aligned), else element by
// element, zero at and past C
template <typename T, bool kVec>
__device__ __forceinline__ Vec<T> load(const T* p, int c, int C) {
  Vec<T> out;
  if (kVec) {
    out = *reinterpret_cast<const Vec<T>*>(p + c);
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i)
      out.v[i] = c + i < C ? p[c + i] : from_f32<T>(0.0f);
  }
  return out;
}

template <typename T, bool kVec>
__device__ __forceinline__ void store(T* p, int c, int C, const Vec<T>& val) {
  if (kVec) {
    *reinterpret_cast<Vec<T>*>(p + c) = val;
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i)
      if (c + i < C) p[c + i] = val.v[i];
  }
}

// one thread a (batch row, tile of kConvRows steps, channel vector), the
// vectors of x then of B/C fastest, so a warp reads neighbouring vectors of
// one step
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kConvThreads) mamba_conv_silu_kernel(
    const T* __restrict__ x, const T* __restrict__ bc,
    const T* __restrict__ wx, const T* __restrict__ bx,
    const T* __restrict__ wbc, const T* __restrict__ bbc,
    T* __restrict__ xo, T* __restrict__ bo, T* __restrict__ co, int batch,
    int S, int Cx, int n) {
  constexpr int V = Vec<T>::N;
  constexpr int W = K - 1 + kConvRows;  // halo rows, then this thread's
  const unsigned nx = (Cx + V - 1) / V, nv = nx + (2 * n + V - 1) / V;
  const unsigned tiles = (S + kConvRows - 1) / kConvRows;
  const unsigned g = blockIdx.x * kConvThreads + threadIdx.x;
  const unsigned j = g % nv, bt = g / nv;
  if (bt >= tiles * (unsigned)batch) return;
  const bool is_x = j < nx;
  const int C = is_x ? Cx : 2 * n;
  const int c = (is_x ? j : j - nx) * V;
  const long long b = bt / tiles;
  const T* src = (is_x ? x : bc) + b * S * C;
  const T* w = is_x ? wx : wbc;
  const int s0 = (bt % tiles) * kConvRows;

  float wk[K][V], bias[V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Vec<T> t = load<T, kVec>(w + (long long)k * C, c, C);
#pragma unroll
    for (int i = 0; i < V; ++i) wk[k][i] = to_f32(t.v[i]);
  }
  {
    const Vec<T> t = load<T, kVec>(is_x ? bx : bbc, c, C);
#pragma unroll
    for (int i = 0; i < V; ++i) bias[i] = to_f32(t.v[i]);
  }
  Vec<T> win[W];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int s = s0 - (K - 1) + r;
    if (s >= 0 && s < S) {
      win[r] = load<T, kVec>(src + (long long)s * C, c, C);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) win[r].v[i] = from_f32<T>(0.0f);
    }
  }
#pragma unroll
  for (int r = 0; r < kConvRows; ++r) {
    const int s = s0 + r;
    if (s >= S) break;
    Vec<T> out;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc = __fmaf_rn(wk[k][i], to_f32(win[r + k].v[i]), acc);
      const float v = rnd<T>(__fadd_rn(rnd<T>(acc), bias[i]));
      out.v[i] = from_f32<T>(silu(v));
    }
    const long long row = b * S + s;
    if (is_x) {
      store<T, kVec>(xo + row * Cx, c, Cx, out);
    } else if (kVec) {  // n is a multiple of V: a vector lies in B or in C
      if (c < n)
        store<T, true>(bo + row * n, c, n, out);
      else
        store<T, true>(co + row * n, c - n, n, out);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int cc = c + i;
        if (cc < n)
          bo[row * n + cc] = out.v[i];
        else if (cc < 2 * n)
          co[row * n + cc - n] = out.v[i];
      }
    }
  }
}

// a row's 4 values at [4j, 4j + 4): one 8-byte (bf16) or 16-byte (float32)
// access, as aten's reduction loads its float32 copy of the row
template <typename T> struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

// The mixer's norms, one block of kNormThreads a row.  The row's u (its
// values, or (y + xs·D) · SiLU(z)) is computed by the whole block, 4 values
// a thread at a time, and kept in shared memory as T; its float32 sum of
// squares is then added up in the order of aten's reduce_kernel
// (ATen/native/cuda/Reduce.cuh; a sum or mean over the contiguous last dim
// of d % 4 == 0, 128 <= d <= 7,936 values, which it loads as 4-value
// vectors and never splits across warps): a team of bw threads (bw from
// the row count, norm_team below), its thread x adding vectors x, x + bw,
// ... into four float32 sums, one per place in the vector, the four then
// summed in order; the team's sums halved from bw/2 down to 32 in shared
// memory and from 16 down to 1 by warp shuffles.  The block's first
// min(bw, kNormThreads) threads play the team; at bw = 2 · kNormThreads
// (a lone row) each plays x and x + kNormThreads and adds the two, the
// halving's first step.  Then every thread writes its values' outputs.
template <typename T, bool kGated>
__device__ __forceinline__ void norm_row(const T* __restrict__ x,
                                         const T* __restrict__ scale,
                                         const T* __restrict__ xs,
                                         const float* __restrict__ D,
                                         const T* __restrict__ z,
                                         T* __restrict__ out, int d, int p,
                                         int bw, float rdiv, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Quad<T>* keep = reinterpret_cast<Quad<T>*>(smem);
  float* tree = reinterpret_cast<float*>(smem + (size_t)d * sizeof(T));
  const int t = threadIdx.x, nv = d / 4;
  const long long base = (long long)blockIdx.x * d;
  const Quad<T>* xr = reinterpret_cast<const Quad<T>*>(x + base);
  for (int j = t; j < nv; j += kNormThreads) {
    const Quad<T> a = xr[j];
    if (kGated) {
      const Quad<T> b = reinterpret_cast<const Quad<T>*>(xs + base)[j];
      const Quad<T> g = reinterpret_cast<const Quad<T>*>(z + base)[j];
      int head = 4 * j / p, at = 4 * j - head * p;  // the head of value 4j + i
      Quad<T> u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dh = rnd<T>(D[head]);
        if (++at == p) at = 0, ++head;
        const float skip = rnd<T>(__fadd_rn(
            to_f32(a.v[i]), rnd<T>(__fmul_rn(to_f32(b.v[i]), dh))));
        u.v[i] = from_f32<T>(__fmul_rn(skip, rnd<T>(silu(to_f32(g.v[i])))));
      }
      keep[j] = u;
    } else {
      keep[j] = a;
    }
  }
  __syncthreads();
  const int team = min(bw, kNormThreads);
  float s = 0.0f;
  if (t < team) {
    for (int x0 = t; x0 < bw; x0 += kNormThreads) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = x0; j < nv; j += bw) {
        const Quad<T> u = keep[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = to_f32(u.v[i]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(f, f));
        }
      }
      const float v =
          __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
      s = x0 == t ? v : __fadd_rn(s, v);
    }
  }
  if (team > 32) {  // uniform over the block: every thread meets each barrier
    tree[t] = s;
    for (int o = team / 2; o >= 32; o >>= 1) {
      __syncthreads();
      if (t < o) {
        s = __fadd_rn(s, tree[t + o]);
        tree[t] = s;
      }
    }
  }
  if (t < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    // var = sum · rdiv (aten multiplies by the divisor's float32
    // reciprocal, and a mean by rows / numel); inv = rsqrt(var + eps)
    // rounded to T
    if (t == 0) tree[kNormThreads] = rnd<T>(rsqrtf(__fadd_rn(
        __fmul_rn(s, rdiv), eps)));
  }
  __syncthreads();
  const float inv = tree[kNormThreads];
  const Quad<T>* sc = reinterpret_cast<const Quad<T>*>(scale);
  Quad<T>* orow = reinterpret_cast<Quad<T>*>(out + base);
  for (int j = t; j < nv; j += kNormThreads) {
    const Quad<T> u = keep[j], w = sc[j];
    Quad<T> o;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o.v[i] = from_f32<T>(__fmul_rn(rnd<T>(__fmul_rn(to_f32(u.v[i]), inv)),
                                     to_f32(w.v[i])));
    orow[j] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads) mamba_rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
    int d, int bw, float rdiv, float eps) {
  norm_row<T, false>(x, scale, nullptr, nullptr, nullptr, out, d, 1, bw,
                     rdiv, eps);
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads) mamba_rmsnorm_gated_kernel(
    const T* __restrict__ y, const T* __restrict__ scale,
    const T* __restrict__ xs, const float* __restrict__ D,
    const T* __restrict__ z, T* __restrict__ out, int d, int p, int bw,
    float rdiv, float eps) {
  norm_row<T, true>(y, scale, xs, D, z, out, d, p, bw, rdiv, eps);
}

template <typename T, bool kVec>
cudaError_t conv_launch(const void* x, const void* bc, const void* wx,
                        const void* bx, const void* wbc, const void* bbc,
                        void* xo, void* bo, void* co, int batch, int S,
                        int Cx, int n, int K, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const long long threads = (long long)((Cx + V - 1) / V +
                                        (2 * n + V - 1) / V) *
                            ((S + kConvRows - 1) / kConvRows) * batch;
  if (threads > 0xffffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (threads + kConvThreads - 1) / kConvThreads;
#define MAMBA_CONV(KW)                                                        \
  mamba_conv_silu_kernel<T, KW, kVec><<<grid, kConvThreads, 0, st>>>(         \
      (const T*)x, (const T*)bc, (const T*)wx, (const T*)bx, (const T*)wbc,   \
      (const T*)bbc, (T*)xo, (T*)bo, (T*)co, batch, S, Cx, n)
  switch (K) {
    case 1: MAMBA_CONV(1); break;
    case 2: MAMBA_CONV(2); break;
    case 3: MAMBA_CONV(3); break;
    case 4: MAMBA_CONV(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef MAMBA_CONV
  return cudaGetLastError();
}

int last_pow2(int n) {  // aten's last_pow2, n >= 1
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

// aten's block for the reduction (setReduceConfig, set_block_dimension):
// 512 threads at most, its width over the row's nv 4-value vectors, its
// height over the rows; a row's team is the block's width
int norm_team(int rows, int nv) {
  const int dim0 = nv < kNormMaxThreads ? last_pow2(nv) : kNormMaxThreads;
  const int dim1 = rows < kNormMaxThreads ? last_pow2(rows) : kNormMaxThreads;
  const int height = std::min(dim1, kNormMaxThreads / std::min(dim0, 32));
  return std::min(dim0, kNormMaxThreads / height);
}

template <typename T>
cudaError_t norm_launch(const void* x, const void* scale, const void* xs,
                        const void* D, const void* z, void* out, int rows,
                        int d, int p, float rdiv, float eps,
                        cudaStream_t st) {
  const int bw = norm_team(rows, d / 4);
  // the row's u as T, then the team's sums and the row's inv
  const size_t smem = (size_t)d * sizeof(T) + (kNormThreads + 1) * 4;
  if (xs == nullptr)
    mamba_rmsnorm_kernel<T><<<rows, kNormThreads, smem, st>>>(
        (const T*)x, (const T*)scale, (T*)out, d, bw, rdiv, eps);
  else
    mamba_rmsnorm_gated_kernel<T><<<rows, kNormThreads, smem, st>>>(
        (const T*)x, (const T*)scale, (const T*)xs, (const float*)D,
        (const T*)z, (T*)out, d, p, bw, rdiv, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 float32, 1 bfloat16; vec 1 where every pointer is 16-byte aligned
// and Cx and n are multiples of a vector's values
extern "C" int mamba_conv_silu_launch(const void* x, const void* bc,
                                      const void* wx, const void* bx,
                                      const void* wbc, const void* bbc,
                                      void* xo, void* bo, void* co, int batch,
                                      int S, int Cx, int n, int K, int dtype,
                                      int vec, void* stream) {
  if (K < 1 || K > kMaxWidth || batch < 1 || S < 1 || Cx < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(vec ? conv_launch<float, true>(x, bc, wx, bx, wbc, bbc, xo,
                                                bo, co, batch, S, Cx, n, K, st)
                     : conv_launch<float, false>(x, bc, wx, bx, wbc, bbc, xo,
                                                 bo, co, batch, S, Cx, n, K,
                                                 st));
  if (dtype == 1)
    return (int)(vec ? conv_launch<__nv_bfloat16, true>(
                           x, bc, wx, bx, wbc, bbc, xo, bo, co, batch, S, Cx,
                           n, K, st)
                     : conv_launch<__nv_bfloat16, false>(
                           x, bc, wx, bx, wbc, bbc, xo, bo, co, batch, S, Cx,
                           n, K, st));
  return (int)cudaErrorInvalidValue;
}

// xs == nullptr: the input norm; else the gated output norm, D (d / p,)
// float32 a head of p values.  rdiv multiplies the row's sum of squares
// into its mean.  Every pointer aligned to 4 values, d % 4 == 0 and
// kNormMinWidth <= d <= kNormMaxWidth
extern "C" int mamba_rmsnorm_launch(const void* x, const void* scale,
                                    const void* xs, const void* D,
                                    const void* z, void* out, int rows, int d,
                                    int p, float rdiv, float eps, int dtype,
                                    void* stream) {
  if (rows < 1 || d % 4 || d < kNormMinWidth || d > kNormMaxWidth || p < 1 ||
      (xs != nullptr && (D == nullptr || z == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)norm_launch<float>(x, scale, xs, D, z, out, rows, d, p, rdiv,
                                   eps, st);
  if (dtype == 1)
    return (int)norm_launch<__nv_bfloat16>(x, scale, xs, D, z, out, rows, d,
                                           p, rdiv, eps, st);
  return (int)cudaErrorInvalidValue;
}
