// The backward of the Mamba2 chunked SSD scan, for Hopper (sm_90a).
//
// For y, final = ssd(x, dt, A, B, C) from a zero state (csrc/ssd_scan.cu;
// the algorithm of kernels/ssd_scan/ref.py::ssd_chunked) and the
// gradients dy and d(final) (null: zero, as in training), it computes dx,
// d(dt), dA, dB and dC.  Per chunk c of q steps, with dtx_s = dt_s x_s, L
// the in-chunk cumsum of dt A, h_c the state before the chunk and G_c the
// gradient of the state after it:
//
//   1. ssd_bwd_states, one block per (chunk, head, batch): L, and the
//      chunk's two local sums S_c = sum_s e^{L_end - L_s} dtx_s B_s^T and
//      U_c = sum_t e^{L_t} dy_t C_t^T (p x n each);
//   2. ssd_bwd_recur, one thread per state element: the states in order,
//      h_{c+1} = e^{L_end} h_c + S_c, and the gradients in reverse,
//      G_{c-1} = e^{L_end} G_c + U_c, each written over its sum;
//   3. ssd_bwd_chunk, one block per (chunk, head, batch), with h_c and G_c
//      from pass 2: in tiles of `ts` steps, for s <= t in the chunk with
//      W_ts = e^{L_t - L_s} (formed only on and below the diagonal, where
//      it is at most 1) and DD_ts = dy_t.dtx_s,
//        d(dtx)_s = sum_t (C_t.B_s) W_ts dy_t + e^{L_end - L_s} G_c B_s,
//        dB_s    += sum_t W_ts DD_ts C_t + e^{L_end - L_s} G_c^T dtx_s,
//        dC_t    += sum_s W_ts DD_ts B_s + e^{L_t} h_c^T dy_t,
//      and the gradient of L: sum_s M_ts - sum_s M_st with M_ts =
//      (C_t.B_s) W_ts DD_ts, + e^{L_t} dy_t.h_c C_t - Q_t with Q_s =
//      e^{L_end - L_s} dtx_s.G_c B_s, the last step adding sum_s Q_s +
//      e^{L_end} <G_c, h_c>; its reverse cumsum is d(dt A), whence
//      dx = dt d(dtx), d(dt) = x.d(dtx) + A d(dt A) and the chunk's part
//      of dA, sum_s dt_s d(dt A)_s.  Loop A walks the s tiles (the t tiles
//      at or after each), loop B the t tiles (the s tiles at or before);
//      dB and dC are written per head;
//   4. ssd_bwd_reduce_bc and ssd_bwd_reduce_a: B and C are shared by all
//      heads, and A by all (batch, step), so dB and dC sum the per-head
//      parts over the heads, and dA the per-(batch, chunk) parts, in a
//      fixed order.
//
// The tail past S is padded with dt = 0 steps (x, B, C and dy zero), as
// the forward pads it: L stays flat there, nothing there is written, and
// dt = 0 keeps those steps out of dA.  No atomics and every sum in a fixed
// order: the same inputs give the same bits at any batch size.
//
// Replaces no TPU kernel: the JAX package differentiates its plain XLA
// scan (src/repro/models/ssm.py::ssd_chunked); this is the backward of the
// function that src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas
// computes, so that a loss through the port's forward kernel trains on the
// card.  The chunk states are recomputed (pass 1) rather than saved by
// the forward, so serving's forward is untouched.
//
// Bound on this card, at the Zamba2 LM training step's (b 4, s 1024, h 64,
// p 64, n 64, chunk 256, bf16): x, dy, dx (b s h p) and B, C, dB, dC
// (b s n) once in bf16, dt and d(dt) in float32, 105 MB, 31.3 us at
// 3.35 TB/s; the algorithm's products done once, 28.1 GFLOP, 28.4 us at
// the bf16 tensor rate: bytes bind (chip_smoke.py ssd_bwd_bound).
//
// Two variants; kernel.py's ``choose_variant_backward`` picks one from
// dtype, shape and alignment alone:
//
// * wgmma (bf16, head dim 64, state 64 or 128, chunk <= 1024, 16-byte
//   aligned x, B, C and dy: LM training and the DiT's gradient).  Passes
//   1 and 3 are one warpgroup of 128 threads per (chunk, head, batch),
//   walking the chunk in 64-step tiles loaded by TMA with the forward's
//   tensor maps (dy through x's); steps past the chunk are masked, steps
//   past S arrive as zeros.  Pass 1 forms S_c and U_c with p as wgmma's
//   M: the scaled x and dy are A fragments in registers, B and C
//   MN-major.  Pass 3 visits each (s tile, t tile >= s tile) pair once,
//   s as M: BC = B_s C_t^T and XY = x_s dy_t^T from the bf16 inputs; W,
//   DD = dt_s XY, M and its row and column sums (into dL: the row sums
//   by the accumulator rows' lanes, the column sums by a fixed shuffle
//   and warp order) on the float32 accumulators; then d(dtx)_s +=
//   (W o CB)^T dy_t and dB_s += (W o DD)^T C_t with A in registers, and
//   dC_t += (W o DD) B_s with (W o DD)^T staged in shared memory as an
//   MN-major A.  d(dtx) and dB stay in registers across an s tile's
//   pairs; dC's accumulator waits in the dC parts' scratch (dcp, this
//   block's own rows) between its t tile's visits, so any chunk and
//   state fit.  The state terms are wgmma too: G B_s^T and x_s G on an s
//   tile's first pair, dy_t h on a t tile's first (G and h in shared
//   memory); Q_s and the h.C term are row dots of their float32
//   accumulators.  The scalings (e^{L_end - L_s}, dt_s, e^{L_t}) multiply
//   float32 accumulators.  Precision: the inputs go to the tensor cores
//   as they are; every float32 intermediate operand (W o CB, W o DD, G,
//   h, and pass 1's dt e^{L_end - L} x and e^{L} dy) as a bf16 hi part
//   plus a bf16 lo part, two wgmmas: with one bf16 part the CPU rounding
//   model (tests/test_torch_bwd_variants.py) reads up to 9.0e-3 of
//   chip_smoke.py's 1e-2 (dB at the DiT's shape) and dA, whose sums
//   cancel, a hundredfold worse; with two, every gradient row is within
//   2.7e-3 and dA within 6.4e-5.  C.B is formed again in every head
//   block: measured, it costs 0.040 ms of a 0.539 ms launch
//   (scripts/torch_bwd_kernel_profile.py), while a table formed once per
//   (batch, chunk) would be read back by the 64 heads' blocks, 164 MB of
//   L2 traffic a launch, no cheaper.  Passes 2 and 4 are the simt
//   variant's.
// * simt (float32, or bf16 at other head dims and states or
//   misaligned): the first design.  Float32 products on the CUDA cores
//   (csrc/simt_tile.cuh) from padded shared memory, in tiles of
//   pick_tile's steps; loops A and B of pass 3 both form C.B and dy.dtx.
//
// Measured on an H100 80GB HBM3 at 700 W at the step's shapes (PERF.md
// section 6, row 4b; chip_smoke.py and scripts/torch_bwd_kernel_profile.py):
// wgmma 0.537 ms a launch (pass 3 0.389 ms, pass 4 0.054 ms, pass 1 0.049
// ms, pass 2 0.040 ms), 5.8% of the bound's rate; simt 5.45 ms, 0.6%,
// pass 3 nine tenths of it.

#include "hopper.cuh"
#include "simt_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using simt::gemm;
using simt::kThreads;
using simt::to_f32;

constexpr int kMaxDim = 128;             // head dim and state

// float offsets of pass 3's shared memory (pick_tile sizes the tile by
// its total)
struct ChunkSmem {
  int L, dL, xdd, red, qrow, misc, xs, dys, acc1, bs, cs, acc2, cb, dd, gh,
      total;
  __host__ __device__ ChunkSmem(int q, int ts, int p, int n) {
    const int ldp = p + 1, ldn = n + 1, ldt = ts + 1;
    L = 0;
    dL = L + q;
    xdd = dL + q;
    red = xdd + q;
    qrow = red + kThreads;
    misc = qrow + ts;
    xs = misc + 2;
    dys = xs + ts * ldp;
    acc1 = dys + ts * ldp;
    bs = acc1 + ts * ldp;
    cs = bs + ts * ldn;
    acc2 = cs + ts * ldn;
    cb = acc2 + ts * ldn;
    dd = cb + ts * ldt;
    gh = dd + ts * ldt;
    total = gh + p * ldn;
  }
};

__host__ __device__ inline int states_floats(int q, int ts, int p, int n) {
  return q + ts * (p + 1) + ts * (n + 1) + p * (n + 1);
}

// L of chunk c of head hh, batch bb into Ls[0, q): the in-chunk cumsum of
// dt A in order (thread 0), dt = 0 past S.  Passes 1 and 3 share it, so
// both see the same bits.
__device__ __forceinline__ void chunk_logdecay(float* Ls, const float* dt,
                                               float a, int64_t s0, int q,
                                               int S, int h, int hh,
                                               int bb) {
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < q; ++t) {
      const int64_t g = s0 + t;
      const float d = g < S ? dt[((int64_t)bb * S + g) * h + hh] : 0.f;
      run += d * a;
      Ls[t] = run;
    }
  }
  __syncthreads();
}

// rows [0, ts) of a (b, s, ., cols) tensor's tile at steps s0 + t0 + r of
// batch bb (column offset col0, row stride rs), times f(r) where given;
// zero past the chunk (r >= valid) and past S
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t rs, int64_t col0, int bb,
                                          int S, int64_t g0, int ts,
                                          int valid, int cols) {
  for (int e = threadIdx.x; e < ts * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    const int64_t g = g0 + r;
    dst[r * ld + c] = (r < valid && g < S)
        ? to_f32(src[((int64_t)bb * S + g) * rs + col0 + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const T* __restrict__ dy,
               float* __restrict__ st_s, float* __restrict__ st_u,
               float* __restrict__ lend, int S, int h, int p, int n, int q,
               int ts) {
  extern __shared__ float smem[];
  const int ldp = p + 1, ldn = n + 1;
  float* Ls = smem;
  float* xs = Ls + q;
  float* bs = xs + ts * ldp;
  float* acc = bs + ts * ldn;
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t s0 = (int64_t)c * q;
  chunk_logdecay(Ls, dt, A[hh], s0, q, S, h, hh, bb);
  const float Lend = Ls[q - 1];
  const int64_t st = (((int64_t)bb * nc + c) * h + hh) * p * n;
  if (threadIdx.x == 0) lend[((int64_t)bb * nc + c) * h + hh] = Lend;

  for (int which = 0; which < 2; ++which) {
    // which 0: S_c from dtx e^{L_end - L} and B; 1: U_c from dy e^{L}, C
    const T* left = which == 0 ? x : dy;
    const T* right = which == 0 ? B : C;
    for (int t0 = 0; t0 < q; t0 += ts) {
      const int valid = min(ts, q - t0);
      __syncthreads();                   // the last tile's reads are done
      load_tile(xs, ldp, left, (int64_t)h * p, (int64_t)hh * p, bb, S,
                s0 + t0, ts, valid, p);
      load_tile(bs, ldn, right, n, 0, bb, S, s0 + t0, ts, valid, n);
      __syncthreads();
      for (int e = threadIdx.x; e < ts * p; e += kThreads) {
        const int r = e / p, pp = e % p;
        const int64_t g = s0 + t0 + r;
        float f = 0.f;
        if (r < valid && g < S)
          f = which == 0
              ? dt[((int64_t)bb * S + g) * h + hh] * expf(Lend - Ls[t0 + r])
              : expf(Ls[t0 + r]);
        xs[r * ldp + pp] *= f;
      }
      __syncthreads();
      gemm(acc, ldn, xs, 1, ldp, bs, ldn, 1, p, n, ts, 1.f, t0 > 0);
    }
    __syncthreads();
    float* dst = which == 0 ? st_s : st_u;
    for (int e = threadIdx.x; e < p * n; e += kThreads)
      dst[st + e] = acc[(e / n) * ldn + e % n];
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_recur(float* __restrict__ st_s, float* __restrict__ st_u,
              const float* __restrict__ lend, const float* __restrict__ dfs,
              int nc, int h, int pn) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  if (e >= pn) return;
  // kRecur chunks' sums and decays are loaded before any is used, so
  // their loads are in flight together; the sums run in chunk order
  constexpr int kRecur = 8;
  float run = 0.f;                       // h_c: the state before chunk c
  for (int c0 = 0; c0 < nc; c0 += kRecur) {
    float sum[kRecur], decay[kRecur];
#pragma unroll
    for (int u = 0; u < kRecur; ++u)
      if (c0 + u < nc) {
        sum[u] = st_s[(((int64_t)bb * nc + c0 + u) * h + hh) * pn + e];
        decay[u] = expf(lend[((int64_t)bb * nc + c0 + u) * h + hh]);
      }
#pragma unroll
    for (int u = 0; u < kRecur; ++u)
      if (c0 + u < nc) {
        st_s[(((int64_t)bb * nc + c0 + u) * h + hh) * pn + e] = run;
        run = decay[u] * run + sum[u];
      }
  }
  run = dfs != nullptr ? dfs[((int64_t)bb * h + hh) * pn + e] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kRecur) {  // G_c: the gradient
    float sum[kRecur], decay[kRecur];             // after chunk c
#pragma unroll
    for (int u = 0; u < kRecur; ++u)
      if (c0 - u >= 0) {
        sum[u] = st_u[(((int64_t)bb * nc + c0 - u) * h + hh) * pn + e];
        decay[u] = expf(lend[((int64_t)bb * nc + c0 - u) * h + hh]);
      }
#pragma unroll
    for (int u = 0; u < kRecur; ++u)
      if (c0 - u >= 0) {
        st_u[(((int64_t)bb * nc + c0 - u) * h + hh) * pn + e] = run;
        run = decay[u] * run + sum[u];
      }
  }
}

// W, the masked products and the sums of M over one tile pair, in place:
// cb holds C_t.B_s and dd holds dy_t.dtx_s (rows t, columns s) on entry.
// by_col: loop A (cb <- cb W, dd <- W dd, dL[s] -= sum_t M_ts);
// otherwise loop B (dd <- W dd, dL[t] += sum_s M_ts).  Threads form
// groups of 256 / ts lanes, one group a column (row), each lane taking a
// strided share of the other index, summed by group_sum in a fixed order.
__device__ __forceinline__ void pair_weights(float* cb, float* dd, int ldt,
                                             const float* Ls, float* dL,
                                             int t0, int s0, int q, int ts,
                                             bool by_col) {
  const int width = kThreads / ts;
  const int own = threadIdx.x / width, lane = threadIdx.x % width;
  float sum = 0.f;
  for (int o = lane; o < ts; o += width) {
    const int t = by_col ? o : own, s = by_col ? own : o;
    const int gt = t0 + t, gs = s0 + s;
    const float w = (gt < q && gs < q && gt >= gs)
                        ? expf(Ls[gt] - Ls[gs]) : 0.f;
    const int idx = t * ldt + s;
    const float cbw = cb[idx] * w;
    sum += cbw * dd[idx];
    if (by_col) cb[idx] = cbw;
    dd[idx] *= w;
  }
  sum = simt::group_sum(sum, width);
  const int g = (by_col ? s0 : t0) + own;
  if (lane == 0 && g < q) dL[g] += by_col ? -sum : sum;
}

// sum_j a[r, j] b[r, j] over j < cols for the ts rows, by groups of lanes
// as in pair_weights; returns it to every lane of row r's group (rows at
// or past ts get 0)
__device__ __forceinline__ float row_dot(const float* a, int lda,
                                         const float* b, int ldb, int cols,
                                         int ts, int* row) {
  const int width = kThreads / ts;
  const int r = threadIdx.x / width, lane = threadIdx.x % width;
  float sum = 0.f;
  for (int j = lane; j < cols; j += width)
    sum += a[r * lda + j] * b[r * ldb + j];
  *row = r;
  return simt::group_sum(sum, width);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ B,
              const T* __restrict__ C, const T* __restrict__ dy,
              const float* __restrict__ st_h, const float* __restrict__ st_g,
              T* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ dbp, float* __restrict__ dcp,
              float* __restrict__ dap, int S, int h, int p, int n, int q,
              int ts) {
  extern __shared__ float smem[];
  const ChunkSmem o(q, ts, p, n);
  const int ldp = p + 1, ldn = n + 1, ldt = ts + 1;
  float *Ls = smem + o.L, *dL = smem + o.dL, *xdd = smem + o.xdd;
  float *red = smem + o.red, *qrow = smem + o.qrow, *misc = smem + o.misc;
  float *xs = smem + o.xs, *dys = smem + o.dys, *acc1 = smem + o.acc1;
  float *bs = smem + o.bs, *cs = smem + o.cs, *acc2 = smem + o.acc2;
  float *cb = smem + o.cb, *dd = smem + o.dd, *gh = smem + o.gh;

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int64_t s0 = (int64_t)c * q;
  const int64_t xrs = (int64_t)h * p, xcol = (int64_t)hh * p;
  const int64_t st = (((int64_t)bb * nc + c) * h + hh) * p * n;
  const float a = A[hh];
  for (int t = tid; t < q; t += kThreads) dL[t] = 0.f;
  if (tid == 0) misc[0] = 0.f;           // sum_s Q_s
  chunk_logdecay(Ls, dt, a, s0, q, S, h, hh, bb);
  const float Lend = Ls[q - 1];
  for (int e = tid; e < p * n; e += kThreads)
    gh[(e / n) * ldn + e % n] = st_g[st + e];          // G_c
  const int nt = (q + ts - 1) / ts;
  auto dt_at = [&](int64_t g) {
    return g < S ? dt[((int64_t)bb * S + g) * h + hh] : 0.f;
  };

  // loop A: s tiles; the state terms, then the t tiles at or after each
  for (int i = 0; i < nt; ++i) {
    const int si = i * ts, vi = min(ts, q - si);
    __syncthreads();
    load_tile(xs, ldp, x, xrs, xcol, bb, S, s0 + si, ts, vi, p);
    load_tile(bs, ldn, B, n, 0, bb, S, s0 + si, ts, vi, n);
    __syncthreads();
    for (int e = tid; e < ts * p; e += kThreads)
      xs[e / p * ldp + e % p] *= dt_at(s0 + si + e / p);   // dtx
    __syncthreads();
    gemm(acc1, ldp, bs, ldn, 1, gh, 1, ldn, ts, p, n, 1.f, false);  // G B_s
    gemm(acc2, ldn, xs, ldp, 1, gh, ldn, 1, ts, n, p, 1.f, false);  // G^T dtx
    __syncthreads();
    for (int e = tid; e < ts * (p + n); e += kThreads) {
      const int r = e < ts * p ? e / p : (e - ts * p) / n;
      const float f = r < vi ? expf(Lend - Ls[si + r]) : 0.f;
      if (e < ts * p) acc1[r * ldp + e % p] *= f;
      else acc2[r * ldn + (e - ts * p) % n] *= f;
    }
    __syncthreads();
    {
      int r;
      const float qv = row_dot(xs, ldp, acc1, ldp, p, ts, &r);
      if (tid % (kThreads / ts) == 0) {
        qrow[r] = qv;
        if (r < vi) dL[si + r] -= qv;
      }
    }
    for (int j = i; j < nt; ++j) {
      const int tj = j * ts, vj = min(ts, q - tj);
      __syncthreads();
      load_tile(cs, ldn, C, n, 0, bb, S, s0 + tj, ts, vj, n);
      load_tile(dys, ldp, dy, xrs, xcol, bb, S, s0 + tj, ts, vj, p);
      __syncthreads();
      gemm(cb, ldt, cs, ldn, 1, bs, 1, ldn, ts, ts, n, 1.f, false);
      gemm(dd, ldt, dys, ldp, 1, xs, 1, ldp, ts, ts, p, 1.f, false);
      __syncthreads();
      pair_weights(cb, dd, ldt, Ls, dL, tj, si, q, ts, true);
      __syncthreads();
      gemm(acc1, ldp, cb, 1, ldt, dys, ldp, 1, ts, p, ts, 1.f, true);
      gemm(acc2, ldn, dd, 1, ldt, cs, ldn, 1, ts, n, ts, 1.f, true);
    }
    __syncthreads();
    if (tid == 0) {
      float sq = misc[0];
      for (int r = 0; r < vi; ++r) sq += qrow[r];
      misc[0] = sq;
    }
    for (int e = tid; e < vi * p; e += kThreads) {
      const int r = e / p, pp = e % p;
      const int64_t g = s0 + si + r;
      if (g < S)
        dx[((int64_t)bb * S + g) * xrs + xcol + pp] =
            simt::from_f32<T>(dt_at(g) * acc1[r * ldp + pp]);
    }
    for (int e = tid; e < vi * n; e += kThreads) {
      const int r = e / n, nn = e % n;
      const int64_t g = s0 + si + r;
      if (g < S)
        dbp[(((int64_t)bb * S + g) * h + hh) * n + nn] = acc2[r * ldn + nn];
    }
    // x . d(dtx): reload x over dtx (the next tile reloads xs)
    __syncthreads();
    load_tile(xs, ldp, x, xrs, xcol, bb, S, s0 + si, ts, vi, p);
    __syncthreads();
    {
      int r;
      const float v = row_dot(xs, ldp, acc1, ldp, p, ts, &r);
      if (tid % (kThreads / ts) == 0 && r < vi) xdd[si + r] = v;
    }
  }

  // loop B: t tiles; the state term, then the s tiles at or before each
  __syncthreads();
  red[tid] = 0.f;
  for (int e = tid; e < p * n; e += kThreads) {
    const float hv = st_h[st + e];                      // h_c
    red[tid] += gh[(e / n) * ldn + e % n] * hv;        // <G_c, h_c>
    gh[(e / n) * ldn + e % n] = hv;
  }
  for (int j = 0; j < nt; ++j) {
    const int tj = j * ts, vj = min(ts, q - tj);
    __syncthreads();
    load_tile(cs, ldn, C, n, 0, bb, S, s0 + tj, ts, vj, n);
    load_tile(dys, ldp, dy, xrs, xcol, bb, S, s0 + tj, ts, vj, p);
    __syncthreads();
    gemm(acc2, ldn, dys, ldp, 1, gh, ldn, 1, ts, n, p, 1.f, false);  // h^T dy
    __syncthreads();
    for (int e = tid; e < ts * n; e += kThreads) {
      const int r = e / n;
      acc2[r * ldn + e % n] *= r < vj ? expf(Ls[tj + r]) : 0.f;
    }
    __syncthreads();
    {
      int r;
      const float v = row_dot(acc2, ldn, cs, ldn, n, ts, &r);
      if (tid % (kThreads / ts) == 0 && r < vj) dL[tj + r] += v;
    }
    for (int i = 0; i <= j; ++i) {
      const int si = i * ts, vi = min(ts, q - si);
      __syncthreads();
      load_tile(xs, ldp, x, xrs, xcol, bb, S, s0 + si, ts, vi, p);
      load_tile(bs, ldn, B, n, 0, bb, S, s0 + si, ts, vi, n);
      __syncthreads();
      for (int e = tid; e < ts * p; e += kThreads)
        xs[e / p * ldp + e % p] *= dt_at(s0 + si + e / p);
      __syncthreads();
      gemm(cb, ldt, cs, ldn, 1, bs, 1, ldn, ts, ts, n, 1.f, false);
      gemm(dd, ldt, dys, ldp, 1, xs, 1, ldp, ts, ts, p, 1.f, false);
      __syncthreads();
      pair_weights(cb, dd, ldt, Ls, dL, tj, si, q, ts, false);
      __syncthreads();
      gemm(acc2, ldn, dd, ldt, 1, bs, ldn, 1, ts, n, ts, 1.f, true);
    }
    __syncthreads();
    for (int e = tid; e < vj * n; e += kThreads) {
      const int r = e / n, nn = e % n;
      const int64_t g = s0 + tj + r;
      if (g < S)
        dcp[(((int64_t)bb * S + g) * h + hh) * n + nn] = acc2[r * ldn + nn];
    }
  }

  // the last step's terms, the reverse cumsum, d(dt) and the chunk's dA
  __syncthreads();
  if (tid == 0) {
    float dot = 0.f;
    for (int i = 0; i < kThreads; ++i) dot += red[i];
    dL[q - 1] += misc[0] + expf(Lend) * dot;
    float run = 0.f, da = 0.f;
    for (int t = q - 1; t >= 0; --t) {
      run += dL[t];
      dL[t] = run;
    }
    for (int t = 0; t < q; ++t) da += dt_at(s0 + t) * dL[t];
    dap[((int64_t)bb * nc + c) * h + hh] = da;
  }
  __syncthreads();
  for (int t = tid; t < q; t += kThreads) {
    const int64_t g = s0 + t;
    if (g < S) ddt[((int64_t)bb * S + g) * h + hh] = xdd[t] + a * dL[t];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_bc(const float* __restrict__ dbp,
                  const float* __restrict__ dcp, T* __restrict__ dB,
                  T* __restrict__ dC, int64_t rows, int h, int n) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * n) return;
  const int64_t row = e / n, nn = e % n;
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    sb += dbp[(row * h + hh) * n + nn];
    sc += dcp[(row * h + hh) * n + nn];
  }
  dB[e] = simt::from_f32<T>(sb);
  dC[e] = simt::from_f32<T>(sc);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_a(const float* __restrict__ dap, float* __restrict__ dA,
                 int parts, int h) {
  const int hh = blockIdx.x * kThreads + threadIdx.x;
  if (hh >= h) return;
  float s = 0.f;
  for (int i = 0; i < parts; ++i) s += dap[(int64_t)i * h + hh];
  dA[hh] = s;
}

// The tile: the largest of 64, 32, 16 and 8 steps, at most max(q, 8),
// whose pass-3 shared memory fits a block of the current device (pass 1
// needs less); 0 when none does.
int pick_tile(int q, int p, int n) {
  int dev = 0, smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  for (int ts = 64; ts >= 8; ts /= 2)
    if (ts <= (q > 8 ? q : 8) &&
        (size_t)ChunkSmem(q, ts, p, n).total * sizeof(float) <= (size_t)smem)
      return ts;
  return 0;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const void* dy,
                   const float* dfs, void* dx, float* ddt, float* dA,
                   void* dB, void* dC, float* st_s, float* st_u, float* lend,
                   float* dbp, float* dcp, float* dap, int b, int S, int h,
                   int p, int n, int q, int ts, cudaStream_t stream) {
  const int nc = (S + q - 1) / q;
  const size_t states_bytes = states_floats(q, ts, p, n) * sizeof(float);
  const size_t chunk_bytes = ChunkSmem(q, ts, p, n).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)states_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)chunk_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)nc, (unsigned)h, (unsigned)b);
  ssd_bwd_states<T><<<grid, kThreads, states_bytes, stream>>>(
      (const T*)x, dt, A, (const T*)B, (const T*)C, (const T*)dy, st_s, st_u,
      lend, S, h, p, n, q, ts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 rgrid((unsigned)((p * n + kThreads - 1) / kThreads),
                   (unsigned)h, (unsigned)b);
  ssd_bwd_recur<<<rgrid, kThreads, 0, stream>>>(st_s, st_u, lend, dfs, nc,
                                                h, p * n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk<T><<<grid, kThreads, chunk_bytes, stream>>>(
      (const T*)x, dt, A, (const T*)B, (const T*)C, (const T*)dy, st_s, st_u,
      (T*)dx, ddt, dbp, dcp, dap, S, h, p, n, q, ts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t rows = (int64_t)b * S;
  ssd_bwd_reduce_bc<T><<<(unsigned)((rows * n + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(dbp, dcp, (T*)dB, (T*)dC,
                                                rows, h, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_reduce_a<<<(unsigned)((h + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(dap, dA, b * nc, h);
  return cudaGetLastError();
}


// ---- bfloat16: wgmma, TMA ----------------------------------------------------
namespace wg {

constexpr int kT = 64;                   // steps a tile
constexpr int kP = 64;                   // head dim
constexpr int kThreads = 128;            // one warpgroup
constexpr int kRowBytes = 128;           // 64 bf16 values: the swizzle width
constexpr int kBox = kT * kRowBytes;     // one TMA box, 64 rows (8 KB)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxChunk = 1024;          // L and the per-step sums fit
constexpr size_t kMaxSmem = 232448;

template <int N>
struct Geo {
  static constexpr int kBC = N / 64 * kBox;              // B or C; a state
  // pass 1: two ring stages of x, dy, B and C
  static constexpr int kStage1 = 2 * kBox + 2 * kBC;
  // pass 3: the s tile (x, B), two t stages (C, dy), G and h as hi and lo
  // bf16 parts, (W o DD)^T as hi and lo
  static constexpr int kSTile = kBox + kBC;
  static constexpr int kTStage = kBC + kBox;
  static constexpr int kFixed3 = kSTile + 2 * kTStage + 4 * kBC + 2 * kBox;
  // alignment slack, the tiles, L and dt (q floats each), three mbarriers
  static size_t smem1(int q) {
    return 1024 + 2 * (size_t)kStage1 + 2 * (size_t)q * 4 + 3 * 8;
  }
  // alignment slack, the tiles, L, dt, the two halves of dL, x.d(dtx) and
  // Q (q floats each), the column sums of four warps, <G, h>'s partial
  // sums, three mbarriers
  static size_t smem3(int q) {
    return 1024 + (size_t)kFixed3 + (6 * (size_t)q + 4 * 64 + 8) * 4 + 3 * 8;
  }
  static_assert(1024 + kFixed3 + (6 * kMaxChunk + 4 * 64 + 8) * 4 + 3 * 8 <=
                    kMaxSmem, "ssd bwd wgmma tiles exceed shared memory");
};

__device__ __forceinline__ float bf_at(const unsigned char* tile, int row,
                                       int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + hopper::swz(row, col)));
}

// the sum of v over the four lanes of a quad (one accumulator row), in a
// fixed order; every lane of the quad gets it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D(64 x N) += A(64 x 16, registers) B(16 x N, MN-major)
template <int N>
__device__ __forceinline__ void acc_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_m64n64k16_rs_t1(d, a, db);
  else hopper::wgmma_m64n128k16_rs_t1(d, a, db);
}

// D(64 x N) += A(64 x 16, smem) B(16 x N, MN-major), A MN-major when TA
template <int N, int TA>
__device__ __forceinline__ void acc_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_m64n64k16_ss<TA, 1>(d, da, db);
  else hopper::wgmma_m64n128k16_ss<TA, 1>(d, da, db);
}

// dt of the chunk's q steps (0 past S) into dts and L = cumsum(dt·a)
// into Ls: warp 0 scans 32 steps at a time (a shuffle scan, then the
// carry), the same order in passes 1 and 3
__device__ __forceinline__ void chunk_logdecay(float* Ls, float* dts,
                                               const float* dt, float a,
                                               int64_t s0, int q, int S,
                                               int h, int hh, int bb) {
  for (int t = threadIdx.x; t < q; t += kThreads) {
    const int64_t g = s0 + t;
    dts[t] = g < S ? dt[((int64_t)bb * S + g) * h + hh] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int t0 = 0; t0 < q; t0 += 32) {
      const int t = t0 + lane;
      float v = t < q ? dts[t] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (t < q) Ls[t] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// pass 1: S_c = sum_s (dt_s e^{L_end - L_s} x_s)^T B_s and U_c = sum_t
// (e^{L_t} dy_t)^T C_t, rows p: the scaled x and dy are A fragments split
// into bf16 hi and lo parts, B and C MN-major from the ring
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_wg(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap dy_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap c_map,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ st_s, float* __restrict__ st_u,
                  float* __restrict__ lend, int S, int h, int q) {
  using namespace hopper;
  using G = Geo<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* Ls = reinterpret_cast<float*>(ring + 2 * G::kStage1);
  float* dts = Ls + q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(dts + q + (q & 1));

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, nt = (q + kT - 1) / kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t s0 = (int64_t)c * q;
  // tile kt: x, dy, B, C of steps s0 + 64 kt on
  const CUtensorMap *xm = &x_map, *dym = &dy_map, *bm = &b_map, *cm = &c_map;
  auto issue = [&](int kt) {
    unsigned char* dst = ring + (kt & 1) * G::kStage1;
    uint64_t* b_ = &bar[kt & 1];
    const int row = (int)(s0 + kt * kT);
    mbar_expect_tx(b_, G::kStage1);
    tma_load_3d(dst, xm, b_, hh * kP, row, bb);
    tma_load_3d(dst + kBox, dym, b_, hh * kP, row, bb);
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      tma_load_3d(dst + 2 * kBox + j * kBox, bm, b_, j * 64, row, bb);
      tma_load_3d(dst + 2 * kBox + G::kBC + j * kBox, cm, b_, j * 64, row,
                  bb);
    }
  };
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < 2 && kt < nt; ++kt) issue(kt);
  chunk_logdecay(Ls, dts, dt, A[hh], s0, q, S, h, hh, bb);
  const float l_end = Ls[q - 1];
  if (tid == 0) lend[((int64_t)bb * nc + c) * h + hh] = l_end;

  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float sacc[N / 2], uacc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sacc[i] = uacc[i] = 0.f;
  for (int kt = 0; kt < nt; ++kt) {
    const unsigned char* xs = ring + (kt & 1) * G::kStage1;
    const unsigned char* dys = xs + kBox;
    const unsigned char* bs = xs + 2 * kBox;
    const unsigned char* cs = bs + G::kBC;
    // this thread's steps 16k + 8 half + cq + {0, 1} of the tile: their
    // weights (0 past the chunk)
    float ws[16], es[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int sl = kt * kT + 16 * (i / 4) + 8 * ((i / 2) % 2) + cq + i % 2;
      const bool ok = sl < q;
      ws[i] = ok ? dts[sl] * exp2_ftz((l_end - Ls[sl]) * kLog2e) : 0.f;
      es[i] = ok ? exp2_ftz(Ls[sl] * kLog2e) : 0.f;
    }
    mbar_wait(&bar[kt & 1], (kt >> 1) & 1);
    // A fragments (rows p, columns the tile's steps), hi and lo
    uint32_t xh[4][4], xl[4][4], yh[4][4], yl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int st = 16 * k + 8 * half + cq, i = 4 * k + 2 * half;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int p = r0 + 8 * qq;
          split_bf16(ws[i] * bf_at(xs, st, p), ws[i + 1] * bf_at(xs, st + 1, p),
                     xh[k][2 * half + qq], xl[k][2 * half + qq]);
          split_bf16(es[i] * bf_at(dys, st, p),
                     es[i + 1] * bf_at(dys, st + 1, p),
                     yh[k][2 * half + qq], yl[k][2 * half + qq]);
        }
      }
    fence_regs(sacc);
    fence_regs(uacc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_rs<N>(sacc, xh[k], mnmajor_desc<kRowBytes>(bs, k));
      acc_rs<N>(sacc, xl[k], mnmajor_desc<kRowBytes>(bs, k));
      acc_rs<N>(uacc, yh[k], mnmajor_desc<kRowBytes>(cs, k));
      acc_rs<N>(uacc, yl[k], mnmajor_desc<kRowBytes>(cs, k));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(uacc);
    fence_regs(xh);
    fence_regs(xl);
    fence_regs(yh);
    fence_regs(yl);
    if (kt + 2 < nt) {                   // refill the stage just consumed
      __syncthreads();
      if (tid == 0) issue(kt + 2);
    }
  }
  const int64_t base = (((int64_t)bb * nc + c) * h + hh) * kP * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = base + (int64_t)(r0 + 8 * r) * N + 8 * j + cq;
      *reinterpret_cast<float2*>(st_s + at) =
          make_float2(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(st_u + at) =
          make_float2(uacc[4 * j + 2 * r], uacc[4 * j + 2 * r + 1]);
    }
}

// pass 3, one block per (chunk, head, batch): the s tiles in order (the s
// tile single-buffered, its x and B by TMA), for each the t tiles at or
// after it (C and dy by TMA in a two-stage ring).  Per tile pair, with s
// as M: BC = B_s C_t^T and XY = x_s dy_t^T on wgmma from the bf16 inputs;
// W, DD = dt_s XY, M and the products' A operands in registers; then
// d(dtx)_s += (W o CB)^T dy_t and dB_s += (W o DD)^T C_t in registers and
// dC_t += (W o DD) B_s from (W o DD)^T staged in shared memory (A
// MN-major), its accumulator kept in the dC parts' scratch (dcp) between
// visits.  The state terms: G B_s^T and x_s G (on the s tile's first
// pair), dy_t h (on the t tile's first pair).
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_wg(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap dy_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap c_map,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ st_h,
                 const float* __restrict__ st_g,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dbp, float* __restrict__ dcp,
                 float* __restrict__ dap, int S, int h, int q) {
  using namespace hopper;
  using G = Geo<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = xs + kBox;                   // the s tile: x, B
  unsigned char* tring = xs + G::kSTile;           // two stages: C, dy
  unsigned char* gt = tring + 2 * G::kTStage;      // G hi, G lo
  unsigned char* ht = gt + 2 * G::kBC;             // h hi, h lo
  unsigned char* wt = ht + 2 * G::kBC;             // (W o DD)^T hi, lo
  float* Ls = reinterpret_cast<float*>(wt + 2 * kBox);
  float* dts = Ls + q;
  float* dLr = dts + q;        // dL's terms summed by accumulator rows
  float* dLc = dLr + q;        // and by columns (the sums of M over s)
  float* xdd = dLc + q;        // x_s . d(dtx)_s
  float* qv = xdd + q;         // Q_s
  float* red = qv + q;         // 4 warps x 64 column sums
  float* misc = red + 4 * 64;  // <G, h>'s partial sums of the four warps
  uint64_t* bar = reinterpret_cast<uint64_t*>(misc + 8);

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, nt = (q + kT - 1) / kT;
  const int npairs = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t s0 = (int64_t)c * q;
  const int64_t st = (((int64_t)bb * nc + c) * h + hh) * kP * N;
  const float a = A[hh];
  // the t tile of pair pi (pairs in order: s tile i, t tiles i .. nt - 1)
  auto pair_t = [&](int pi) {
    int i = 0;
    while (pi >= nt - i) pi -= nt - i++;
    return i + pi;
  };
  const CUtensorMap *xm = &x_map, *dym = &dy_map, *bm = &b_map, *cm = &c_map;
  auto issue_t = [&](int pi) {
    unsigned char* dst = tring + (pi & 1) * G::kTStage;
    uint64_t* b_ = &bar[1 + (pi & 1)];
    const int row = (int)(s0 + pair_t(pi) * kT);
    mbar_expect_tx(b_, G::kTStage);
#pragma unroll
    for (int j = 0; j < N / 64; ++j)
      tma_load_3d(dst + j * kBox, cm, b_, j * 64, row, bb);
    tma_load_3d(dst + G::kBC, dym, b_, hh * kP, row, bb);
  };
  auto issue_s = [&](int i) {
    const int row = (int)(s0 + i * kT);
    mbar_expect_tx(&bar[0], G::kSTile);
    tma_load_3d(xs, xm, &bar[0], hh * kP, row, bb);
#pragma unroll
    for (int j = 0; j < N / 64; ++j)
      tma_load_3d(bs + j * kBox, bm, &bar[0], j * 64, row, bb);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    issue_s(0);
    for (int pi = 0; pi < 2 && pi < npairs; ++pi) issue_t(pi);
  }

  // G_c and h_c: bf16 hi and lo parts in swizzled (p, n) tiles, and
  // <G_c, h_c> in float32
  {
    float gh = 0.f;
    for (int e = tid; e < kP * N / 2; e += kThreads) {
      const int p = e / (N / 2), n = 2 * (e % (N / 2));
      const float2 g = *reinterpret_cast<const float2*>(st_g + st + p * N + n);
      const float2 v = *reinterpret_cast<const float2*>(st_h + st + p * N + n);
      gh += g.x * v.x + g.y * v.y;
      uint32_t hi, lo;
      split_bf16(g.x, g.y, hi, lo);
      *reinterpret_cast<uint32_t*>(gt + swz(p, n)) = hi;
      *reinterpret_cast<uint32_t*>(gt + G::kBC + swz(p, n)) = lo;
      split_bf16(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(ht + swz(p, n)) = hi;
      *reinterpret_cast<uint32_t*>(ht + G::kBC + swz(p, n)) = lo;
    }
    for (int o = 16; o > 0; o >>= 1)
      gh += __shfl_xor_sync(0xffffffffu, gh, o);
    if (lane == 0) misc[warp] = gh;
    for (int t = tid; t < q; t += kThreads) dLr[t] = dLc[t] = 0.f;
    fence_proxy_async();
  }
  chunk_logdecay(Ls, dts, dt, a, s0, q, S, h, hh, bb);  // syncs the block
  const float l_end = Ls[q - 1];

  // accumulator rows r0 and r0 + 8 (s with s as M, t with t as M);
  // columns 8j + cq + {0, 1}
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int pi = 0;
  for (int i = 0; i < nt; ++i) {
    const int si = i * kT;
    float es[2], dts_r[2];               // e^{L_end - L_s}, dt_s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sl = si + r0 + 8 * r;
      const bool ok = sl < q;
      es[r] = ok ? exp2_ftz((l_end - Ls[sl]) * kLog2e) : 0.f;
      dts_r[r] = ok ? dts[sl] : 0.f;
    }
    float dtx[32], dba[N / 2];
#pragma unroll
    for (int k = 0; k < 32; ++k) dtx[k] = 0.f;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) dba[k] = 0.f;
    mbar_wait(&bar[0], i & 1);

    for (int j = i; j < nt; ++j, ++pi) {
      const int tj = j * kT;
      const unsigned char* cs = tring + (pi & 1) * G::kTStage;
      const unsigned char* dys = cs + G::kBC;
      // dC_t so far (0 on the t tile's first pair), rows t < q and < S
      float dc[N / 2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tl = tj + r0 + 8 * r;
        const bool ok = i > 0 && tl < q && s0 + tl < S;
        const float* src = dcp + (((int64_t)bb * S + s0 + tl) * h + hh) * N;
#pragma unroll
        for (int k = 0; k < N / 8; ++k) {
          const float2 v = ok ? *reinterpret_cast<const float2*>(
                                    src + 8 * k + cq)
                              : make_float2(0.f, 0.f);
          dc[4 * k + 2 * r] = v.x;
          dc[4 * k + 2 * r + 1] = v.y;
        }
      }
      // L of this thread's 2 s rows
      float ls[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ls[r] = Ls[min(si + r0 + 8 * r, q - 1)];

      float bc[32], xy[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) bc[k] = xy[k] = 0.f;
      fence_regs(bc);
      fence_regs(xy);
      fence_regs(dtx);
      fence_regs(dba);
      fence_regs(dc);
      mbar_wait(&bar[1 + (pi & 1)], (pi >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < N / 16; ++k)
        wgmma_m64n64k16_ss_t0(bc, kmajor_desc<kRowBytes>(bs, k),
                              kmajor_desc<kRowBytes>(cs, k));
#pragma unroll
      for (int k = 0; k < kP / 16; ++k)
        wgmma_m64n64k16_ss_t0(xy, kmajor_desc<kRowBytes>(xs, k),
                              kmajor_desc<kRowBytes>(dys, k));
      if (j == i) {                      // G B_s^T into d(dtx), x_s G into dB
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int k = 0; k < N / 16; ++k)
            wgmma_m64n64k16_ss_t0(
                dtx, kmajor_desc<kRowBytes>(bs, k),
                kmajor_desc<kRowBytes>(gt + part * G::kBC, k));
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int k = 0; k < kP / 16; ++k)
            acc_ss<N, 0>(dba, kmajor_desc<kRowBytes>(xs, k),
                         mnmajor_desc<kRowBytes>(gt + part * G::kBC, k));
      }
      if (i == 0) {                      // dy_t h into dC
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int k = 0; k < kP / 16; ++k)
            acc_ss<N, 0>(dc, kmajor_desc<kRowBytes>(dys, k),
                         mnmajor_desc<kRowBytes>(ht + part * G::kBC, k));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(bc);
      fence_regs(xy);
      fence_regs(dtx);
      fence_regs(dba);
      fence_regs(dc);

      if (j == i) {
        // Q_s = e^{L_end - L_s} dt_s x_s . (G B_s), then the state terms'
        // scalings
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            v += bf_at(xs, r0 + 8 * r, 8 * (k / 2) + cq + k % 2) *
                 dtx[4 * (k / 2) + 2 * r + k % 2];
          v = quad_sum(v) * es[r] * dts_r[r];
          const int sl = si + r0 + 8 * r;
          if (lane % 4 == 0 && sl < q) {
            dLr[sl] -= v;
            qv[sl] = v;
          }
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) dtx[k] *= es[(k / 2) % 2];
#pragma unroll
        for (int k = 0; k < N / 2; ++k)
          dba[k] *= es[(k / 2) % 2] * dts_r[(k / 2) % 2];
      }
      if (i == 0) {
        // e^{L_t} dy_t . (h C_t) into dL_t, e^{L_t} h^T dy_t into dC_t
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tl = tj + r0 + 8 * r;
          const float et = tl < q ? exp2_ftz(Ls[tl] * kLog2e) : 0.f;
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < N / 4; ++k)
            v += bf_at(cs, r0 + 8 * r, 8 * (k / 2) + cq + k % 2) *
                 dc[4 * (k / 2) + 2 * r + k % 2];
          v = quad_sum(v) * et;
          if (lane % 4 == 0 && tl < q) dLr[tl] += v;
#pragma unroll
          for (int k = 0; k < N / 8; ++k) {
            dc[4 * k + 2 * r] *= et;
            dc[4 * k + 2 * r + 1] *= et;
          }
        }
      }

      // W = e^{L_t - L_s} (s <= t < q, else 0), DD = dt_s XY, M = CB W DD
      // and its sums over t (rows) and s (columns: this thread's two rows,
      // then the warp's eight lane groups); bc <- W o CB and xy <- W o DD
      float rows[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tl = tj + 8 * k + cq + e;
          const float lt = tl < q ? Ls[tl] : 0.f;
          float col = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * k + 2 * r + e;
            const int sl = si + r0 + 8 * r;
            const float w =
                sl <= tl && tl < q
                    ? exp2_ftz(fminf(lt - ls[r], 0.f) * kLog2e)
                    : 0.f;
            const float dd = xy[idx] * dts_r[r];
            const float cbw = bc[idx] * w;
            const float m = cbw * dd;
            rows[r] += m;
            col += m;
            bc[idx] = cbw;
            xy[idx] = dd * w;
          }
          col += __shfl_xor_sync(0xffffffffu, col, 4);
          col += __shfl_xor_sync(0xffffffffu, col, 8);
          col += __shfl_xor_sync(0xffffffffu, col, 16);
          if (lane < 4) red[warp * 64 + 8 * k + cq + e] = col;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(rows[r]);
        const int sl = si + r0 + 8 * r;
        if (lane % 4 == 0 && sl < q) dLr[sl] -= v;
      }
      uint32_t ch[4][4], cl[4][4], dh[4][4], dl[4][4];
      split_frags(bc, ch, cl);
      split_frags(xy, dh, dl);
      // (W o DD)^T, rows s and columns t, as the A operand of dC (MN-major)
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split_bf16(xy[4 * k + 2 * r], xy[4 * k + 2 * r + 1], hi, lo);
          const int at = swz(r0 + 8 * r, 8 * k + cq);
          *reinterpret_cast<uint32_t*>(wt + at) = hi;
          *reinterpret_cast<uint32_t*>(wt + kBox + at) = lo;
        }
      fence_proxy_async();
      __syncthreads();                   // the staged tile and red
      if (tid < 64 && tj + tid < q)
        dLc[tj + tid] += red[tid] + red[64 + tid] + red[128 + tid] +
                         red[192 + tid];

      fence_regs(dtx);
      fence_regs(dba);
      fence_regs(dc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_m64n64k16_rs_t1(dtx, ch[k], mnmajor_desc<kRowBytes>(dys, k));
        wgmma_m64n64k16_rs_t1(dtx, cl[k], mnmajor_desc<kRowBytes>(dys, k));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc_rs<N>(dba, dh[k], mnmajor_desc<kRowBytes>(cs, k));
        acc_rs<N>(dba, dl[k], mnmajor_desc<kRowBytes>(cs, k));
      }
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc_ss<N, 1>(dc, mnmajor_desc<kRowBytes>(wt + part * kBox, k),
                       mnmajor_desc<kRowBytes>(bs, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dtx);
      fence_regs(dba);
      fence_regs(dc);
      fence_regs(ch);
      fence_regs(cl);
      fence_regs(dh);
      fence_regs(dl);
      // dC_t's part so far, kept in dcp between visits (only this thread
      // reads and writes these elements)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tl = tj + r0 + 8 * r;
        if (tl >= q || s0 + tl >= S) continue;
        float* dst = dcp + (((int64_t)bb * S + s0 + tl) * h + hh) * N;
#pragma unroll
        for (int k = 0; k < N / 8; ++k)
          *reinterpret_cast<float2*>(dst + 8 * k + cq) =
              make_float2(dc[4 * k + 2 * r], dc[4 * k + 2 * r + 1]);
      }
      __syncthreads();                   // the stage, wt and red are free
      if (tid == 0 && pi + 2 < npairs) issue_t(pi + 2);
    }

    // the s tile is done: dx = dt d(dtx), dB's part, x . d(dtx)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sl = si + r0 + 8 * r;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v += bf_at(xs, r0 + 8 * r, 8 * (k / 2) + cq + k % 2) *
             dtx[4 * (k / 2) + 2 * r + k % 2];
      v = quad_sum(v);
      if (sl >= q || s0 + sl >= S) continue;
      if (lane % 4 == 0) xdd[sl] = v;
      const int64_t row = ((int64_t)bb * S + s0 + sl) * h + hh;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        *reinterpret_cast<uint32_t*>(dx + row * kP + 8 * k + cq) =
            pack_bf16(dts_r[r] * dtx[4 * k + 2 * r],
                      dts_r[r] * dtx[4 * k + 2 * r + 1]);
#pragma unroll
      for (int k = 0; k < N / 8; ++k)
        *reinterpret_cast<float2*>(dbp + row * N + 8 * k + cq) =
            make_float2(dba[4 * k + 2 * r], dba[4 * k + 2 * r + 1]);
    }
    __syncthreads();                     // the s tile is free
    if (tid == 0 && i + 1 < nt) issue_s(i + 1);
  }

  // the last step's terms, the reverse cumsum of dL, d(dt) and the
  // chunk's dA, by warp 0 in 32-step segments from the end
  __syncthreads();
  if (warp == 0) {
    float sq = 0.f;
    for (int t = lane; t < q; t += 32) sq += qv[t];
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float gh = misc[0] + misc[1] + misc[2] + misc[3];
    const float last = sq + exp2_ftz(l_end * kLog2e) * gh;
    float carry = 0.f, da = 0.f;
    for (int t1 = q; t1 > 0; t1 -= 32) {
      const int t = t1 - 32 + lane;
      float v = t >= 0 ? dLr[t] + dLc[t] + (t == q - 1 ? last : 0.f) : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
      v += carry;
      carry = __shfl_sync(0xffffffffu, v, 0);
      if (t >= 0) {
        da += dts[t] * v;
        if (s0 + t < S)
          ddt[((int64_t)bb * S + s0 + t) * h + hh] = xdd[t] + a * v;
      }
    }
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) dap[((int64_t)bb * nc + c) * h + hh] = da;
  }
}

template <int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const void* dy,
                   const float* dfs, void* dx, float* ddt, float* dA,
                   void* dB, void* dC, float* st_s, float* st_u, float* lend,
                   float* dbp, float* dcp, float* dap, int b, int S, int h,
                   int q, const long long* x_geometry,
                   const long long* bc_geometry, cudaStream_t stream) {
  using G = Geo<N>;
  if (q < 1 || q > kMaxChunk) return cudaErrorInvalidValue;
  static int configured = 0;             // the largest chunk set so far
  if (q > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_states_wg<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::smem1(q));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk_wg<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::smem3(q));
    if (e != cudaSuccess) return e;
    configured = q;
  }
  CUtensorMap x_map, dy_map, b_map, c_map;
  if (!hopper::encode_map(&x_map, x, x_geometry) ||
      !hopper::encode_map(&dy_map, dy, x_geometry) ||
      !hopper::encode_map(&b_map, B, bc_geometry) ||
      !hopper::encode_map(&c_map, C, bc_geometry))
    return cudaErrorInvalidValue;
  const int nc = (S + q - 1) / q;
  const dim3 grid((unsigned)nc, (unsigned)h, (unsigned)b);
  ssd_bwd_states_wg<N><<<grid, kThreads, G::smem1(q), stream>>>(
      x_map, dy_map, b_map, c_map, dt, A, st_s, st_u, lend, S, h, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 rgrid((unsigned)((kP * N + simt::kThreads - 1) / simt::kThreads),
                   (unsigned)h, (unsigned)b);
  ssd_bwd_recur<<<rgrid, simt::kThreads, 0, stream>>>(st_s, st_u, lend, dfs,
                                                      nc, h, kP * N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk_wg<N><<<grid, kThreads, G::smem3(q), stream>>>(
      x_map, dy_map, b_map, c_map, dt, A, st_s, st_u, (__nv_bfloat16*)dx,
      ddt, dbp, dcp, dap, S, h, q);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t rows = (int64_t)b * S;
  ssd_bwd_reduce_bc<__nv_bfloat16>
      <<<(unsigned)((rows * N + simt::kThreads - 1) / simt::kThreads),
         simt::kThreads, 0, stream>>>(dbp, dcp, (__nv_bfloat16*)dB,
                                      (__nv_bfloat16*)dC, rows, h, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_reduce_a<<<(unsigned)((h + simt::kThreads - 1) / simt::kThreads),
                     simt::kThreads, 0, stream>>>(dap, dA, b * nc, h);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// variant: 0 = simt (float32), 1 = simt (bfloat16), 2 = wgmma (bfloat16,
// p 64, n 64 or 128, q <= 1024).  x, dy and dx are (b, S, h, p), dt and
// ddt (b, S, h) float32, A and dA (h,) float32, B, C, dB and dC (b, S, n),
// dfs null or (b, h, p, n) float32, all contiguous.  Scratch, float32:
// st_s and st_u (b, nc, h, p, n), lend and dap (b, nc, h), dbp and dcp
// (b, S, h, n), with nc = ceil(S / q).  q is the chunk, 1 <= p, n <= 128
// (checked by the Python wrapper); simt's tile is pick_tile's.  For wgmma,
// x_map (also dy's) and bc_map are the tensor maps' geometry (hopper.cuh
// ``encode_map``), computed by kernel.py as for the forward.  Returns the
// cudaError_t of the first launch that failed (0 on success),
// cudaErrorInvalidValue when no simt tile fits or the variant does not
// take the shape.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dfs, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* st_s, void* st_u, void* lend,
    void* dbp, void* dcp, void* dap, int b, int S, int h, int p, int n,
    int q, int variant, const long long* x_map, const long long* bc_map,
    void* stream) {
  if (p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || q < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dt_ = (const float*)dt;
  const float* A_ = (const float*)A;
  const float* dfs_ = (const float*)dfs;
  if (variant == 2) {
    if (p != wg::kP || x_map == nullptr || bc_map == nullptr)
      return (int)cudaErrorInvalidValue;
    if (n == 64)
      return (int)wg::launch<64>(
          x, dt_, A_, B, C, dy, dfs_, dx, (float*)ddt, (float*)dA, dB, dC,
          (float*)st_s, (float*)st_u, (float*)lend, (float*)dbp, (float*)dcp,
          (float*)dap, b, S, h, q, x_map, bc_map, s);
    if (n == 128)
      return (int)wg::launch<128>(
          x, dt_, A_, B, C, dy, dfs_, dx, (float*)ddt, (float*)dA, dB, dC,
          (float*)st_s, (float*)st_u, (float*)lend, (float*)dbp, (float*)dcp,
          (float*)dap, b, S, h, q, x_map, bc_map, s);
    return (int)cudaErrorInvalidValue;
  }
  const int ts = pick_tile(q, p, n);
  if (ts == 0) return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return (int)launch<float>(
        x, dt_, A_, B, C, dy, dfs_, dx, (float*)ddt, (float*)dA, dB, dC,
        (float*)st_s, (float*)st_u, (float*)lend, (float*)dbp, (float*)dcp,
        (float*)dap, b, S, h, p, n, q, ts, s);
  if (variant == 1)
    return (int)launch<__nv_bfloat16>(
        x, dt_, A_, B, C, dy, dfs_, dx, (float*)ddt, (float*)dA, dB, dC,
        (float*)st_s, (float*)st_u, (float*)lend, (float*)dbp, (float*)dcp,
        (float*)dap, b, S, h, p, n, q, ts, s);
  return (int)cudaErrorInvalidValue;
}

// The tile that ssd_scan_bwd_launch uses at chunk q, head dim p and state
// n on the current device; 0 when none fits.
extern "C" int ssd_scan_bwd_tile(int q, int p, int n) {
  return pick_tile(q, p, n);
}
