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
// card.  The first design: float32 products on the CUDA cores
// (csrc/simt_tile.cuh) from padded shared memory; the chunk states are
// recomputed (pass 1) rather than saved by the forward, so serving's
// forward is untouched.
//
// Bound on this card, at the Zamba2 LM training step's (b 4, s 1024, h 64,
// p 64, n 64, chunk 256, bf16): x, dy, dx (b s h p) and B, C, dB, dC
// (b s n) once in bf16, dt and d(dt) in float32, 105 MB, 31.3 us at
// 3.35 TB/s; the algorithm's products done once, 28.1 GFLOP, 28.4 us at
// the bf16 tensor rate: bytes bind (chip_smoke.py ssd_bwd_bound).  Loops
// A and B both form C.B and dy.dtx, C.B is formed again for every head
// though B and C are shared, and the products run on the CUDA cores'
// float32 rate: 5.5 ms a launch on an H100 80GB HBM3 at 700 W, 0.6% of
// the bound's rate, pass 3 nine tenths of it.

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
  float run = 0.f;                       // h_c: the state before chunk c
  for (int c = 0; c < nc; ++c) {
    const int64_t i = (((int64_t)bb * nc + c) * h + hh) * pn + e;
    const float sum = st_s[i];
    st_s[i] = run;
    run = expf(lend[((int64_t)bb * nc + c) * h + hh]) * run + sum;
  }
  run = dfs != nullptr ? dfs[((int64_t)bb * h + hh) * pn + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {    // G_c: the gradient after chunk c
    const int64_t i = (((int64_t)bb * nc + c) * h + hh) * pn + e;
    const float sum = st_u[i];
    st_u[i] = run;
    run = expf(lend[((int64_t)bb * nc + c) * h + hh]) * run + sum;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC).  x, dy and
// dx are (b, S, h, p), dt and ddt (b, S, h) float32, A and dA (h,)
// float32, B, C, dB and dC (b, S, n), dfs null or (b, h, p, n) float32,
// all contiguous.  Scratch, float32: st_s and st_u (b, nc, h, p, n), lend
// and dap (b, nc, h), dbp and dcp (b, S, h, n), with nc = ceil(S / q).
// q is the chunk, 1 <= p, n <= 128 (checked by the Python wrapper); the
// tile is pick_tile's.  Returns the cudaError_t of the first launch that
// failed (0 on success), cudaErrorInvalidValue when no tile fits.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dfs, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* st_s, void* st_u, void* lend,
    void* dbp, void* dcp, void* dap, int b, int S, int h, int p, int n,
    int q, int dtype, void* stream) {
  const int ts = pick_tile(q, p, n);
  if (p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || q < 1 || ts == 0 ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(
        x, (const float*)dt, (const float*)A, B, C, dy, (const float*)dfs, dx,
        (float*)ddt, (float*)dA, dB, dC, (float*)st_s, (float*)st_u,
        (float*)lend, (float*)dbp, (float*)dcp, (float*)dap, b, S, h, p, n,
        q, ts, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        x, (const float*)dt, (const float*)A, B, C, dy, (const float*)dfs, dx,
        (float*)ddt, (float*)dA, dB, dC, (float*)st_s, (float*)st_u,
        (float*)lend, (float*)dbp, (float*)dcp, (float*)dap, b, S, h, p, n,
        q, ts, s);
  return (int)cudaErrorInvalidValue;
}

// The tile that ssd_scan_bwd_launch uses at chunk q, head dim p and state
// n on the current device; 0 when none fits.
extern "C" int ssd_scan_bwd_tile(int q, int p, int n) {
  return pick_tile(q, p, n);
}
