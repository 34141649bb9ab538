// Mamba-2 SSD chunked scan (h0 = 0), forward and backward, over
// contiguous x [Bs,T,H,hd], dt [Bs,T,H] fp32, A [H] fp32, B/C [Bs,T,S]
// (ngroups 1: B and C belong to the batch row, not the head).
//
// Replaces the TPU kernel ssd_scan_kernel of
// src/repro/kernels/ssd_scan/kernel.py, whose grid (batch, head, chunk)
// ran its chunk axis in order and carried the [hd,S] state in VMEM
// scratch from one grid step to the next. The JAX package differentiates
// the scan with XLA autodiff, so the backward has no TPU kernel of its
// own.
//
// Within a chunk of c rows with s = cumsum(dt * A) (c <= 128):
//   y_i = sum_{j<=i} (C_i.B_j) e^{s_i-s_j} dt_j x_j  +  e^{s_i} C_i h
//   h  <- e^{s_last} h + sum_j e^{s_last-s_j} dt_j x_j B_j^T
//
// Forward (fwd_kernel): blocks run in no order on Hopper, so the chunk
// loop lives inside the block: one block per (head, batch row) sweeps
// the chunks in order with the fp32 state in shared memory. Per chunk it
// stages B and dt*x in fp32, then walks the rows in tiles of 32: each
// tile stages its C rows, forms the decay-masked (C B^T) o L tile (only
// the columns at or left of the diagonal) and its y rows (intra plus
// inter-chunk terms). Then the state update. Each warp owns 4 rows of a
// tile and each lane 4 columns, so every shared-memory word read feeds 4
// multiply-adds; row strides are padded by one word, so the lanes of a
// warp hit distinct banks. C.B^T is computed per head, as in the TPU
// kernel, though every head of a row reads the same B and C. The state
// before each chunk is written out for the backward (168 MB at the
// training shape, about 0.05 ms of bandwidth).
//
// Backward, with dxd_j the gradient of dt_j x_j, P(t,j) = (C_t.B_j)
// e^{s_t-s_j} (dy_t.xd_j) for j <= t, and the carry R = sum over later
// rows t of e^{s_t - s_end} dy_t C_t^T [hd,S]; two kernels on one stream:
//  1. dc_kernel, one block per (chunk, head, batch row), from the
//     forward's saved state h before the chunk:
//       dC_t = sum_{j<=t} (dy_t.xd_j) e^{s_t-s_j} B_j + e^{s_t} h^T dy_t
//     (this head's part), and u_t = e^{s_t} C_t.(h^T dy_t), the pairs
//     (t, j before the chunk), into a scratch row.
//  2. bwd_scan_kernel, one block per (head, batch row), sweeps the chunks
//     in REVERSE order (the forward's structure, B and C swapped, time
//     reversed): per 32-row tile j, with M = (B_j.C_t) e^{s_t-s_j} and
//     N = (xd_j.dy_t) e^{s_t-s_j} for t >= j,
//       dxd_j = sum_t M dy_t + e^{s_end-s_j} R B_j     -> dx = dt dxd
//       dB_j  = sum_t N C_t + e^{s_end-s_j} R^T xd_j   (this head's part)
//     then ddt = A dloga + x.dxd, this block's part of dA = sum dt dloga,
//     and R <- e^{s_end} R + sum_t e^{s_t} dy_t C_t^T.
//     dloga_k is the sum of P(t,j) over the pairs j < k <= t, summed as
//     four parts: pairs inside the chunk (suffix sums of each row of P,
//     from the same tiles), t here and j before (u), j here and t after
//     (e^{s_end-s_j} xd_j.(R B_j)), j before and t after (e^{s_end}
//     <R, h>). The shorter formula dloga_k = sum_{t>=k} (dy_t.y_t -
//     xd_t.dxd_t) sums terms that cancel over the whole sequence: at the
//     training shape its fp32 error in dA reached 6e-4 of dA's largest
//     entry; the pair sums have none of that cancellation.
// The sums over heads (dB, dC) and over batch rows (dA) cross blocks:
// each block writes its own fp32 part and the wrapper sums them, so the
// result is deterministic; no atomics.
//
// Bound on the H100 at the training shape (Bs 4, T 2048, H 80, hd 64,
// S 128): bytes. The forward moves about 0.27 GB (y in fp32 is most of
// it) for about 54 GFLOP; this kernel runs its products on the CUDA
// cores in fp32, where that work, not the bytes, is its limit. A C.B^T
// shared by all heads and wgmma tiles are the later steps.
#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int CH = 128;           // largest chunk
constexpr int TI = 32;            // rows per tile
constexpr int RPW = TI / NW;      // tile rows per warp
constexpr unsigned FULL = 0xffffffffu;

// In-place inclusive prefix sum of v[0..n), n <= CH, by one warp (every
// lane calls it), from the back when ``rev``; returns the total to every
// lane.
__device__ float warp_cumsum(float* v, int n, bool rev) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    float& e = v[rev ? n - 1 - i : i];
    run += e;
    e = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) v[rev ? n - 1 - i : i] += excl;
  __syncwarp();
  return __shfl_sync(FULL, incl, 31);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Warp 0: dtv[0..ch) holds dt; fill sv = cumsum(dt * a), es = e^{sv},
// wv = e^{sv[ch-1] - sv}.
__device__ void chunk_decays(const float* dtv, float* sv, float* es,
                             float* wv, int ch, float a) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < ch; i += 32) sv[i] = dtv[i] * a;
  __syncwarp();
  warp_cumsum(sv, ch, false);
  const float s_end = sv[ch - 1];
  for (int i = lane; i < ch; i += 32) {
    es[i] = expf(sv[i]);
    if (wv) wv[i] = expf(s_end - sv[i]);
  }
}

// Stage rows [r0, r0 + nr) of a [rows, W] tensor (element offset of row
// r: base + r * stride) into dst[nr][W + 1] in fp32, zero at or past
// ``lim``.
template <int W, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           long long base, long long stride,
                                           int r0, int nr, int lim) {
  for (int e = threadIdx.x; e < nr * W; e += NT) {
    const int r = e / W, k = e % W;
    const int row = r0 + r;
    dst[r * (W + 1) + k] =
        row < lim ? to_f32(src[base + (long long)row * stride + k]) : 0.f;
  }
}

template <int HD, int S>
struct Smem {
  static constexpr int SP = S + 1, HP = HD + 1;
  static constexpr int fwd = CH * SP + CH * HP + HD * SP + TI * SP + TI * CH
                             + 4 * CH;
  static constexpr int bwd = CH * SP + CH * HP + HD * SP + TI * SP + TI * HP
                             + 3 * TI * CH + 8 * CH + NW;
  static constexpr int dc = CH * SP + CH * HP + HD * SP + TI * HP + TI * SP
                            + TI * CH + 3 * CH;
};

template <typename T, int HD, int S>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ hT, float* __restrict__ states, int Tn, int H,
           int ch) {
  constexpr int SP = S + 1, HP = HD + 1, DPT = HD / 32;
  constexpr int NG = NT / S, DPG = HD / NG;
  extern __shared__ float smem[];
  float* Bs = smem;                 // [CH][SP]  B of the chunk
  float* xd = Bs + CH * SP;         // [CH][HP]  dt * x of the chunk
  float* hs = xd + CH * HP;         // [HD][SP]  the state
  float* Ct = hs + HD * SP;         // [TI][SP]  C of the row tile
  float* G = Ct + TI * SP;          // [TI][CH]  (C B^T) o L of the tile
  float* dtv = G + TI * CH;         // [CH]
  float* sv = dtv + CH;
  float* es = sv + CH;
  float* wv = es + CH;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * RPW;
  const int sn = tid % S, d0 = (tid / S) * DPG;  // this thread's state cells
  const int nc = Tn / ch;
  const float a = A[h];
  for (int e = tid; e < HD * S; e += NT) hs[(e / S) * SP + e % S] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)b * Tn + (long long)c * ch;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < ch; i += NT) dtv[i] = dt[(row0 + i) * H + h];
    stage_rows<S>(Bs, Bm, row0 * S, S, 0, ch, ch);
    __syncthreads();
    for (int e = tid; e < ch * HD; e += NT) {
      const int j = e / HD, d = e % HD;
      xd[j * HP + d] = dtv[j] * to_f32(x[((row0 + j) * H + h) * HD + d]);
    }
    if (warp == 0) chunk_decays(dtv, sv, es, wv, ch, a);

    for (int i0 = 0; i0 < ch; i0 += TI) {
      __syncthreads();  // xd, sv ready; the previous tile is consumed
      stage_rows<S>(Ct, Cm, row0 * S, S, i0, TI, ch);
      __syncthreads();
      const int jmax = min(ch, i0 + TI);  // live columns of the tile
      const int kmax = (jmax + 31) / 32;
      {
        float acc[RPW][4];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[q][k] = 0.f;
        for (int n = 0; n < S; ++n) {
          float cr[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) cr[q] = Ct[(r0 + q) * SP + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < kmax) {
              const float bj = Bs[(lane + 32 * k) * SP + n];
#pragma unroll
              for (int q = 0; q < RPW; ++q) acc[q][k] += cr[q] * bj;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int i = i0 + r0 + q;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            if (k < kmax)
              G[(r0 + q) * CH + j] = (j <= i && i < ch)
                                         ? acc[q][k] * expf(sv[i] - sv[j])
                                         : 0.f;
          }
        }
      }
      __syncthreads();
      {
        float acc[RPW][DPT], inter[RPW][DPT];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
#pragma unroll
          for (int m = 0; m < DPT; ++m) acc[q][m] = inter[q][m] = 0.f;
        for (int j = 0; j < jmax; ++j) {
          float g[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) g[q] = G[(r0 + q) * CH + j];
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const float xv = xd[j * HP + lane + 32 * m];
#pragma unroll
            for (int q = 0; q < RPW; ++q) acc[q][m] += g[q] * xv;
          }
        }
        for (int n = 0; n < S; ++n) {
          float cr[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) cr[q] = Ct[(r0 + q) * SP + n];
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const float hv = hs[(lane + 32 * m) * SP + n];
#pragma unroll
            for (int q = 0; q < RPW; ++q) inter[q][m] += cr[q] * hv;
          }
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int i = i0 + r0 + q;
          if (i < ch) {
#pragma unroll
            for (int m = 0; m < DPT; ++m)
              y[((row0 + i) * H + h) * HD + lane + 32 * m] =
                  acc[q][m] + es[i] * inter[q][m];
          }
        }
      }
    }
    __syncthreads();  // every tile has read the old state
    {
      float acc[DPG];
#pragma unroll
      for (int q = 0; q < DPG; ++q) acc[q] = 0.f;
      for (int j = 0; j < ch; ++j) {
        const float bw = Bs[j * SP + sn] * wv[j];
#pragma unroll
        for (int q = 0; q < DPG; ++q) acc[q] += xd[j * HP + d0 + q] * bw;
      }
      const float dec = es[ch - 1];
      float* st = states + (((long long)b * H + h) * nc + c) * HD * S;
#pragma unroll
      for (int q = 0; q < DPG; ++q) {
        const int d = d0 + q;
        const float old = hs[d * SP + sn];
        st[d * S + sn] = old;
        hs[d * SP + sn] = old * dec + acc[q];
      }
    }
  }
  float* out = hT + ((long long)b * H + h) * HD * S;
#pragma unroll
  for (int q = 0; q < DPG; ++q)
    out[(d0 + q) * S + sn] = hs[(d0 + q) * SP + sn];
}

template <typename T, int HD, int S>
__global__ void __launch_bounds__(NT)
bwd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ states,
                const float* __restrict__ dy, const float* __restrict__ ub,
                T* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dAp, float* __restrict__ dBp, int Tn,
                int H, int ch) {
  constexpr int SP = S + 1, HP = HD + 1, DPT = HD / 32, SPT = S / 32;
  constexpr int NG = NT / S, DPG = HD / NG;
  extern __shared__ float smem[];
  float* Cs = smem;                 // [CH][SP]  C of the chunk
  float* dys = Cs + CH * SP;        // [CH][HP]  dy of the chunk
  float* Rs = dys + CH * HP;        // [HD][SP]  the reverse carry R
  float* Bt = Rs + HD * SP;         // [TI][SP]  B of the row tile
  float* xt = Bt + TI * SP;         // [TI][HP]  x of the row tile
  float* Mcb = xt + TI * HP;        // [TI][CH]
  float* Mdx = Mcb + TI * CH;       // [TI][CH]
  float* Qs = Mdx + TI * CH;        // [TI][CH]  suffix sums of P over t
  float* dtv = Qs + TI * CH;        // [CH] each below
  float* sv = dtv + CH;
  float* es = sv + CH;
  float* wv = es + CH;
  float* dlg = wv + CH;             // dloga, intra-chunk pairs first
  float* xdot = dlg + CH;
  float* uv = xdot + CH;
  float* vj = uv + CH;
  float* red = vj + CH;             // [NW]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * RPW;
  const int sn = tid % S, d0 = (tid / S) * DPG;
  const int nc = Tn / ch;
  const float a = A[h];
  double dA_acc = 0.0;              // warp 0: this block's dA, in fp64
  for (int e = tid; e < HD * S; e += NT) Rs[(e / S) * SP + e % S] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const long long row0 = (long long)b * Tn + (long long)c * ch;
    __syncthreads();  // the previous chunk (and R's update) is complete
    for (int i = tid; i < ch; i += NT) {
      dtv[i] = dt[(row0 + i) * H + h];
      uv[i] = ub[(row0 + i) * H + h];
      dlg[i] = 0.f;
    }
    stage_rows<S>(Cs, Cm, row0 * S, S, 0, ch, ch);
    stage_rows<HD>(dys, dy, (row0 * H + h) * HD, (long long)H * HD, 0, ch,
                   ch);
    __syncthreads();
    if (warp == 0) chunk_decays(dtv, sv, es, wv, ch, a);

    for (int j0 = 0; j0 < ch; j0 += TI) {
      __syncthreads();  // sv ready; the previous tile is consumed
      stage_rows<S>(Bt, Bm, row0 * S, S, j0, TI, ch);
      stage_rows<HD>(xt, x, (row0 * H + h) * HD, (long long)H * HD, j0, TI,
                     ch);
      __syncthreads();
      const int kmin = j0 / 32, kmax = (ch + 31) / 32;  // columns t >= j0
      {
        float acb[RPW][4], adx[RPW][4];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) acb[q][k] = adx[q][k] = 0.f;
        for (int n = 0; n < S; ++n) {
          float br[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) br[q] = Bt[(r0 + q) * SP + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= kmin && k < kmax) {
              const float cv = Cs[(lane + 32 * k) * SP + n];
#pragma unroll
              for (int q = 0; q < RPW; ++q) acb[q][k] += br[q] * cv;
            }
          }
        }
        for (int d = 0; d < HD; ++d) {
          float xr[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) xr[q] = xt[(r0 + q) * HP + d];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= kmin && k < kmax) {
              const float dv = dys[(lane + 32 * k) * HP + d];
#pragma unroll
              for (int q = 0; q < RPW; ++q) adx[q][k] += xr[q] * dv;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int j = j0 + r0 + q;
          const float dtj = j < ch ? dtv[j] : 0.f;
          float pv[4], seg[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = lane + 32 * k;
            const bool live = t >= j && t < ch && j < ch;
            const float L = live ? expf(sv[t] - sv[j]) : 0.f;
            const float m = live ? acb[q][k] * L : 0.f;
            const float nx = adx[q][k] * dtj;
            if (k >= kmin && k < kmax) {
              Mcb[(r0 + q) * CH + t] = m;
              Mdx[(r0 + q) * CH + t] = live ? nx * L : 0.f;
            }
            pv[k] = m * nx;  // P(t, j), zero off the live triangle
            seg[k] = warp_sum(pv[k]);
          }
          // Qs[j][t] = sum_{t' >= t} P(t', j): a reverse scan over lanes
          // within each 32-column segment plus the later segments
          float later = 0.f;
#pragma unroll
          for (int k = 3; k >= 0; --k) {
            float rs = pv[k];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const float u = __shfl_down_sync(FULL, rs, o);
              if (lane + o < 32) rs += u;
            }
            Qs[(r0 + q) * CH + lane + 32 * k] = rs + later;
            later += seg[k];
          }
        }
      }
      __syncthreads();
      {  // dxd of the tile's rows, lanes over d
        float acc[RPW][DPT], rb[RPW][DPT];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
#pragma unroll
          for (int m = 0; m < DPT; ++m) acc[q][m] = rb[q][m] = 0.f;
        for (int t = j0; t < ch; ++t) {
          float g[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) g[q] = Mcb[(r0 + q) * CH + t];
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const float dv = dys[t * HP + lane + 32 * m];
#pragma unroll
            for (int q = 0; q < RPW; ++q) acc[q][m] += g[q] * dv;
          }
        }
        for (int n = 0; n < S; ++n) {
          float br[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) br[q] = Bt[(r0 + q) * SP + n];
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const float rv = Rs[(lane + 32 * m) * SP + n];
#pragma unroll
            for (int q = 0; q < RPW; ++q) rb[q][m] += br[q] * rv;
          }
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int j = j0 + r0 + q;
          const float wj = j < ch ? wv[j] : 0.f;
          const float dtj = j < ch ? dtv[j] : 0.f;
          float xs = 0.f, xr = 0.f;
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const int d = lane + 32 * m;
            const float xv = xt[(r0 + q) * HP + d];
            const float g = acc[q][m] + wj * rb[q][m];
            xs += xv * g;
            xr += xv * rb[q][m];
            if (j < ch) dx[((row0 + j) * H + h) * HD + d] = from_f32<T>(dtj * g);
          }
          xs = warp_sum(xs);
          xr = warp_sum(xr);
          if (lane == 0 && j < ch) {
            xdot[j] = xs;
            vj[j] = wj * dtj * xr;  // pairs (j, t in later chunks)
          }
        }
      }
      {  // this head's dB of the tile's rows, lanes over n
        float acc[RPW][SPT], rx[RPW][SPT];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
#pragma unroll
          for (int k = 0; k < SPT; ++k) acc[q][k] = rx[q][k] = 0.f;
        for (int t = j0; t < ch; ++t) {
          float g[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) g[q] = Mdx[(r0 + q) * CH + t];
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            const float cv = Cs[t * SP + lane + 32 * k];
#pragma unroll
            for (int q = 0; q < RPW; ++q) acc[q][k] += g[q] * cv;
          }
        }
        for (int d = 0; d < HD; ++d) {
          float xr[RPW];
#pragma unroll
          for (int q = 0; q < RPW; ++q) xr[q] = xt[(r0 + q) * HP + d];
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            const float rv = Rs[d * SP + lane + 32 * k];
#pragma unroll
            for (int q = 0; q < RPW; ++q) rx[q][k] += xr[q] * rv;
          }
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int j = j0 + r0 + q;
          if (j < ch) {
            const float wd = wv[j] * dtv[j];
            float* out = dBp + (((long long)b * H + h) * Tn + c * ch + j) * S;
#pragma unroll
            for (int k = 0; k < SPT; ++k)
              out[lane + 32 * k] = acc[q][k] + wd * rx[q][k];
          }
        }
      }
      // dloga_k over the pairs j < k <= t inside the chunk: the rows
      // j < k of this tile
      for (int k = tid; k < ch; k += NT) {
        float s = 0.f;
        const int rmax = min(TI, k - j0);
        for (int r = 0; r < rmax; ++r) s += Qs[r * CH + k];
        dlg[k] += s;
      }
    }
    __syncthreads();  // xdot, vj, dlg complete; every tile has read R
    {  // <R, h> of the state before the chunk: pairs across the chunk
      const float* hp = states + (((long long)b * H + h) * nc + c) * HD * S;
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < DPG; ++q)
        p += Rs[(d0 + q) * SP + sn] * hp[(d0 + q) * S + sn];
      p = warp_sum(p);
      if (lane == 0) red[warp] = p;
    }
    __syncthreads();
    if (warp == 0) {
      // dloga_k = sum over pairs j < k <= t: inside the chunk (dlg), t
      // here and j before it (u, a suffix sum), j here and t after it
      // (v, a prefix sum), j before and t after
      float rh = 0.f;
      for (int w = 0; w < NW; ++w) rh += red[w];
      const float across = es[ch - 1] * rh;
      warp_cumsum(uv, ch, true);
      warp_cumsum(vj, ch, false);
      for (int k = lane; k < ch; k += 32) {
        const double dl = (double)dlg[k] + uv[k] +
                          (k > 0 ? vj[k - 1] : 0.f) + across;
        ddt[(row0 + k) * H + h] = (float)(a * dl) + xdot[k];
        dA_acc += dtv[k] * dl;
      }
    }
    {  // R <- e^{s_end} R + sum_t e^{s_t} dy_t C_t^T
      float acc[DPG];
#pragma unroll
      for (int q = 0; q < DPG; ++q) acc[q] = 0.f;
      for (int t = 0; t < ch; ++t) {
        const float cv = Cs[t * SP + sn] * es[t];
#pragma unroll
        for (int q = 0; q < DPG; ++q) acc[q] += dys[t * HP + d0 + q] * cv;
      }
      const float dec = es[ch - 1];
#pragma unroll
      for (int q = 0; q < DPG; ++q) {
        float& r = Rs[(d0 + q) * SP + sn];
        r = r * dec + acc[q];
      }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dA_acc += __shfl_xor_sync(FULL, dA_acc, o);
    if (lane == 0) dAp[(long long)b * H + h] = (float)dA_acc;
  }
}

template <typename T, int HD, int S>
__global__ void __launch_bounds__(NT)
dc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const T* __restrict__ Bm,
          const T* __restrict__ Cm, const float* __restrict__ dy,
          const float* __restrict__ states, float* __restrict__ dCp,
          float* __restrict__ ub, int Tn, int H, int ch) {
  constexpr int SP = S + 1, HP = HD + 1, SPT = S / 32;
  extern __shared__ float smem[];
  float* Bs = smem;                 // [CH][SP]  B of the chunk
  float* xs = Bs + CH * SP;         // [CH][HP]  x of the chunk
  float* hp = xs + CH * HP;         // [HD][SP]  the state before the chunk
  float* dyt = hp + HD * SP;        // [TI][HP]  dy of the row tile
  float* Ct = dyt + TI * HP;        // [TI][SP]  C of the row tile
  float* M = Ct + TI * SP;          // [TI][CH]
  float* dtv = M + TI * CH;         // [CH]
  float* sv = dtv + CH;
  float* es = sv + CH;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * RPW;
  const int nc = Tn / ch;
  const long long row0 = (long long)b * Tn + (long long)c * ch;
  for (int i = tid; i < ch; i += NT) dtv[i] = dt[(row0 + i) * H + h];
  stage_rows<S>(Bs, Bm, row0 * S, S, 0, ch, ch);
  stage_rows<HD>(xs, x, (row0 * H + h) * HD, (long long)H * HD, 0, ch, ch);
  stage_rows<S>(hp, states, (((long long)b * H + h) * nc + c) * HD * S, S, 0,
                HD, HD);
  __syncthreads();
  if (warp == 0) chunk_decays(dtv, sv, es, nullptr, ch, A[h]);

  for (int t0 = 0; t0 < ch; t0 += TI) {
    __syncthreads();  // sv ready; the previous tile is consumed
    stage_rows<HD>(dyt, dy, (row0 * H + h) * HD, (long long)H * HD, t0, TI,
                   ch);
    stage_rows<S>(Ct, Cm, row0 * S, S, t0, TI, ch);
    __syncthreads();
    const int jmax = min(ch, t0 + TI);
    const int kmax = (jmax + 31) / 32;
    {  // M[t][j] = dt_j (dy_t . x_j) e^{s_t - s_j}, j <= t
      float acc[RPW][4];
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[q][k] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float dr[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) dr[q] = dyt[(r0 + q) * HP + d];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < kmax) {
            const float xv = xs[(lane + 32 * k) * HP + d];
#pragma unroll
            for (int q = 0; q < RPW; ++q) acc[q][k] += dr[q] * xv;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int t = t0 + r0 + q;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = lane + 32 * k;
          if (k < kmax)
            M[(r0 + q) * CH + j] =
                (j <= t && t < ch)
                    ? acc[q][k] * dtv[j] * expf(sv[t] - sv[j])
                    : 0.f;
        }
      }
    }
    __syncthreads();
    {  // this head's dC of the tile's rows, lanes over n, and
       // u_t = e^{s_t} C_t . (h^T dy_t), the pairs (j before the chunk, t)
      float acc[RPW][SPT], hd_[RPW][SPT];
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int k = 0; k < SPT; ++k) acc[q][k] = hd_[q][k] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float g[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) g[q] = M[(r0 + q) * CH + j];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float bv = Bs[j * SP + lane + 32 * k];
#pragma unroll
          for (int q = 0; q < RPW; ++q) acc[q][k] += g[q] * bv;
        }
      }
      for (int d = 0; d < HD; ++d) {
        float dr[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) dr[q] = dyt[(r0 + q) * HP + d];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float hv = hp[d * SP + lane + 32 * k];
#pragma unroll
          for (int q = 0; q < RPW; ++q) hd_[q][k] += dr[q] * hv;
        }
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int t = t0 + r0 + q;
        float u = 0.f;
#pragma unroll
        for (int k = 0; k < SPT; ++k)
          u += Ct[(r0 + q) * SP + lane + 32 * k] * hd_[q][k];
        u = warp_sum(u);
        if (t < ch) {
          const float et = es[t];
          float* out = dCp + (((long long)b * H + h) * Tn + c * ch + t) * S;
#pragma unroll
          for (int k = 0; k < SPT; ++k)
            out[lane + 32 * k] = acc[q][k] + et * hd_[q][k];
          if (lane == 0) ub[(row0 + t) * H + h] = et * u;
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HD, int S>
cudaError_t launch_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* hT,
                       void* states, int Bs, int Tn, int H, int ch,
                       cudaStream_t st) {
  const int bytes = Smem<HD, S>::fwd * (int)sizeof(float);
  cudaError_t e = allow_smem(fwd_kernel<T, HD, S>, bytes);
  if (e != cudaSuccess) return e;
  fwd_kernel<T, HD, S><<<dim3(H, Bs), NT, bytes, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (float*)y, (float*)hT, (float*)states, Tn, H, ch);
  return cudaGetLastError();
}

template <typename T, int HD, int S>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* states,
                       const void* dy, void* dx, void* ddt, void* dAp,
                       void* dBp, void* dCp, void* ub, int Bs, int Tn, int H,
                       int ch, cudaStream_t st) {
  const int b1 = Smem<HD, S>::bwd * (int)sizeof(float);
  const int b2 = Smem<HD, S>::dc * (int)sizeof(float);
  cudaError_t e = allow_smem(bwd_scan_kernel<T, HD, S>, b1);
  if (e == cudaSuccess) e = allow_smem(dc_kernel<T, HD, S>, b2);
  if (e != cudaSuccess) return e;
  dc_kernel<T, HD, S><<<dim3(Tn / ch, H, Bs), NT, b2, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)dy, (const float*)states, (float*)dCp,
      (float*)ub, Tn, H, ch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_scan_kernel<T, HD, S><<<dim3(H, Bs), NT, b1, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)states, (const float*)dy,
      (const float*)ub, (T*)dx, (float*)ddt, (float*)dAp, (float*)dBp, Tn,
      H, ch);
  return cudaGetLastError();
}

// Runs CALL with T_, HD and S_ bound to the dtype code, head dim and
// state size, or returns cudaErrorInvalidValue from the enclosing
// function.
#define SSD_DISPATCH_S(T_TYPE, HD_V, s, CALL)                            \
  if ((s) == 32) {                                                       \
    using T_ = T_TYPE;                                                   \
    constexpr int HD = HD_V, S_ = 32;                                    \
    return (int)(CALL);                                                  \
  } else if ((s) == 128) {                                               \
    using T_ = T_TYPE;                                                   \
    constexpr int HD = HD_V, S_ = 128;                                   \
    return (int)(CALL);                                                  \
  }
#define SSD_DISPATCH(dtype, hd, s, CALL)                                 \
  if ((dtype) == DT_F32 && (hd) == 32) {                                 \
    SSD_DISPATCH_S(float, 32, s, CALL)                                   \
  } else if ((dtype) == DT_F32 && (hd) == 64) {                          \
    SSD_DISPATCH_S(float, 64, s, CALL)                                   \
  } else if ((dtype) == DT_BF16 && (hd) == 32) {                         \
    SSD_DISPATCH_S(__nv_bfloat16, 32, s, CALL)                           \
  } else if ((dtype) == DT_BF16 && (hd) == 64) {                         \
    SSD_DISPATCH_S(__nv_bfloat16, 64, s, CALL)                           \
  }                                                                      \
  return (int)cudaErrorInvalidValue;

bool bad_shape(int Bs, int T, int H, int chunk) {
  return Bs <= 0 || T <= 0 || H <= 0 || chunk <= 0 || chunk > CH ||
         T % chunk != 0;
}

}  // namespace

// x [Bs,T,H,hd] (dtype), dt [Bs,T,H] fp32, A [H] fp32, B/C [Bs,T,S]
// (dtype); T a multiple of chunk (<= 128); hd 32 or 64, S 32 or 128.
// Writes y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S] fp32 and the state before
// each chunk [Bs,H,T/chunk,hd,S] fp32.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, void* hT,
                            void* states, int Bs, int T, int H, int hd,
                            int S, int chunk, int dtype, void* stream) {
  if (bad_shape(Bs, T, H, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SSD_DISPATCH(dtype, hd, S, (launch_fwd<T_, HD, S_>(
      x, dt, A, B, C, y, hT, states, Bs, T, H, chunk, st)));
}

// The forward's inputs and states, and dy [Bs,T,H,hd] fp32. Writes dx
// [Bs,T,H,hd] (dtype), ddt [Bs,T,H] fp32, and the per-block parts dAp
// [Bs,H], dBp and dCp [Bs,H,T,S], all fp32, which the caller sums over
// Bs (dA) and over H (dB, dC); ub [Bs,T,H] fp32 is scratch.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* states,
                            const void* dy, void* dx, void* ddt, void* dAp,
                            void* dBp, void* dCp, void* ub, int Bs, int T,
                            int H, int hd, int S, int chunk, int dtype,
                            void* stream) {
  if (bad_shape(Bs, T, H, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SSD_DISPATCH(dtype, hd, S, (launch_bwd<T_, HD, S_>(
      x, dt, A, B, C, states, dy, dx, ddt, dAp, dBp, dCp, ub, Bs, T, H,
      chunk, st)));
}
