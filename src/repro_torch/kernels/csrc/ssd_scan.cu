// Mamba-2 SSD chunked scan, forward and backward, over contiguous x
// [Bs,T,H,hd], dt [Bs,T,H] fp32, A [H] fp32, B/C [Bs,T,S] (ngroups 1: B
// and C belong to the batch row, not the head). The forward starts from
// a carried state h0 [Bs,H,hd,S] fp32 (a serving prefill's chunk after
// the first), or from zero when h0 is null (training; the backward
// assumes zero).
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
// Forward, two routes by dtype.
//
// fp32 (fwd_kernel, the CUDA cores, which alone hold fp32's rtol of
// 1e-4): blocks run in no order on Hopper, so the chunk
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
// bf16 x, B and C (the training path): chunk-parallel kernels on the
// tensor cores (namespace tc), one block per (chunk, batch row, group of
// heads) where a block works on chunks, three launches on one stream:
//  1. chunk_state_tc: per head the chunk's own state S_c = sum_j
//     e^{s_end-s_j} dt_j x_j B_j^T [hd,S] (the shape of the backward's
//     D_c), written into the states slot of chunk c+1 (hT for the last
//     chunk), and s_end into a scratch row;
//  2. state_pass: the forward pass over the chunks in place, h_0 the
//     carried state (or 0), h_{c+1} = e^{s_end(c)} h_c + S_c, which
//     leaves each slot holding the state before its chunk and hT the
//     final state;
//  3. chunk_scan_tc: G = C B^T once for all heads of the group, then per
//     head y_t = sum_{j<=t} (G o L)_{tj} dt_j x_j + e^{s_t} C_t.h_c.
// x, B and C enter the products as exact bf16 operands; w dt x, h_c and
// the masked, decayed G o L dt as bf16 hi + lo halves; e^{s_t}
// multiplies the fp32 accumulator rows. Each block stages the next
// head's x (cp.async) and state (into registers) while this head's
// products run. Deterministic: fixed-order sums, no atomics.
//
// Backward, with dxd_j the gradient of dt_j x_j, P(t,j) = (C_t.B_j)
// e^{s_t-s_j} (dy_t.xd_j) for j <= t, and the carry R = sum over later
// rows t of e^{s_t - s_end} dy_t C_t^T [hd,S]. Two routes by dtype.
//
// fp32 (the bf16 tensor cores cannot hold fp32's rtol of 1e-4): two
// kernels on one stream, their products on the CUDA cores in fp32:
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
// bf16 x, B and C (the training path): chunk-parallel kernels on the
// tensor cores (namespace tc; hopper.cuh's tiles, cp.async copies and
// wgmma), one block per (chunk, batch row, group of heads), four
// launches on one stream:
//  1. dc_tc: per head, dC_t = sum_{j<=t} N L dt_j B_j + e^{s_t} h^T dy_t
//     with N = dy x^T, u_t (as above), and the chunk's contribution to
//     the carry, D_c = sum_t e^{s_t} dy_t C_t^T [hd,S];
//  2. carry_kernel: the reverse pass over the chunks, R_{c-1} =
//     e^{s_end(c)} R_c + D_c, elementwise in place of D (R_last = 0);
//  3. dxb_tc: G = C B^T once for all heads of the group, then per head
//     dxd, dx, dB (as in bwd_scan_kernel, from G and R_c), the four
//     parts of dloga, ddt and the chunk's part of dA. Inside the chunk
//     dloga_k is the exclusive prefix sum over k of (sum_{t>k} P(t,k) -
//     sum_{j<k} P(k,j)), each pair counted once per k it spans: the
//     terms cancel only within the 128 rows of a chunk, not over the
//     sequence;
//  4. sum_groups: dB and dC from the groups' fp32 parts, in group order.
// x, B and C enter the products as exact bf16 operands; dy, e^s dy, h
// and R as bf16 hi + lo halves, and so do the masked, decayed products
// that feed a second product from registers (G o L, N o L dt); the
// per-row fp32 factors (dt_j, e^{s_t}, e^{s_end - s_j}) multiply the
// fp32 accumulators. Deterministic: fixed-order sums, no atomics.
//
// Bound on the H100 at the training shape (Bs 4, T 2048, H 80, hd 64,
// S 128): bytes. The forward moves about 0.27 GB (y in fp32 is most of
// it) for about 54 GFLOP; fwd_kernel runs its products on the CUDA cores
// in fp32, where that work, not the bytes, is its limit. The bf16 route
// runs them on the tensor cores and moves about 1.0 GB (x twice, the
// states written, passed and read, y), at least 0.30 ms. The backward's
// about 140 GFLOP sit above its bytes at the bf16 tensor-core rate (0.141
// ms); its bf16 route runs them on the tensor cores, and its time goes
// to staging each head's dy, states and x from device memory, which
// waits on the loads (no copy of the next head overlaps this one's
// products yet).
#include "common.cuh"
#include "hopper.cuh"

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
           const T* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hT,
           float* __restrict__ states, int Tn, int H, int ch) {
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
  const float* hin = h0 ? h0 + ((long long)b * H + h) * HD * S : nullptr;
  for (int e = tid; e < HD * S; e += NT)
    hs[(e / S) * SP + e % S] = hin ? hin[e] : 0.f;

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

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (hopper.cuh's tall tiles, cp.async
// copies and wgmma; the head comment gives the algebra)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NTB = 256;  // two warpgroups: rows 0-63 and 64-127
constexpr int CP = 128;   // chunk rows of a tile (zero past the chunk)

template <int S> struct Pad {
  static constexpr int SP = S <= 64 ? 64 : 128;  // S padded with zeros
  static constexpr int BC = CP * SP * 2;         // bytes of a B or C tile
  static constexpr int ST = 64 * SP * 2;         // of a state tile
};
constexpr int XB = CP * 64 * 2;                  // of an x or dy tile

// Element (r, c) of a 128-row tall tile at shared address ``tile``
// (``gen`` + address is its generic pointer).
__device__ __forceinline__ float tile_at(const uint8_t* gen, uint32_t tile,
                                         int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      gen + tile + hop::tall_off<CP>(r, c / 8) + (c % 8) * 2));
}

__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  hop::split2(v[0], v[1], hi.x, lo.x);
  hop::split2(v[2], v[3], hi.y, lo.y);
  hop::split2(v[4], v[5], hi.z, lo.z);
  hop::split2(v[6], v[7], hi.w, lo.w);
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// dy rows [0, ch) of one head (row r at dy + base + r * ld, HD floats)
// into the hi and lo tiles at shared addresses dh, dl (128 x 64, zero
// past ch and past HD). Every load is issued before the first store.
// Ends with a barrier; returns whether any lo half is nonzero (none is
// on the training path, whose dy holds bf16 values).
template <int HD>
__device__ bool stage_dy(uint8_t* gen, uint32_t dh, uint32_t dl,
                         const float* __restrict__ dy, long long base,
                         long long ld, int ch, int tid) {
  constexpr int IT = CP * 8 / NTB;
  float v[IT][8];
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int r = (tid + k * NTB) / 8, c = (tid + k * NTB) % 8;
    if (r < ch && c * 8 < HD) {
      load8(v[k], dy + base + r * ld + c * 8);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[k][q] = 0.f;
    }
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int r = (tid + k * NTB) / 8, c = (tid + k * NTB) % 8;
    uint4 hi, lo;
    split8(v[k], hi, lo);
    any |= (lo.x | lo.y | lo.z | lo.w) != 0u;
    const uint32_t off = hop::tall_off<CP>(r, c);
    *reinterpret_cast<uint4*>(gen + dh + off) = hi;
    *reinterpret_cast<uint4*>(gen + dl + off) = lo;
  }
  return __syncthreads_or(any) != 0;
}

// This thread's IT x 8 entries of an [HD, S] fp32 state (row-major, zero
// past HD and S) as a 64 x SP tile: load_state reads them from device
// memory (loads only), store_state writes them into the hi and lo tiles
// at th, tl.
template <int S> struct StateFrag {
  static constexpr int CPR = Pad<S>::SP / 8, IT = 64 * CPR / NTB;
};
template <int HD, int S>
__device__ __forceinline__ void load_state(
    float (&v)[StateFrag<S>::IT][8], const float* __restrict__ src,
    int tid) {
  constexpr int CPR = StateFrag<S>::CPR;
#pragma unroll
  for (int k = 0; k < StateFrag<S>::IT; ++k) {
    const int r = (tid + k * NTB) / CPR, c = (tid + k * NTB) % CPR;
    if (r < HD && c * 8 < S) {
      load8(v[k], src + r * S + c * 8);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[k][q] = 0.f;
    }
  }
}
template <int S>
__device__ __forceinline__ void store_state(
    uint8_t* gen, uint32_t th, uint32_t tl,
    const float (&v)[StateFrag<S>::IT][8], int tid) {
  constexpr int CPR = StateFrag<S>::CPR;
#pragma unroll
  for (int k = 0; k < StateFrag<S>::IT; ++k) {
    const int r = (tid + k * NTB) / CPR, c = (tid + k * NTB) % CPR;
    uint4 hi, lo;
    split8(v[k], hi, lo);
    const uint32_t off = hop::tall_off<64>(r, c);
    *reinterpret_cast<uint4*>(gen + th + off) = hi;
    *reinterpret_cast<uint4*>(gen + tl + off) = lo;
  }
}

// An [HD, S] fp32 state into the hi and lo tiles at th, tl, every load
// before the first store; with DOT, ``dot`` gains this thread's part of
// <src, other>.
template <int HD, int S, bool DOT>
__device__ void stage_state(uint8_t* gen, uint32_t th, uint32_t tl,
                            const float* __restrict__ src,
                            const float* __restrict__ other, float& dot,
                            int tid) {
  constexpr int IT = StateFrag<S>::IT;
  float v[IT][8];
  load_state<HD, S>(v, src, tid);
  if constexpr (DOT) {
    float o[IT][8];
    load_state<HD, S>(o, other, tid);
#pragma unroll
    for (int k = 0; k < IT; ++k)
#pragma unroll
      for (int q = 0; q < 8; ++q) dot += v[k][q] * o[k][q];
  }
  store_state<S>(gen, th, tl, v, tid);
}

// Dynamic shared memory: B, C, x, dy hi + lo, a state hi + lo, then
// dc_tc's three vectors, or dxb_tc's G^T, eight vectors, the column sums
// of P of each warp and eight partial sums; 1024 bytes of alignment slack.
template <int S> constexpr int dc_smem() {
  return 2 * Pad<S>::BC + 3 * XB + 2 * Pad<S>::ST + 3 * CP * 4 + 1024;
}
template <int S> constexpr int dxb_smem() {
  return 2 * Pad<S>::BC + 3 * XB + 2 * Pad<S>::ST + 64 * NTB * 4 +
         16 * CP * 4 + 8 * 4 + 1024;
}

// dC, u and the carry's D_c. One block per (chunk, batch row, head
// group), warpgroup w owning the chunk's rows t in [64w, 64w + 64); B and
// C staged once, then per head x, dt, dy (hi + lo) and the saved state h
// (hi + lo):
//   Z = dy h (SS; h N-major): u_t = e^{s_t} C_t.Z_t, dC += e^{s_t} Z;
//   N = dy x^T (SS), Nd = N o L dt_j in the registers, dC += Nd B (Nd
//   from registers as hi + lo, B N-major; the k steps of j past this
//   warpgroup's rows skipped);
//   D_c = (e^s dy)^T C (A from registers, hi + lo, made from dy in device
//   memory; warpgroup w the columns [64w, 64w + 64) of S).
// dC sums over the group's heads in registers; the block writes it as
// its group's fp32 part. ``send`` gets the chunk's s_end of each head.
template <int HD, int S>
__global__ void __launch_bounds__(NTB, 1)
dc_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
      const float* __restrict__ A, const bf16* __restrict__ Bm,
      const bf16* __restrict__ Cm, const float* __restrict__ states,
      const float* __restrict__ dy, float* __restrict__ dCp,
      float* __restrict__ ub, float* __restrict__ Dc,
      float* __restrict__ send, int Bs, int Tn, int H, int ch, int group) {
  constexpr int SP = Pad<S>::SP;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  uint8_t* gen = smraw - hop::smem_u32(smraw);  // gen + address: generic
  const uint32_t bt = sm, ct = bt + Pad<S>::BC, xt = ct + Pad<S>::BC;
  const uint32_t dh = xt + XB, dl = dh + XB, hh = dl + XB;
  const uint32_t hl = hh + Pad<S>::ST;
  float* dtv = reinterpret_cast<float*>(gen + hl + Pad<S>::ST);
  float* sv = dtv + CP;
  float* es = sv + CP;

  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int nc = Tn / ch;
  const int h0 = g * group, h1 = min(H, h0 + group);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32,
            lane = tid % 32;
  const uint32_t arow = wg * 64 * 128;  // this warpgroup's rows of a tile
  const long long row0 = (long long)b * Tn + (long long)c * ch;
  const long long xld = (long long)H * HD;
  hop::load_tall<CP, SP, NTB>(bt, Bm + row0 * S, S, ch, S, tid);
  hop::load_tall<CP, SP, NTB>(ct, Cm + row0 * S, S, ch, S, tid);
  hop::cp_commit();

  float dC[SP / 2];
#pragma unroll
  for (int i = 0; i < SP / 2; ++i) dC[i] = 0.f;
  const int nk = min(4 * (wg + 1), (ch + 15) / 16);  // live k steps of j

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the previous head's tiles are consumed
    hop::load_tall<CP, 64, NTB>(xt, x + row0 * xld + h * HD, xld, ch, HD,
                                tid);
    hop::cp_commit();
    if (tid < CP) {
      dtv[tid] = tid < ch ? dt[(row0 + tid) * H + h] : 0.f;
      sv[tid] = 0.f;
      es[tid] = 0.f;
    }
    const long long sidx = ((long long)b * H + h) * nc + c;
    float unused = 0.f;
    stage_state<HD, S, false>(gen, hh, hl, states + sidx * HD * S, nullptr,
                              unused, tid);
    const bool lo = stage_dy<HD>(gen, dh, dl, dy, row0 * xld + h * HD, xld,
                                 ch, tid);
    if (warp == 0) {
      chunk_decays(dtv, sv, es, nullptr, ch, A[h]);
      if (lane == 0) send[sidx] = sv[ch - 1];
    }
    hop::cp_wait<0>();
    hop::fence_async_smem();
    __syncthreads();

    float acc[64];
    {  // Z = dy h: u and the state part of dC
      float(&z)[SP / 2] = *reinterpret_cast<float(*)[SP / 2]>(acc);
#pragma unroll
      for (int i = 0; i < SP / 2; ++i) z[i] = 0.f;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        hop::mma_ss_t<SP, 1>(z, hop::desc_kt<CP>(dh + arow, kk),
                             hop::desc_nt<64>(hh, kk), 1);
        hop::mma_ss_t<SP, 1>(z, hop::desc_kt<CP>(dh + arow, kk),
                             hop::desc_nt<64>(hl, kk), 1);
        if (lo)
          hop::mma_ss_t<SP, 1>(z, hop::desc_kt<CP>(dl + arow, kk),
                               hop::desc_nt<64>(hh, kk), 1);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(z);
      float u[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < SP / 2; ++i) {
        const int t = wg * 64 + hop::acc_row(i);
        u[(i >> 1) & 1] += tile_at(gen, ct, t, hop::acc_col(i)) * z[i];
        dC[i] += es[t] * z[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        u[r] += __shfl_xor_sync(FULL, u[r], 1);
        u[r] += __shfl_xor_sync(FULL, u[r], 2);
        const int t = wg * 64 + hop::acc_row(2 * r);
        if (lane % 4 == 0 && t < ch) ub[(row0 + t) * H + h] = es[t] * u[r];
      }
    }
    // N = dy x^T, then Nd = N o L dt_j
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hop::mma_ss_t<128, 0>(acc, hop::desc_kt<CP>(dh + arow, kk),
                            hop::desc_kt<CP>(xt, kk), 1);
      if (lo)
        hop::mma_ss_t<128, 0>(acc, hop::desc_kt<CP>(dl + arow, kk),
                              hop::desc_kt<CP>(xt, kk), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int t = wg * 64 + hop::acc_row(i), j = hop::acc_col(i);
      acc[i] = (j <= t && t < ch) ? acc[i] * expf(sv[t] - sv[j]) * dtv[j]
                                  : 0.f;
    }
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nk) {
        uint32_t fh[4], fl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hop::split2(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1], fh[e],
                      fl[e]);
        hop::mma_rs<SP>(dC, fh, hop::desc_nt<CP>(bt, kk));
        hop::mma_rs<SP>(dC, fl, hop::desc_nt<CP>(bt, kk));
      }
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dC);

    if (SP == 128 || wg == 0) {  // D_c, columns [64 wg, 64 wg + 64) of S
      // A = (e^s dy)^T from device memory, every load before the first
      // product; rows d of A are dims of dy, its k steps rows t
      float raw[64], dacc[32];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int d = hop::acc_row(i), t = hop::acc_col(i);
        raw[i] = (d < HD && t < ch)
                     ? es[t] * dy[(row0 + t) * xld + h * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
      const uint32_t cw = ct + wg * CP * 128;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < (ch + 15) / 16) {
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hop::split2(raw[8 * kk + 2 * e], raw[8 * kk + 2 * e + 1], fh[e],
                        fl[e]);
          hop::mma_rs<64>(dacc, fh, hop::desc_nt<CP>(cw, kk));
          hop::mma_rs<64>(dacc, fl, hop::desc_nt<CP>(cw, kk));
        }
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(dacc);
      float* out = Dc + sidx * HD * S;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int d = hop::acc_row(i), n = wg * 64 + hop::acc_col(i);
        if (d < HD && n < S)
          *reinterpret_cast<float2*>(out + d * S + n) =
              make_float2(dacc[i], dacc[i + 1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = wg * 64 + hop::acc_row(2 * r);
    if (t >= ch) continue;
    float* dst = dCp + ((long long)g * Bs * Tn + row0 + t) * S;
#pragma unroll
    for (int q = 0; q < SP / 8; ++q) {
      const int i = 4 * q + 2 * r, n = hop::acc_col(i);
      if (n < S)
        *reinterpret_cast<float2*>(dst + n) = make_float2(dC[i], dC[i + 1]);
    }
  }
}

// The reverse carry, in place: Dc holds D_c per (batch row, head, chunk)
// and is left holding R_c, the carry from the later chunks (R_last = 0,
// R_{c-1} = e^{s_end(c)} R_c + D_c). Elementwise and bytes-bound: one
// thread per four elements of [HD, S] of a (batch row, head), which
// loads the D_c of CB chunks before it stores any, so that each thread
// keeps CB 16-byte loads in flight.
__global__ void carry_kernel(float* __restrict__ Dc,
                             const float* __restrict__ send, long long per,
                             long long n, int nc) {
  constexpr int CB = 8;
  const long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
  const long long bh = e / per, r = e % per;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c1 = nc; c1 > 0; c1 -= CB) {  // chunks [c1 - CB, c1), backwards
    float4 d[CB];
    float f[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        d[k] = *reinterpret_cast<const float4*>(Dc + (bh * nc + c) * per + r);
        f[k] = expf(send[bh * nc + c]);
      }
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        *reinterpret_cast<float4*>(Dc + (bh * nc + c) * per + r) = carry;
        carry.x = f[k] * carry.x + d[k].x;
        carry.y = f[k] * carry.y + d[k].y;
        carry.z = f[k] * carry.z + d[k].z;
        carry.w = f[k] * carry.w + d[k].w;
      }
    }
  }
}

// dx, ddt, dA and dB. One block per (chunk, batch row, head group),
// warpgroup w owning the chunk's rows j in [64w, 64w + 64). Once per
// block: G^T = B C^T (SS), kept in shared memory in register order. Per
// head, with R = R_c (hi + lo):
//   X1 = B R^T (SS): v_j = w_j dt_j x_j.X1_j, dxd = w_j X1;
//   X2 = x R (SS; R N-major): dB += w_j dt_j X2;
//   N^T = x dy^T (SS); then per k step of t: M^T = G^T o L and Nd^T =
//   N^T o L dt_j in registers (hi + lo), the row and column sums of P =
//   G^T o Nd^T over t > j, dxd += M^T dy and dB += Nd^T C (RS; dy and C
//   N-major), the k steps of t before this warpgroup's rows skipped;
//   dx = dt dxd; then dloga from its four parts, ddt = A dloga + x.dxd
//   and this chunk's part of dA, sum_k dt_k dloga_k.
// dB sums over the group's heads in registers; the block writes it as
// its group's fp32 part.
template <int HD, int S>
__global__ void __launch_bounds__(NTB, 1)
dxb_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ A, const bf16* __restrict__ Bm,
       const bf16* __restrict__ Cm, const float* __restrict__ states,
       const float* __restrict__ dy, const float* __restrict__ Rc,
       const float* __restrict__ ub, bf16* __restrict__ dx,
       float* __restrict__ ddt, float* __restrict__ dAp,
       float* __restrict__ dBp, int Bs, int Tn, int H, int ch, int group) {
  constexpr int SP = Pad<S>::SP;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  uint8_t* gen = smraw - hop::smem_u32(smraw);
  const uint32_t bt = sm, ct = bt + Pad<S>::BC, xt = ct + Pad<S>::BC;
  const uint32_t dh = xt + XB, dl = dh + XB, rh = dl + XB;
  const uint32_t rl = rh + Pad<S>::ST;
  float* gs = reinterpret_cast<float*>(gen + rl + Pad<S>::ST);  // [64][NTB]
  float* dtv = gs + 64 * NTB;
  float* sv = dtv + CP;
  float* es = sv + CP;
  float* wv = es + CP;
  float* uv = wv + CP;
  float* colv = uv + CP;
  float* vv = colv + CP;
  float* xdot = vv + CP;
  float* rowpart = xdot + CP;     // [8 warps][CP]
  float* red = rowpart + 8 * CP;  // [8]

  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int nc = Tn / ch;
  const int h0 = g * group, h1 = min(H, h0 + group);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32,
            lane = tid % 32;
  const uint32_t arow = wg * 64 * 128;
  const long long row0 = (long long)b * Tn + (long long)c * ch;
  const long long xld = (long long)H * HD;
  hop::load_tall<CP, SP, NTB>(bt, Bm + row0 * S, S, ch, S, tid);
  hop::load_tall<CP, SP, NTB>(ct, Cm + row0 * S, S, ch, S, tid);
  hop::cp_commit();
  hop::cp_wait<0>();
  hop::fence_async_smem();
  __syncthreads();
  {  // G^T = B C^T, shared by the heads
    float gacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gacc[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk)
      hop::mma_ss_t<128, 0>(gacc, hop::desc_kt<CP>(bt + arow, kk),
                            hop::desc_kt<CP>(ct, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(gacc);
#pragma unroll
    for (int i = 0; i < 64; ++i) gs[i * NTB + tid] = gacc[i];
  }

  float dB[SP / 2];
#pragma unroll
  for (int i = 0; i < SP / 2; ++i) dB[i] = 0.f;
  const int kmin = 4 * wg, kmax = (ch + 15) / 16;  // live k steps of t

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the previous head's tiles and vectors are consumed
    hop::load_tall<CP, 64, NTB>(xt, x + row0 * xld + h * HD, xld, ch, HD,
                                tid);
    hop::cp_commit();
    if (tid < CP) {
      dtv[tid] = tid < ch ? dt[(row0 + tid) * H + h] : 0.f;
      uv[tid] = tid < ch ? ub[(row0 + tid) * H + h] : 0.f;
      sv[tid] = 0.f;
      es[tid] = 0.f;
      wv[tid] = 0.f;
    }
    const long long sidx = ((long long)b * H + h) * nc + c;
    float rh_dot = 0.f;  // this thread's part of <R_c, h_c>
    stage_state<HD, S, true>(gen, rh, rl, Rc + sidx * HD * S,
                             states + sidx * HD * S, rh_dot, tid);
    rh_dot = warp_sum(rh_dot);
    if (lane == 0) red[warp] = rh_dot;
    const bool lo = stage_dy<HD>(gen, dh, dl, dy, row0 * xld + h * HD, xld,
                                 ch, tid);
    if (warp == 0) chunk_decays(dtv, sv, es, wv, ch, A[h]);
    hop::cp_wait<0>();
    hop::fence_async_smem();
    __syncthreads();

    float acc[64], ax[32];
    float(&z)[SP / 2] = *reinterpret_cast<float(*)[SP / 2]>(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) ax[i] = 0.f;
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) z[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {  // X1 = B R^T
      hop::mma_ss_t<64, 0>(ax, hop::desc_kt<CP>(bt + arow, kk),
                           hop::desc_kt<64>(rh, kk), 1);
      hop::mma_ss_t<64, 0>(ax, hop::desc_kt<CP>(bt + arow, kk),
                           hop::desc_kt<64>(rl, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // X2 = x R
      hop::mma_ss_t<SP, 1>(z, hop::desc_kt<CP>(xt + arow, kk),
                           hop::desc_nt<64>(rh, kk), 1);
      hop::mma_ss_t<SP, 1>(z, hop::desc_kt<CP>(xt + arow, kk),
                           hop::desc_nt<64>(rl, kk), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(ax);
    hop::fence_regs(z);
    {
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = wg * 64 + hop::acc_row(i);
        v[(i >> 1) & 1] += tile_at(gen, xt, j, hop::acc_col(i)) * ax[i];
        ax[i] *= wv[j];
      }
#pragma unroll
      for (int i = 0; i < SP / 2; ++i) {
        const int j = wg * 64 + hop::acc_row(i);
        dB[i] += wv[j] * dtv[j] * z[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        v[r] += __shfl_xor_sync(FULL, v[r], 1);
        v[r] += __shfl_xor_sync(FULL, v[r], 2);
        const int j = wg * 64 + hop::acc_row(2 * r);
        if (lane % 4 == 0 && j < ch) vv[j] = wv[j] * dtv[j] * v[r];
      }
    }
    // N^T = x dy^T
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hop::mma_ss_t<128, 0>(acc, hop::desc_kt<CP>(xt + arow, kk),
                            hop::desc_kt<CP>(dh, kk), 1);
      if (lo)
        hop::mma_ss_t<128, 0>(acc, hop::desc_kt<CP>(xt + arow, kk),
                              hop::desc_kt<CP>(dl, kk), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);

    float colr[2] = {0.f, 0.f};  // sums over t > j of P(t, j), two rows j
    float rp[32];                // sums over this thread's rows j < t
#pragma unroll
    for (int q = 0; q < 32; ++q) rp[q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < kmin || kk >= kmax) continue;
      uint32_t mh[4], ml[4], nh[4], nl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float mv[2], nv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 8 * kk + 2 * e + q;
          const int j = wg * 64 + hop::acc_row(i), t = hop::acc_col(i);
          const float L = (j <= t && t < ch) ? expf(sv[t] - sv[j]) : 0.f;
          const float gv = gs[i * NTB + tid];
          mv[q] = gv * L;
          nv[q] = acc[i] * L * dtv[j];
          if (t > j) {
            const float p = gv * nv[q];
            colr[(i >> 1) & 1] += p;
            rp[(i >> 2) * 2 + (i & 1)] += p;
          }
        }
        hop::split2(mv[0], mv[1], mh[e], ml[e]);
        hop::split2(nv[0], nv[1], nh[e], nl[e]);
      }
      hop::wg_fence();
      hop::mma_rs<64>(ax, mh, hop::desc_nt<CP>(dh, kk));
      hop::mma_rs<64>(ax, ml, hop::desc_nt<CP>(dh, kk));
      if (lo) hop::mma_rs<64>(ax, mh, hop::desc_nt<CP>(dl, kk));
      hop::mma_rs<SP>(dB, nh, hop::desc_nt<CP>(ct, kk));
      hop::mma_rs<SP>(dB, nl, hop::desc_nt<CP>(ct, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(ax);
      hop::fence_regs(dB);
    }
    // the column sums of P over this warp's 16 rows: a row of rowpart
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      float s = rp[q];
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (lane < 4) rowpart[warp * CP + 8 * (q >> 1) + 2 * lane + (q & 1)] = s;
    }
    {  // dx, x.dxd and the row sums of P
      float xs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = wg * 64 + hop::acc_row(i);
        xs[(i >> 1) & 1] += tile_at(gen, xt, j, hop::acc_col(i)) * ax[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          xs[r] += __shfl_xor_sync(FULL, xs[r], o);
          colr[r] += __shfl_xor_sync(FULL, colr[r], o);
        }
        const int j = wg * 64 + hop::acc_row(2 * r);
        if (j >= ch) continue;
        if (lane % 4 == 0) {
          xdot[j] = xs[r];
          colv[j] = colr[r];
        }
        const float dtj = dtv[j];
        bf16* dst = dx + (row0 + j) * xld + h * HD;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = 4 * q + 2 * r, d = hop::acc_col(i);
          if (d < HD)
            *reinterpret_cast<__nv_bfloat162*>(dst + d) =
                __floats2bfloat162_rn(dtj * ax[i], dtj * ax[i + 1]);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // dloga_k: inside the chunk, the exclusive prefix sum of (sum_{t>k}
      // P(t,k) - sum_{j<k} P(k,j)); t here and j before (u, a suffix
      // sum); j here and t after (v, an exclusive prefix sum); j before
      // and t after (e^{s_end} <R, h>). Each sum in a fixed order.
      for (int k = lane; k < ch; k += 32) {
        float rs = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) rs += rowpart[w * CP + k];
        colv[k] -= rs;
      }
      __syncwarp();
      warp_cumsum(colv, ch, false);
      warp_cumsum(uv, ch, true);
      warp_cumsum(vv, ch, false);
      float rhs = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) rhs += red[w];
      const float across = es[ch - 1] * rhs;
      const float a = A[h];
      float da = 0.f;
      for (int k = lane; k < ch; k += 32) {
        const float dl = (k > 0 ? colv[k - 1] + vv[k - 1] : 0.f) + uv[k] +
                         across;
        ddt[(row0 + k) * H + h] = a * dl + xdot[k];
        da += dtv[k] * dl;
      }
      da = warp_sum(da);
      if (lane == 0) dAp[sidx] = da;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = wg * 64 + hop::acc_row(2 * r);
    if (j >= ch) continue;
    float* dst = dBp + ((long long)g * Bs * Tn + row0 + j) * S;
#pragma unroll
    for (int q = 0; q < SP / 8; ++q) {
      const int i = 4 * q + 2 * r, n = hop::acc_col(i);
      if (n < S)
        *reinterpret_cast<float2*>(dst + n) = make_float2(dB[i], dB[i + 1]);
    }
  }
}

// dB and dC from the groups' fp32 parts, summed in group order: one
// thread per four elements, the loads of GB groups issued together.
__global__ void sum_groups(const float* __restrict__ dBp,
                           const float* __restrict__ dCp,
                           bf16* __restrict__ dB, bf16* __restrict__ dC,
                           long long nel, int groups) {
  constexpr int GB = 4;
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= nel) return;
  float sb[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = 0; g0 < groups; g0 += GB) {
    float4 b[GB], c[GB];
#pragma unroll
    for (int k = 0; k < GB; ++k) {
      if (g0 + k < groups) {
        b[k] = *reinterpret_cast<const float4*>(dBp + (g0 + k) * nel + i);
        c[k] = *reinterpret_cast<const float4*>(dCp + (g0 + k) * nel + i);
      }
    }
#pragma unroll
    for (int k = 0; k < GB; ++k) {
      if (g0 + k < groups) {
        sb[0] += b[k].x; sb[1] += b[k].y; sb[2] += b[k].z; sb[3] += b[k].w;
        sc[0] += c[k].x; sc[1] += c[k].y; sc[2] += c[k].z; sc[3] += c[k].w;
      }
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(dB + i) =
      __floats2bfloat162_rn(sb[0], sb[1]);
  *reinterpret_cast<__nv_bfloat162*>(dB + i + 2) =
      __floats2bfloat162_rn(sb[2], sb[3]);
  *reinterpret_cast<__nv_bfloat162*>(dC + i) =
      __floats2bfloat162_rn(sc[0], sc[1]);
  *reinterpret_cast<__nv_bfloat162*>(dC + i + 2) =
      __floats2bfloat162_rn(sc[2], sc[3]);
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (the head comment gives the algebra)
// ---------------------------------------------------------------------------

// Warp 0: this lane's dt of head h over the chunk's rows lane + 32k (zero
// past ch); loads only, so that they fly during the products.
__device__ __forceinline__ void load_dt(float (&d)[4],
                                        const float* __restrict__ dt,
                                        long long row0, int H, int h, int ch,
                                        int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane + 32 * k;
    d[k] = i < ch ? dt[(row0 + i) * H + h] : 0.f;
  }
}

// Warp 0: a head's dt (from load_dt) into dtv, then sv, es and (given) wv
// as chunk_decays fills them, every entry past ch zero.
__device__ void head_decays(const float (&d)[4], float* dtv, float* sv,
                            float* es, float* wv, int ch, float a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane + 32 * k;
    dtv[i] = d[k];
    sv[i] = es[i] = 0.f;
    if (wv) wv[i] = 0.f;
  }
  __syncwarp();
  chunk_decays(dtv, sv, es, wv, ch, a);
}

// Dynamic shared memory: chunk_state_tc's B, two x tiles and two sets of
// four vectors; chunk_scan_tc's B, C, two x tiles, two states hi + lo and
// two sets of three vectors; 1024 bytes of alignment slack.
template <int S> constexpr int state_smem() {
  return Pad<S>::BC + 2 * XB + 2 * 4 * CP * 4 + 1024;
}
template <int S> constexpr int scan_smem() {
  return 2 * Pad<S>::BC + 2 * XB + 4 * Pad<S>::ST + 2 * 3 * CP * 4 + 1024;
}

// The chunks' own states. One block per (chunk, batch row, head group),
// two blocks an SM (at most 128 registers), so that one block's copies
// overlap the other's products: B staged once, then per head S_c = (w dt
// x)^T B with w_j = e^{s_end - s_j}: A from registers as hi + lo (rows d,
// k steps j, made from x's tile one k step at a time), B N-major;
// warpgroup w the columns [64w, 64w + 64) of S. S_c goes into the states
// slot of chunk c + 1 (hT for the last chunk), s_end into ``send``. The
// next head's x tile (cp.async) and dt (warp 0) are in flight during
// this head's products.
template <int HD, int S>
__global__ void __launch_bounds__(NTB, 2)
chunk_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               float* __restrict__ states, float* __restrict__ hT,
               float* __restrict__ send, int Tn, int H, int ch, int group) {
  constexpr int SP = Pad<S>::SP;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  uint8_t* gen = smraw - hop::smem_u32(smraw);
  const uint32_t bt = sm, xt0 = bt + Pad<S>::BC;  // x tile k at xt0 + k XB
  float* vec0 = reinterpret_cast<float*>(gen + xt0 + 2 * XB);  // [2][4][CP]

  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int nc = Tn / ch;
  const int h0 = g * group, h1 = min(H, h0 + group);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32,
            lane = tid % 32;
  const long long row0 = (long long)b * Tn + (long long)c * ch;
  const long long xld = (long long)H * HD;
  const int nk = (ch + 15) / 16;  // live k steps of j
  // Warp 0: a head's vectors into set k, wv then holding w dt; its s_end
  // into send.
  auto decays = [&](const float(&d)[4], int k, int h, float a) {
    float* v = vec0 + k * 4 * CP;
    head_decays(d, v, v + CP, v + 2 * CP, v + 3 * CP, ch, a);
    for (int i = lane; i < ch; i += 32) v[3 * CP + i] *= v[i];
    if (lane == 0) send[((long long)b * H + h) * nc + c] = v[CP + ch - 1];
  };
  hop::load_tall<CP, SP, NTB>(bt, Bm + row0 * S, S, ch, S, tid);
  hop::load_tall<CP, 64, NTB>(xt0, x + row0 * xld + h0 * HD, xld, ch, HD,
                              tid);
  hop::cp_commit();
  float dnext[4];
  if (warp == 0) {
    load_dt(dnext, dt, row0, H, h0, ch, lane);
    decays(dnext, 0, h0, A[h0]);
  }

  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const uint32_t xt = xt0 + buf * XB;
    const float* wd = vec0 + buf * 4 * CP + 3 * CP;  // w_j dt_j
    hop::cp_wait<0>();
    hop::fence_async_smem();
    __syncthreads();  // this head's tile and vectors are in; the previous
                      // head's are consumed
    float anext = 0.f;
    if (h + 1 < h1) {
      hop::load_tall<CP, 64, NTB>(xt0 + (buf ^ 1) * XB,
                                  x + row0 * xld + (h + 1) * HD, xld, ch,
                                  HD, tid);
      hop::cp_commit();
      if (warp == 0) {
        load_dt(dnext, dt, row0, H, h + 1, ch, lane);
        anext = A[h + 1];
      }
    }
    if (SP == 128 || wg == 0) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const uint32_t bw = bt + wg * CP * 128;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nk) {
          // k step kk of A = (w dt x)^T: rows d are dims of x, columns j
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int i = 8 * kk + 2 * e + q;
              const int d = hop::acc_row(i), j = hop::acc_col(i);
              v[q] = (d < HD && j < ch) ? wd[j] * tile_at(gen, xt, j, d)
                                        : 0.f;
            }
            hop::split2(v[0], v[1], fh[e], fl[e]);
          }
          hop::mma_rs<64>(acc, fh, hop::desc_nt<CP>(bw, kk));
          hop::mma_rs<64>(acc, fl, hop::desc_nt<CP>(bw, kk));
        }
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc);
      const long long bh = (long long)b * H + h;
      float* out = c + 1 < nc ? states + (bh * nc + c + 1) * HD * S
                              : hT + bh * HD * S;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int d = hop::acc_row(i), n = wg * 64 + hop::acc_col(i);
        if (d < HD && n < S)
          *reinterpret_cast<float2*>(out + d * S + n) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
    if (warp == 0 && h + 1 < h1) decays(dnext, buf ^ 1, h + 1, anext);
  }
}

// The forward pass over the chunks, in place: the states slot of chunk
// c + 1 holds S_c (hT S_last) and is left holding h_{c+1} = e^{s_end(c)}
// h_c + S_c, slot 0 h_0 (``h0``, or 0 when null), hT the final state. Elementwise and
// bytes-bound, as carry_kernel: one thread per four elements of [HD, S]
// of a (batch row, head), loading the S_c of CB chunks before it stores
// any.
__global__ void state_pass(float* states, float* hT,
                           const float* __restrict__ send,
                           const float* __restrict__ h0, long long per,
                           long long n, int nc) {
  constexpr int CB = 8;
  const long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
  const long long bh = e / per, r = e % per;
  float4* last = reinterpret_cast<float4*>(hT + bh * per + r);
  float4 carry =
      h0 ? *reinterpret_cast<const float4*>(h0 + bh * per + r)
         : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += CB) {  // chunks [c0, c0 + CB)
    float4 d[CB];
    float f[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        d[k] = c + 1 < nc ? *reinterpret_cast<const float4*>(
                                states + (bh * nc + c + 1) * per + r)
                          : *last;
        f[k] = expf(send[bh * nc + c]);
      }
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        *reinterpret_cast<float4*>(states + (bh * nc + c) * per + r) = carry;
        carry.x = f[k] * carry.x + d[k].x;
        carry.y = f[k] * carry.y + d[k].y;
        carry.z = f[k] * carry.z + d[k].z;
        carry.w = f[k] * carry.w + d[k].w;
      }
    }
  }
  *last = carry;
}

// y. One block per (chunk, batch row, head group), warpgroup w owning the
// chunk's rows t in [64w, 64w + 64). Once per block: G = C B^T (SS), kept
// in the registers. Per head, with h_c the state before the chunk (hi +
// lo):
//   y = C h_c^T (SS; the state K-major), its rows times e^{s_t};
//   y += (G o L dt_j) x (G o L dt_j from registers as hi + lo, x N-major;
//   the k steps of j past this warpgroup's rows skipped).
// The next head's x tile (cp.async), state (into registers, split and
// stored after the products) and dt (warp 0) are in flight during this
// head's products.
template <int HD, int S>
__global__ void __launch_bounds__(NTB, 1)
chunk_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ states,
              float* __restrict__ y, int Tn, int H, int ch, int group) {
  constexpr int SP = Pad<S>::SP, ST = Pad<S>::ST;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  uint8_t* gen = smraw - hop::smem_u32(smraw);
  const uint32_t bt = sm, ct = bt + Pad<S>::BC, xt0 = ct + Pad<S>::BC;
  const uint32_t st0 = xt0 + 2 * XB;  // state k: hi at st0 + 2k ST, lo + ST
  float* vec0 = reinterpret_cast<float*>(gen + st0 + 4 * ST);  // [2][3][CP]

  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int nc = Tn / ch;
  const int h0 = g * group, h1 = min(H, h0 + group);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32,
            lane = tid % 32;
  const uint32_t arow = wg * 64 * 128;  // this warpgroup's rows of a tile
  const long long row0 = (long long)b * Tn + (long long)c * ch;
  const long long xld = (long long)H * HD;
  const int nk = min(4 * (wg + 1), (ch + 15) / 16);  // live k steps of j
  hop::load_tall<CP, SP, NTB>(bt, Bm + row0 * S, S, ch, S, tid);
  hop::load_tall<CP, SP, NTB>(ct, Cm + row0 * S, S, ch, S, tid);
  hop::load_tall<CP, 64, NTB>(xt0, x + row0 * xld + h0 * HD, xld, ch, HD,
                              tid);
  hop::cp_commit();
  float hv[StateFrag<S>::IT][8], dnext[4];
  load_state<HD, S>(hv, states + (((long long)b * H + h0) * nc + c) * HD * S,
                    tid);
  store_state<S>(gen, st0, st0 + ST, hv, tid);
  if (warp == 0) {
    load_dt(dnext, dt, row0, H, h0, ch, lane);
    head_decays(dnext, vec0, vec0 + CP, vec0 + 2 * CP, nullptr, ch, A[h0]);
  }
  hop::cp_wait<0>();
  hop::fence_async_smem();
  __syncthreads();
  float gacc[64];  // G = C B^T: rows t of this warpgroup, columns j
#pragma unroll
  for (int i = 0; i < 64; ++i) gacc[i] = 0.f;
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
    hop::mma_ss_t<128, 0>(gacc, hop::desc_kt<CP>(ct + arow, kk),
                          hop::desc_kt<CP>(bt, kk), 1);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(gacc);

  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const uint32_t xt = xt0 + buf * XB, sh = st0 + 2 * buf * ST,
                   sl = sh + ST;
    const float* dtv = vec0 + buf * 3 * CP;
    const float* sv = dtv + CP;
    const float* es = sv + CP;
    if (h > h0) {
      hop::cp_wait<0>();
      hop::fence_async_smem();
      __syncthreads();  // this head's tiles and vectors are in; the
                        // previous head's are consumed
    }
    float anext = 0.f;
    if (h + 1 < h1) {
      hop::load_tall<CP, 64, NTB>(xt0 + (buf ^ 1) * XB,
                                  x + row0 * xld + (h + 1) * HD, xld, ch,
                                  HD, tid);
      hop::cp_commit();
      load_state<HD, S>(
          hv, states + (((long long)b * H + h + 1) * nc + c) * HD * S, tid);
      if (warp == 0) {
        load_dt(dnext, dt, row0, H, h + 1, ch, lane);
        anext = A[h + 1];
      }
    }
    float yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {  // C h_c^T
      hop::mma_ss_t<64, 0>(yacc, hop::desc_kt<CP>(ct + arow, kk),
                           hop::desc_kt<64>(sh, kk), 1);
      hop::mma_ss_t<64, 0>(yacc, hop::desc_kt<CP>(ct + arow, kk),
                           hop::desc_kt<64>(sl, kk), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(yacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= es[wg * 64 + hop::acc_row(i)];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nk) {
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float mv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = 8 * kk + 2 * e + q;
            const int t = wg * 64 + hop::acc_row(i), j = hop::acc_col(i);
            mv[q] = (j <= t && t < ch)
                        ? gacc[i] * expf(sv[t] - sv[j]) * dtv[j] : 0.f;
          }
          hop::split2(mv[0], mv[1], mh[e], ml[e]);
        }
        hop::mma_rs<64>(yacc, mh, hop::desc_nt<CP>(xt, kk));
        hop::mma_rs<64>(yacc, ml, hop::desc_nt<CP>(xt, kk));
      }
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(yacc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = wg * 64 + hop::acc_row(2 * r);
      if (t >= ch) continue;
      float* dst = y + (row0 + t) * xld + h * HD;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = 4 * q + 2 * r, d = hop::acc_col(i);
        if (d < HD)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(yacc[i], yacc[i + 1]);
      }
    }
    if (h + 1 < h1) {
      store_state<S>(gen, st0 + 2 * (buf ^ 1) * ST,
                     st0 + 2 * (buf ^ 1) * ST + ST, hv, tid);
      if (warp == 0) {
        float* nv = vec0 + (buf ^ 1) * 3 * CP;
        head_decays(dnext, nv, nv + CP, nv + 2 * CP, nullptr, ch, anext);
      }
    }
  }
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HD, int S>
cudaError_t launch_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* h0, void* y,
                       void* hT, void* states, int Bs, int Tn, int H, int ch,
                       cudaStream_t st) {
  const int bytes = Smem<HD, S>::fwd * (int)sizeof(float);
  cudaError_t e = allow_smem(fwd_kernel<T, HD, S>, bytes);
  if (e != cudaSuccess) return e;
  fwd_kernel<T, HD, S><<<dim3(H, Bs), NT, bytes, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)h0, (float*)y, (float*)hT, (float*)states,
      Tn, H, ch);
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

template <int HD, int S>
cudaError_t launch_bwd_tc(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, const void* states,
                          const void* dy, void* dx, void* ddt, void* dAp,
                          void* dB, void* dC, void* dBp, void* dCp, void* ub,
                          void* Dc, void* send, int Bs, int Tn, int H,
                          int ch, int group, cudaStream_t st) {
  using tc::bf16;
  const int nc = Tn / ch, groups = (H + group - 1) / group;
  constexpr int s1 = tc::dc_smem<S>(), s2 = tc::dxb_smem<S>();
  cudaError_t e = allow_smem(tc::dc_tc<HD, S>, s1);
  if (e == cudaSuccess) e = allow_smem(tc::dxb_tc<HD, S>, s2);
  if (e != cudaSuccess) return e;
  const dim3 grid(nc, Bs, groups);
  tc::dc_tc<HD, S><<<grid, tc::NTB, s1, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)states, (const float*)dy, (float*)dCp,
      (float*)ub, (float*)Dc, (float*)send, Bs, Tn, H, ch, group);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per = (long long)HD * S, n = (long long)Bs * H * per;
  tc::carry_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
      (float*)Dc, (const float*)send, per, n, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tc::dxb_tc<HD, S><<<grid, tc::NTB, s2, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)states, (const float*)dy,
      (const float*)Dc, (const float*)ub, (bf16*)dx, (float*)ddt,
      (float*)dAp, (float*)dBp, Bs, Tn, H, ch, group);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long nel = (long long)Bs * Tn * S;
  tc::sum_groups<<<(unsigned)((nel / 4 + 255) / 256), 256, 0, st>>>(
      (const float*)dBp, (const float*)dCp, (bf16*)dB, (bf16*)dC, nel,
      groups);
  return cudaGetLastError();
}

template <int HD, int S>
cudaError_t launch_fwd_tc(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, const void* h0,
                          void* y, void* hT, void* states, void* send, int Bs,
                          int Tn, int H, int ch, int group, cudaStream_t st) {
  using tc::bf16;
  const int nc = Tn / ch, groups = (H + group - 1) / group;
  constexpr int s1 = tc::state_smem<S>(), s3 = tc::scan_smem<S>();
  cudaError_t e = allow_smem(tc::chunk_state_tc<HD, S>, s1);
  if (e == cudaSuccess) e = allow_smem(tc::chunk_scan_tc<HD, S>, s3);
  if (e != cudaSuccess) return e;
  const dim3 grid(nc, Bs, groups);
  tc::chunk_state_tc<HD, S><<<grid, tc::NTB, s1, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (float*)states, (float*)hT, (float*)send, Tn, H, ch, group);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per = (long long)HD * S, n = (long long)Bs * H * per;
  tc::state_pass<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
      (float*)states, (float*)hT, (const float*)send, (const float*)h0, per,
      n, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tc::chunk_scan_tc<HD, S><<<grid, tc::NTB, s3, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)states, (float*)y, Tn, H, ch, group);
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
// (dtype), h0 [Bs,H,hd,S] fp32 or null (a zero start); T a multiple of
// chunk (<= 128); hd 32 or 64, S 32 or 128. Writes y [Bs,T,H,hd] fp32,
// hT [Bs,H,hd,S] fp32 and the state before each chunk [Bs,H,T/chunk,hd,S]
// fp32.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* h0,
                            void* y, void* hT, void* states, int Bs, int T,
                            int H, int hd, int S, int chunk, int dtype,
                            void* stream) {
  if (bad_shape(Bs, T, H, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SSD_DISPATCH(dtype, hd, S, (launch_fwd<T_, HD, S_>(
      x, dt, A, B, C, h0, y, hT, states, Bs, T, H, chunk, st)));
}

// The bf16 route (tensor cores): the forward's inputs and outputs, with
// bf16 x, B and C; ``group`` heads a block; send [Bs,H,T/chunk] fp32 is
// scratch.
extern "C" int ssd_scan_fwd_tc(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* h0,
                               void* y, void* hT, void* states, void* send,
                               int Bs, int T, int H, int hd, int S, int chunk,
                               int group, void* stream) {
  if (bad_shape(Bs, T, H, chunk) || group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SSD_TC(HD_, S_)                                                    \
  if (hd == HD_ && S == S_)                                                \
    return (int)launch_fwd_tc<HD_, S_>(x, dt, A, B, C, h0, y, hT, states, \
                                      send, Bs, T, H, chunk, group, st);
  SSD_TC(32, 32)
  SSD_TC(32, 128)
  SSD_TC(64, 32)
  SSD_TC(64, 128)
#undef SSD_TC
  return (int)cudaErrorInvalidValue;
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

// The bf16 route (tensor cores): the forward's inputs and states, dy
// [Bs,T,H,hd] fp32 -> dx [Bs,T,H,hd] bf16, ddt [Bs,T,H] fp32, dAp
// [Bs,H,T/chunk] fp32 (the caller sums it), dB and dC [Bs,T,S] bf16.
// Scratch, all fp32: dBp and dCp [ceil(H/group),Bs,T,S], ub [Bs,T,H], Dc
// [Bs,H,T/chunk,hd,S], send [Bs,H,T/chunk].
extern "C" int ssd_scan_bwd_tc(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* states, const void* dy, void* dx,
                               void* ddt, void* dAp, void* dB, void* dC,
                               void* dBp, void* dCp, void* ub, void* Dc,
                               void* send, int Bs, int T, int H, int hd,
                               int S, int chunk, int group, void* stream) {
  if (bad_shape(Bs, T, H, chunk) || group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SSD_TC(HD_, S_)                                                    \
  if (hd == HD_ && S == S_)                                                \
    return (int)launch_bwd_tc<HD_, S_>(x, dt, A, B, C, states, dy, dx, ddt, \
                                      dAp, dB, dC, dBp, dCp, ub, Dc, send, \
                                      Bs, T, H, chunk, group, st);
  SSD_TC(32, 32)
  SSD_TC(32, 128)
  SSD_TC(64, 32)
  SSD_TC(64, 128)
#undef SSD_TC
  return (int)cudaErrorInvalidValue;
}
