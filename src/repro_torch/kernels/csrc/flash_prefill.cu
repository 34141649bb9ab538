// Dense causal flash attention, forward and backward, over contiguous
// q [B,T,H,hd] and k/v [B,T,KV,hd] (the training path's attention).
//
// Replaces the TPU kernel flash_prefill_kernel of
// src/repro/kernels/flash_prefill/kernel.py, which took heads repeated
// to H == KV and T padded to its block; the JAX package differentiates
// the same attention with XLA autodiff, so the backward has no TPU
// kernel of its own.
//
// Two routes, chosen by dtype in flash_prefill_fwd / flash_prefill_bwd
// (an explicit dispatch, not a fallback: a bf16 call that cannot launch
// raises):
//
// bf16: tensor-core kernels (namespace tc, tile machinery in
// hopper.cuh). Bound on the H100: operations. At the training shapes (T
// = 2048) the forward does 4 * hd flops per live (query row, key) pair
// and the backward 10 * hd, about 500 flops per byte moved, above the
// ~295 at which the bf16 tensor cores, not the memory, become the limit.
// So every product runs as a warpgroup wgmma on bf16 tiles staged in
// shared memory by cp.async (a two-stage ring, the next tiles copied
// while this one is multiplied), with 64-row query and key tiles:
//  - fwd_tc: one warpgroup per (query head, batch row, query tile); S =
//    Q K^T, the online softmax on S's registers, O += P V with P from
//    registers. Heads are not repeated: the rep heads of a kv head read
//    the same K/V tiles through L2.
//  - dq_tc: the same blocks; D = rowsum(dO * O), then per key tile S and
//    dP = dO V^T, dS = P (dP - D), dQ += dS K.
//  - dkdv_tc: two warpgroups per (kv head, head group, batch row, key
//    tile), dV and dK one in each, K and V resident, sweeping the live
//    query tiles of the group's heads. Where one group would leave fewer
//    blocks than the card has SMs several times over (recurrentgemma-9b:
//    16 heads on one kv head), the heads split into G groups that write
//    fp32 partial sums, summed in group order by sum_parts.
// Each dQ, dK, dV element has one writer or a fixed-order sum: no
// atomics, so the backward is deterministic. P and dS enter their
// products as bf16 hi + lo halves (hopper.cuh), so they keep about 16
// bits; products accumulate in fp32. Masks (causal, window, the ragged
// edge of T) are evaluated only on the tiles that need them; rows and
// keys past T are copied as zeros and never written.
//
// fp32: the CUDA-core kernels, whose products run in
// fp32 (the bf16 tensor cores cannot hold fp32's tolerance). They are
// the sweep of the paged prefill kernel (flash::sweep in common.cuh)
// with a contiguous key address and no prior context:
//  - fwd_kernel: one block per (request, kv head, query tile): the rep =
//    H/KV query heads of the kv head share each K/V tile in shared
//    memory; the block sweeps only its live keys [first query - window
//    + 1, last query].
//  - dq_kernel: the same blocks; D = rowsum(dO * O), then P = exp(S *
//    scale - lse), dP = dO V^T, dS = P * (dP - D), dQ += scale * dS K.
//  - dkdv_kernel: one block per (request, kv head, tile of 32 keys; 16
//    at hd 256), threads per key row holding K, V, dK and dV slices in
//    registers, looping over the live query rows of all rep heads.
// At hd 256 a query row has eight threads and a key tile 16 positions
// (flash::Tile), so every fp32 tile stays in 32 KB of static shared
// memory; the query heads of a kv head must divide a block's rows (64,
// 32 at hd 256).
//
// Both routes: scores scaled by hd^-0.5, the output divided by max(l,
// 1e-30), the row's log-sum-exp written in fp32 (REPRO_NEG_INF for a row
// with no live key), any T.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using flash::NT;
using flash::Tile;

// Row ownership shared by the forward and dq kernels: the query row
// (head h, position qi) of this thread, Tile<HD>::TPR threads per row.
template <int HD> struct RowMap {
  int tile, kvh, b, h, qi, qq, q_first, q_last, lo;
  bool ok;
  __device__ RowMap(int T, int H, int KV, int window) {
    constexpr int TPR = Tile<HD>::TPR;
    const int rep = H / KV;
    const int bq = Tile<HD>::ROWS / rep;
    tile = gridDim.x - 1 - blockIdx.x;  // the longest sweeps start first
    kvh = blockIdx.y;
    b = blockIdx.z;
    const int row = threadIdx.x / TPR;
    qq = threadIdx.x % TPR;
    h = kvh * rep + row / bq;
    qi = tile * bq + row % bq;
    ok = qi < T;
    q_first = tile * bq;
    q_last = min(q_first + bq, T) - 1;
    lo = window > 0 ? max(0, q_first - window + 1) : 0;
  }
  __device__ long long elem(int T, int H) const {
    return (((long long)b * T + qi) * H + h) * HD;
  }
  __device__ long long stat(int T, int H) const {
    return ((long long)b * H + h) * T + qi;
  }
};

template <int HD>
__device__ __forceinline__ void load_row(float (&r)[Tile<HD>::PER],
                                         const float* x, long long o,
                                         bool ok, int qq) {
#pragma unroll
  for (int i = 0; i < Tile<HD>::PER; ++i)
    r[i] = ok ? x[o + Tile<HD>::TPR * i + qq] : 0.f;
}

// The sum over the TPR threads of a row; every one of them gets it.
template <int HD>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < Tile<HD>::TPR; w <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int Tn, int H, int KV, int window,
           float scale) {
  constexpr int PER = Tile<HD>::PER;
  constexpr int TPR = Tile<HD>::TPR;
  const RowMap<HD> rm(Tn, H, KV, window);
  const int kvh = rm.kvh, b = rm.b;
  auto key_off = [=](int kp) -> long long {
    return (((long long)b * Tn + kp) * KV + kvh) * HD;
  };
  float qr[PER];
  load_row<HD>(qr, q, rm.elem(Tn, H), rm.ok, rm.qq);

  __shared__ flash::KVTile<HD> sm;
  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  flash::sweep<HD>(sm, k, v, key_off, qr, rm.lo, rm.q_last + 1, rm.qi,
                   rm.qi, window, scale, m, l, acc);

  if (rm.ok) {
    const long long o = rm.elem(Tn, H);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      out[o + TPR * i + rm.qq] = acc[i] * inv;
    if (rm.qq == 0)
      lse[rm.stat(Tn, H)] = l > 0.f ? m + logf(l) : REPRO_NEG_INF;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ out,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int Tn, int H,
          int KV, int window, float scale) {
  constexpr int PER = Tile<HD>::PER;
  constexpr int TPR = Tile<HD>::TPR;
  constexpr int BK = Tile<HD>::BK;
  const RowMap<HD> rm(Tn, H, KV, window);
  const int kvh = rm.kvh, b = rm.b, qq = rm.qq;
  auto key_off = [=](int kp) -> long long {
    return (((long long)b * Tn + kp) * KV + kvh) * HD;
  };
  const long long o = rm.elem(Tn, H);
  float qr[PER], dor[PER], acc[PER];
  load_row<HD>(qr, q, o, rm.ok, qq);
  load_row<HD>(dor, dout, o, rm.ok, qq);
  // D = rowsum(dO * O), reusing acc to hold the output row
  load_row<HD>(acc, out, o, rm.ok, qq);
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) dsum += dor[i] * acc[i];
  dsum = row_sum<HD>(dsum);
  const float lse_r = rm.ok ? lse[rm.stat(Tn, H)] : 0.f;
  if (rm.ok && qq == 0) delta[rm.stat(Tn, H)] = dsum;
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  __shared__ flash::KVTile<HD> sm;
  const int hi = rm.q_last + 1;
  for (int t0 = rm.lo; t0 < hi; t0 += BK) {
    flash::stage_tile<HD>(sm, k, v, t0, hi, key_off);
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float s = flash::row_dot<HD>(qr, sm.k, j, qq);
      const float dp = flash::row_dot<HD>(dor, sm.v, j, qq);
      const bool on = flash::live(t0 + j, hi, rm.qi, rm.qi, window);
      const float p = on ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - dsum);
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += ds * sm.k[j][TPR * i + qq];
    }
  }
  if (rm.ok) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      dq[o + TPR * i + qq] = acc[i] * scale;
  }
}

// Tiling of dkdv_kernel by head dim: KB keys per block, LPK threads per
// key row, QR query rows staged at a time. At hd 256 a key row has 16
// threads, so that each holds the same 16 elements of K, V, dK and dV as
// at hd 128, and a block 16 keys and 16 staged rows, so that it keeps
// 256 threads and 32 KB of static shared memory.
template <int HD> struct KTile {
  static constexpr int KB = HD > 128 ? 16 : 32;
  static constexpr int LPK = HD > 128 ? 16 : 8;
  static constexpr int QR = HD > 128 ? 16 : 32;
  static constexpr int NTB = KB * LPK;
};

template <int HD>
__global__ void __launch_bounds__(KTile<HD>::NTB)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Tn, int H,
            int KV, int window, float scale) {
  constexpr int KB = KTile<HD>::KB;
  constexpr int LPK = KTile<HD>::LPK;
  constexpr int QR = KTile<HD>::QR;
  constexpr int NTB = KTile<HD>::NTB;
  constexpr int PER = HD / LPK;
  const int tile = blockIdx.x;  // early keys have the most queries
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid % LPK;
  const int kpos = tile * KB + tid / LPK;
  const bool key_ok = kpos < Tn;
  const long long ko = (((long long)b * Tn + kpos) * KV + kvh) * HD;

  float kr[PER], vr[PER], dkr[PER], dvr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    kr[i] = key_ok ? k[ko + LPK * i + lane] : 0.f;
    vr[i] = key_ok ? v[ko + LPK * i + lane] : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }
  // live query positions of this key tile: [k_first, t_hi)
  const int k_first = tile * KB;
  const int k_last = min(k_first + KB, Tn) - 1;
  const int t_hi = window > 0 ? min(Tn, k_last + window) : Tn;
  const int nrows = (t_hi - k_first) * rep;

  __shared__ float qs[QR][HD];
  __shared__ float dos[QR][HD];
  __shared__ float lse_s[QR];
  __shared__ float del_s[QR];
  __shared__ int tpos[QR];

  for (int r0 = 0; r0 < nrows; r0 += QR) {
    __syncthreads();  // the previous rows are consumed
    // row index r0 + rr is (position k_first + idx / rep, head idx % rep)
    for (int x = tid; x < QR * HD; x += NTB) {
      const int rr = x / HD;
      const int d = x % HD;
      const int idx = r0 + rr;
      float qv = 0.f, dov = 0.f;
      if (idx < nrows) {
        const int t = k_first + idx / rep;
        const int h = kvh * rep + idx % rep;
        const long long off = (((long long)b * Tn + t) * H + h) * HD + d;
        qv = q[off];
        dov = dout[off];
      }
      qs[rr][d] = qv;
      dos[rr][d] = dov;
    }
    if (tid < QR) {
      const int idx = r0 + tid;
      int t = -1;
      float lv = 0.f, dl = 0.f;
      if (idx < nrows) {
        t = k_first + idx / rep;
        const long long st =
            ((long long)b * H + kvh * rep + idx % rep) * Tn + t;
        lv = lse[st];
        dl = delta[st];
      }
      tpos[tid] = t;
      lse_s[tid] = lv;
      del_s[tid] = dl;
    }
    __syncthreads();

#pragma unroll 2
    for (int rr = 0; rr < QR; ++rr) {
      float qv[PER], dov[PER];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        qv[i] = qs[rr][LPK * i + lane];
        dov[i] = dos[rr][LPK * i + lane];
        s += qv[i] * kr[i];
        dp += dov[i] * vr[i];
      }
#pragma unroll
      for (int w = 1; w < LPK; w <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, w);
        dp += __shfl_xor_sync(0xffffffffu, dp, w);
      }
      const int t = tpos[rr];
      const bool on = key_ok && t >= kpos &&
                      (window <= 0 || kpos > t - window);
      const float p = on ? expf(s * scale - lse_s[rr]) : 0.f;
      const float dsv = p * (dp - del_s[rr]);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dvr[i] += p * dov[i];
        dkr[i] += dsv * qv[i];
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      dk[ko + LPK * i + lane] = dkr[i] * scale;
      dv[ko + LPK * i + lane] = dvr[i];
    }
  }
}

template <int HD>
void launch_fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Tn, int H, int KV, int window,
                float scale, cudaStream_t st) {
  const int bq = Tile<HD>::ROWS / (H / KV);
  dim3 grid((Tn + bq - 1) / bq, KV, B);
  fwd_kernel<HD><<<grid, NT, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, Tn, H, KV, window, scale);
}

template <int HD>
void launch_bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, int B, int Tn, int H, int KV, int window,
                float scale, cudaStream_t st) {
  const int bq = Tile<HD>::ROWS / (H / KV);
  dim3 grid_q((Tn + bq - 1) / bq, KV, B);
  dq_kernel<HD><<<grid_q, NT, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)out,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq, Tn,
      H, KV, window, scale);
  constexpr int KB = KTile<HD>::KB;
  constexpr int NTB = KTile<HD>::NTB;
  dim3 grid_k((Tn + KB - 1) / KB, KV, B);
  dkdv_kernel<HD><<<grid_k, NTB, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Tn, H,
      KV, window, scale);
}

// ---------------------------------------------------------------------------
// The bf16 route: tensor-core kernels (hopper.cuh)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using hop::TR;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A key at kp is live for a query at qp (flash::live with hi = T, last =
// qp).
__device__ __forceinline__ bool live(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// Forward. One warpgroup per (query head, batch row, 64-row query tile),
// the longest sweeps first. Shared memory: the Q tile and a two-stage
// ring of (K, V) tiles; the next tiles' copies run while this one is
// multiplied. S = Q K^T (SS), the online softmax on S's registers in
// base 2, O += P V with P from registers (hi and lo) and V N-major.
template <int HD>
__global__ void __launch_bounds__(128)
fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, bf16* __restrict__ out,
       float* __restrict__ lse, int T, int H, int KV, int window,
       float scale) {
  constexpr int TB = hop::Tile<HD>::BYTES;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TR;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const long long qld = (long long)H * HD, kld = (long long)KV * HD;
  const bf16* kg = k + (long long)b * T * kld + kvh * HD;
  const bf16* vg = v + (long long)b * T * kld + kvh * HD;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(q0 + TR - 1, T - 1);
  const int t0 = lo / TR, n = hi / TR - t0 + 1;

  hop::load_tile<HD, 128>(sm, q + ((long long)b * T + q0) * qld + h * HD,
                          qld, T - q0, tid);
  auto load_kv = [&](int it) {
    const int k0 = (t0 + it) * TR;
    const uint32_t st = sm + TB * (1 + 2 * (it & 1));
    hop::load_tile<HD, 128>(st, kg + k0 * kld, kld, T - k0, tid);
    hop::load_tile<HD, 128>(st + TB, vg + k0 * kld, kld, T - k0, tid);
  };
  load_kv(0);
  hop::cp_commit();

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_kv(it + 1);
      hop::cp_commit();
      hop::cp_wait<1>();
    } else {
      hop::cp_wait<0>();
    }
    hop::fence_async_smem();
    __syncthreads();
    const uint32_t ks = sm + TB * (1 + 2 * (it & 1)), vs = ks + TB;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hop::mma_ss<64>(s, hop::desc_k<HD>(sm, kk), hop::desc_k<HD>(ks, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);

    const int k0 = (t0 + it) * TR;
    const bool edge =
        k0 + TR - 1 > q0 || (window > 0 && k0 <= q0 + TR - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * c;
      if (edge && !live(k0 + hop::acc_col(i), q0 + hop::acc_row(i), window))
        x = -INFINITY;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      base[r] = mn == -INFINITY ? 0.f : mn;   // a row with no live key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - base[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::split_frag(s, kk, ph[kk], pl[kk]);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::mma_rs<HD>(o, ph[kk], hop::desc_n<HD>(vs, kk));
      hop::mma_rs<HD>(o, pl[kk], hop::desc_n<HD>(vs, kk));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(o);
    __syncthreads();  // this stage is free for the copy after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + hop::acc_row(2 * r);
    if (row >= T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((long long)b * T + row) * qld + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + hop::acc_col(i)) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
    if (tid % 4 == 0)
      lse[((long long)b * H + h) * T + row] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : REPRO_NEG_INF;
  }
}

// dQ. One warpgroup per (query head, batch row, 64-row query tile): D =
// rowsum(dO * O) first (written to ``delta`` for dkdv_tc), then over the
// live key tiles: S = Q K^T and dP = dO V^T (SS), P = exp2(S c - lse
// log2 e), dS = P (dP - D), dQ += dS K (dS from registers, hi and lo; K
// N-major). Shared memory: Q, dO and a two-stage (K, V) ring.
template <int HD>
__global__ void __launch_bounds__(128)
dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
      const bf16* __restrict__ v, const bf16* __restrict__ out,
      const bf16* __restrict__ dout, const float* __restrict__ lse,
      float* __restrict__ delta, bf16* __restrict__ dq, int T, int H,
      int KV, int window, float scale) {
  constexpr int TB = hop::Tile<HD>::BYTES;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  float* dsm = reinterpret_cast<float*>(smraw + (sm - hop::smem_u32(smraw)) +
                                        6 * TB);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TR;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const long long qld = (long long)H * HD, kld = (long long)KV * HD;
  const long long qoff = ((long long)b * T + q0) * qld + h * HD;
  const bf16* kg = k + (long long)b * T * kld + kvh * HD;
  const bf16* vg = v + (long long)b * T * kld + kvh * HD;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(q0 + TR - 1, T - 1);
  const int t0 = lo / TR, n = hi / TR - t0 + 1;

  hop::load_tile<HD, 128>(sm, q + qoff, qld, T - q0, tid);
  hop::load_tile<HD, 128>(sm + TB, dout + qoff, qld, T - q0, tid);
  auto load_kv = [&](int it) {
    const int k0 = (t0 + it) * TR;
    const uint32_t st = sm + TB * (2 + 2 * (it & 1));
    hop::load_tile<HD, 128>(st, kg + k0 * kld, kld, T - k0, tid);
    hop::load_tile<HD, 128>(st + TB, vg + k0 * kld, kld, T - k0, tid);
  };
  load_kv(0);
  hop::cp_commit();

  {  // D: two threads a row, HD / 2 elements each
    const int row = tid / 2, half = tid % 2;
    float d = 0.f;
    if (q0 + row < T) {
      const long long o = qoff + row * qld + half * (HD / 2);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const uint4 a = *reinterpret_cast<const uint4*>(out + o + 8 * j);
        const uint4 g = *reinterpret_cast<const uint4*>(dout + o + 8 * j);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(g2[e]);
          d += x.x * y.x + x.y * y.y;
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      dsm[row] = d;
      if (q0 + row < T) delta[((long long)b * H + h) * T + q0 + row] = d;
    }
  }
  __syncthreads();
  float dr[2], lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = hop::acc_row(2 * r);
    dr[r] = dsm[row];
    lr[r] = q0 + row < T ? lse[((long long)b * H + h) * T + q0 + row] * LOG2E
                         : 0.f;
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float c = scale * LOG2E;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_kv(it + 1);
      hop::cp_commit();
      hop::cp_wait<1>();
    } else {
      hop::cp_wait<0>();
    }
    hop::fence_async_smem();
    __syncthreads();
    const uint32_t ks = sm + TB * (2 + 2 * (it & 1)), vs = ks + TB;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hop::mma_ss<64>(s, hop::desc_k<HD>(sm, kk), hop::desc_k<HD>(ks, kk), 1);
      hop::mma_ss<64>(dp, hop::desc_k<HD>(sm + TB, kk),
                      hop::desc_k<HD>(vs, kk), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);

    const int k0 = (t0 + it) * TR;
    const bool edge =
        k0 + TR - 1 > q0 || (window > 0 && k0 <= q0 + TR - 1 - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(s[i] * c - lr[r]);
      if (edge && !live(k0 + hop::acc_col(i), q0 + hop::acc_row(i), window))
        p = 0.f;
      s[i] = p * (dp[i] - dr[r]);
    }
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::split_frag(s, kk, fh[kk], fl[kk]);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::mma_rs<HD>(acc, fh[kk], hop::desc_n<HD>(ks, kk));
      hop::mma_rs<HD>(acc, fl[kk], hop::desc_n<HD>(ks, kk));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = hop::acc_row(2 * r);
    if (q0 + row >= T) continue;
    bf16* drow = dq + qoff + row * qld;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(drow + hop::acc_col(i)) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// dK and dV. Two warpgroups per (kv head and head group, batch row,
// 64-key tile), the longest sweeps first: warpgroup 0 owns dV, warpgroup
// 1 dK, each 64 x HD in its registers. The block keeps its K and V
// tiles in shared memory and sweeps the live query tiles of the heads of
// its group through a two-stage ring of (Q, dO, lse, D) tiles. Per tile:
// S^T = K Q^T on warpgroup 0 while dP^T = V dO^T runs on warpgroup 1
// (SS); warpgroup 0 makes P^T and hands it to warpgroup 1 through
// shared memory in its own register order; then dV += P^T dO on
// warpgroup 0 and dK += dS^T Q with dS^T = P^T (dP^T - D) on warpgroup
// 1 (A from registers, hi and lo; B N-major). With one group the block
// writes dK (scaled) and dV in bf16; with G groups each writes fp32
// partial sums to ``part`` [2][G][B,T,KV,HD] for sum_parts.
template <int HD>
__global__ void __launch_bounds__(256, 1)
dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv,
        float* __restrict__ part, int B, int T, int H, int KV, int groups,
        int window, float scale) {
  constexpr int TB = hop::Tile<HD>::BYTES;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  uint8_t* base = smraw + (sm - hop::smem_u32(smraw));
  float* stats = reinterpret_cast<float*>(base + 6 * TB);  // [2][lse, D][64]
  float* xchg = stats + 4 * TR;                            // [32][128]
  const int rep = H / KV, hpg = rep / groups;
  const int kvh = blockIdx.x / groups, g = blockIdx.x % groups;
  const int b = blockIdx.y;
  const int kt = blockIdx.z, k0 = kt * TR;
  const int tid = threadIdx.x, wg = tid / 128;
  const long long qld = (long long)H * HD, kld = (long long)KV * HD;
  const long long koff = ((long long)b * T + k0) * kld + kvh * HD;
  const int qhi = window > 0 ? min(T - 1, k0 + TR - 1 + window - 1) : T - 1;
  const int nq = qhi / TR - kt + 1, n = hpg * nq;

  hop::load_tile<HD, 256>(sm, k + koff, kld, T - k0, tid);
  hop::load_tile<HD, 256>(sm + TB, v + koff, kld, T - k0, tid);
  auto load_q = [&](int it) {
    const int h = kvh * rep + g * hpg + it / nq;
    const int q0 = (kt + it % nq) * TR;
    const int st = it & 1;
    const long long off = ((long long)b * T + q0) * qld + h * HD;
    hop::load_tile<HD, 256>(sm + TB * (2 + 2 * st), q + off, qld, T - q0,
                            tid);
    hop::load_tile<HD, 256>(sm + TB * (3 + 2 * st), dout + off, qld,
                            T - q0, tid);
    if (tid < 2 * TR) {
      const int j = tid % TR;
      const float* src = (tid < TR ? lse : delta) +
                         ((long long)b * H + h) * T + q0 + j;
      hop::cp_async4(hop::smem_u32(stats + st * 2 * TR + tid), src,
                     q0 + j < T);
    }
  };
  load_q(0);
  hop::cp_commit();

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float c = scale * LOG2E;
  const int wt = tid % 128;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_q(it + 1);
      hop::cp_commit();
      hop::cp_wait<1>();
    } else {
      hop::cp_wait<0>();
    }
    hop::fence_async_smem();
    __syncthreads();
    const int st = it & 1;
    const uint32_t qs = sm + TB * (2 + 2 * st), dos = qs + TB;
    const float* ls = stats + st * 2 * TR;
    const float* ds = ls + TR;
    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    const uint32_t a_op = wg == 0 ? sm : sm + TB;
    const uint32_t b_op = wg == 0 ? qs : dos;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hop::mma_ss<64>(s, hop::desc_k<HD>(a_op, kk),
                      hop::desc_k<HD>(b_op, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);

    const int q0 = (kt + it % nq) * TR;
    if (wg == 0) {
      const bool edge = q0 == k0 || q0 + TR > T ||
                        (window > 0 && q0 + TR - 1 - window >= k0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cq = hop::acc_col(i), qp = q0 + cq;
        float p = exp2f(s[i] * c - ls[cq] * LOG2E);
        if (edge && !(qp < T && live(k0 + hop::acc_row(i), qp, window)))
          p = 0.f;
        s[i] = p;
        xchg[i * 128 + wt] = p;
      }
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = xchg[i * 128 + wt] * (s[i] - ds[hop::acc_col(i)]);
    }
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::split_frag(s, kk, fh[kk], fl[kk]);
    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
    const uint32_t n_op = wg == 0 ? dos : qs;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::mma_rs<HD>(acc, fh[kk], hop::desc_n<HD>(n_op, kk));
      hop::mma_rs<HD>(acc, fl[kk], hop::desc_n<HD>(n_op, kk));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncthreads();  // the stage and the exchange are free
  }

  const float mul = wg == 1 ? scale : 1.f;
  const long long nel = (long long)B * T * kld;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = hop::acc_row(2 * r);
    if (k0 + row >= T) continue;
    const long long o = koff + row * kld;
    if (groups == 1) {
      bf16* dst = (wg == 0 ? dv : dk) + o;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dst + hop::acc_col(i)) =
            __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
      }
    } else {
      float* dst = part + ((long long)(1 - wg) * groups + g) * nel + o;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(dst + hop::acc_col(i)) =
            make_float2(acc[i] * mul, acc[i + 1] * mul);
      }
    }
  }
}

// dK and dV from the groups' partial sums, in group order.
__global__ void sum_parts(const float* __restrict__ part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          long long nel, int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < nel; i += (long long)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < groups; ++g) {
      sk += part[(long long)g * nel + i];
      sv += part[(long long)(groups + g) * nel + i];
    }
    dk[i] = __float2bfloat16_rn(sk);
    dv[i] = __float2bfloat16_rn(sv);
  }
}

// The tile machinery alone, on one warpgroup: mode 0, C [64,64] = A B^T
// with A and B [64,HD] bf16 K-major in shared memory (the products S = Q
// K^T and dP = dO V^T); mode 1, C [64,HD] = A B with A [64,64] fp32 split
// into hi and lo register fragments and B [64,HD] bf16 N-major (P V, dS
// K, P^T dO, dS^T Q).
template <int HD>
__global__ void __launch_bounds__(128)
tile_check(const void* __restrict__ a, const bf16* __restrict__ bm,
           float* __restrict__ cm, int mode) {
  constexpr int TB = hop::Tile<HD>::BYTES;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  const int tid = threadIdx.x;
  if (mode == 0)
    hop::load_tile<HD, 128>(sm + TB, (const bf16*)a, HD, TR, tid);
  hop::load_tile<HD, 128>(sm, bm, HD, TR, tid);
  hop::cp_commit();
  hop::cp_wait<0>();
  hop::fence_async_smem();
  __syncthreads();
  if (mode == 0) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hop::mma_ss<64>(s, hop::desc_k<HD>(sm + TB, kk),
                      hop::desc_k<HD>(sm, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      cm[hop::acc_row(i) * TR + hop::acc_col(i)] = s[i];
  } else {
    const float* af = (const float*)a;
    float s[32], o[HD / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = af[hop::acc_row(i) * TR + hop::acc_col(i)];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::split_frag(s, kk, fh[kk], fl[kk]);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::mma_rs<HD>(o, fh[kk], hop::desc_n<HD>(sm, kk));
      hop::mma_rs<HD>(o, fl[kk], hop::desc_n<HD>(sm, kk));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(o);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      cm[hop::acc_row(i) * HD + hop::acc_col(i)] = o[i];
  }
}

// Dynamic shared memory of each kernel: its tiles (and the dq and dkdv
// kernels' row statistics and exchange), plus 1024 bytes of slack for
// the tiles' alignment.
template <int HD> constexpr int fwd_smem() {
  return 5 * hop::Tile<HD>::BYTES + 1024;        // Q, 2 x (K, V)
}
template <int HD> constexpr int dq_smem() {
  return 6 * hop::Tile<HD>::BYTES + TR * 4 + 1024;  // Q, dO, 2 x (K, V), D
}
template <int HD> constexpr int dkdv_smem() {
  // K, V, 2 x (Q, dO); 2 x (lse, D); the P^T exchange
  return 6 * hop::Tile<HD>::BYTES + 4 * TR * 4 + 32 * 128 * 4 + 1024;
}

template <typename K, typename... A>
void launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t st,
            A... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<grid, threads, smem, st>>>(args...);
}

template <int HD>
void launch_fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int T, int H, int KV, int window,
                float scale, cudaStream_t st) {
  launch(fwd_tc<HD>, dim3(H, B, (T + TR - 1) / TR), 128, fwd_smem<HD>(),
         st, (const bf16*)q, (const bf16*)k,
         (const bf16*)v, (bf16*)out, (float*)lse, T, H, KV, window, scale);
}

template <int HD>
void launch_bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, void* part, int B, int T, int H, int KV,
                int groups, int window, float scale, cudaStream_t st) {
  const int nt = (T + TR - 1) / TR;
  launch(dq_tc<HD>, dim3(H, B, nt), 128, dq_smem<HD>(), st,
         (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)out,
         (const bf16*)dout, (const float*)lse, (float*)delta, (bf16*)dq, T,
         H, KV, window, scale);
  launch(dkdv_tc<HD>, dim3(KV * groups, B, nt), 256, dkdv_smem<HD>(), st,
         (const bf16*)q,
         (const bf16*)k, (const bf16*)v, (const bf16*)dout,
         (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
         (float*)part, B, T, H, KV, groups, window, scale);
  if (groups > 1) {
    const long long nel = (long long)B * T * KV * HD;
    sum_parts<<<(int)min((nel + 255) / 256, 4096LL), 256, 0, st>>>(
        (const float*)part, (bf16*)dk, (bf16*)dv, nel, groups);
  }
}

}  // namespace tc

// Runs CALL with HD bound to the head dim, or returns
// cudaErrorInvalidValue from the enclosing function.
#define FLASH_HD(hd, CALL)                                               \
  switch (hd) {                                                          \
    case 64: { constexpr int HD = 64; CALL; break; }                     \
    case 128: { constexpr int HD = 128; CALL; break; }                   \
    case 256: { constexpr int HD = 256; CALL; break; }                   \
    default: return (int)cudaErrorInvalidValue;                          \
  }

// In fp32 the query heads of a kv head must divide the rows of a block:
// 64 at hd 64 and 128, 32 at hd 256. The bf16 kernels take any rep.
bool bad_heads(int H, int KV, int hd, int dtype) {
  if (KV <= 0 || H % KV != 0) return true;
  if (dtype == DT_BF16) return false;
  const int rows = hd > 128 ? Tile<256>::ROWS : Tile<128>::ROWS;
  return dtype != DT_F32 || rows % (H / KV) != 0;
}

}  // namespace

// q/out [B,T,H,hd], k/v [B,T,KV,hd], all of one dtype; lse [B,H,T] fp32.
// window <= 0: none.
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int T, int H,
                                 int KV, int hd, int window, float scale,
                                 int dtype, void* stream) {
  if (bad_heads(H, KV, hd, dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) {
    FLASH_HD(hd, (tc::launch_fwd<HD>(q, k, v, out, lse, B, T, H, KV, window,
                                     scale, st)));
  } else {
    FLASH_HD(hd, (launch_fwd<HD>(q, k, v, out, lse, B, T, H, KV,
                                        window, scale, st)));
  }
  return (int)cudaGetLastError();
}

// The forward's inputs, its out and lse, and dout [B,T,H,hd]; writes
// dq [B,T,H,hd], dk/dv [B,T,KV,hd] (the inputs' dtype) and delta
// [B,H,T] fp32 scratch (rowsum(dout * out)). bf16: the query heads of a
// kv head form ``groups`` groups (groups divides H/KV); with more than
// one, ``part`` is fp32 scratch [2, groups, B, T, KV, hd]. fp32 ignores
// both.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* part, int B, int T,
                                 int H, int KV, int hd, int window,
                                 int groups, float scale, int dtype,
                                 void* stream) {
  if (bad_heads(H, KV, hd, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16 && (groups < 1 || (H / KV) % groups != 0 ||
                           (groups > 1 && part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) {
    FLASH_HD(hd, (tc::launch_bwd<HD>(q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, part, B, T, H, KV, groups, window,
                                     scale, st)));
  } else {
    FLASH_HD(hd, (launch_bwd<HD>(q, k, v, out, dout, lse, delta, dq,
                                        dk, dv, B, T, H, KV, window, scale,
                                        st)));
  }
  return (int)cudaGetLastError();
}

// The tile machinery's check (tests and chip_smoke.py only): mode 0, c
// [64,64] fp32 = a b^T with a, b [64,hd] bf16; mode 1, c [64,hd] fp32 =
// a b with a [64,64] fp32 and b [64,hd] bf16.
extern "C" int flash_tile_check(const void* a, const void* b, void* c,
                                int hd, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_HD(hd, (tc::launch(tc::tile_check<HD>, dim3(1), 128,
                           2 * hop::Tile<HD>::BYTES + 1024, st, a,
                           (const __nv_bfloat16*)b, (float*)c, mode)));
  return (int)cudaGetLastError();
}

// The dynamic shared memory that the bf16 forward (which 0), dq (1) or
// dkdv (2) kernel asks for at head dim hd; -1 for none.
extern "C" int flash_tc_smem(int hd, int which) {
  const int sizes[3][3] = {
      {tc::fwd_smem<64>(), tc::dq_smem<64>(), tc::dkdv_smem<64>()},
      {tc::fwd_smem<128>(), tc::dq_smem<128>(), tc::dkdv_smem<128>()},
      {tc::fwd_smem<256>(), tc::dq_smem<256>(), tc::dkdv_smem<256>()}};
  const int i = hd == 64 ? 0 : hd == 128 ? 1 : hd == 256 ? 2 : -1;
  return i < 0 || which < 0 || which > 2 ? -1 : sizes[i][which];
}
