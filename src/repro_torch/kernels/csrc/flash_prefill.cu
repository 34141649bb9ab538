// Dense causal flash attention, forward and backward, over contiguous
// q [B,T,H,hd] and k/v [B,T,KV,hd] (the training path's attention).
//
// Replaces the TPU kernel flash_prefill_kernel of
// src/repro/kernels/flash_prefill/kernel.py, which took heads repeated
// to H == KV and T padded to its block; the JAX package differentiates
// the same attention with XLA autodiff, so the backward has no TPU
// kernel of its own.
//
// Forward: the sweep of the paged prefill kernel (flash::sweep in
// common.cuh) with a contiguous key address and no prior context. One
// block owns one (request, kv head, query tile): the rep = H/KV query
// heads of the kv head share each K/V tile in shared memory, so heads
// are never repeated. The block sweeps only its live keys, [first query
// - window + 1, last query], so key tiles past the diagonal or before
// the window are never read; the ragged edge of T is masked, not padded.
// Scores are scaled by hd^-0.5, the output divided by max(l, 1e-30) as
// in the TPU kernel, and the row's log-sum-exp is written in fp32 for
// the backward.
//
// Backward, in the FlashAttention-2 form, two kernels on one stream:
//  1. dq_kernel, one block per (request, kv head, query tile) as in the
//     forward: D = rowsum(dO * O) (kept for step 2), then a sweep over
//     the live key tiles with P = exp(S * scale - lse), dP = dO V^T,
//     dS = P * (dP - D), dQ += scale * dS K. Each dQ row is owned by one
//     block, so it needs neither atomics nor an fp32 scratch buffer.
//  2. dkdv_kernel, one block per (request, kv head, tile of 32 keys),
//     eight threads per key row holding its K, V, dK and dV slices in
//     registers, looping over the live query rows of all rep heads (32
//     at a time, staged in shared memory): dV += P^T dO and
//     dK += scale * dS^T Q.
// The same causal and window masks apply throughout.
//
// Head dims 64, 128 and 256. At hd 256 (RecurrentGemma's local
// attention) a query row has eight threads and a key tile 16 positions
// (flash::Tile), a dK/dV block 16 keys of 16 threads each and 16 staged
// query rows (KTile): every thread holds as many elements as at hd 128,
// and every tile stays in 32 KB of static shared memory.
//
// Bound on the H100: operations. At the training shapes (T = 2048, hd =
// 128) the forward does 4 * hd flops per live (query row, key) pair and
// the backward 10 * hd, about 500 flops per byte moved, above the ~295
// at which the bf16 tensor cores, not the memory, become the limit.
// These kernels run the products on the CUDA cores in fp32; wgmma tiles
// fed by TMA are the later step. What they keep from flash attention: no
// score or probability matrix ever reaches device memory.
#include "common.cuh"

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

template <int HD, typename T>
__device__ __forceinline__ void load_row(float (&r)[Tile<HD>::PER],
                                         const T* x, long long o, bool ok,
                                         int qq) {
#pragma unroll
  for (int i = 0; i < Tile<HD>::PER; ++i)
    r[i] = ok ? to_f32(x[o + Tile<HD>::TPR * i + qq]) : 0.f;
}

// The sum over the TPR threads of a row; every one of them gets it.
template <int HD>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < Tile<HD>::TPR; w <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
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
      out[o + TPR * i + rm.qq] = from_f32<T>(acc[i] * inv);
    if (rm.qq == 0)
      lse[rm.stat(Tn, H)] = l > 0.f ? m + logf(l) : REPRO_NEG_INF;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int Tn, int H,
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
      dq[o + TPR * i + qq] = from_f32<T>(acc[i] * scale);
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

template <typename T, int HD>
__global__ void __launch_bounds__(KTile<HD>::NTB)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Tn, int H, int KV,
            int window, float scale) {
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
    kr[i] = key_ok ? to_f32(k[ko + LPK * i + lane]) : 0.f;
    vr[i] = key_ok ? to_f32(v[ko + LPK * i + lane]) : 0.f;
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
        qv = to_f32(q[off]);
        dov = to_f32(dout[off]);
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
      dk[ko + LPK * i + lane] = from_f32<T>(dkr[i] * scale);
      dv[ko + LPK * i + lane] = from_f32<T>(dvr[i]);
    }
  }
}

template <typename T, int HD>
void launch_fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Tn, int H, int KV, int window,
                float scale, cudaStream_t st) {
  const int bq = Tile<HD>::ROWS / (H / KV);
  dim3 grid((Tn + bq - 1) / bq, KV, B);
  fwd_kernel<T, HD><<<grid, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, Tn, H,
      KV, window, scale);
}

template <typename T, int HD>
void launch_bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, int B, int Tn, int H, int KV, int window,
                float scale, cudaStream_t st) {
  const int bq = Tile<HD>::ROWS / (H / KV);
  dim3 grid_q((Tn + bq - 1) / bq, KV, B);
  dq_kernel<T, HD><<<grid_q, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      (const float*)lse, (float*)delta, (T*)dq, Tn, H, KV, window, scale);
  constexpr int KB = KTile<HD>::KB;
  constexpr int NTB = KTile<HD>::NTB;
  dim3 grid_k((Tn + KB - 1) / KB, KV, B);
  dkdv_kernel<T, HD><<<grid_k, NTB, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Tn, H, KV,
      window, scale);
}

// Runs CALL with T_ and HD bound to the dtype code and head dim, or
// returns cudaErrorInvalidValue from the enclosing function.
#define FLASH_CASE(code, type, hd_, dtype, hd, CALL)                     \
  if ((dtype) == (code) && (hd) == (hd_)) {                             \
    using T_ = type;                                                     \
    constexpr int HD = hd_;                                              \
    CALL;                                                                \
  } else
#define FLASH_DISPATCH(dtype, hd, CALL)                                  \
  FLASH_CASE(DT_F32, float, 64, dtype, hd, CALL)                         \
  FLASH_CASE(DT_F32, float, 128, dtype, hd, CALL)                        \
  FLASH_CASE(DT_F32, float, 256, dtype, hd, CALL)                        \
  FLASH_CASE(DT_BF16, __nv_bfloat16, 64, dtype, hd, CALL)                \
  FLASH_CASE(DT_BF16, __nv_bfloat16, 128, dtype, hd, CALL)               \
  FLASH_CASE(DT_BF16, __nv_bfloat16, 256, dtype, hd, CALL) {             \
    return (int)cudaErrorInvalidValue;                                   \
  }

// The query heads of a kv head must divide the rows of a block: 64 at hd
// 64 and 128, 32 at hd 256.
bool bad_heads(int H, int KV, int hd) {
  const int rows = hd > 128 ? Tile<256>::ROWS : Tile<128>::ROWS;
  return KV <= 0 || H % KV != 0 || rows % (H / KV) != 0;
}

}  // namespace

// q/out [B,T,H,hd], k/v [B,T,KV,hd], all of one dtype; lse [B,H,T] fp32.
// window <= 0: none.
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int T, int H,
                                 int KV, int hd, int window, float scale,
                                 int dtype, void* stream) {
  if (bad_heads(H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dtype, hd, (launch_fwd<T_, HD>(q, k, v, out, lse, B, T, H,
                                                KV, window, scale, st)));
  return (int)cudaGetLastError();
}

// The forward's inputs, its out and lse, and dout [B,T,H,hd]; writes
// dq [B,T,H,hd], dk/dv [B,T,KV,hd] (the inputs' dtype) and delta
// [B,H,T] fp32 scratch (rowsum(dout * out)).
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int T, int H,
                                 int KV, int hd, int window, float scale,
                                 int dtype, void* stream) {
  if (bad_heads(H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dtype, hd, (launch_bwd<T_, HD>(q, k, v, out, dout, lse,
                                                delta, dq, dk, dv, B, T, H,
                                                KV, window, scale, st)));
  return (int)cudaGetLastError();
}
