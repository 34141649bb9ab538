// Paged flash prefill: chunked-prefill attention straight over the paged
// KV pool, after the chunk's own rows were appended to it.
//
// Replaces the TPU kernel paged_flash_prefill_kernel of
// src/repro/kernels/flash_prefill/kernel.py. There a sequential grid (b,
// q block, page) carried the online-softmax state across pages in VMEM.
// On the card one thread block owns one (request, kv head, query tile):
// the rep = H/KV query heads of that kv head times BQ = 64/rep query
// positions, 64 query rows in all, four threads per row, each thread
// holding every fourth element of its row's query and accumulator. The
// block walks the block table over its own key range itself: [window_lo,
// last query position], or [0, prior) for prior_only, in tiles of 32 key
// positions staged in shared memory in fp32. Query row i of request b
// sits at absolute position prior_len[b] + i, so the causal mask kpos <=
// qpos covers the prior context and the chunk's prefix in one sweep.
// Rows past T (the ragged edge of the last tile) compute but never
// store: nothing is padded.
//
// Bound on the H100: at serving shapes (T = 512, contexts of thousands of
// tokens) the sweep does 4 * H * hd flops per (query row, key) pair, more
// than the ~295 flops per byte the card needs before its bf16 tensor
// cores, not its memory, are the limit, so the least time is the flops
// over 989 TFLOP/s. This kernel runs them on the CUDA cores in fp32, not
// on the tensor cores; wgmma tiles fed by TMA are the later step. What
// it does keep from flash attention: K/V rows are read once per tile of
// 64 query rows, and no score matrix ever reaches device memory.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;          // query rows per block
constexpr int NT = ROWS * 4;      // four threads per row
constexpr int BK = 32;            // key positions per shared tile

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(NT)
prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
               const KT* __restrict__ vpool, const int* __restrict__ bt,
               const int* __restrict__ prior_len, QT* __restrict__ out,
               float* __restrict__ lse, int T, int H, int KV, int page,
               int MB, int window, float scale, int prior_only) {
  constexpr int PER = HD / 4;
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int BQ = ROWS / rep;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int qq = tid & 3;
  const int r = row / BQ;
  const int qi = tile * BQ + row % BQ;
  const bool row_ok = qi < T;
  const int h = kvh * rep + r;
  const int prior = prior_len[b];
  const int qpos = prior + qi;

  float qr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    qr[i] = row_ok
        ? to_f32(q[(((long long)b * T + qi) * H + h) * HD + 4 * i + qq])
        : 0.f;

  const int q_first = prior + tile * BQ;
  const int q_last = prior + min(tile * BQ + BQ, T) - 1;
  const int hi = min(prior_only ? prior : q_last + 1, MB * page);
  const int lo = window > 0 ? max(0, q_first - window + 1) : 0;

  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  __shared__ long long rowoff[BK];

  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    if (tid < BK) {
      const int kp = t0 + tid;
      long long off = -1;
      if (kp < hi) {
        const long long blk = max(bt[(long long)b * MB + kp / page], 0);
        off = ((blk * page + kp % page) * KV + kvh) * HD;
      }
      rowoff[tid] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD;
      const int d = idx % HD;
      const long long off = rowoff[j];
      ks[j][d] = off >= 0 ? to_f32(kpool[off + d]) : 0.f;
      vs[j][d] = off >= 0 ? to_f32(vpool[off + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) p += qr[i] * ks[j][4 * i + qq];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int kp = t0 + j;
      const bool ok = kp < hi && (prior_only ? kp < prior : kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      s[j] = ok ? p * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float mn = fmaxf(m, mt);
    if (mn > -INFINITY) {
      const float alpha = expf(m - mn);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = s[j] > -INFINITY ? expf(s[j] - mn) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] += p * vs[j][4 * i + qq];
      }
      m = mn;
    }
  }

  if (row_ok) {
    const long long o = (((long long)b * T + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      out[o + 4 * i + qq] = from_f32<QT>(l > 0.f ? acc[i] / l : 0.f);
    if (lse != nullptr && qq == 0)
      lse[((long long)b * H + h) * T + qi] =
          l > 0.f ? m + logf(l) : REPRO_NEG_INF;
  }
}

template <typename QT, typename KT>
int launch_hd(const void* q, const void* kp, const void* vp, const void* bt,
              const void* prior, void* out, void* lse, int B, int T, int H,
              int KV, int hd, int page, int MB, int window, float scale,
              int prior_only, cudaStream_t st) {
  const int bq = ROWS / (H / KV);
  dim3 grid((T + bq - 1) / bq, KV, B);
  if (hd == 64)
    prefill_kernel<QT, KT, 64><<<grid, NT, 0, st>>>(
        (const QT*)q, (const KT*)kp, (const KT*)vp, (const int*)bt,
        (const int*)prior, (QT*)out, (float*)lse, T, H, KV, page, MB, window,
        scale, prior_only);
  else if (hd == 128)
    prefill_kernel<QT, KT, 128><<<grid, NT, 0, st>>>(
        (const QT*)q, (const KT*)kp, (const KT*)vp, (const int*)bt,
        (const int*)prior, (QT*)out, (float*)lse, T, H, KV, page, MB, window,
        scale, prior_only);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q [B,T,H,hd]; pools [nblk,page,KV,hd] holding the chunk's rows; bt
// [B,MB] int32; prior [B] int32; out [B,T,H,hd] (q's dtype); lse [B,H,T]
// fp32 or null. window <= 0: none.
extern "C" int paged_flash_prefill(const void* q, const void* kpool,
                                   const void* vpool, const void* bt,
                                   const void* prior, void* out, void* lse,
                                   int B, int T, int H, int KV, int hd,
                                   int page, int MB, int window, float scale,
                                   int prior_only, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0 || ROWS % (H / KV) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    rc = launch_hd<float, float>(q, kpool, vpool, bt, prior, out, lse, B, T,
                                 H, KV, hd, page, MB, window, scale,
                                 prior_only, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    rc = launch_hd<float, __nv_bfloat16>(q, kpool, vpool, bt, prior, out,
                                         lse, B, T, H, KV, hd, page, MB,
                                         window, scale, prior_only, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_F32)
    rc = launch_hd<__nv_bfloat16, float>(q, kpool, vpool, bt, prior, out,
                                         lse, B, T, H, KV, hd, page, MB,
                                         window, scale, prior_only, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    rc = launch_hd<__nv_bfloat16, __nv_bfloat16>(
        q, kpool, vpool, bt, prior, out, lse, B, T, H, KV, hd, page, MB,
        window, scale, prior_only, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
