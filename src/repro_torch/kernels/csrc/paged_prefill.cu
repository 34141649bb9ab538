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
// positions staged in shared memory in fp32 (flash::sweep in common.cuh,
// which the dense kernel of flash_prefill.cu shares). Query row i of request b
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

using flash::NT;
using flash::ROWS;

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
  // the block table gives each key position's page
  auto key_off = [=](int kp) -> long long {
    const long long blk = max(bt[(long long)b * MB + kp / page], 0);
    return ((blk * page + kp % page) * KV + kvh) * HD;
  };

  __shared__ flash::KVTile<HD> sm;
  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  flash::sweep<HD>(sm, kpool, vpool, key_off, qr, lo, hi,
                   prior_only ? prior - 1 : qpos, qpos, window, scale, m, l,
                   acc);

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
