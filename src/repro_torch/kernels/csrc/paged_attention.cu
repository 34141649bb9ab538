// Paged decode attention: one query token per request against its paged
// KV context, GQA-grouped, online softmax in fp32.
//
// Replaces the TPU kernel paged_attention_kernel of
// src/repro/kernels/paged_attention/kernel.py. There a sequential grid
// (batch, page) carried the softmax state across pages in VMEM scratch
// and the page gather rode on scalar-prefetched block tables. On the
// card blocks run in parallel and carry nothing, so one thread block
// owns one (request, kv head) pair and loops over the live token range
// [max(0, ctx - window), ctx) itself, looking up block_table[b, pos /
// page] for each position (page is a runtime argument: the mode view's
// block capacity). Its 8 warps take every 8th position; within a warp
// each lane holds hd/32 elements of the rep = H/KV query rows and of
// their accumulators, so a key row is one coalesced load per warp and a
// score is one warp reduction. The warps' partial (max, sum, acc) states
// merge through shared memory at the end.
//
// Bound on the H100: bytes. Every live key and value row of the request
// is read once (2 * ctx * KV * hd * 2 bytes in bf16) against 4 flops per
// element and query head, far below the card's ridge point, so the least
// time is the KV bytes over 3.35 TB/s. With B * KV blocks the card is
// only partly filled at small batch; splitting the key range across
// blocks (split-K) is the later step.
#include "common.cuh"

namespace {

constexpr int NW = 8;        // warps per block
constexpr int MAX_REP = 8;   // query heads per kv head

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
              const KT* __restrict__ vpool, const int* __restrict__ bt,
              const int* __restrict__ ctx_len, QT* __restrict__ out,
              float* __restrict__ lse, int H, int KV, int page, int MB,
              int window, float scale) {
  constexpr int PER = HD / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[MAX_REP][PER];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int i = 0; i < PER; ++i)
      qr[r][i] = r < rep
          ? to_f32(q[((long long)b * H + kvh * rep + r) * HD + lane * PER + i])
          : 0.f;

  const int ctx = ctx_len[b];
  const int hi = min(ctx, MB * page);
  const int lo = window > 0 ? max(0, ctx - window) : 0;

  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][PER];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }

  for (int pos = lo + warp; pos < hi; pos += NW) {
    const long long blk = max(bt[(long long)b * MB + pos / page], 0);
    const long long off =
        ((blk * page + pos % page) * KV + kvh) * HD + lane * PER;
    float kk[PER], vv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      kk[i] = to_f32(kpool[off + i]);
      vv[i] = to_f32(vpool[off + i]);
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) s += qr[r][i] * kk[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale;
      const float mn = fmaxf(m[r], s);
      const float alpha = expf(m[r] - mn);
      const float p = expf(s - mn);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] = acc[r][i] * alpha + p * vv[i];
      m[r] = mn;
    }
  }

  __shared__ float sm_m[NW][MAX_REP];
  __shared__ float sm_l[NW][MAX_REP];
  __shared__ float sm_acc[NW][MAX_REP][HD];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) sm_acc[warp][r][lane * PER + i] = acc[r][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * HD; idx += NW * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, O = 0.f;
    if (M > -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (sm_l[w][r] > 0.f) {
          const float f = expf(sm_m[w][r] - M);
          L += sm_l[w][r] * f;
          O += sm_acc[w][r][d] * f;
        }
      }
    }
    const long long h = (long long)b * H + kvh * rep + r;
    out[h * HD + d] = from_f32<QT>(L > 0.f ? O / L : 0.f);
    if (lse != nullptr && d == 0) lse[h] = L > 0.f ? M + logf(L) : REPRO_NEG_INF;
  }
}

template <typename QT, typename KT>
int launch_hd(const void* q, const void* kp, const void* vp, const void* bt,
              const void* ctx, void* out, void* lse, int B, int H, int KV,
              int hd, int page, int MB, int window, float scale,
              cudaStream_t st) {
  dim3 grid(KV, B);
  if (hd == 64)
    decode_kernel<QT, KT, 64><<<grid, NW * 32, 0, st>>>(
        (const QT*)q, (const KT*)kp, (const KT*)vp, (const int*)bt,
        (const int*)ctx, (QT*)out, (float*)lse, H, KV, page, MB, window,
        scale);
  else if (hd == 128)
    decode_kernel<QT, KT, 128><<<grid, NW * 32, 0, st>>>(
        (const QT*)q, (const KT*)kp, (const KT*)vp, (const int*)bt,
        (const int*)ctx, (QT*)out, (float*)lse, H, KV, page, MB, window,
        scale);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q [B,H,hd]; pools [nblk,page,KV,hd]; bt [B,MB] int32; ctx [B] int32;
// out [B,H,hd] (q's dtype); lse [B,H] fp32 or null. window <= 0: none.
extern "C" int paged_attention_decode(const void* q, const void* kpool,
                                      const void* vpool, const void* bt,
                                      const void* ctx, void* out, void* lse,
                                      int B, int H, int KV, int hd, int page,
                                      int MB, int window, float scale,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_REP)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    rc = launch_hd<float, float>(q, kpool, vpool, bt, ctx, out, lse, B, H,
                                 KV, hd, page, MB, window, scale, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    rc = launch_hd<float, __nv_bfloat16>(q, kpool, vpool, bt, ctx, out, lse,
                                         B, H, KV, hd, page, MB, window,
                                         scale, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_F32)
    rc = launch_hd<__nv_bfloat16, float>(q, kpool, vpool, bt, ctx, out, lse,
                                         B, H, KV, hd, page, MB, window,
                                         scale, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    rc = launch_hd<__nv_bfloat16, __nv_bfloat16>(
        q, kpool, vpool, bt, ctx, out, lse, B, H, KV, hd, page, MB, window,
        scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
