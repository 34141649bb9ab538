// Paged decode attention: one query token per request against its paged
// KV context, GQA-grouped, online softmax in fp32, the key range split
// across blocks (split-K).
//
// Replaces the TPU kernel paged_attention_kernel of
// src/repro/kernels/paged_attention/kernel.py. There a sequential grid
// (batch, page) carried the softmax state across pages in VMEM scratch
// and the page gather rode on scalar-prefetched block tables. On the
// card blocks run in parallel and carry nothing.
//
// Bound on the H100: bytes. Every live key and value row is read once (2
// * ctx * KV * hd * 2 bytes in bf16) against 4 flops per element and
// query head, far below the card's ridge point, so the least time is the
// KV bytes over 3.35 TB/s, and the kernel's job is to keep enough loads
// in flight on every SM. So:
//
// - Split-K. A block owns (split, request, kv head, head group): the key
//   positions [s * split_len, (s + 1) * split_len) of the request's live
//   range [max(0, ctx - window), ctx). The wrapper picks split_len from
//   the card's SM count so that B * KV * groups * splits blocks fill the
//   card several times over; blocks whose split lies outside the live
//   range leave at once. A request whose live range fits one split writes
//   its output directly.
// - Many 16-byte loads in flight. Each lane holds 8 elements of a row, so
//   a row takes hd / 8 lanes and a warp covers 32 / (hd / 8) rows per
//   load instruction. A warp's chunk is NK such instructions for K and V
//   (8 rows at hd 128, 16 at hd 64, half that at 8 heads a group); the
//   next chunk's loads are issued before this one is computed, and the
//   online softmax updates once per chunk, not per key. Page is a runtime
//   argument: each row's address comes through the block table, one
//   division a chunk.
// - Any rep = H/KV. The rep query heads of a kv head go in groups of up
//   to 8 along a grid dimension; within a group each K/V row is read once
//   for all its heads.
// - Merging the splits in the same launch. Each split block writes its
//   fp32 partial (max, sum, unnormalised output) to scratch, then takes a
//   ticket from a per-(request, kv head, group) counter that the wrapper
//   keeps zeroed; the block that takes the last ticket merges all the
//   partials in split order (so the result does not depend on which block
//   came last: deterministic), writes the output and sets the counter
//   back to 0.
#include "common.cuh"

namespace {

constexpr int NW = 4;         // warps per block
constexpr int MAX_G = 8;      // query heads per group
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Eight consecutive elements of a row, loaded as raw 16-byte words (one
// for bf16, two for fp32) so that the loads can be issued before any is
// used.
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// Partial state of one head group: per head its max (base 2), its sum
// and its unnormalised output, in fp32.
template <int HD> struct Partial {
  float m[MAX_G];
  float l[MAX_G];
  float acc[MAX_G][HD];
};

// One block: (split, kv head * groups + group, request). ``part`` holds
// B * KV * groups * splits partials; ``count`` B * KV * groups counters,
// zero on entry and left zero.
template <typename QT, typename KT, int HD, int RG>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
              const KT* __restrict__ vpool, const int* __restrict__ bt,
              const int* __restrict__ ctx_len, QT* __restrict__ out,
              float* __restrict__ lse, Partial<HD>* __restrict__ part,
              int* __restrict__ count, int H, int KV, int groups, int page,
              int MB, int window, float scale, int split_len) {
  constexpr int LPR = HD / 8;           // lanes per row
  constexpr int RPI = 32 / LPR;         // rows per load instruction
  // NK load instructions a chunk: 64 bytes of K and V a lane (32 at 8
  // heads a group, whose registers hold twice the queries and outputs)
  constexpr int NK = (sizeof(KT) == 2 ? 4 : 2) / (RG > 4 ? 2 : 1);
  constexpr int KPW = RPI * NK;         // rows per warp chunk
  constexpr int NSTATE = NW * RPI;      // partial states of a block
  const int s = blockIdx.x;
  const int kvh = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int hpg = (rep + groups - 1) / groups;
  const int h0 = kvh * rep + grp * hpg;
  const int ng = min(hpg, rep - grp * hpg);    // heads in this group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR;                  // row of a load instruction
  const int d0 = (lane % LPR) * 8;             // this lane's 8 elements

  const int ctx = ctx_len[b];
  const int hi = min(ctx, MB * page);
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const long long hrow = (long long)b * H + h0;      // first head's row
  const long long cnt = ((long long)b * KV + kvh) * groups + grp;
  if (hi <= lo) {                              // no live key
    if (s == 0)
      for (int x = threadIdx.x; x < ng * HD; x += NW * 32) {
        out[(hrow + x / HD) * HD + x % HD] = from_f32<QT>(0.f);
        if (lse != nullptr && x % HD == 0) lse[hrow + x / HD] = REPRO_NEG_INF;
      }
    return;
  }
  const int s_lo = lo / split_len, s_hi = (hi - 1) / split_len;
  if (s < s_lo || s > s_hi) return;
  const int k_lo = max(lo, s * split_len);
  const int k_hi = min(hi, (s + 1) * split_len);

  const float c = scale * LOG2E;
  float qr[RG][8];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[r][i] = r < ng ? to_f32(q[(hrow + r) * HD + d0 + i]) * c : 0.f;

  float m[RG], l[RG], acc[RG][8];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  const int* btb = bt + (long long)b * MB;
  // Issue the loads of the chunk at ``base``: this lane's rows lie RPI key
  // positions apart, so one division finds the first one's page.
  auto fetch = [&](int base, Row8<KT> (&kx)[NK], Row8<KT> (&vx)[NK]) {
    const int kp0 = base + sub;
    int pg = kp0 / page, po = kp0 - pg * page;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (kp0 + i * RPI < k_hi) {
        const long long off =
            (((long long)max(btb[pg], 0) * page + po) * KV + kvh) * HD + d0;
        kx[i].load(kpool + off);
        vx[i].load(vpool + off);
      } else {
        kx[i].zero();
        vx[i].zero();
      }
      for (po += RPI; po >= page; po -= page) ++pg;
    }
  };
  // the next chunk's loads are in flight while this one is computed
  Row8<KT> kr[NK], vr[NK], kn[NK], vn[NK];
  if (k_lo + warp * KPW < k_hi) fetch(k_lo + warp * KPW, kr, vr);
  for (int base = k_lo + warp * KPW; base < k_hi; base += NW * KPW) {
    if (base + NW * KPW < k_hi) fetch(base + NW * KPW, kn, vn);
    float sc[RG][NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      float x[8];
      kr[i].get(x);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) p += qr[r][e] * x[e];
        sc[r][i] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int i = 0; i < NK; ++i) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          sc[r][i] += __shfl_xor_sync(0xffffffffu, sc[r][i], o);
        if (base + i * RPI + sub >= k_hi) sc[r][i] = -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < NK; ++i) mx = fmaxf(mx, sc[r][i]);
      if (mx == -INFINITY) continue;           // no live key in the chunk
      const float alpha = exp2f(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < NK; ++i) sc[r][i] = exp2f(sc[r][i] - mx);
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      float x[8];
      vr[i].get(x);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (m[r] == -INFINITY) continue;
        l[r] += sc[r][i];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += sc[r][i] * x[e];
      }
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      kr[i] = kn[i];
      vr[i] = vn[i];
    }
  }

  // merge the block's NW * RPI states (warp, row of a load instruction)
  __shared__ float sm_m[NSTATE][RG], sm_l[NSTATE][RG];
  __shared__ float sm_acc[NSTATE][RG][HD];
  __shared__ bool last;
  const int st = warp * RPI + sub;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (lane % LPR == 0) {
      sm_m[st][r] = m[r];
      sm_l[st][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[st][r][d0 + e] = acc[r][e];
  }
  __syncthreads();
  const bool whole = s_lo == s_hi;             // one split: write directly
  Partial<HD>* mine = part + cnt * gridDim.x + s;
  for (int x = threadIdx.x; x < ng * HD; x += NW * 32) {
    const int r = x / HD, d = x % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NSTATE; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NSTATE; ++w) {
      if (sm_l[w][r] > 0.f) {
        const float f = exp2f(sm_m[w][r] - M);
        L += sm_l[w][r] * f;
        O += sm_acc[w][r][d] * f;
      }
    }
    if (whole) {
      out[(hrow + r) * HD + d] = from_f32<QT>(L > 0.f ? O / L : 0.f);
      if (lse != nullptr && d == 0)
        lse[hrow + r] = L > 0.f ? (M + log2f(L)) * LN2 : REPRO_NEG_INF;
    } else {
      mine->acc[r][d] = O;
      if (d == 0) {
        mine->m[r] = M;
        mine->l[r] = L;
      }
    }
  }
  if (whole) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(count + cnt, 1) == s_hi - s_lo;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const Partial<HD>* all = part + cnt * gridDim.x;
  for (int x = threadIdx.x; x < ng * HD; x += NW * 32) {
    const int r = x / HD, d = x % HD;
    float M = -INFINITY;
    for (int t = s_lo; t <= s_hi; ++t) M = fmaxf(M, __ldcg(&all[t].m[r]));
    float L = 0.f, O = 0.f;
    for (int t = s_lo; t <= s_hi; ++t) {
      const float lt = __ldcg(&all[t].l[r]);
      if (lt > 0.f) {
        const float f = exp2f(__ldcg(&all[t].m[r]) - M);
        L += lt * f;
        O += __ldcg(&all[t].acc[r][d]) * f;
      }
    }
    out[(hrow + r) * HD + d] = from_f32<QT>(L > 0.f ? O / L : 0.f);
    if (lse != nullptr && d == 0)
      lse[hrow + r] = L > 0.f ? (M + log2f(L)) * LN2 : REPRO_NEG_INF;
  }
  if (threadIdx.x == 0) count[cnt] = 0;
}

template <typename QT, typename KT, int HD>
int launch_rg(dim3 grid, int rg, cudaStream_t st, const void* q,
              const void* kp, const void* vp, const void* bt,
              const void* ctx, void* out, void* lse, void* part, void* count,
              int H, int KV, int groups, int page, int MB, int window,
              float scale, int split_len) {
#define REPRO_DECODE(RG)                                                    \
  decode_kernel<QT, KT, HD, RG><<<grid, NW * 32, 0, st>>>(                  \
      (const QT*)q, (const KT*)kp, (const KT*)vp, (const int*)bt,           \
      (const int*)ctx, (QT*)out, (float*)lse, (Partial<HD>*)part,           \
      (int*)count, H, KV, groups, page, MB, window, scale, split_len)
  switch (rg) {
    case 1: REPRO_DECODE(1); break;
    case 2: REPRO_DECODE(2); break;
    case 4: REPRO_DECODE(4); break;
    case 8: REPRO_DECODE(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE
  return 0;
}

template <typename QT, typename KT>
int launch_hd(int hd, dim3 grid, int rg, cudaStream_t st, const void* q,
              const void* kp, const void* vp, const void* bt,
              const void* ctx, void* out, void* lse, void* part, void* count,
              int H, int KV, int groups, int page, int MB, int window,
              float scale, int split_len) {
  if (hd == 64)
    return launch_rg<QT, KT, 64>(grid, rg, st, q, kp, vp, bt, ctx, out, lse,
                                 part, count, H, KV, groups, page, MB,
                                 window, scale, split_len);
  if (hd == 128)
    return launch_rg<QT, KT, 128>(grid, rg, st, q, kp, vp, bt, ctx, out,
                                  lse, part, count, H, KV, groups, page, MB,
                                  window, scale, split_len);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,hd]; pools [nblk,page,KV,hd]; bt [B,MB] int32; ctx [B] int32;
// out [B,H,hd] (q's dtype); lse [B,H] fp32 or null. window <= 0: none.
// splits blocks of split_len keys per (request, kv head, group); with
// more than one split, part holds B * KV * groups * splits partials (fp32
// Partial<hd>, (2 + hd) * 8 floats each) and count B * KV * groups int32
// zeros (left zero); groups = ceil((H / KV) / 8).
extern "C" int paged_attention_decode(const void* q, const void* kpool,
                                      const void* vpool, const void* bt,
                                      const void* ctx, void* out, void* lse,
                                      void* part, void* count, int B, int H,
                                      int KV, int hd, int page, int MB,
                                      int window, float scale, int splits,
                                      int split_len, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || page <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < (long long)MB * page ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int groups = (H / KV + MAX_G - 1) / MAX_G;
  const int hpg = (H / KV + groups - 1) / groups;
  const int rg = hpg <= 1 ? 1 : hpg <= 2 ? 2 : hpg <= 4 ? 4 : 8;
  const dim3 grid(splits, KV * groups, B);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    rc = launch_hd<float, float>(hd, grid, rg, st, q, kpool, vpool, bt, ctx,
                                 out, lse, part, count, H, KV, groups, page,
                                 MB, window, scale, split_len);
  else if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    rc = launch_hd<float, __nv_bfloat16>(hd, grid, rg, st, q, kpool, vpool,
                                         bt, ctx, out, lse, part, count, H,
                                         KV, groups, page, MB, window, scale,
                                         split_len);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_F32)
    rc = launch_hd<__nv_bfloat16, float>(hd, grid, rg, st, q, kpool, vpool,
                                         bt, ctx, out, lse, part, count, H,
                                         KV, groups, page, MB, window, scale,
                                         split_len);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    rc = launch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, grid, rg, st, q, kpool, vpool, bt, ctx, out, lse, part, count, H,
        KV, groups, page, MB, window, scale, split_len);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
