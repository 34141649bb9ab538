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
//   (8 rows at hd 128, 16 at hd 64, 4 at hd 256, where a row fills a
//   warp; half that at 8 heads a group); the
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
#include "hopper.cuh"

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
  if (hd == 256)
    return launch_rg<QT, KT, 256>(grid, rg, st, q, kp, vp, bt, ctx, out,
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

// ---------------------------------------------------------------------------
// Absorbed MLA decode over the compressed paged cache (DeepSeek-V2).
//
// The TPU package runs this through paged_attention_kernel on the KV=1
// view of the one compressed pool ([nblk, page, W], entries [c_kv ++
// k_pe], W = kv_lora_rank + qk_rope_head_dim = 576 at full width), with
// the pool as both K and V, fp32 queries q_cat = [q_nope W_uk ++ q_pe]
// pre-scaled by the caller, and keeps the first R = kv_lora_rank lanes
// of the output (src/repro/kernels/paged_attention/ops.py,
// paged_mla_attention_decode). decode_kernel above cannot take that
// shape: a row of 576 elements is 72 lanes, and 128 query heads on one
// kv head would be 16 groups of 8, each reading the whole context again.
//
// Bound on the H100: a key costs every head (W + R) * 2 flops (the score
// over W lanes, the value over R) against W * 2 bytes read once for all
// heads: 128 heads make ~140 flops a byte, above the fp32 CUDA cores'
// ridge (67 TFLOP/s over 3.35 TB/s, 20 a byte) and below the bf16 tensor
// cores' (295). So a bf16 pool goes to the tensor cores (decode_tc); an
// fp32 pool keeps the CUDA-core form (decode), the way K4 and K5 split by
// dtype.
//
// Both split each request's live range [max(0, ctx - window), ctx) into
// splits of split_len keys, a block per (head block, split, request),
// and merge the splits in the same launch as decode_kernel's do: fp32
// partials (max, sum, unnormalised [heads, R] output) to scratch, a
// ticket from a per-(request, head block) counter left zero, and the
// last block merges in split order.
// ---------------------------------------------------------------------------
namespace {
namespace mla {

constexpr int MAX_W = 576;               // widest entry taken

// ---------------------------------------------------------------------------
// decode: fp32 pools, the fp32 CUDA cores.
//
// - A block owns (split, head group, request): HG = 32 query heads.
// - Each tile of TK = 32 key rows is staged in shared memory once and
//   serves both products for all the block's heads: the scores over W
//   lanes and the value read over the first R lanes. The next tile's
//   global loads are in flight while one tile is computed.
// - Scores: warp w owns heads 4w..4w+3 and lane t key t of the tile, so
//   the query reads are warp-wide broadcasts and the online softmax of a
//   head is one warp's shuffles. Rows are padded to W + 4 floats, which
//   keeps the 32 lanes' 16-byte key reads free of bank conflicts.
// - Values: thread (c, g) owns columns 4c..4c+3 (and 4c + 512.. when R
//   exceeds 512) of 16 heads' fp32 outputs in registers.
// ---------------------------------------------------------------------------
constexpr int NT = 256;                  // threads a block
constexpr int HG = 32;                   // query heads a block
constexpr int TK = 32;                   // key positions a tile
constexpr int HPW = HG / (NT / 32);      // heads a warp scores
constexpr int HPT = HG / 2;              // heads a thread accumulates
constexpr int LPT = (TK * (MAX_W / 8) + NT - 1) / NT;  // row loads a tile
constexpr int PS = HG + 4;               // row stride of the p tile
static_assert(HPW == 4, "a warp writes its heads' p as one float4");

__host__ __device__ inline size_t smem_bytes(int W) {
  return ((size_t)(HG + TK) * (W + 4) + (size_t)TK * PS + 3 * HG) *
         sizeof(float);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q [B,H,W] fp32; pool [nblk,page,W] fp32; out [B,H,R] fp32; lse [B,H]
// fp32, written when LSE (NEG_INF where no key is live: an instance of
// its own, so the one without is the kernel as it was). ``part`` holds B
// * groups * splits partials of (2 + R) * HG floats (m[HG], l[HG],
// acc[HG][R]); ``count`` B * groups counters, zero on entry, left zero.
template <int NQ, bool LSE>
__global__ void __launch_bounds__(NT, 1)
decode(const float* __restrict__ q, const float* __restrict__ pool,
       const int* __restrict__ bt, const int* __restrict__ ctx_len,
       float* __restrict__ out, float* __restrict__ lse,
       float* __restrict__ part, int* __restrict__ count, int H, int groups,
       int W, int R, int page, int MB, int window, float scale,
       int split_len) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [HG][W + 4]
  const int WP = W + 4;
  float* sk = sq + HG * WP;                      // [TK][W + 4]
  float* sp = sk + TK * WP;                      // [TK][PS]
  float* s_alpha = sp + TK * PS;                 // [HG]
  float* s_m = s_alpha + HG;                     // [HG]
  float* s_l = s_m + HG;                         // [HG]
  __shared__ bool last;

  const int s = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int hpg = (H + groups - 1) / groups;
  const int h0 = grp * hpg;
  const int ng = min(hpg, H - h0);               // heads of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ctx = ctx_len[b];
  const int hi = min(ctx, MB * page);
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const long long hrow = (long long)b * H + h0;  // first head's row
  const long long cnt = (long long)b * groups + grp;
  if (hi <= lo) {                                // no live key
    if (s == 0) {
      for (int x = tid; x < ng * R; x += NT) out[hrow * R + x] = 0.f;
      if (LSE && tid < ng) lse[hrow + tid] = REPRO_NEG_INF;
    }
    return;
  }
  const int s_lo = lo / split_len, s_hi = (hi - 1) / split_len;
  if (s < s_lo || s > s_hi) return;
  const int k_lo = max(lo, s * split_len);
  const int k_hi = min(hi, (s + 1) * split_len);

  // queries, scaled into base 2; heads past ng are zero
  const float c = scale * LOG2E;
  const int W4 = W / 4;
  for (int x = tid; x < HG * W4; x += NT) {
    const int h = x / W4, w4 = x - h * W4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < ng) {
      v = reinterpret_cast<const float4*>(q + (hrow + h) * W)[w4];
      v.x *= c; v.y *= c; v.z *= c; v.w *= c;
    }
    reinterpret_cast<float4*>(sq + h * WP)[w4] = v;
  }

  const int W8 = W / 8;
  const int n_ld = TK * W8;
  const int* btb = bt + (long long)b * MB;
  Row8<float> reg[LPT];
  // global loads of the tile at ``base`` into registers (zero past k_hi)
  auto fetch = [&](int base) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int x = tid + i * NT;
      const int t = x / W8, c8 = x - t * W8;
      const int key = base + t;
      if (x < n_ld && key < k_hi) {
        const int pg = key / page;
        const long long row =
            (long long)max(btb[pg], 0) * page + (key - pg * page);
        reg[i].load(pool + row * W + c8 * 8);
      } else {
        reg[i].zero();
      }
    }
  };
  // the registers' tile into shared memory, in fp32
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int x = tid + i * NT;
      if (x < n_ld) {
        const int t = x / W8, c8 = x - t * W8;
        float v[8];
        reg[i].get(v);
        float4* d = reinterpret_cast<float4*>(sk + t * WP + c8 * 8);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  };

  float m_w[HPW], l_w[HPW];          // the warp's heads: max (base 2), sum
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m_w[j] = -INFINITY;
    l_w[j] = 0.f;
  }
  const int cq = tid % (NT / 2), hh = tid / (NT / 2);
  float acc[HPT][4 * NQ];
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int e = 0; e < 4 * NQ; ++e) acc[h][e] = 0.f;

  fetch(k_lo);
  for (int base = k_lo; base < k_hi; base += TK) {
    __syncthreads();                 // the previous tile is consumed
    stage();
    __syncthreads();
    if (base + TK < k_hi) fetch(base + TK);

    // scores of the warp's heads against key ``lane``
    float sc[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) sc[j] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(sk + lane * WP);
    const float4* qr = reinterpret_cast<const float4*>(sq + warp * HPW * WP);
#pragma unroll 4
    for (int w4 = 0; w4 < W4; ++w4) {
      const float4 kv = kr[w4];
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const float4 qv = qr[j * (WP / 4) + w4];
        sc[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    // the online softmax: key ``base`` is live, so every max is finite
    const bool live = base + lane < k_hi;
    float pv[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const float x = live ? sc[j] : -INFINITY;
      const float mn = fmaxf(m_w[j], warp_max(x));
      const float alpha = exp2f(m_w[j] - mn);
      pv[j] = live ? exp2f(x - mn) : 0.f;
      l_w[j] = l_w[j] * alpha + warp_sum(pv[j]);
      m_w[j] = mn;
      if (lane == 0) s_alpha[warp * HPW + j] = alpha;
    }
    *reinterpret_cast<float4*>(sp + lane * PS + warp * HPW) =
        make_float4(pv[0], pv[1], pv[2], pv[3]);
    __syncthreads();

    // values: the first R lanes of each key row
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const float a = s_alpha[hh * HPT + h];
#pragma unroll
      for (int e = 0; e < 4 * NQ; ++e) acc[h][e] *= a;
    }
#pragma unroll
    for (int qd = 0; qd < NQ; ++qd) {
      const int col = 4 * (cq + qd * (NT / 2));
      if (col >= R) continue;
#pragma unroll 4
      for (int t = 0; t < TK; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(sk + t * WP + col);
        const float4* pr =
            reinterpret_cast<const float4*>(sp + t * PS + hh * HPT);
#pragma unroll
        for (int h4 = 0; h4 < HPT / 4; ++h4) {
          const float4 p = pr[h4];
          const float ps[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[h4 * 4 + i][4 * qd] += ps[i] * v.x;
            acc[h4 * 4 + i][4 * qd + 1] += ps[i] * v.y;
            acc[h4 * 4 + i][4 * qd + 2] += ps[i] * v.z;
            acc[h4 * 4 + i][4 * qd + 3] += ps[i] * v.w;
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      s_m[warp * HPW + j] = m_w[j];
      s_l[warp * HPW + j] = l_w[j];
    }
  }
  __syncthreads();

  const bool whole = s_lo == s_hi;               // one split: write directly
  const size_t psz = (size_t)(2 + R) * HG;
  float* mine = part + ((size_t)cnt * gridDim.x + s) * psz;
#pragma unroll
  for (int qd = 0; qd < NQ; ++qd) {
    const int col = 4 * (cq + qd * (NT / 2));
    if (col >= R) continue;
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const int hg = hh * HPT + h;
      if (hg >= ng) continue;
      const float4 a = make_float4(acc[h][4 * qd], acc[h][4 * qd + 1],
                                   acc[h][4 * qd + 2], acc[h][4 * qd + 3]);
      if (whole) {
        const float L = s_l[hg];
        const float inv = L > 0.f ? 1.f / L : 0.f;
        *reinterpret_cast<float4*>(out + (hrow + hg) * R + col) =
            make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      } else {
        *reinterpret_cast<float4*>(mine + 2 * HG + (size_t)hg * R + col) = a;
      }
    }
  }
  if (whole) {
    if (LSE && tid < ng)
      lse[hrow + tid] = s_l[tid] > 0.f
                            ? (s_m[tid] + log2f(s_l[tid])) * LN2
                            : REPRO_NEG_INF;
    return;
  }
  if (tid < HG) {
    mine[tid] = s_m[tid];
    mine[HG + tid] = s_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + cnt, 1) == s_hi - s_lo;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (size_t)cnt * gridDim.x * psz;
  for (int x = tid; x < ng * R; x += NT) {
    const int h = x / R, r = x - h * R;
    float M = -INFINITY;
    for (int t = s_lo; t <= s_hi; ++t) M = fmaxf(M, __ldcg(all + t * psz + h));
    float L = 0.f, O = 0.f;
    for (int t = s_lo; t <= s_hi; ++t) {
      const float lt = __ldcg(all + t * psz + HG + h);
      if (lt > 0.f) {
        const float f = exp2f(__ldcg(all + t * psz + h) - M);
        L += lt * f;
        O += __ldcg(all + t * psz + 2 * HG + (size_t)h * R + r) * f;
      }
    }
    out[(hrow + h) * R + r] = L > 0.f ? O / L : 0.f;
    if (LSE && r == 0)
      lse[hrow + h] = L > 0.f ? (M + log2f(L)) * LN2 : REPRO_NEG_INF;
  }
  if (tid == 0) count[cnt] = 0;
}

// ---------------------------------------------------------------------------
// decode_tc: bf16 pools, the tensor cores (wgmma, tile code in
// hopper.cuh).
//
// - A block owns (head block, split, request): HB = 64 query heads, the
//   wgmma M, zero rows past H. The head block is blockIdx.x, so the
//   blocks that read one (request, split) run side by side and the second
//   read of the context comes from L2.
// - q (fp32) is split once into q_hi = bf16(q c) and q_lo = bf16(q c -
//   q_hi), c = scale log2(e), both kept in shared memory for the whole
//   sweep (9 atoms of 64 x 64 each at W 576, zero past W). The pool is
//   bf16, so K is exact and S = q_hi K^T + q_lo K^T keeps about 16 bits of
//   q, as K5 keeps of its P.
// - Tiles of TK = 32 keys in a two-stage ring: the next tile's copy
//   (cp.async, zero past the split and past W; a thread copies one row,
//   whose block-table entry it looked up a tile ahead) runs while this
//   one is multiplied.
// - Two consumer warpgroups. S [64 x 32] = q K^T (m64n32k16, K-major B):
//   each warpgroup takes half of W's k steps, in two accumulators (hi
//   and lo), and the halves are summed through shared memory, so both
//   hold the same S and run the same online softmax in base 2 on their
//   registers. Then O += P V for each warpgroup's own NC of R's columns,
//   P from registers as split_frag's hi + lo fragments, V the same key
//   tile read N-major. At R 512 each owns 256 columns (128 fp32
//   registers); R above 512 gives warpgroup 1 the 64 columns past 512
//   too (EX).
// - What bounds it: the products read their operands from shared memory,
//   and q (147 KB, hi + lo) is read again for every 32 keys: about 285 KB
//   of operand reads a tile against 36 KB of keys from device memory.
// - Shared memory: q hi + lo 147,456 bytes, two key tiles 73,728, the S
//   exchange 8,192: 229,376 (+ 1024 for alignment), one block an SM. At
//   the end the block's output goes through the tiles' space to 16-byte
//   stores, and the last block's merge keeps its weights there.
// ---------------------------------------------------------------------------
constexpr int HB = hop::TR;                   // query heads a block
constexpr int TKC = 32;                       // keys a tile
constexpr int NTC = 2 * hop::WG;              // two consumer warpgroups
constexpr int Q_BYTES = HB * MAX_W * 2;       // q hi (or lo): 9 atoms
constexpr int KT_ATOM = TKC * 128;            // a key tile's 64-column atom
constexpr int K_BYTES = TKC * MAX_W * 2;      // a key tile
constexpr int X_BYTES = HB * TKC * 4;         // the S exchange
constexpr int TC_SMEM = 2 * Q_BYTES + 2 * K_BYTES + X_BYTES + 1024;
constexpr int QJ = MAX_W / 32;                 // q chunks a thread stages
static_assert(NTC == 8 * TKC && NTC == 4 * HB, "a key row is 8 threads', "
              "a q row 4 threads'");
// the merge keeps two floats a (head, split) where the q tiles were
constexpr int MAX_SPLITS_TC = 2 * Q_BYTES / (2 * HB * 4);

// A warpgroup's accumulator ``acc`` (columns c0 + acc_col(i), those
// under R) into the [HB, rp] fp32 rows at ``so`` in shared memory,
// divided by the row sums ``l`` where ``norm``.
template <int NR>
__device__ __forceinline__ void stage_acc(const float (&acc)[NR],
                                          const float (&l)[2], int c0,
                                          int R, bool norm, float* so,
                                          int rp) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = !norm ? 1.f : l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int col = c0 + hop::acc_col(i);
    if (col >= R) continue;
    const float f = inv[(i >> 1) & 1];
    *reinterpret_cast<float2*>(so + hop::acc_row(i) * rp + col) =
        make_float2(acc[i] * f, acc[i + 1] * f);
  }
}

// The two warpgroups' halves of S summed through shared memory ``xs``
// ([4][WG] float4, this thread's column at xs[0]): warpgroup 1 writes
// its half, warpgroup 0 adds it to its own and writes the sum back, and
// warpgroup 1 reads it, so both hold the same S.
__device__ __forceinline__ void sum_halves(float (&sc)[16], float4* xs,
                                           int g) {
  if (g == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xs[j * hop::WG] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                                    sc[4 * j + 3]);
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = xs[j * hop::WG];
      sc[4 * j] += v.x;
      sc[4 * j + 1] += v.y;
      sc[4 * j + 2] += v.z;
      sc[4 * j + 3] += v.w;
      xs[j * hop::WG] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                                    sc[4 * j + 3]);
    }
  }
  __syncthreads();
  if (g == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = xs[j * hop::WG];
      sc[4 * j] = v.x;
      sc[4 * j + 1] = v.y;
      sc[4 * j + 2] = v.z;
      sc[4 * j + 3] = v.w;
    }
  }
}

// q [B,H,W] fp32; pool [nblk,page,W] bf16; out [B,H,R] fp32; lse [B,H]
// fp32, written when LSE; ``part`` holds B * groups * splits partials of
// (2 + R) * HB floats, ``count`` B * groups counters (groups =
// gridDim.x), as for decode.
template <int NC, bool EX, bool LSE>
__global__ void __launch_bounds__(NTC, 1)
decode_tc(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pool,
          const int* __restrict__ bt, const int* __restrict__ ctx_len,
          float* __restrict__ out, float* __restrict__ lse,
          float* __restrict__ part, int* __restrict__ count, int H, int W,
          int R, int page, int MB, int window, float scale, int split_len) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smraw[];
  const uint32_t sq_hi = hop::smem_base(smraw), sq_lo = sq_hi + Q_BYTES;
  const uint32_t sk0 = sq_lo + Q_BYTES;
  uint8_t* sgen = smraw + (sq_hi - hop::smem_u32(smraw));  // sq_hi, generic
  float4* sx = reinterpret_cast<float4*>(sgen + 2 * Q_BYTES + 2 * K_BYTES);
  __shared__ bool last;

  const int hb = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int h0 = hb * HB, ng = min(HB, H - h0);
  const int tid = threadIdx.x, g = tid / hop::WG;
  const int ctx = ctx_len[b];
  const int hi = min(ctx, MB * page);
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const long long hrow = (long long)b * H + h0;
  const long long cnt = (long long)b * gridDim.x + hb;
  if (hi <= lo) {                                // no live key
    if (s == 0) {
      for (int x = tid; x < ng * R; x += NTC) out[hrow * R + x] = 0.f;
      if (LSE && tid < ng) lse[hrow + tid] = REPRO_NEG_INF;
    }
    return;
  }
  const int s_lo = lo / split_len, s_hi = (hi - 1) / split_len;
  if (s < s_lo || s > s_hi) return;
  const int k_lo = max(lo, s * split_len);
  const int k_hi = min(hi, (s + 1) * split_len);
  const int n = (k_hi - k_lo + TKC - 1) / TKC;
  const int CPR = ((W + 15) & ~15) / 8;          // 16-byte chunks read a row
  const int* btb = bt + (long long)b * MB;

  // the element offset of this thread's key row in tile ``it`` (-1: past
  // the split): thread t copies row t / 8 of each key tile, its 16-byte
  // chunks t % 8 + 8 j, so it looks up one block-table entry a tile
  const int kr = tid >> 3, kc = tid & 7;
  auto row_of = [&](int it) -> long long {
    const int key = k_lo + it * TKC + kr;
    if (it >= n || key >= k_hi) return -1;
    const int pg = key / page;
    return ((long long)max(btb[pg], 0) * page + (key - pg * page)) * W;
  };
  // start the copy of key tile ``it`` (this thread's row at ``row``) into
  // ring stage it % 2: zero past the split and past W
  auto load_k = [&](int it, long long row) {
    const uint32_t st = sk0 + (it & 1) * K_BYTES + hop::swizzle(kr, kc);
#pragma unroll
    for (int j = 0; j < MAX_W / 64; ++j) {
      const int c = kc + 8 * j;
      const bool ok = row >= 0 && c * 8 < W;
      if (c < CPR) hop::cp_async16(st + j * KT_ATOM, ok ? pool + row + c * 8
                                                        : pool, ok);
    }
  };
  long long row_next = row_of(0);
  load_k(0, row_next);
  hop::cp_commit();
  row_next = row_of(1);

  // q hi and lo, scaled into base 2; heads past ng and lanes past W zero.
  // Thread t stages row t / 4, its 32-byte chunks t % 4 + 4 j, six
  // chunks' loads in flight at once.
  const float cs = scale * LOG2E;
  const int qh = tid >> 2, qc = tid & 3;
  const float* qrow = q + (hrow + min(qh, ng - 1)) * W;
#pragma unroll
  for (int j0 = 0; j0 < QJ; j0 += 6) {
    float4 a[6], e[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int c = qc + 4 * (j0 + j);
      a[j] = e[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qh < ng && c * 8 < W) {
        a[j] = reinterpret_cast<const float4*>(qrow + c * 8)[0];
        e[j] = reinterpret_cast<const float4*>(qrow + c * 8)[1];
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int c = qc + 4 * (j0 + j);
      if (c >= CPR) continue;
      uint4 vh, vl;
      hop::split2(a[j].x * cs, a[j].y * cs, vh.x, vl.x);
      hop::split2(a[j].z * cs, a[j].w * cs, vh.y, vl.y);
      hop::split2(e[j].x * cs, e[j].y * cs, vh.z, vl.z);
      hop::split2(e[j].z * cs, e[j].w * cs, vh.w, vl.w);
      const uint32_t off =
          (c / 8) * hop::Tile<MAX_W>::ATOM + hop::swizzle(qh, c % 8);
      *reinterpret_cast<uint4*>(sgen + off) = vh;
      *reinterpret_cast<uint4*>(sgen + Q_BYTES + off) = vl;
    }
  }

  float o[NC / 2], ox[EX ? 32 : 1];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (EX ? 32 : 1); ++i) ox[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool pv = g * NC < R;          // this warpgroup's columns are read
  const uint32_t vcol = (g * NC / 64) * KT_ATOM;
  // this warpgroup's k steps of S: its half of W
  const int kh = (CPR / 2 + 1) / 2;
  const int kk0 = g * kh, kk1 = min(CPR / 2, kk0 + kh);
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_k(it + 1, row_next);
      hop::cp_commit();
      row_next = row_of(it + 2);     // its lookup runs under this tile
      hop::cp_wait<1>();
    } else {
      hop::cp_wait<0>();
    }
    hop::fence_async_smem();
    __syncthreads();
    const uint32_t kt = sk0 + (it & 1) * K_BYTES;

    // S = q K^T, hi and lo (two accumulators, so that the two chains of
    // products overlap): each warpgroup over its half of W, then the
    // halves summed through shared memory, so both hold the same S
    float sc[16], sl[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = sl[i] = 0.f;
    hop::wg_fence();
    for (int kk = kk0; kk < kk1; ++kk) {
      const uint64_t dk = hop::desc_kt<TKC>(kt, kk);
      hop::mma_ss_t<32, 0>(sc, hop::desc_k<MAX_W>(sq_hi, kk), dk, 1);
      hop::mma_ss_t<32, 0>(sl, hop::desc_k<MAX_W>(sq_lo, kk), dk, 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(sl);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] += sl[i];
    sum_halves(sc, sx + tid % hop::WG, g);

    // the online softmax: the tile's first key is live, so every max is
    // finite; keys past k_hi are masked
    const int base = k_lo + it * TKC;
    const bool edge = base + TKC > k_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (edge && base + hop::acc_col(i) >= k_hi) sc[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }

    // O += P V over this warpgroup's columns, P as hi + lo fragments
    if (pv) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) hop::split_frag(sc, kk, ph[kk], pl[kk]);
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      if constexpr (EX) {
#pragma unroll
        for (int i = 0; i < 32; ++i) ox[i] *= alpha[(i >> 1) & 1];
      }
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t dv = hop::desc_nt<TKC>(kt + vcol, kk);
        hop::mma_rs<NC>(o, ph[kk], dv);
        hop::mma_rs<NC>(o, pl[kk], dv);
      }
      if constexpr (EX) {
        if (g == 1) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint64_t dv = hop::desc_nt<TKC>(kt + 8 * KT_ATOM, kk);
            hop::mma_rs<64>(ox, ph[kk], dv);
            hop::mma_rs<64>(ox, pl[kk], dv);
          }
        }
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(o);
      if constexpr (EX) hop::fence_regs(ox);
    }
    __syncthreads();  // this stage is free for the copy after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const bool whole = s_lo == s_hi;               // one split: write directly
  const size_t psz = (size_t)(2 + R) * HB;
  float* mine = part + ((size_t)cnt * gridDim.y + s) * psz;
  // the block's [ng, R] output (normalised if whole, else the split's
  // partial) through shared memory (the tiles' space: the copies and
  // products are done), then out in coalesced 16-byte stores
  float* so = reinterpret_cast<float*>(sgen);    // [HB][R + 8]
  const int rp = R + 8;                          // rows 32 bytes apart mod 128
  if (pv) stage_acc(o, l, g * NC, R, whole, so, rp);
  if constexpr (EX) {
    if (g == 1) stage_acc(ox, l, 512, R, whole, so, rp);
  }
  __syncthreads();
  {
    float4* dst = reinterpret_cast<float4*>(whole ? out + hrow * R
                                                  : mine + 2 * HB);
    const int R4 = R / 4;
    for (int x = tid; x < ng * R4; x += NTC) {
      const int h = x / R4;
      dst[x] = *reinterpret_cast<const float4*>(so + h * rp + 4 * (x - h * R4));
    }
  }
  if (whole) {
    // each row's (m, l) is whole in every thread of its quad
    if (LSE && g == 0 && tid % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = hop::acc_row(2 * r);
        if (row < ng)
          lse[hrow + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2
                                       : REPRO_NEG_INF;
      }
    }
    return;
  }
  if (g == 0 && tid % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = hop::acc_row(2 * r);
      mine[row] = m[r];
      mine[HB + row] = l[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + cnt, 1) == s_hi - s_lo;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the merge: every split's (m, l) of each head into shared memory (the
  // q tiles' space) at once, then each head's weights exp2(m - M) / L
  // in place of its m, then 16-byte loads of the partials, MI at a time
  const int ns = s_hi - s_lo + 1;
  const float* all = part + ((size_t)cnt * gridDim.y + s_lo) * psz;
  float* wt = reinterpret_cast<float*>(sgen);    // [ng][ns]: m, then weight
  float* lt = wt + ng * ns;                      // [ng][ns]: l
  for (int x = tid; x < ng * ns; x += NTC) {
    const int h = x / ns, t = x - h * ns;
    wt[x] = __ldcg(all + t * psz + h);
    lt[x] = __ldcg(all + t * psz + HB + h);
  }
  __syncthreads();
  for (int h = tid; h < ng; h += NTC) {
    float M = -INFINITY, L = 0.f;
    for (int t = 0; t < ns; ++t) M = fmaxf(M, wt[h * ns + t]);
    for (int t = 0; t < ns; ++t)
      if (lt[h * ns + t] > 0.f)
        L += lt[h * ns + t] * exp2f(wt[h * ns + t] - M);
    for (int t = 0; t < ns; ++t)
      wt[h * ns + t] = lt[h * ns + t] > 0.f && L > 0.f
                           ? exp2f(wt[h * ns + t] - M) / L
                           : 0.f;
    if (LSE)
      lse[hrow + h] = L > 0.f ? (M + log2f(L)) * LN2 : REPRO_NEG_INF;
  }
  __syncthreads();
  // a thread sums MI float4s of the output at once: MI of a split's
  // loads in flight
  constexpr int MI = 16;
  const int R4 = R / 4, n4 = ng * R4;
  const size_t ps4 = psz / 4;
  const float4* src = reinterpret_cast<const float4*>(all) + HB / 2;
  float4* dst = reinterpret_cast<float4*>(out + hrow * R);
  for (int x0 = tid; x0 < n4; x0 += MI * NTC) {
    float4 a[MI];
    int xs[MI], hs[MI];
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      xs[j] = min(x0 + j * NTC, n4 - 1);         // past n4: read, not stored
      hs[j] = xs[j] / R4;
    }
    for (int t = 0; t < ns; ++t) {
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        const float4 v = __ldcg(src + t * ps4 + xs[j]);
        const float w = wt[hs[j] * ns + t];
        a[j].x += w * v.x;
        a[j].y += w * v.y;
        a[j].z += w * v.z;
        a[j].w += w * v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < MI; ++j)
      if (x0 + j * NTC < n4) dst[x0 + j * NTC] = a[j];
  }
  if (tid == 0) count[cnt] = 0;
}

// The shared-memory limit of each kernel is set once, at its first launch.
template <typename K>
int allow_smem(K kernel, bool& ready, size_t smem) {
  if (ready) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ready = true;
  return 0;
}

template <int NQ, bool LSE>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* pool,
           const void* bt, const void* ctx, void* out, void* lse, void* part,
           void* count, int H, int groups, int W, int R, int page, int MB,
           int window, float scale, int split_len) {
  static bool ready = false;
  const int rc = allow_smem(decode<NQ, LSE>, ready, smem_bytes(MAX_W));
  if (rc != 0) return rc;
  decode<NQ, LSE><<<grid, NT, smem_bytes(W), st>>>(
      (const float*)q, (const float*)pool, (const int*)bt, (const int*)ctx,
      (float*)out, (float*)lse, (float*)part, (int*)count, H, groups, W, R,
      page, MB, window, scale, split_len);
  return 0;
}

template <int NC, bool EX, bool LSE>
int launch_tc(dim3 grid, cudaStream_t st, const void* q, const void* pool,
              const void* bt, const void* ctx, void* out, void* lse,
              void* part, void* count, int H, int W, int R, int page, int MB,
              int window, float scale, int split_len) {
  static bool ready = false;
  const int rc = allow_smem(decode_tc<NC, EX, LSE>, ready, TC_SMEM);
  if (rc != 0) return rc;
  decode_tc<NC, EX, LSE><<<grid, NTC, TC_SMEM, st>>>(
      (const float*)q, (const __nv_bfloat16*)pool, (const int*)bt,
      (const int*)ctx, (float*)out, (float*)lse, (float*)part, (int*)count,
      H, W, R, page, MB, window, scale, split_len);
  return 0;
}

}  // namespace mla

}  // namespace

// q [B,H,W] fp32 (pre-scaled queries [q_nope W_uk ++ q_pe]); pool
// [nblk,page,W] bf16 (decode_tc) or fp32 (decode); bt [B,MB] int32; ctx
// [B] int32; out [B,H,R] fp32, the first R lanes of the attention output;
// lse [B,H] fp32 (m + log l of each head, NEG_INF where no key is live) or
// null. W and R multiples of 8, R <= W <= 576. window <= 0: none. splits
// blocks of split_len keys per (request, head block) of hg = 64 heads
// (bf16) or 32 (fp32); with more than one split, part holds B * groups *
// splits partials of (2 + R) * hg floats and count B * groups int32 zeros
// (left zero); groups = ceil(H / hg).
extern "C" int mla_decode(const void* q, const void* pool, const void* bt,
                          const void* ctx, void* out, void* lse, void* part,
                          void* count, int B, int H, int W, int R, int page,
                          int MB, int window, float scale, int splits,
                          int split_len, int kv_dtype, void* stream) {
  using namespace mla;
  if (W <= 0 || W % 8 || W > MAX_W || R <= 0 || R % 8 || R > W || H <= 0 ||
      page <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < (long long)MB * page ||
      (splits > 1 && (part == nullptr || count == nullptr)) ||
      (kv_dtype != DT_BF16 && kv_dtype != DT_F32))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (kv_dtype == DT_BF16) {
    const dim3 grid((H + HB - 1) / HB, splits, B);
    auto go = [&](auto fn) {
      return fn(grid, st, q, pool, bt, ctx, out, lse, part, count, H, W, R,
                page, MB, window, scale, split_len);
    };
    if (splits > MAX_SPLITS_TC) return (int)cudaErrorInvalidValue;
    const bool l = lse != nullptr;
    if (R <= 128)
      rc = l ? go(launch_tc<64, false, true>)
             : go(launch_tc<64, false, false>);
    else if (R <= 256)
      rc = l ? go(launch_tc<128, false, true>)
             : go(launch_tc<128, false, false>);
    else if (R <= 512)
      rc = l ? go(launch_tc<256, false, true>)
             : go(launch_tc<256, false, false>);
    else
      rc = l ? go(launch_tc<256, true, true>)
             : go(launch_tc<256, true, false>);
  } else {
    const int groups = (H + HG - 1) / HG;
    const dim3 grid(splits, groups, B);
    auto go = [&](auto fn) {
      return fn(grid, st, q, pool, bt, ctx, out, lse, part, count, H, groups,
                W, R, page, MB, window, scale, split_len);
    };
    const bool l = lse != nullptr;
    if (R <= 4 * (NT / 2))
      rc = l ? go(launch<1, true>) : go(launch<1, false>);
    else
      rc = l ? go(launch<2, true>) : go(launch<2, false>);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of decode_tc, for reports.
extern "C" int mla_decode_tc_smem() { return mla::TC_SMEM; }
