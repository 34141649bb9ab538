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
// Bound on the H100: operations. A key costs every head (W + R) * 2
// flops (the score over W lanes, the value over R) against W * 2 bytes
// read once for all heads: 128 heads make ~140 flops a byte, above the
// fp32 CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s, 20 a byte) and
// below the bf16 tensor cores' (295). This kernel is the simple fp32
// CUDA-core form; the tensor-core form is a later step.
//
// - A block owns (split, head group, request): HG = 32 query heads and
//   the key positions [s * split_len, (s + 1) * split_len) of the live
//   range [max(0, ctx - window), ctx); 128 heads are 4 groups.
// - Each tile of TK = 32 key rows is staged in shared memory once, in
//   fp32, and serves both products for all the block's heads: the
//   scores over W lanes and the value read over the first R lanes. The
//   next tile's global loads are in flight while one tile is computed.
// - Scores: warp w owns heads 4w..4w+3 and lane t key t of the tile, so
//   the query reads are warp-wide broadcasts and the online softmax of a
//   head is one warp's shuffles. Rows are padded to W + 4 floats, which
//   keeps the 32 lanes' 16-byte key reads free of bank conflicts.
// - Values: thread (c, g) owns columns 4c..4c+3 (and 4c + 512.. when R
//   exceeds 512) of 16 heads' fp32 outputs in registers.
// - Splits merge in the same launch as decode_kernel's do: fp32 partials
//   (max, sum, unnormalised [HG, R] output) to scratch, a ticket from a
//   per-(request, group) counter left zero, and the last block merges in
//   split order.
// ---------------------------------------------------------------------------
namespace {
namespace mla {

constexpr int NT = 256;                  // threads a block
constexpr int HG = 32;                   // query heads a block
constexpr int TK = 32;                   // key positions a tile
constexpr int HPW = HG / (NT / 32);      // heads a warp scores
constexpr int HPT = HG / 2;              // heads a thread accumulates
constexpr int MAX_W = 576;               // widest entry taken
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

// q [B,H,W] fp32; pool [nblk,page,W]; out [B,H,R] fp32. ``part`` holds
// B * groups * splits partials of (2 + R) * HG floats (m[HG], l[HG],
// acc[HG][R]); ``count`` B * groups counters, zero on entry, left zero.
template <typename KT, int NQ>
__global__ void __launch_bounds__(NT, 1)
decode(const float* __restrict__ q, const KT* __restrict__ pool,
       const int* __restrict__ bt, const int* __restrict__ ctx_len,
       float* __restrict__ out, float* __restrict__ part,
       int* __restrict__ count, int H, int groups, int W, int R, int page,
       int MB, int window, float scale, int split_len) {
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
    if (s == 0)
      for (int x = tid; x < ng * R; x += NT) out[hrow * R + x] = 0.f;
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
  Row8<KT> reg[LPT];
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
  if (whole) return;
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
  }
  if (tid == 0) count[cnt] = 0;
}

template <typename KT, int NQ>
int launch(dim3 grid, size_t smem, cudaStream_t st, const void* q,
           const void* pool, const void* bt, const void* ctx, void* out,
           void* part, void* count, int H, int groups, int W, int R,
           int page, int MB, int window, float scale, int split_len) {
  static bool ready = false;     // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode<KT, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_W));
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  decode<KT, NQ><<<grid, NT, smem, st>>>(
      (const float*)q, (const KT*)pool, (const int*)bt, (const int*)ctx,
      (float*)out, (float*)part, (int*)count, H, groups, W, R, page, MB,
      window, scale, split_len);
  return 0;
}

template <typename KT>
int launch_nq(int R, dim3 grid, size_t smem, cudaStream_t st, const void* q,
              const void* pool, const void* bt, const void* ctx, void* out,
              void* part, void* count, int H, int groups, int W, int page,
              int MB, int window, float scale, int split_len) {
  if (R <= 4 * (NT / 2))
    return launch<KT, 1>(grid, smem, st, q, pool, bt, ctx, out, part, count,
                         H, groups, W, R, page, MB, window, scale,
                         split_len);
  return launch<KT, 2>(grid, smem, st, q, pool, bt, ctx, out, part, count,
                       H, groups, W, R, page, MB, window, scale, split_len);
}

}  // namespace mla

}  // namespace

// q [B,H,W] fp32 (pre-scaled queries [q_nope W_uk ++ q_pe]); pool
// [nblk,page,W] fp32 or bf16; bt [B,MB] int32; ctx [B] int32; out [B,H,R]
// fp32, the first R lanes of the attention output. W and R multiples of
// 8, R <= W <= 576. window <= 0: none. splits blocks of split_len keys
// per (request, head group); with more than one split, part holds B *
// groups * splits partials of (2 + R) * 32 floats and count B * groups
// int32 zeros (left zero); groups = ceil(H / 32).
extern "C" int mla_decode(const void* q, const void* pool, const void* bt,
                          const void* ctx, void* out, void* part,
                          void* count, int B, int H, int W, int R, int page,
                          int MB, int window, float scale, int splits,
                          int split_len, int kv_dtype, void* stream) {
  using namespace mla;
  if (W <= 0 || W % 8 || W > MAX_W || R <= 0 || R % 8 || R > W || H <= 0 ||
      page <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < (long long)MB * page ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int groups = (H + HG - 1) / HG;
  const dim3 grid(splits, groups, B);
  const size_t smem = smem_bytes(W);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (kv_dtype == DT_F32)
    rc = launch_nq<float>(R, grid, smem, st, q, pool, bt, ctx, out, part,
                          count, H, groups, W, page, MB, window, scale,
                          split_len);
  else if (kv_dtype == DT_BF16)
    rc = launch_nq<__nv_bfloat16>(R, grid, smem, st, q, pool, bt, ctx, out,
                                  part, count, H, groups, W, page, MB,
                                  window, scale, split_len);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
