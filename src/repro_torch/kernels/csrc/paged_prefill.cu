// Paged flash prefill: chunked-prefill attention straight over the paged
// KV pool, after the chunk's own rows were appended to it.
//
// Replaces the TPU kernel paged_flash_prefill_kernel of
// src/repro/kernels/flash_prefill/kernel.py. There a sequential grid (b,
// q block, page) carried the online-softmax state across pages in VMEM,
// with q reshaped to [KV, rep * rows, hd] so that each K/V page served all
// rep = H/KV query heads of its kv head. The card keeps that packing: the
// rows of one (request, kv head) are the flattened list [T * rep], row j
// being query position j / rep of head kvh * rep + j % rep, at absolute
// position prior_len[b] + j / rep. A block owns 64 consecutive rows and
// walks the block table over its own key range: [window_lo, last query
// position], or [0, prior) for prior_only. So each K/V row is read once
// per 64 rows for all rep heads, any rep works (7, 12, ...), the causal
// mask kpos <= qpos covers the prior context and the chunk's prefix in
// one sweep, and no score ever reaches device memory. Rows past T * rep
// compute but never store: nothing is padded.
//
// Bound on the H100: operations. At serving shapes (T = 512, contexts of
// thousands of tokens) the sweep does 4 * hd flops per live (row, key)
// pair, far above the ~295 flops per byte at which the bf16 tensor cores,
// not the memory, are the limit. Two routes, chosen by dtype alone:
//
// bf16 q over bf16 pools: prefill_tc, on the tensor cores with the tile
// machinery of hopper.cuh, as flash_prefill.cu's fwd_tc. One warpgroup
// per 64 rows; the Q tile is a gather of those rows; each 64-key tile is
// 64 pool rows looked up through the block table (page is a runtime
// argument and need not divide 64; the rows' offsets are computed one
// each by 64 threads into shared memory a tile ahead, so a thread pays
// one division a tile, not eight), copied by cp.async into a two-stage
// ring with the 128-byte swizzle, zero past the key range. S = Q K^T as a
// wgmma from shared memory, the online softmax in base 2 on S's
// registers, O += P V with P from registers as bf16 hi + lo halves (one
// bf16 rounding of P errs by up to 2^-9, over the bf16 tolerance where O
// is near 0) and V through the transpose bit. Masks (causal, window,
// prior_only, the key range's end) only on the tiles that need them. The
// requests' priors make the work per block differ up to ~8x, so
// blockIdx.z walks the requests longest prior first and blockIdx.x a
// request's tiles last first: the longest sweeps start first.
//
// fp32 q, or fp32 pools: prefill_kernel, on the CUDA cores in fp32 (the
// tensor cores cannot hold fp32's tolerance): 256 threads, four per row,
// sweeping 32-key tiles staged in shared memory in fp32 (flash::sweep in
// common.cuh, which the dense fp32 kernels of flash_prefill.cu share).
// This is what the lse-returning partial sweeps take (fp32 q over bf16
// pools).
#include "common.cuh"
#include "hopper.cuh"

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
  const int R = T * rep;
  const int tid = threadIdx.x;
  const int qq = tid & 3;
  const int j = tile * ROWS + (tid >> 2);
  const bool row_ok = j < R;
  const int qi = j / rep;
  const int h = kvh * rep + j % rep;
  const int prior = prior_len[b];
  const int qpos = prior + qi;

  float qr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    qr[i] = row_ok
        ? to_f32(q[(((long long)b * T + qi) * H + h) * HD + 4 * i + qq])
        : 0.f;

  const int q_first = prior + tile * ROWS / rep;
  const int q_last = prior + (min(tile * ROWS + ROWS, R) - 1) / rep;
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
  dim3 grid((T * (H / KV) + ROWS - 1) / ROWS, KV, B);
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

// ---------------------------------------------------------------------------
// The bf16 route: tensor cores (hopper.cuh)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using hop::TR;
constexpr int NTHR = hop::WG;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory: the Q tile and a two-stage ring of (K, V) tiles,
// plus 1024 bytes of slack for the tiles' alignment.
template <int HD> constexpr int smem_bytes() {
  return 5 * hop::Tile<HD>::BYTES + 1024;
}

// The request that block row ``z`` serves: the z-th longest prior (ties
// by index), so that the longest sweeps are scheduled first.
__device__ __forceinline__ int nth_longest(const int* __restrict__ prior,
                                           int B, int z) {
  __shared__ int pick;
  for (int c = threadIdx.x; c < B; c += blockDim.x) {
    const int pc = prior[c];
    int rank = 0;
    for (int o = 0; o < B; ++o) {
      const int po = prior[o];
      rank += po > pc || (po == pc && o < c);
    }
    if (rank == z) pick = c;
  }
  __syncthreads();
  return pick;
}

template <int HD>
__global__ void __launch_bounds__(NTHR)
prefill_tc(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
           const bf16* __restrict__ vpool, const int* __restrict__ bt,
           const int* __restrict__ prior_len, bf16* __restrict__ out,
           float* __restrict__ lse, int B, int T, int H, int KV, int page,
           int MB, int window, float scale, int prior_only) {
  constexpr int TB = hop::Tile<HD>::BYTES;
  constexpr int NS = hop::ROW_SLOTS<HD, NTHR>;
  extern __shared__ uint8_t smraw[];
  const uint32_t sm = hop::smem_base(smraw);
  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = nth_longest(prior_len, B, blockIdx.z);
  const int rep = H / KV;
  const int R = T * rep;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TR;
  const int prior = prior_len[b];
  const int q_first = prior + row0 / rep;
  const int q_last = prior + (min(row0 + TR, R) - 1) / rep;
  const int hi = min(prior_only ? prior : q_last + 1, MB * page);
  const int lo = window > 0 ? max(0, q_first - window + 1) : 0;
  // every row of the tile may see the keys up to here
  const int last_all = prior_only ? prior - 1 : q_first;
  const int t0 = lo / TR;
  const int n = hi > lo ? (hi - 1) / TR - t0 + 1 : 0;

  long long off[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int j = row0 + hop::row_slot<HD, NTHR>(i, tid);
    off[i] = j < R ? (((long long)b * T + j / rep) * H + kvh * rep + j % rep)
                         * HD
                   : -1;
  }
  hop::load_tile_rows<HD, NTHR>(sm, q, off, tid);
  // The key rows' offsets of tile it, written by threads 0-63 (one row
  // each, one division) into koff[it % 2] during iteration it - 2, behind
  // that iteration's S product; load_kv(it) reads them at the top of
  // iteration it - 1.
  __shared__ long long koff[2][TR];
  const int* btb = bt + (long long)b * MB;
  auto put_offsets = [&](int it) {
    const int kp = (t0 + it) * TR + tid;
    if (tid < TR)
      koff[it & 1][tid] = kp < hi ? (((long long)max(btb[kp / page], 0) *
                                      page + kp % page) * KV + kvh) * HD
                                  : -1;
  };
  auto load_kv = [&](int it) {
    long long ko[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i)
      ko[i] = koff[it & 1][hop::row_slot<HD, NTHR>(i, tid)];
    const uint32_t st = sm + TB * (1 + 2 * (it & 1));
    hop::load_tile_rows<HD, NTHR>(st, kpool, ko, tid);
    hop::load_tile_rows<HD, NTHR>(st + TB, vpool, ko, tid);
  };
  put_offsets(0);
  put_offsets(1);
  __syncthreads();
  if (n > 0) load_kv(0);
  hop::cp_commit();

  // the absolute positions of this thread's two accumulator rows
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qpos[r] = prior + (row0 + hop::acc_row(2 * r)) / rep;
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
    put_offsets(it + 2);
    hop::wg_wait<0>();
    hop::fence_regs(s);

    const int k0 = (t0 + it) * TR;
    const bool edge = k0 + TR > hi || k0 + TR - 1 > last_all ||
                      (window > 0 && k0 <= q_last - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i] * c;
      if (edge) {
        const int kp = k0 + hop::acc_col(i);
        if (kp >= hi || kp > (prior_only ? prior - 1 : qpos[r]) ||
            (window > 0 && kp <= qpos[r] - window))
          x = -INFINITY;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
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
  hop::cp_wait<0>();  // no key tile: the Q copy alone is in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = row0 + hop::acc_row(2 * r);
    if (j >= R) continue;
    const int qi = j / rep, h = kvh * rep + j % rep;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + (((long long)b * T + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + hop::acc_col(i)) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
    if (lse != nullptr && tid % 4 == 0)
      lse[((long long)b * H + h) * T + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : REPRO_NEG_INF;
  }
}

template <int HD>
void launch(const void* q, const void* kp, const void* vp, const void* bt,
            const void* prior, void* out, void* lse, int B, int T, int H,
            int KV, int page, int MB, int window, float scale,
            int prior_only, cudaStream_t st) {
  cudaFuncSetAttribute(prefill_tc<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes<HD>());
  dim3 grid((T * (H / KV) + TR - 1) / TR, KV, B);
  prefill_tc<HD><<<grid, NTHR, smem_bytes<HD>(), st>>>(
      (const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)bt,
      (const int*)prior, (bf16*)out, (float*)lse, B, T, H, KV, page, MB,
      window, scale, prior_only);
}

}  // namespace tc

}  // namespace

// q [B,T,H,hd]; pools [nblk,page,KV,hd] holding the chunk's rows; bt
// [B,MB] int32; prior [B] int32; out [B,T,H,hd] (q's dtype); lse [B,H,T]
// fp32 or null. window <= 0: none. Any H/KV; hd 64 or 128.
extern "C" int paged_flash_prefill(const void* q, const void* kpool,
                                   const void* vpool, const void* bt,
                                   const void* prior, void* out, void* lse,
                                   int B, int T, int H, int KV, int hd,
                                   int page, int MB, int window, float scale,
                                   int prior_only, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0 || page <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16) {
    if (hd == 64)
      tc::launch<64>(q, kpool, vpool, bt, prior, out, lse, B, T, H, KV, page,
                     MB, window, scale, prior_only, st);
    else if (hd == 128)
      tc::launch<128>(q, kpool, vpool, bt, prior, out, lse, B, T, H, KV,
                      page, MB, window, scale, prior_only, st);
    else
      rc = (int)cudaErrorInvalidValue;
  } else if (q_dtype == DT_F32 && kv_dtype == DT_F32) {
    rc = launch_hd<float, float>(q, kpool, vpool, bt, prior, out, lse, B, T,
                                 H, KV, hd, page, MB, window, scale,
                                 prior_only, st);
  } else if (q_dtype == DT_F32 && kv_dtype == DT_BF16) {
    rc = launch_hd<float, __nv_bfloat16>(q, kpool, vpool, bt, prior, out,
                                         lse, B, T, H, KV, hd, page, MB,
                                         window, scale, prior_only, st);
  } else if (q_dtype == DT_BF16 && kv_dtype == DT_F32) {
    rc = launch_hd<__nv_bfloat16, float>(q, kpool, vpool, bt, prior, out,
                                         lse, B, T, H, KV, hd, page, MB,
                                         window, scale, prior_only, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The dynamic shared memory that the bf16 kernel asks for at head dim hd;
// -1 for none.
extern "C" int paged_prefill_tc_smem(int hd) {
  return hd == 64 ? tc::smem_bytes<64>()
                  : hd == 128 ? tc::smem_bytes<128>() : -1;
}
