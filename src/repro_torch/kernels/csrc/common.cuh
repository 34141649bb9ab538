// Shared helpers of the port's CUDA kernels: dtype codes, loads and
// stores that convert between the storage type and fp32, and the flash
// sweep that the paged prefill kernel (paged_prefill.cu) and the dense
// causal kernels (flash_prefill.cu) share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// dtype codes passed by the Python wrappers (kernels/_lib.py DTYPES)
enum : int { DT_F32 = 0, DT_BF16 = 1 };

// lse of a row with no live key (models/cache.py NEG_INF)
#define REPRO_NEG_INF (-0x1.666664p+127f)  // fp32(-0.7 * FLT_MAX)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// The flash sweep over key tiles.
//
// A block of NT threads owns Tile<HD>::ROWS query rows: the rep = H/KV
// query heads of one kv head times ROWS/rep query positions, TPR threads
// per row, each thread holding every TPR-th element of its row (dims
// TPR*i + qq), so that the threads of a row read neighbouring
// shared-memory words and the rows of a warp read the same ones:
// conflict-free broadcasts. The block walks its key range itself in tiles
// of BK key positions, staged in shared memory in fp32 once for all ROWS
// rows. Where a key row lies in memory is the caller's business: a
// functor maps a key position to the element offset of its row of this
// kv head (a block-table lookup for the paged pool, plain arithmetic for
// a dense [B,T,KV,hd] tensor).
//
// At hd 64 and 128 a row has four threads and a tile 32 keys (ROWS = 64,
// the constants below, which the paged kernel uses). At hd 256 a row has
// eight threads and a tile 16 keys, so that a thread's slices of its row
// (HD/TPR floats each) and the static shared tile (2 x BK x HD floats,
// 32 KB) keep their hd-128 sizes; a block then owns 32 rows.
// ---------------------------------------------------------------------------
namespace flash {

constexpr int NT = 256;        // threads per block, at every head dim
constexpr int ROWS = 64;       // query rows per block at hd <= 128

template <int HD> struct Tile {
  static constexpr int TPR = HD > 128 ? 8 : 4;   // threads per query row
  static constexpr int PER = HD / TPR;           // row elements a thread
  static constexpr int ROWS = NT / TPR;          // query rows per block
  static constexpr int BK = HD > 128 ? 16 : 32;  // key positions a tile
};

template <int HD> struct KVTile {
  float k[Tile<HD>::BK][HD];
  float v[Tile<HD>::BK][HD];
  long long off[Tile<HD>::BK];
};

// Stage key positions [t0, t0 + BK) of one kv head into ``sm`` in fp32;
// positions at or past ``hi`` are zero. Ends with the tile visible to
// every thread of the block.
template <int HD, typename KT, typename KeyOff>
__device__ __forceinline__ void stage_tile(KVTile<HD>& sm,
                                           const KT* __restrict__ k,
                                           const KT* __restrict__ v, int t0,
                                           int hi, KeyOff key_off) {
  constexpr int BK = Tile<HD>::BK;
  const int tid = threadIdx.x;
  __syncthreads();  // the previous tile is consumed
  if (tid < BK) {
    const int kp = t0 + tid;
    sm.off[tid] = kp < hi ? key_off(kp) : -1;
  }
  __syncthreads();
  for (int idx = tid; idx < BK * HD; idx += NT) {
    const int j = idx / HD;
    const int d = idx % HD;
    const long long off = sm.off[j];
    sm.k[j][d] = off >= 0 ? to_f32(k[off + d]) : 0.f;
    sm.v[j][d] = off >= 0 ? to_f32(v[off + d]) : 0.f;
  }
  __syncthreads();
}

// Dot product of one row (TPR threads, this one holding ``r``) with row
// ``j`` of a staged tile; every thread of the row gets the full sum.
template <int HD>
__device__ __forceinline__ float row_dot(const float (&r)[Tile<HD>::PER],
                                         const float (*x)[HD], int j,
                                         int qq) {
  constexpr int TPR = Tile<HD>::TPR;
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < Tile<HD>::PER; ++i) p += r[i] * x[j][TPR * i + qq];
#pragma unroll
  for (int w = 1; w < TPR; w <<= 1) p += __shfl_xor_sync(0xffffffffu, p, w);
  return p;
}

// A key at position kp is live for a query row at position qpos when it
// lies below ``hi``, at or before ``last`` (the causal bound: qpos, or
// the end of a prior-only segment) and, with a window, after qpos - window.
__device__ __forceinline__ bool live(int kp, int hi, int last, int qpos,
                                     int window) {
  return kp < hi && kp <= last && (window <= 0 || kp > qpos - window);
}

// Online-softmax sweep of this thread's query row over key positions
// [lo, hi): updates the running max ``m`` (of scaled scores), sum ``l``
// and unnormalised output ``acc``. Masked keys get probability exactly 0.
// Every thread of the block must call it with the same lo and hi.
template <int HD, typename KT, typename KeyOff>
__device__ __forceinline__ void sweep(
    KVTile<HD>& sm, const KT* __restrict__ k, const KT* __restrict__ v,
    KeyOff key_off, const float (&qr)[Tile<HD>::PER], int lo, int hi,
    int last, int qpos, int window, float scale, float& m, float& l,
    float (&acc)[Tile<HD>::PER]) {
  constexpr int PER = Tile<HD>::PER;
  constexpr int TPR = Tile<HD>::TPR;
  constexpr int BK = Tile<HD>::BK;
  const int qq = threadIdx.x % TPR;
  for (int t0 = lo; t0 < hi; t0 += BK) {
    stage_tile<HD>(sm, k, v, t0, hi, key_off);
    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = row_dot<HD>(qr, sm.k, j, qq);
      s[j] = live(t0 + j, hi, last, qpos, window) ? p * scale : -INFINITY;
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
        for (int i = 0; i < PER; ++i) acc[i] += p * sm.v[j][TPR * i + qq];
      }
      m = mn;
    }
  }
}

}  // namespace flash
