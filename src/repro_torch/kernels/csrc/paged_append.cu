// Paged KV append: write new token rows into the K and V pools in place.
//
// Replaces the TPU kernels paged_append_token_kernel (one row per
// request, decode) and paged_append_chunk_kernel (B*T rows, chunked
// prefill) of src/repro/kernels/paged_attention/kernel.py. There each
// grid step DMA'd one aliased (1, 1, *w) pool row in and out of VMEM.
// Distinct live rows never share a slot (block tables are disjoint per
// request), and every parked row (slot < 0) lands on the reserved
// scratch row, the last row of the last block, whose content nobody
// reads.
//
// Bound on the H100: bytes. Each row is read once and written once
// (2 * w * (in + out) bytes for K and V) and nothing is computed, so the
// least time is those bytes over 3.35 TB/s; at decode sizes (B rows of
// 2 KB) that is a few nanoseconds, and the launch and one round trip to
// memory are all there is. So the design keeps a launch to one round
// trip: each thread moves one 16-byte vector of pool row (VEC elements)
// of K and one of V, its slot and both loads issued before either store;
// a row of w elements takes w / VEC threads, and a block of 256 threads
// takes 256 / (w / VEC) rows when rows are short (the chunk append's
// many rows of a small model). Values are cast to the pool's dtype
// (fp32 <-> bf16) in registers. A row width that is not a multiple of
// VEC, or a pointer off 16 bytes, takes the scalar route
// (append_rows_scalar), one block a row.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T, int N> struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename VT, typename PT>
__global__ void __launch_bounds__(NT)
append_rows_kernel(const VT* __restrict__ kvals, const VT* __restrict__ vvals,
                   PT* __restrict__ kpool, PT* __restrict__ vpool,
                   const int* __restrict__ slots, long long n_rows,
                   long long park_row, int w, int tpr) {
  constexpr int VEC = 16 / sizeof(PT);
  const int nvec = w / VEC;
  const long long n = (long long)blockIdx.x * (NT / tpr) + threadIdx.x / tpr;
  if (n >= n_rows) return;
  const int s = slots[n];
  const long long row = s >= 0 ? (long long)s : park_row;
  for (int i = threadIdx.x % tpr; i < nvec; i += tpr) {
    const long long src = n * w + (long long)i * VEC;
    const Vec<VT, VEC> k = *reinterpret_cast<const Vec<VT, VEC>*>(kvals + src);
    const Vec<VT, VEC> v = *reinterpret_cast<const Vec<VT, VEC>*>(vvals + src);
    Vec<PT, VEC> ko, vo;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ko.v[e] = from_f32<PT>(to_f32(k.v[e]));
      vo.v[e] = from_f32<PT>(to_f32(v.v[e]));
    }
    const long long dst = row * w + (long long)i * VEC;
    *reinterpret_cast<Vec<PT, VEC>*>(kpool + dst) = ko;
    *reinterpret_cast<Vec<PT, VEC>*>(vpool + dst) = vo;
  }
}

template <typename VT, typename PT>
__global__ void append_rows_scalar(const VT* __restrict__ kvals,
                                   const VT* __restrict__ vvals,
                                   PT* __restrict__ kpool,
                                   PT* __restrict__ vpool,
                                   const int* __restrict__ slots,
                                   long long park_row, int w) {
  const long long n = blockIdx.x;
  const int s = slots[n];
  const long long row = s >= 0 ? (long long)s : park_row;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    kpool[row * w + i] = from_f32<PT>(to_f32(kvals[n * w + i]));
    vpool[row * w + i] = from_f32<PT>(to_f32(vvals[n * w + i]));
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename VT, typename PT>
void launch(const void* kv, const void* vv, void* kp, void* vp,
            const void* slots, long long n_rows, long long park_row, int w,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(PT);
  constexpr int VB = VEC * sizeof(VT);  // bytes of a thread's value load
  const bool vec_ok = w % VEC == 0 && aligned16(kp) && aligned16(vp) &&
                      ((uintptr_t)kv % VB) == 0 && ((uintptr_t)vv % VB) == 0;
  if (!vec_ok) {
    append_rows_scalar<VT, PT><<<(unsigned)n_rows, 128, 0, stream>>>(
        (const VT*)kv, (const VT*)vv, (PT*)kp, (PT*)vp, (const int*)slots,
        park_row, w);
    return;
  }
  int tpr = 1;  // threads a row: a power of two, at least nvec or NT
  while (tpr < w / VEC && tpr < NT) tpr <<= 1;
  const long long rpb = NT / tpr;
  append_rows_kernel<VT, PT>
      <<<(unsigned)((n_rows + rpb - 1) / rpb), NT, 0, stream>>>(
          (const VT*)kv, (const VT*)vv, (PT*)kp, (PT*)vp, (const int*)slots,
          n_rows, park_row, w, tpr);
}

}  // namespace

// kvals/vvals [n_rows, w]; pools [rows_total, w] (contiguous views of the
// flat per-layer pools); slots [n_rows] int32 flat token slots.
extern "C" int paged_append_rows(const void* kvals, const void* vvals,
                                 void* kpool, void* vpool, const void* slots,
                                 long long n_rows, long long park_row, int w,
                                 int val_dtype, int pool_dtype,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows > 0) {
    if (val_dtype == DT_F32 && pool_dtype == DT_F32)
      launch<float, float>(kvals, vvals, kpool, vpool, slots, n_rows,
                           park_row, w, st);
    else if (val_dtype == DT_F32 && pool_dtype == DT_BF16)
      launch<float, __nv_bfloat16>(kvals, vvals, kpool, vpool, slots,
                                   n_rows, park_row, w, st);
    else if (val_dtype == DT_BF16 && pool_dtype == DT_F32)
      launch<__nv_bfloat16, float>(kvals, vvals, kpool, vpool, slots,
                                   n_rows, park_row, w, st);
    else if (val_dtype == DT_BF16 && pool_dtype == DT_BF16)
      launch<__nv_bfloat16, __nv_bfloat16>(kvals, vvals, kpool, vpool,
                                           slots, n_rows, park_row, w, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
