// Paged KV append: write new token rows into the K and V pools in place.
//
// Replaces the TPU kernels paged_append_token_kernel (one row per
// request, decode) and paged_append_chunk_kernel (B*T rows, chunked
// prefill) of src/repro/kernels/paged_attention/kernel.py. There each
// grid step DMA'd one aliased (1, 1, *w) pool row in and out of VMEM.
// Here one thread block copies one row: its threads stride over the
// row's w = KV*hd elements with a dtype cast, for K and V in the same
// launch. Blocks run in parallel; distinct live rows never share a slot
// (block tables are disjoint per request), and every parked row (slot <
// 0) lands on the reserved scratch row, the last row of the last block,
// whose content nobody reads.
//
// Bound on the H100: bytes. Each row is read once and written once
// (2 * w * (in + out) bytes for K and V) and nothing is computed, so the
// least time is those bytes over 3.35 TB/s. The design moves exactly
// those bytes with coalesced accesses; at decode sizes (B rows) the
// launch itself dominates.
#include "common.cuh"

template <typename VT, typename PT>
__global__ void append_rows_kernel(const VT* __restrict__ kvals,
                                   const VT* __restrict__ vvals,
                                   PT* __restrict__ kpool,
                                   PT* __restrict__ vpool,
                                   const int* __restrict__ slots,
                                   long long park_row, int w) {
  const long long n = blockIdx.x;
  const int s = slots[n];
  const long long row = s >= 0 ? (long long)s : park_row;
  const VT* ks = kvals + n * w;
  const VT* vs = vvals + n * w;
  PT* kd = kpool + row * w;
  PT* vd = vpool + row * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    kd[i] = from_f32<PT>(to_f32(ks[i]));
    vd[i] = from_f32<PT>(to_f32(vs[i]));
  }
}

template <typename VT, typename PT>
static void launch(const void* kv, const void* vv, void* kp, void* vp,
                   const void* slots, long long n_rows, long long park_row,
                   int w, cudaStream_t stream) {
  append_rows_kernel<VT, PT><<<(unsigned)n_rows, 128, 0, stream>>>(
      (const VT*)kv, (const VT*)vv, (PT*)kp, (PT*)vp, (const int*)slots,
      park_row, w);
}

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
