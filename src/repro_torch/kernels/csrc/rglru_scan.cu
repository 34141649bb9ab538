// RG-LRU linear recurrence h_t = a_t * h_{t-1} + g_t, forward and
// backward, over contiguous a/g [B,T,C] (fp32 or bf16, read as fp32), y
// [B,T,C] fp32 (the recurrence of RecurrentGemma's RG-LRU block). The
// forward starts from a carried h_{-1} = h0 [B,C] fp32 (a serving
// prefill's chunk after the first) or from 0 when h0 is null (training;
// the backward assumes 0).
//
// Replaces the TPU kernel rglru_scan_kernel of
// src/repro/kernels/rglru_scan/kernel.py. There a grid (batch, channel
// tile, time tile) with time innermost ran a log2(blk_t)-round
// associative scan over each 128 x 128 time tile in VMEM, to keep the
// TPU's lanes busy, carrying h from tile to tile in scratch; T and C were
// padded to the tiles with the identity a = 1, g = 0. The JAX package
// differentiates the recurrence with XLA autodiff, so the backward has no
// TPU kernel of its own.
//
// On the card each thread owns one (batch row, channel) and walks T in
// order: the recurrence needs no scan, only a carry. Neighbouring
// threads own neighbouring channels, so every load and store of a warp
// is one coalesced 128-byte row of a time step. The loads do not depend
// on h, so a thread keeps the next U time steps of its inputs in flight
// (a double buffer in registers) while it computes the current ones. The
// ragged ends of T and C are masked, not padded. Each step rounds its
// product and its sum separately (no fused multiply-add), as the plain
// PyTorch loop does, so the two agree to the last bit.
//
// Backward, the same sweep in reverse time: with dy the gradient of y,
//   dh_t = dy_t + a_{t+1} * dh_{t+1}   (dh_{T-1} = dy_{T-1})
//   dg_t = dh_t,  da_t = dh_t * y_{t-1}   (y_{-1} = 0)
// one thread per (batch row, channel) as in the forward: it reads a, y
// and dy once and writes da and dg once, no atomics.
//
// Bound on the H100: bytes. The forward moves 12 bytes a (row, step,
// channel) in fp32 for 2 flops, the backward 20 bytes for 3. At the
// training shape (B 4, T 2048, C 4096) that is 0.120 ms and 0.200 ms at
// 3.35 TB/s. One thread per (row, channel) gives 16,384 threads there,
// four warps an SM, so the kernel is bound by how many loads are in
// flight (latency), not by the memory's rate; splitting T into chunks
// with a carry pass between them is the later step.
#include "common.cuh"

namespace {

constexpr int NTH = 128;  // threads (channels) per block
constexpr int U = 16;     // time steps a thread keeps in flight

template <typename T>
__device__ __forceinline__ float load_or(const T* x, long long i, bool ok,
                                         float dflt) {
  return ok ? to_f32(x[i]) : dflt;
}

template <typename T>
__global__ void __launch_bounds__(NTH)
rglru_fwd_kernel(const T* __restrict__ a, const T* __restrict__ g,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ hT, int Tn, int C) {
  const int c = blockIdx.x * NTH + threadIdx.x;
  if (c >= C) return;
  const int b = blockIdx.y;
  const long long base = (long long)b * Tn * C + c;
  float an[U], gn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    an[u] = load_or(a, base + (long long)u * C, u < Tn, 1.f);
    gn[u] = load_or(g, base + (long long)u * C, u < Tn, 0.f);
  }
  float h = h0 ? h0[(long long)b * C + c] : 0.f;
  for (int t0 = 0; t0 < Tn; t0 += U) {
    float ac[U], gc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next U steps, in flight
      const int t = t0 + U + u;
      an[u] = load_or(a, base + (long long)t * C, t < Tn, 1.f);
      gn[u] = load_or(g, base + (long long)t * C, t < Tn, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      h = __fadd_rn(__fmul_rn(ac[u], h), gc[u]);
      if (t < Tn) y[base + (long long)t * C] = h;
    }
  }
  hT[(long long)b * C + c] = h;
}

template <typename T>
__global__ void __launch_bounds__(NTH)
rglru_bwd_kernel(const T* __restrict__ a, const float* __restrict__ y,
                 const float* __restrict__ dy, T* __restrict__ da,
                 T* __restrict__ dg, int Tn, int C) {
  const int c = blockIdx.x * NTH + threadIdx.x;
  if (c >= C) return;
  const int b = blockIdx.y;
  const long long base = (long long)b * Tn * C + c;
  // step u of a tile ending at ``s`` is time s - u; y_{t-1} is 0 at t = 0
  float an[U], yn[U], dn[U];
  const int last = Tn - 1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = last - u;
    const long long i = base + (long long)t * C;
    an[u] = load_or(a, i, t >= 0, 0.f);
    yn[u] = load_or(y, i - C, t >= 1, 0.f);
    dn[u] = load_or(dy, i, t >= 0, 0.f);
  }
  float carry = 0.f;  // a_{t+1} * dh_{t+1}
  for (int s = last; s >= 0; s -= U) {
    float ac[U], yc[U], dc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      yc[u] = yn[u];
      dc[u] = dn[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next U steps back, in flight
      const int t = s - U - u;
      const long long i = base + (long long)t * C;
      an[u] = load_or(a, i, t >= 0, 0.f);
      yn[u] = load_or(y, i - C, t >= 1, 0.f);
      dn[u] = load_or(dy, i, t >= 0, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = s - u;
      if (t >= 0) {
        const float dh = __fadd_rn(dc[u], carry);
        const long long i = base + (long long)t * C;
        dg[i] = from_f32<T>(dh);
        da[i] = from_f32<T>(__fmul_rn(dh, yc[u]));
        carry = __fmul_rn(ac[u], dh);
      }
    }
  }
}

}  // namespace

// a/g [B,T,C] of one dtype, h0 [B,C] fp32 or null (a zero start);
// writes y [B,T,C] and hT [B,C], fp32.
extern "C" int rglru_scan_fwd(const void* a, const void* g, const void* h0,
                              void* y, void* hT, int B, int T, int C,
                              int dtype, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((C + NTH - 1) / NTH, B);
  if (dtype == DT_F32)
    rglru_fwd_kernel<float><<<grid, NTH, 0, st>>>(
        (const float*)a, (const float*)g, (const float*)h0, (float*)y,
        (float*)hT, T, C);
  else if (dtype == DT_BF16)
    rglru_fwd_kernel<__nv_bfloat16><<<grid, NTH, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)g, (const float*)h0,
        (float*)y, (float*)hT, T, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a [B,T,C] (a's dtype), the forward's y and its gradient dy [B,T,C]
// fp32; writes da and dg [B,T,C] in a's dtype.
extern "C" int rglru_scan_bwd(const void* a, const void* y, const void* dy,
                              void* da, void* dg, int B, int T, int C,
                              int dtype, void* stream) {
  if (B == 0 || T == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((C + NTH - 1) / NTH, B);
  if (dtype == DT_F32)
    rglru_bwd_kernel<float><<<grid, NTH, 0, st>>>(
        (const float*)a, (const float*)y, (const float*)dy, (float*)da,
        (float*)dg, T, C);
  else if (dtype == DT_BF16)
    rglru_bwd_kernel<__nv_bfloat16><<<grid, NTH, 0, st>>>(
        (const __nv_bfloat16*)a, (const float*)y, (const float*)dy,
        (__nv_bfloat16*)da, (__nv_bfloat16*)dg, T, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
