// Hopper tile machinery of the port's tensor-core kernels: bf16 tiles
// staged in shared memory by asynchronous copies, warpgroup matrix
// products (wgmma) on them, and the register fragments that feed one
// product's fp32 result into the next as its bf16 A operand.
//
// Tile layout. A tile holds TR = 64 rows of HD bf16 (one row per query
// or key position) as HD/64 column blocks ("atoms") of 64 rows x 128
// bytes, one after the other. The 16-byte chunk c (0-7) of row r of an
// atom lies at r * 128 + ((c ^ (r % 8)) * 16): the 128-byte swizzle that
// TMA writes and wgmma reads, so that the eight rows of a core matrix
// fall in distinct banks. Tiles start on 1024-byte boundaries.
//
// Operands. wgmma reads A (64 x 16) and B (16 x N) of each k step from
// shared memory through a 64-bit descriptor: start address, the byte
// stride between 8-row groups (SBO, 1024 here) and, for an operand whose
// N dimension runs along the rows (N-major, the transpose bit set), the
// byte stride between 64-column atoms (LBO, one atom). A K-major operand
// (the 16 k values of a k step along a row) advances 32 bytes within the
// atom per k step and one atom per four; an N-major one advances 16 rows
// (2048 bytes) per k step. A may instead come from registers, in the
// layout of an fp32 accumulator: the result of S = Q K^T feeds P V
// without a trip through shared memory.
//
// Accumulator layout of an m64nN product (N/2 floats a thread): thread t
// of the warpgroup (warp w = t / 32, lane l) holds, in register i, row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
// The four registers 8 kk .. 8 kk + 7 cover columns 16 kk .. 16 kk + 15
// of both rows: packed in pairs to bf16 they are k step kk's A fragment.
//
// Precision. A bf16 A operand made from fp32 values (probabilities,
// score gradients) is split into hi = bf16(x) and lo = bf16(x - hi) and
// multiplied twice, so the product keeps about 16 bits of x instead of
// 8; the B operands (Q, K, V, dO) are bf16 inputs and exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

constexpr int TR = 64;    // rows of a tile: the wgmma M
constexpr int WG = 128;   // threads of a warpgroup

template <int HD> struct Tile {
  static constexpr int ATOM = TR * 128;     // bytes of one 64-column block
  static constexpr int BYTES = TR * HD * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after the dynamic shared memory
// base (kernels ask for 1024 bytes more than they use).
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// asynchronous copies (cp.async); a copy with ``ok`` false writes zeros
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes visible to wgmma (the async
// proxy); then a barrier hands them to the other threads' products.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Start the copy of one tile: rows [0, TR) from ``g`` (row r at g + r *
// ld elements) into the tile at shared address ``sm``; rows at or past
// ``nvalid`` are zero. NTHR threads (tid in [0, NTHR)) share the copy.
template <int HD, int NTHR>
__device__ __forceinline__ void load_tile(uint32_t sm,
                                          const __nv_bfloat16* g,
                                          long long ld, int nvalid,
                                          int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks of a row
  static_assert(TR * CPR % NTHR == 0, "threads must divide the chunks");
#pragma unroll
  for (int i = 0; i < TR * CPR / NTHR; ++i) {
    const int x = tid + i * NTHR;
    const int r = x / CPR, c = x % CPR;
    const bool ok = r < nvalid;
    cp_async16(sm + (c / 8) * Tile<HD>::ATOM + swizzle(r, c % 8),
               ok ? g + r * ld + c * 8 : g, ok);
  }
}

// A tile whose rows lie at gathered addresses (a paged pool's rows through
// a block table, the packed query heads of a kv head): NTHR threads share
// the copy as in load_tile, so thread ``tid`` copies the 16-byte chunk tid
// % CPR of rows row_slot(i, tid), i < ROW_SLOTS, and the caller gives
// each of those rows' element offsets from ``g`` (negative: a zero row).
template <int HD, int NTHR>
constexpr int ROW_SLOTS = TR * (HD / 8) / NTHR;
template <int HD, int NTHR>
__device__ __forceinline__ int row_slot(int i, int tid) {
  static_assert(NTHR % (HD / 8) == 0, "a thread keeps one chunk column");
  return tid / (HD / 8) + i * (NTHR / (HD / 8));
}
template <int HD, int NTHR>
__device__ __forceinline__ void load_tile_rows(
    uint32_t sm, const __nv_bfloat16* g,
    const long long (&off)[ROW_SLOTS<HD, NTHR>], int tid) {
  constexpr int CPR = HD / 8;
  const int c = tid % CPR;
#pragma unroll
  for (int i = 0; i < ROW_SLOTS<HD, NTHR>; ++i) {
    const int r = row_slot<HD, NTHR>(i, tid);
    const bool ok = off[i] >= 0;
    cp_async16(sm + (c / 8) * Tile<HD>::ATOM + swizzle(r, c % 8),
               ok ? g + off[i] + c * 8 : g, ok);
  }
}

// ---------------------------------------------------------------------------
// wgmma descriptors and synchronisation
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}
// K-major operand (A, or B as its N rows), k step kk of 16 elements.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * Tile<HD>::ATOM + (kk % 4) * 32, 16, 1024);
}
// N-major B (k along the tile's rows, N = HD along a row), k step kk.
template <int HD>
__device__ __forceinline__ uint64_t desc_n(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, Tile<HD>::ATOM, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (called after wg_wait).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int acc);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db);

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
template <> __device__ __forceinline__ void mma_ss<64>(float (&d)[32],
                                                   uint64_t da,
                                                   uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from
// shared memory N-major (the transpose bit set)
template <> __device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from
// shared memory N-major (the transpose bit set)
template <> __device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A from registers, B from
// shared memory N-major (the transpose bit set)
template <> __device__ __forceinline__ void mma_rs<256>(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// register fragments
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// k step kk's A fragments from a 64 x N fp32 accumulator ``s`` (N / 2
// registers): hi = bf16(s), lo = bf16(s - hi).
template <int NR>
__device__ __forceinline__ void split_frag(const float (&s)[NR], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[j] = bf16x2_bits(h);
    lo[j] = bf16x2_bits(__floats2bfloat162_rn(
        x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y)));
  }
}

// Row (0-63) and column offset of accumulator register i for this thread.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x % WG) / 32) + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// ---------------------------------------------------------------------------
// Tall tiles (the SSD backward, ssd_scan.cu; the MLA decode's 32-key
// tiles, paged_attention.cu): RW = 32, 64 or 128 rows of W bf16 columns,
// stored as W/64 atoms of RW rows x 128 bytes, each with the 128-byte
// swizzle above. A 64-row tall tile is a Tile<W>. With 128 rows
// a K-major operand still advances 32 bytes a k step within an atom and
// one atom per four, an N-major one 16 rows (2048 bytes) a k step, with
// the atoms RW * 128 bytes apart; a 64-row A operand from rows 64..127
// starts 8192 bytes into each atom.
// ---------------------------------------------------------------------------
template <int RW>
__device__ __forceinline__ uint32_t tall_off(int r, int c) {  // c: chunk
  return (c / 8) * RW * 128 + swizzle(r, c % 8);
}
template <int RW>
__device__ __forceinline__ uint64_t desc_kt(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * RW * 128 + (kk % 4) * 32, 16, 1024);
}
template <int RW>
__device__ __forceinline__ uint64_t desc_nt(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, RW * 128, 1024);
}

// Start the copy of rows [0, RW) x columns [0, W) of a bf16 matrix (row r
// at g + r * ld elements) into a tall tile; rows at or past ``nrows`` and
// columns at or past ``ncols`` (a multiple of 8) are zero.
template <int RW, int W, int NTHR>
__device__ __forceinline__ void load_tall(uint32_t sm, const __nv_bfloat16* g,
                                          long long ld, int nrows, int ncols,
                                          int tid) {
  constexpr int CPR = W / 8;
  for (int x = tid; x < RW * CPR; x += NTHR) {
    const int r = x / CPR, c = x % CPR;
    const bool ok = r < nrows && c * 8 < ncols;
    cp_async16(sm + tall_off<RW>(r, c), ok ? g + r * ld + c * 8 : g, ok);
  }
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, A
// K-major, B K-major (TB 0) or N-major (TB 1, the transpose bit)
template <int N, int TB> struct SS;
template <int TB> struct SS<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int TB> struct SS<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int TB> struct SS<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int N, int TB>
__device__ __forceinline__ void mma_ss_t(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  SS<N, TB>::run(d, da, db, acc);
}

// hi = bf16(x), lo = bf16(x - hi) of a pair, packed as A-fragment words
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - __bfloat162float(h.x),
                                         x1 - __bfloat162float(h.y)));
}

}  // namespace hop
