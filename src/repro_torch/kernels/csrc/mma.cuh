// Tensor-core building blocks of the port's sm_90a kernels: 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads from a
// bank-conflict-free swizzled tile, and the warp-level bf16 product
// mma.sync.aligned.m16n8k16 with float32 accumulation.
//
// Fragment layouts of m16n8k16 (lane = 4 * group + t, group 0..7, t 0..3):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row group,     cols 2t, 2t+1)   a2 (row group,     cols 2t+8, 2t+9)
//     a1 (row group + 8, cols 2t, 2t+1)   a3 (row group + 8, cols 2t+8, 2t+9)
//   B (16 x 8, "col": element (k, n)), 2 registers of 2 bf16:
//     b0 (k 2t, 2t+1; n group)            b1 (k 2t+8, 2t+9; n group)
//   C/D (16 x 8 float32): c0, c1 (row group, cols 2t, 2t+1), c2, c3 (row group + 8)
// An m16n8 accumulator tile is `float[4]`; S = Q K^T keeps one per 8 keys,
// O = P V one per 8 output columns.  Two adjacent S tiles (16 keys) are, as
// packed bf16 pairs (pack_bf16, split_bf16), exactly the A fragment of P
// for those keys.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace rt {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; with ok false nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1, zero-filled with ok false (src must
// still be a valid address).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// which lands in r[i] (lane holds row lane/4, cols 2(lane%4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane holds rows 2(lane%4), +1 of col lane/4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of bf16 (round to nearest): lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as two bf16 terms each, x = big + small with big = bf16(x)
// and small = bf16(x - big): a pair of products, big * b + small * b,
// carries x to about 2^-17 of itself where one bf16 product keeps 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 bf = __bfloat1622float2(b);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = pack_bf16(x0 - bf.x, x1 - bf.y);
}

// A shared-memory tile of rows of D bf16 (D a multiple of 8, at least 16),
// stored as 16-byte chunks whose position in the row is XOR-swizzled so
// that the 8 rows one ldmatrix matrix reads at the same logical chunk fall
// in 8 different 16-byte bank groups: with C = D/8 chunks a row, chunk c of
// row r sits at c ^ ((r / (8/G)) % G), G = min(C, 8).  The XOR keeps a
// chunk inside its row only where C is a power of two (Padded below serves
// the other head dims).
template <int D>
struct Swizzle {
  static_assert(D % 8 == 0 && D >= 16, "rows of at least two 16-byte chunks");
  static constexpr int kChunks = D / 8;
  static constexpr int kGroup = kChunks < 8 ? kChunks : 8;
  static constexpr int kRowsPerStep = 8 / kGroup;
  static constexpr int kStride = D;  // elements a row takes
  static_assert((kChunks & (kChunks - 1)) == 0, "the XOR stays inside a row of 2^k chunks");

  // element offset of the first element of (row, chunk)
  __device__ static __forceinline__ int at(int row, int chunk) {
    return row * D + ((chunk ^ ((row / kRowsPerStep) & (kGroup - 1))) << 3);
  }
};

// A shared-memory tile of rows of D bf16 (D a multiple of 16) padded to
// D + 8: a row spans an odd number of 16-byte chunks, so the 8 rows one
// ldmatrix matrix reads at the same chunk fall in 8 different 16-byte bank
// groups for every such D, powers of two or not (80, 96, ...).
template <int D>
struct Padded {
  static_assert(D % 16 == 0, "rows of whole k16 steps");
  static constexpr int kStride = D + 8;

  // element offset of the first element of (row, chunk)
  __device__ static __forceinline__ int at(int row, int chunk) {
    return row * kStride + (chunk << 3);
  }
};

// ---------------------------------------------------------------------------
// wgmma: warpgroup (4 warps, 128 threads) products from shared memory
// ---------------------------------------------------------------------------
// Descriptor of a shared-memory operand laid out in 128-byte-swizzled
// blocks: rows of 128 bytes (64 bf16), 16-byte chunk c of row r at
// c ^ (r % 8), blocks 1024-byte aligned.  lbo and sbo are byte offsets:
// K-major, sbo is the stride of 8-row groups (1024) and lbo is unused;
// MN-major, lbo is the stride of 64-element blocks along MN and sbo that of
// 8-row groups along K.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread (cp.async, st.shared) become visible
// to the async proxy that wgmma reads through; before the barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins registers at this point of the program: the compiler moves no
// access of them across it.  wgmma reads and writes its registers behind
// the compiler's back from the instruction until wgmma_wait, so every accumulator
// and A fragment is fenced after the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A * B^T over one k16 step, A 64 x 16 and B N x 16 both K-major in
// shared memory; d is the 64 x N float32 accumulator, N/2 per thread in the
// m16n8 layout of each warp's 16 rows; accumulate 0 overwrites d.  N = 32.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A * B over one k16 step, A 64 x 16 from registers (each warp's 16
// rows as the m16n8k16 A fragment), B 16 x N MN-major in shared memory (read
// transposed); d as above.  N = 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace mma
}  // namespace rt
