// Pieces of the flash-attention forward kernel (flash_attn_fwd.cu):
// cp.async tile loads, the bf16 mma.sync m16n8k16 product and its
// fragment loads.  (The backward kernels use hopper_common.cuh.)
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16, row-major: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                       a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same);
//   B 16x8, "col":      b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9);
//   C 16x8, f32:        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So a C tile of rows x 16 columns, rounded to bf16, is exactly the A
// fragment of the next product over those 16 columns: the forward keeps
// its probabilities in registers between its two products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;  // rows of every Q / K / V / dO tile
constexpr int kWarps = 4;  // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
// padded shared-memory row (elements): 144 bytes, so the 8 rows a warp
// reads in one fragment load fall on distinct banks
constexpr int kStride = kHeadDim + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows [row0, row0 + 64) of one (batch, head) into a padded smem tile;
// rows at or past S are zero-filled (and masked by the caller)
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          int64_t row_stride, int row0, int S,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < kTile * (kHeadDim / 8); i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < S;
    const __nv_bfloat16* src = base + (valid ? row : 0) * row_stride + c;
    cp_async16(smem + r * kStride + c, src, valid);
  }
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of this warp's 16 rows of a [64, 64] smem tile, all four
// 16-column steps of the head dim
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[kHeadDim / 16][4],
                                            const __nv_bfloat16* tile,
                                            int warp, int lane) {
  const __nv_bfloat16* r =
      tile + (warp * 16 + (lane >> 2)) * kStride + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    f[kk][0] = lds32(r + kk * 16);
    f[kk][1] = lds32(r + 8 * kStride + kk * 16);
    f[kk][2] = lds32(r + kk * 16 + 8);
    f[kk][3] = lds32(r + 8 * kStride + kk * 16 + 8);
  }
}

// acc[16 x 64] = A[16 x 64] * T^T for the warp's A fragments and a
// [64, 64] smem tile T read by rows (the B operand of "x @ T^T")
__device__ __forceinline__ void product_abt(float (&acc)[kTile / 8][4],
                                            const uint32_t (&a)[kHeadDim / 16][4],
                                            const __nv_bfloat16* tile,
                                            int lane) {
#pragma unroll
  for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      const __nv_bfloat16* r =
          tile + (nb * 8 + (lane >> 2)) * kStride + kk * 16 + 2 * (lane & 3);
      mma_bf16_16816(acc[nb], a[kk], lds32(r), lds32(r + 8));
    }
  }
}

// acc[16 x 64] += X[16 x 64] * T for X given as an f32 C tile (rounded to
// bf16 here, the A fragments of the product) and a [64, 64] smem tile T
// read through ldmatrix.trans (the B operand of "x @ T")
__device__ __forceinline__ void product_ab(float (&acc)[kHeadDim / 8][4],
                                           const float (&x)[kTile / 8][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < kHeadDim / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + row * kStride + np * 16 + (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// this warp's 16 rows of a [*, 64] f32 C tile to bf16 rows of `out`,
// skipping rows at or past S
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           int64_t row_stride,
                                           const float (&acc)[kHeadDim / 8][4],
                                           int row_a, int S, int lane,
                                           float mul_a = 1.f,
                                           float mul_b = 1.f) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int nb = 0; nb < kHeadDim / 8; ++nb) {
    const int col = nb * 8 + 2 * (lane & 3);
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(out + row_a * row_stride + col) =
          __floats2bfloat162_rn(acc[nb][0] * mul_a, acc[nb][1] * mul_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(out + row_b * row_stride + col) =
          __floats2bfloat162_rn(acc[nb][2] * mul_b, acc[nb][3] * mul_b);
  }
}

}  // namespace flash
