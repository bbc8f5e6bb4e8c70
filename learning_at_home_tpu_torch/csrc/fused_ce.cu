// Fused softmax cross-entropy backward for Hopper (sm_90a): dx (K2) and
// dhead (K3), bf16 operands, f32 statistics and accumulators.  The forward
// (K1) is fused_ce_fwd.cu.
//
// Replaces: learning_at_home_tpu/ops/fused_ce.py, the Pallas TPU kernels
// _dx_kernel (:96, pallas_call :244) and _dhead_kernel (:124, pallas_call
// :254).  Like them, no [n, V] logits tile ever reaches device memory:
// each block recomputes its logits tiles in registers from x, the head
// and the forward's row log-sum-exp.
//
// Layout.  x is [n, D] with D contiguous; the head [D, V] is passed as its
// transpose w = head^T [V, D] with D contiguous (the tied head is embed.T,
// so w is the embedding table itself).  logits[r, v] = x[r, :] . w[v, :].
//
// One template serves both kernels.  A block owns a "fixed" tile of 64
// rows of one operand, kept in shared memory, and streams 64-row tiles of
// the other operand through a cp.async double buffer:
//
//   K2 (dx):    fixed = x rows, streamed = vocab tiles.  Per tile: S, then
//               dl = (exp(S - lse) - onehot) * dce in f32, rounded to bf16
//               into shared memory, then acc[64, D] += dl . w_tile.
//   K3 (dhead): fixed = 64 vocab rows of w, streamed = row tiles of x.
//               Per tile: S^T = w_tile . x_tile^T, the same dl, then
//               acc[64 vocab, D] += dl^T . x_tile.  Each block owns its
//               vocab rows of dhead^T and walks the row tiles in order,
//               so the result is deterministic and needs no atomics.
//
// The [64, D] f32 accumulator of K2/K3 (128 KB at D = 512) is split over
// the block's 8 warps by columns: each warp holds [64, D/8] in registers
// (128 floats a thread at D = 512).  So the logits are computed once per
// (row tile, vocab tile) pair: K2 and K3 each recompute the forward
// product once (recompute factor 1, as on the TPU) and no kernel splits
// D across blocks.
//
// What bounds them on the H100: at n = 45056, D = 512, V = 32768 the
// products are 3.02 TFLOP each against ~80 MB of operands, so tensor-core
// throughput, not memory, bounds both (3.06 ms at 989 TFLOP/s).  The
// design keeps every product on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators) and never writes logits.  Known levers left
// for later: wgmma and TMA (as in K1) and a deeper pipeline.
//
// Numerics.  dl is rounded to bf16 before the second product (the TPU
// kernel multiplies it in f32): relative error 2^-9 per term, so dx and
// dhead are held against their f32 plain versions with a tolerance
// derived from 2^-8.  Everything else (logits, statistics, the sums of
// both products) is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows of the fixed tile and of each streamed tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// padding (elements) of each shared-memory row: with D + 8 elements a row
// is 16 bytes past a multiple of 128, so the 8 rows an ldmatrix reads hit
// distinct banks
constexpr int kPad = 8;
constexpr int kDlStride = kTile + kPad;

enum Mode { kDx, kDhead };

template <int D>
struct Layout {
  static constexpr int kStride = D + kPad;
  static constexpr int kTileElems = kTile * kStride;
  // fixed tile, two streamed tiles, the bf16 dl tile
  static constexpr int kBf16Elems = 3 * kTileElems + kTile * kDlStride;
  // per streamed row (K3): lse, dce, target, double-buffered
  static constexpr size_t kBytes =
      kBf16Elems * sizeof(bf16) + 2 * 3 * kTile * sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a [rows, D] matrix (row stride ld) into a padded
// shared tile; rows at or past `rows` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g,
                                          int64_t ld, int r0, int rows,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = r0 + r;
    const bool valid = row < rows;
    cp_async16(smem + r * Layout<D>::kStride + c,
               g + static_cast<int64_t>(valid ? row : 0) * ld + c, valid);
  }
}

// lse, dce and target of rows [r0, r0 + 64) (K3's streamed rows); rows at
// or past n read as zero, so their dl is zero
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_dce,
                                               int* s_tgt, const float* lse,
                                               const float* dce,
                                               const int* tgt, int r0, int n,
                                               int tid) {
  if (tid < kTile) {
    const int row = r0 + tid;
    const bool valid = row < n;
    const int src = valid ? row : 0;
    cp_async4(s_lse + tid, lse + src, valid);
    cp_async4(s_dce + tid, dce + src, valid);
    cp_async4(s_tgt + tid, tgt + src, valid);
  }
}

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ce_kernel(const bf16* __restrict__ fixed, int64_t ld_fixed,
                    int n_fixed, const bf16* __restrict__ streamed,
                    int64_t ld_streamed, int n_streamed,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse_in,
                    const float* __restrict__ dce_in,
                    bf16* __restrict__ out, int64_t ld_out) {
  using L = Layout<D>;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sF = reinterpret_cast<bf16*>(smem_raw);
  bf16* sT = sF + L::kTileElems;            // two buffers
  bf16* sDL = sT + 2 * L::kTileElems;       // [64][kDlStride]
  float* sStats = reinterpret_cast<float*>(sDL + kTile * kDlStride);
  // K3: per streamed row, double-buffered
  float* sLse = sStats;                     // [2][64]
  float* sDce = sStats + 2 * kTile;         // [2][64]
  int* sTgt = reinterpret_cast<int*>(sStats + 4 * kTile);  // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within 8
  const int q = lane & 3;   // accumulator column pair
  const int wm = warp & 3;  // 16-row slab of the S tile
  const int wn = warp >> 2; // 32-column half of the S tile
  const int f0 = blockIdx.x * kTile;
  const int n_tiles = (n_streamed + kTile - 1) / kTile;
  // rows of x live on the fixed side for K2, on the streamed side for K3
  const int n_rows = kMode == kDhead ? n_streamed : n_fixed;

  load_tile<D>(sF, fixed, ld_fixed, f0, n_fixed, tid);
  load_tile<D>(sT, streamed, ld_streamed, 0, n_streamed, tid);
  if (kMode == kDhead)
    load_row_stats(sLse, sDce, sTgt, lse_in, dce_in, tgt, 0, n_rows, tid);
  cp_async_commit();

  // this thread's two fixed rows (accumulator rows g and g + 8)
  const int fr[2] = {f0 + wm * 16 + g, f0 + wm * 16 + g + 8};
  float row_lse[2] = {0.f, 0.f}, row_dce[2] = {0.f, 0.f};
  int row_tgt[2] = {-1, -1};
  if (kMode != kDhead) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (fr[r] < n_rows) {
        row_tgt[r] = __ldg(tgt + fr[r]);
        row_lse[r] = __ldg(lse_in + fr[r]);
        row_dce[r] = __ldg(dce_in + fr[r]);
      }
    }
  }

  // acc[64, D/8] of this warp's columns
  constexpr int kNT = D / 64;  // n8 tiles per warp
  const int col0 = warp * (D / 8);
  float acc[4][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sT + (buf ^ 1) * L::kTileElems, streamed, ld_streamed,
                   (j + 1) * kTile, n_streamed, tid);
      if (kMode == kDhead)
        load_row_stats(sLse + (buf ^ 1) * kTile, sDce + (buf ^ 1) * kTile,
                       sTgt + (buf ^ 1) * kTile, lse_in, dce_in, tgt,
                       (j + 1) * kTile, n_rows, tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile j (and, at j == 0, the fixed tile)
    __syncthreads();

    const bf16* tile = sT + buf * L::kTileElems;
    const int t0 = j * kTile;

    // ---- S[16 x 32 of this warp] = fixed . tile^T over D ----
    float s[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sF + (wm * 16 + (lane & 15)) * kStride + ks * 16 +
                         (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];
        ldmatrix_x4(b, tile + (wn * 32 + h * 16 + (lane & 7) +
                               ((lane >> 4) << 3)) * kStride +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * h], a, b[0], b[1]);
        mma_bf16_16816(s[2 * h + 1], a, b[2], b[3]);
      }
    }

    // ---- dl = (exp(S - lse) - onehot) * dce -> bf16 tile [fixed][streamed]
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int tc = wn * 32 + nb * 8 + 2 * q;  // streamed index in tile
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int fi = wm * 16 + g + 8 * r;  // fixed index in tile
        float dl[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float lse, dce;
          int is_target;
          if (kMode == kDx) {  // fixed = row, streamed = vocab
            lse = row_lse[r];
            dce = row_dce[r];
            is_target = (t0 + tc + c) == row_tgt[r];
          } else {  // fixed = vocab, streamed = row
            const int buf_row = buf * kTile + tc + c;
            lse = sLse[buf_row];
            dce = sDce[buf_row];
            is_target = (f0 + fi) == sTgt[buf_row];
          }
          const float p = __expf(s[nb][2 * r + c] - lse);
          dl[c] = (p - (is_target ? 1.f : 0.f)) * dce;
        }
        *reinterpret_cast<uint32_t*>(sDL + fi * kDlStride + tc) =
            pack_bf16(dl[0], dl[1]);
      }
    }
    __syncthreads();  // the dl tile is complete

    // ---- acc[64 x D/8 of this warp] += dl[64 x 64] . tile[64 x D] ----
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], sDL + (mt * 16 + (lane & 15)) * kDlStride +
                               ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, tile + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          kStride +
                   col0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer buf and the dl tile are reused next
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f0 + mt * 16 + g + 8 * r;
      if (row >= n_fixed) continue;
      bf16* dst = out + static_cast<int64_t>(row) * ld_out + col0 + 2 * q;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
            __floats2bfloat162_rn(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
    }
  }
}

template <int D, int kMode>
int launch(const void* fixed, int64_t ld_fixed, int n_fixed,
           const void* streamed, int64_t ld_streamed, int n_streamed,
           const int* tgt, const float* lse_in, const float* dce_in,
           void* out, int64_t ld_out, void* stream) {
  auto kernel = fused_ce_kernel<D, kMode>;
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_fixed + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(fixed), ld_fixed, n_fixed,
      static_cast<const bf16*>(streamed), ld_streamed, n_streamed, tgt, lse_in,
      dce_in, static_cast<bf16*>(out), ld_out);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_d(int D, const void* fixed, int64_t ld_fixed, int n_fixed,
             const void* streamed, int64_t ld_streamed, int n_streamed,
             const int* tgt, const float* lse_in, const float* dce_in,
             void* out, int64_t ld_out, void* stream) {
#define LAH_FUSED_CE_CASE(DD)                                                 \
  case DD:                                                                    \
    return launch<DD, kMode>(fixed, ld_fixed, n_fixed, streamed, ld_streamed, \
                             n_streamed, tgt, lse_in, dce_in, out, ld_out,   \
                             stream);
  switch (D) {
    LAH_FUSED_CE_CASE(128)
    LAH_FUSED_CE_CASE(256)
    LAH_FUSED_CE_CASE(384)
    LAH_FUSED_CE_CASE(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAH_FUSED_CE_CASE
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns a CUDA error code (0 on success).  x is [n, D] and w = head^T is
// [V, D], both bf16 with D contiguous, row strides ldx / ldw in elements
// (multiples of 8), 16-byte aligned; D is 128, 256, 384 or 512.  targets
// are int32, lse / dce f32, all [n] and contiguous.

// K2: dx[n, D] (bf16, row stride lddx)
extern "C" int lah_fused_ce_dx_bf16(const void* x, int64_t ldx, const void* w,
                                    int64_t ldw, const int* targets,
                                    const float* lse, const float* dce,
                                    void* dx, int64_t lddx, int n, int V,
                                    int D, void* stream) {
  return launch_d<kDx>(D, x, ldx, n, w, ldw, V, targets, lse, dce, dx, lddx,
                       stream);
}

// K3: dw[V, D] = dhead^T (bf16, row stride lddw)
extern "C" int lah_fused_ce_dhead_bf16(const void* x, int64_t ldx,
                                       const void* w, int64_t ldw,
                                       const int* targets, const float* lse,
                                       const float* dce, void* dw,
                                       int64_t lddw, int n, int V, int D,
                                       void* stream) {
  return launch_d<kDhead>(D, w, ldw, V, x, ldx, n, targets, lse, dce, dw,
                          lddw, stream);
}
