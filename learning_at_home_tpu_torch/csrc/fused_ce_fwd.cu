// Fused softmax cross-entropy forward (K1) for Hopper (sm_90a): ce[n] and
// lse[n] of x [n, D] @ head [D, V] against integer targets, bf16 operands,
// f32 logits and statistics, no logits written to device memory.
//
// Replaces: learning_at_home_tpu/ops/fused_ce.py:58 _fwd_kernel (_fwd
// :202, pallas_call :211), which walks vocab tiles with a running max,
// sum of exp and target logit per row.  The backward kernels K2 and K3
// are in fused_ce.cu.
//
// Layout.  x is [n, D] with D contiguous; the head is read as its
// transpose w = head^T [V, D] with D contiguous (the tied head is embed.T,
// so w is the embedding table itself).  logits[r, v] = x[r, :] . w[v, :].
//
// What bounds it on the H100: 2 n D V operations against (n + V) D bf16
// bytes, ~1.5 TFLOP against ~80 MB at n = 45056, D = 512, V = 32768:
// tensor-core throughput (1.53 ms at 989 TFLOP/s).
//
// Design.  A block of 3 warpgroups owns 128 rows of x.  Warpgroups 0 and
// 1 are consumers, 64 rows each; one thread of warpgroup 2 is the TMA
// producer (setmaxnreg: consumers 240 registers, producer 24).  The
// block's x rows stay in shared memory as D/64 128-byte-swizzled chunks
// of [128 rows, 64 columns], loaded once.  w streams through a ring of
// kStages slots under full/empty mbarriers in chunks of [128 vocab rows,
// 64 columns of D]; both consumers share each chunk.  A vocab tile's
// logits S[64 x 128] = x wᵀ are D/64 chunks of four wgmma m64n128k16
// (both operands K-major from shared memory) into f32 registers; each
// chunk's slot is released as soon as the products reading it are done,
// keeping kInFlight chunks on the tensor cores.  The epilogue of a tile
// runs while the next tile's first kInFlight chunks are on the tensor
// cores: each consumer holds two accumulators and alternates them.  In
// wgmma's accumulator layout a quad of 4 lanes holds a row, so each
// thread folds its own columns into a running (max, sum of exp) per row,
// with log2(e) folded into exp2, and the quad merges once at the end: no
// shared-memory merge.  The target logit is looked for only in the tile
// that holds it (one compare per row and tile); a target outside [0, V)
// picks nothing (ce = lse).  Columns at or past V (a ragged last tile: V
// is a multiple of 64, not always of 128) come in as zeros from TMA and
// are masked; rows at or past n are never written.

#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;    // x rows a block: two consumer warpgroups
constexpr int kCols = 128;    // vocab columns a tile
constexpr int kChunk = 64;    // D columns a chunk: one 128-byte row
constexpr int kStages = 6;    // w ring
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr uint32_t kChunkBytes = kRows * kChunk * 2;  // 16384, x or w
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, bytes from a 1024-byte-aligned base: the x chunks, the
// ring, then the barriers
template <int D>
struct Layout {
  static constexpr int kChunks = D / kChunk;
  static constexpr uint32_t kRing = kChunks * kChunkBytes;
  static constexpr uint32_t kBarOffset = kRing + kStages * kChunkBytes;
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  // chunks on the tensor cores while the previous tile's epilogue runs
  // (2 beat 3 and 4 on the H100: PERF.md §6)
  static constexpr int kInFlight = 2;
  static_assert(kInFlight < kStages, "the producer must run ahead");
};

struct Barriers {
  uint32_t full, empty, x;
  __device__ uint32_t full_at(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_at(int s) const { return empty + 8 * s; }
};

// per row (this thread's two): running max and sum of exp over the
// thread's columns, the target logit once found, the target's column
struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float t[2] = {0.f, 0.f};
  int tgt[2];
};

// fold tile `tile`'s logits into the running statistics; reads the
// accumulator only (an instruction that wrote it while the other
// accumulator's products run would make ptxas serialise the wgmma).
// kRagged: the last tile, whose columns at or past V are masked
template <bool kRagged>
__device__ __forceinline__ void fold_tile(const float (&acc)[64],
                                          RowStats& st, int tile, int V) {
  const int lt = threadIdx.x & 3;
  const int col0 = tile * kCols;
  const int n_valid = V - col0 - 2 * lt;
  auto valid = [&](int j, int e) { return !kRagged || 8 * j + e < n_valid; };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = st.m[h];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mx = fmaxf(mx, valid(j, e) ? acc[4 * j + 2 * h + e] : -INFINITY);
    const int tc = st.tgt[h] - col0;
    if (static_cast<unsigned>(tc) < static_cast<unsigned>(kCols)) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * lt + e == tc) st.t[h] = acc[4 * j + 2 * h + e];
    }
    // every thread holds columns below V in every tile: mx is finite
    const float mx2 = mx * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sum += valid(j, e)
                   ? exp2_approx(fmaf(acc[4 * j + 2 * h + e], kLog2e, -mx2))
                   : 0.f;
    st.l[h] = st.l[h] * exp2_approx(st.m[h] * kLog2e - mx2) + sum;
    st.m[h] = mx;
  }
}

__device__ __forceinline__ void epilogue(const float (&acc)[64], RowStats& st,
                                         int tile, int V) {
  if ((tile + 1) * kCols > V)
    fold_tile<true>(acc, st, tile, V);
  else
    fold_tile<false>(acc, st, tile, V);
}

// One vocab tile of a consumer warpgroup: issues tile t's chunks into
// `cur`, releasing each chunk's slot once kInFlight later chunks are
// issued; once tile t - 1's chunks are done, folds `prev` (tile t - 1)
// while tile t's first kInFlight chunks are on the tensor cores
template <int D>
__device__ __forceinline__ void tile_step(int t, float (&cur)[64],
                                          float (&prev)[64], RowStats& st,
                                          const Barriers& bars, uint32_t base,
                                          uint32_t s_x, int V) {
  using L = Layout<D>;
  constexpr int C = L::kChunks;
  constexpr int kL = L::kInFlight;
#pragma unroll
  for (int kc = 0; kc < C; ++kc) {
    const int g = t * C + kc;
    const int s = g % kStages;
    mbar_wait(bars.full_at(s), (g / kStages) & 1);
    const uint32_t slot = base + L::kRing + s * kChunkBytes;
    // the x chunk's address, opaque to the compiler: its descriptors are
    // made here, not hoisted out of the tile loop into 2 registers each
    uint32_t x_chunk = s_x + kc * kChunkBytes;
    fence_operand(x_chunk);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k)
      wgmma_m64n128k16_ss<0>(cur, desc_kmajor(x_chunk, k),
                             desc_kmajor(slot, k), kc | k);
    wgmma_commit();
    if (g >= kL) {
      wgmma_wait<kL>();
      mbar_arrive(bars.empty_at((g - kL) % kStages));
    }
    if (kc == kL - 1 && t > 0) {  // tile t - 1 is done
      fence_operands(prev);
      epilogue(prev, st, t - 1, V);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const int* __restrict__ targets,
                        float* __restrict__ ce_out,
                        float* __restrict__ lse_out, int n, int V) {
  using L = Layout<D>;
  constexpr int C = L::kChunks;
  constexpr int kL = L::kInFlight;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int row0 = blockIdx.x * kRows;
  const int n_tiles = (V + kCols - 1) / kCols;
  const int n_chunks = n_tiles * C;
  const Barriers bars{base + L::kBarOffset, base + L::kBarOffset + 8 * kStages,
                      base + L::kBarOffset + 16 * kStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full_at(s), 1);
      mbar_init(bars.empty_at(s), kConsumerThreads);
    }
    mbar_init(bars.x, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x != 2 * 128) return;  // one producer thread
    mbar_arrive_expect_tx(bars.x, C * kChunkBytes);
    for (int kc = 0; kc < C; ++kc)
      tma_load_2d(base + kc * kChunkBytes, &tm_x, bars.x, kc * kChunk, row0);
    for (int g = 0; g < n_chunks; ++g) {
      const int s = g % kStages;
      mbar_wait(bars.empty_at(s), ((g / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(bars.full_at(s), kChunkBytes);
      tma_load_2d(base + L::kRing + s * kChunkBytes, &tm_w, bars.full_at(s),
                  (g % C) * kChunk, (g / C) * kCols);
    }
    return;
  }

  reg_alloc<240>();
  const int lane = threadIdx.x & 31;
  // this thread's first row within the warpgroup's 64 (and +8)
  const int row = row0 + wg * 64 + 16 * ((threadIdx.x & 127) >> 5) +
                  (lane >> 2);
  RowStats st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const int tg = r < n ? targets[r] : -1;
    st.tgt[h] = (tg >= 0 && tg < V) ? tg : -1;  // outside [0, V): no pick
  }
  const uint32_t s_x = base + wg * (kChunkBytes / 2);
  float acc0[64], acc1[64];
  mbar_wait(bars.x, 0);

  for (int t = 0; t < n_tiles; t += 2) {
    tile_step<D>(t, acc0, acc1, st, bars, base, s_x, V);
    if (t + 1 < n_tiles) tile_step<D>(t + 1, acc1, acc0, st, bars, base, s_x, V);
  }
  wgmma_wait<0>();
  for (int g = max(n_chunks - kL, 0); g < n_chunks; ++g)
    mbar_arrive(bars.empty_at(g % kStages));
  if ((n_tiles - 1) & 1) {
    fence_operands(acc1);
    epilogue(acc1, st, n_tiles - 1, V);
  } else {
    fence_operands(acc0);
    epilogue(acc0, st, n_tiles - 1, V);
  }

  // merge the quad's four column sets of each row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, st.m[h], off);
      const float ol = __shfl_xor_sync(0xffffffffu, st.l[h], off);
      const float ot = __shfl_xor_sync(0xffffffffu, st.t[h], off);
      const float nm = fmaxf(st.m[h], om);
      st.l[h] = st.l[h] * exp2_approx((st.m[h] - nm) * kLog2e) +
                ol * exp2_approx((om - nm) * kLog2e);
      st.m[h] = nm;
      st.t[h] += ot;
    }
    const int r = row + 8 * h;
    if ((lane & 3) == 0 && r < n) {
      const float lse = st.m[h] + logf(st.l[h]);
      lse_out[r] = lse;
      ce_out[r] = lse - st.t[h];
    }
  }
}

template <int D>
int launch(const void* x, int64_t x_stride, const void* w, int64_t w_stride,
           const int* targets, float* ce, float* lse, int n, int V,
           int grid_x, int smem_bytes, void* stream) {
  static bool smem_set[64] = {};
  auto kernel = fused_ce_fwd_kernel<D>;
  if (grid_x != (n + kRows - 1) / kRows || smem_bytes != Layout<D>::kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w;
  if (int err = encode_matrix_map(&tm_x, x, n, D, x_stride, kRows))
    return err < 0 ? -1 : -1000 - err;
  if (int err = encode_matrix_map(&tm_w, w, V, D, w_stride, kCols))
    return err < 0 ? -1 : -1000 - err;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  kernel<<<grid_x, kThreads, smem_bytes,
           reinterpret_cast<cudaStream_t>(stream)>>>(tm_x, tm_w, targets, ce,
                                                     lse, n, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns 0 on success, a CUDA error (cudaGetLastError() after the
// launch; cudaErrorInvalidValue for a D other than 128, 256, 384 or 512),
// or a negative code when a tensor map could not be encoded (-1: the
// driver lacks cuTensorMapEncodeTiled; -1000 - r: it returned CUresult r).
// x is [n, D] and w = head^T is [V, D], both bf16 with D contiguous, row
// strides x_stride / w_stride in bytes (multiples of 16), 16-byte aligned;
// V is a multiple of 64.  targets are int32, ce and lse f32, all [n] and
// contiguous.  `grid_x` and `smem_bytes` are the caller's launch geometry
// (ops/fused_ce.py: ce_fwd_launch_geometry); a mismatch with the kernel's
// is refused with cudaErrorInvalidValue before any launch.
extern "C" int lah_fused_ce_fwd_bf16(const void* x, int64_t x_stride,
                                     const void* w, int64_t w_stride,
                                     const int* targets, float* ce,
                                     float* lse, int n, int V, int D,
                                     int grid_x, int smem_bytes,
                                     void* stream) {
  switch (D) {
#define LAH_FUSED_CE_FWD_CASE(DD)                                            \
  case DD:                                                                   \
    return launch<DD>(x, x_stride, w, w_stride, targets, ce, lse, n, V,      \
                      grid_x, smem_bytes, stream);
    LAH_FUSED_CE_FWD_CASE(128)
    LAH_FUSED_CE_FWD_CASE(256)
    LAH_FUSED_CE_FWD_CASE(384)
    LAH_FUSED_CE_FWD_CASE(512)
#undef LAH_FUSED_CE_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
