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
// One template serves both kernels.  A block owns 64 "fixed" rows of one
// operand and streams 64-row tiles of the other:
//
//   K2 (dx):    fixed = x rows, streamed = vocab rows of w;
//               dx[r, :] = sum_v dl[r, v] w[v, :].
//   K3 (dhead): fixed = vocab rows of w, streamed = x rows;
//               dw[v, :] = sum_r dl[r, v] x[r, :], dw = dhead^T.
//
// with dl = (exp(S - lse) - onehot) * dce and S = x w^T recomputed per
// tile.  Each block owns its output rows and walks the streamed tiles in
// order, so every output element is written once, by one block, from a
// sum in a fixed order: deterministic, no atomics.
//
// What bounds them on the H100: at n = 45056, D = 512, V = 32768 each does
// two products of 1.51 TFLOP against ~80 MB of operands, so tensor-core
// throughput (3.06 ms at 989 TFLOP/s).  Next comes L2: every block streams
// the whole of the other operand (K2: 704 blocks x 32 MB = 22.5 GB a
// launch; K3: 512 x 46 MB = 23.6 GB), ~7 TB/s at the tensor-core bound.
//
// Design.  A block is two consumer warpgroups, 256 threads.  (With a
// third warpgroup or a ninth warp for loads, ptxas allocates within 168
// registers a thread whatever setmaxnreg asks, and at D = 512 the
// accumulators below need more: it spilled and serialised every wgmma.)
// The fixed rows stay in shared memory as D/64 128-byte-swizzled [64, 64]
// tiles, loaded once by TMA.  The streamed tiles come through a ring of
// kStages stages (2 at D = 512), each a whole [64, D] tile as D/64
// [64, 64] TMA boxes back to back, under full/empty mbarriers; warp 0
// loads them: at the top of tile i it waits until both consumers have
// released tile i - 1's stage and loads tile i - 1 + kStages into it.
// The [64, D] f32 accumulator (128 KB at D = 512) does not fit one
// warpgroup, so the two consumers split its D columns: each holds
// [64, D/2] in registers (128 floats a thread at D = 512).  Per tile:
//   1. each consumer computes S for half of the tile's 64 streamed rows,
//      S[64, 32] = fixed . streamed^T over D (wgmma m64n32k16, both
//      operands K-major from shared memory);
//   2. it turns its half into dl in f32 in place (exp2 with log2 e folded
//      into one FFMA), rounds it to bf16 and stores it into a swizzled
//      [64, 64] dl tile (two slots, alternating), and the consumers meet
//      at a named barrier;
//   3. each consumer adds dl [64, 64] times its D half of the streamed
//      tile to its accumulator (wgmma m64n(D/2)k16: A = the dl tile,
//      B = the streamed tile read MN-major, its rows being the product's
//      K), waits for it and releases the stage.
// K2's lse, dce and targets belong to the fixed rows and are stored into
// shared memory once; K3's belong to the streamed rows, and warp 0 copies
// them (cp.async, completing on the stage's full barrier) beside each
// tile.  Rows past n come in as zeros from TMA and their statistics as
// zeros, so their dl is zero (K3); outputs at or past n are never written
// (K2).  V is a multiple of 64 (no ragged vocab).
// ptxas: descriptors are made per use from addresses the compiler cannot
// hoist (hoisted, they cost two registers each); no instruction defines
// an accumulator register between two waits that enclose a wgmma (ptxas
// would serialise every wgmma of the kernel, C7515); S's accumulator is
// the tile's own and first written by an output-only wgmma (an undefined
// input is a value ptxas keeps, and spills, around the products).
//
// Numerics.  S, lse, exp and dl are f32; dl is rounded once to bf16 before
// the second product (the TPU kernel multiplies it in f32: relative error
// 2^-9 per term), which accumulates in f32; the output is rounded once to
// bf16.  So dx and dhead are held against their f32 plain versions with a
// tolerance derived from 2^-8.

#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

enum Mode { kDx, kDhead };

constexpr int kRows = 64;    // fixed rows a block
constexpr int kTile = 64;    // streamed rows a tile
constexpr int kChunk = 64;   // D columns a TMA box: one 128-byte row
constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kDlBarrier = 1;  // the consumers' named barrier
constexpr uint32_t kBoxBytes = 64 * kChunk * 2;  // 8192, a [64, 64] box
constexpr uint32_t kDlBytes = kRows * kTile * 2;  // 8192
constexpr uint32_t kStatsBytes = 3 * kTile * 4;  // lse, dce, targets
constexpr float kLog2e = 1.4426950408889634f;
// streamed-tile stages at D = 128, 256, 384, 512
constexpr int kStagesByD[4] = {4, 4, 3, 2};

// shared memory, bytes from a 1024-byte-aligned base: the fixed rows, the
// ring, two dl slots, the statistics of each stage's streamed rows (K3)
// and of the fixed rows (K2), then the barriers
template <int D>
struct Layout {
  static constexpr int kChunks = D / kChunk;
  static constexpr int kStages = kStagesByD[kChunks / 2 - 1];
  static constexpr uint32_t kTileBytes = kChunks * kBoxBytes;
  static constexpr uint32_t kRing = kTileBytes;
  static constexpr uint32_t kDl = kRing + kStages * kTileBytes;
  static constexpr uint32_t kStats = kDl + 2 * kDlBytes;
  static constexpr uint32_t kFixedStats = kStats + kStages * kStatsBytes;
  static constexpr uint32_t kBarOffset = kFixedStats + kStatsBytes;
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
};

struct Barriers {
  uint32_t full, empty, fixed;
  __device__ uint32_t full_at(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_at(int s) const { return empty + 8 * s; }
};

// one thread of each consumer warpgroup: the warpgroup reads stage s no
// more (its last product there is complete)
__device__ __forceinline__ void release(const Barriers& bars, int s) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(bars.empty_at(s));
}

// acc[64, N] (+)= A B over 16 K: the consumer's product of the dl tile
// and its N = D/2 columns of the streamed tile
template <int N>
__device__ __forceinline__ void second_product(float (&acc)[N / 2],
                                               uint64_t a, uint64_t b,
                                               int accumulate) {
  if constexpr (N == 256)
    wgmma_m64n256k16_ss<1>(acc, a, b, accumulate);
  else if constexpr (N == 192)
    wgmma_m64n192k16_ss<1>(acc, a, b, accumulate);
  else if constexpr (N == 128)
    wgmma_m64n128k16_ss<1>(acc, a, b, accumulate);
  else
    wgmma_m64n64k16_ss<1>(acc, a, b, accumulate);
}

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ce_bwd_kernel(const __grid_constant__ CUtensorMap tm_fixed,
                        const __grid_constant__ CUtensorMap tm_streamed,
                        const int* __restrict__ targets,
                        const float* __restrict__ lse,
                        const float* __restrict__ dce,
                        __nv_bfloat16* __restrict__ out, int64_t out_stride,
                        int n_fixed, int n_streamed) {
  using L = Layout<D>;
  constexpr int C = L::kChunks;
  constexpr int kHalf = D / 2;  // accumulator columns of a consumer
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);

  const int f0 = blockIdx.x * kRows;
  const int n_tiles = (n_streamed + kTile - 1) / kTile;
  const Barriers bars{base + L::kBarOffset,
                      base + L::kBarOffset + 8 * L::kStages,
                      base + L::kBarOffset + 16 * L::kStages};
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const bool loader = threadIdx.x < 32;  // warp 0 loads

  // warp 0: tile `tile` into its stage, the boxes by TMA (lane 0) and, for
  // K3, the lse, dce and targets of its rows by cp.async (rows past n
  // read as zeros); each lane's arrival on the full barrier completes
  // with its copies
  auto load = [&](int tile) {
    const int s = tile % L::kStages;
    if (lane == 0) {
      const uint32_t slot = base + L::kRing + s * L::kTileBytes;
      mbar_expect_tx(bars.full_at(s), L::kTileBytes);
      for (int kc = 0; kc < C; ++kc)
        tma_load_2d(slot + kc * kBoxBytes, &tm_streamed, bars.full_at(s),
                    kc * kChunk, tile * kTile);
    }
    if constexpr (kMode == kDhead) {
      const uint32_t st = base + L::kStats + s * kStatsBytes;
      for (int r = lane; r < kTile; r += 32) {
        const int row = tile * kTile + r;
        const bool valid = row < n_streamed;
        const int src = valid ? row : 0;
        cp_async_4(st + 4 * r, lse + src, valid);
        cp_async_4(st + 4 * (kTile + r), dce + src, valid);
        cp_async_4(st + 4 * (2 * kTile + r), targets + src, valid);
      }
      cp_async_mbar_arrive(bars.full_at(s));
    } else {
      mbar_arrive(bars.full_at(s));
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars.full_at(s), 32);  // warp 0's lanes
      mbar_init(bars.empty_at(s), 2);  // release()'s threads
    }
    mbar_init(bars.fixed, 32);
    fence_barrier_init();
  }
  __syncthreads();
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bars.fixed, L::kTileBytes);
      for (int kc = 0; kc < C; ++kc)
        tma_load_2d(base + kc * kBoxBytes, &tm_fixed, bars.fixed,
                    kc * kChunk, f0);
    }
    if constexpr (kMode == kDx) {  // the fixed rows' statistics
      float* st = reinterpret_cast<float*>(smem + L::kFixedStats);
      for (int r = lane; r < kRows; r += 32) {
        const int row = f0 + r;
        const int tg = row < n_fixed ? targets[row] : -1;
        st[r] = row < n_fixed ? lse[row] * kLog2e : 0.f;
        st[kRows + r] = row < n_fixed ? dce[row] : 0.f;
        // a target outside [0, V) adds no one-hot term
        reinterpret_cast<int*>(st)[2 * kRows + r] =
            (tg >= 0 && tg < n_streamed) ? tg : -1;
      }
    }
    mbar_arrive(bars.fixed);
    for (int tile = 0; tile < min(L::kStages, n_tiles); ++tile) load(tile);
  }
  __syncwarp();

  const int t = lane & 3;
  // this thread's first fixed row within the block's 64 (and +8)
  const int row = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  // acc [64, D/2] is written by the wgmma only (the first product does
  // not accumulate): an instruction defining an accumulator register
  // between two wgmma waits that enclose a wgmma makes ptxas serialise
  // every wgmma of the kernel (C7515)
  float acc[kHalf / 2];
  mbar_wait(bars.fixed, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    if (loader && j > 0 && j - 1 + L::kStages < n_tiles) {
      mbar_wait(bars.empty_at((j - 1) % L::kStages),
                ((j - 1) / L::kStages) & 1);
      load(j - 1 + L::kStages);
    }
    __syncwarp();
    mbar_wait(bars.full_at(s), (j / L::kStages) & 1);
    const uint32_t slot = base + L::kRing + s * L::kTileBytes;

    // 1. S[64, 32] of this consumer's 32 streamed rows.  Each box's
    // addresses are opaque to the compiler, so its descriptors are made
    // here, per use, and not all hoisted ahead of the products.  sc is
    // the tile's own (an array carried from tile to tile would be kept,
    // and spilled, around the products), first written by the first
    // product
    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < C; ++kc) {
      uint32_t a = base + kc * kBoxBytes;
      uint32_t b = slot + kc * kBoxBytes + wg * 32 * 128;
      fence_operand(a);
      fence_operand(b);
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        if (kc == 0 && k == 0)
          wgmma_m64n32k16_ss_first<0>(sc, desc_kmajor(a, k),
                                      desc_kmajor(b, k));
        else
          wgmma_m64n32k16_ss<0>(sc, desc_kmajor(a, k), desc_kmajor(b, k), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // 2. dl of these 32 columns in f32, in place of S, then in bf16 into
    // the dl tile [64 fixed, 64 streamed] (row r at r * 128 bytes, 16-byte
    // chunk c at c ^ (r % 8)).  K2's row statistics are read here, per
    // tile, to keep them out of the registers the products hold
    const uint32_t dl = base + L::kDl + (j & 1) * kDlBytes;
    const uint32_t st = base + L::kStats + s * kStatsBytes;
    // the thread's row and column pair, opaque to the compiler: the
    // store offsets and indices made from them are made here, not held
    // in registers through the products
    uint32_t me = (row << 2) | t;
    fence_operand(me);
    const int row = me >> 2, t = me & 3;
    float lse2[2] = {0.f, 0.f}, dce_r[2] = {0.f, 0.f};
    int tgt[2] = {-1, -1};
    if constexpr (kMode == kDx) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t at = base + L::kFixedStats + 4 * (row + 8 * h);
        lse2[h] = ld_shared_f32(at);
        dce_r[h] = ld_shared_f32(at + 4 * kRows);
        tgt[h] = __float_as_int(ld_shared_f32(at + 8 * kRows));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 32 * wg + 8 * c + 2 * t;  // in the tile, and +1
      float2 lse_c{}, dce_c{}, tgt_f{};
      if constexpr (kMode == kDhead) {  // lse times log2 e, below
        lse_c = ld_shared_f32x2(st + 4 * col);
        lse_c.x *= kLog2e;
        lse_c.y *= kLog2e;
        dce_c = ld_shared_f32x2(st + 4 * (kTile + col));
        tgt_f = ld_shared_f32x2(st + 4 * (2 * kTile + col));
      }
      const int2 tgt_c{__float_as_int(tgt_f.x), __float_as_int(tgt_f.y)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = sc + 4 * c + 2 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kMode == kDx) {
            const float p = exp2_approx(fmaf(d[e], kLog2e, -lse2[h]));
            const bool hit = j * kTile + col + e == tgt[h];
            d[e] = (p - (hit ? 1.f : 0.f)) * dce_r[h];
          } else {
            const float p = exp2_approx(fmaf(d[e], kLog2e, e ? -lse_c.y
                                                             : -lse_c.x));
            const bool hit = (e ? tgt_c.y : tgt_c.x) == f0 + row + 8 * h;
            d[e] = (p - (hit ? 1.f : 0.f)) * (e ? dce_c.y : dce_c.x);
          }
        }
        const int r = row + 8 * h;
        const int chunk = (col >> 3) ^ (r & 7);
        st_shared_u32(dl + r * 128 + chunk * 16 + (col & 7) * 2,
                      pack_bf16(d[0], d[1]));
      }
    }
    // nothing is in flight: this wait only closes the wgmma stage in which
    // the dl step wrote sc
    wgmma_wait<0>();
    fence_proxy_async();
    named_barrier_sync(kDlBarrier, kThreads);

    // 3. acc[64, D/2] += dl[64, 64] . streamed[64, this consumer's D/2]
    uint32_t a = dl;
    uint32_t b = slot + wg * (C / 2) * kBoxBytes;
    fence_operand(a);
    fence_operand(b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k)
      second_product<kHalf>(acc, desc_kmajor(a, k), desc_mnmajor(b, k),
                            j | k);
    wgmma_commit();
    wgmma_wait<0>();
    release(bars, s);
  }
  fence_operands(acc);

  // the thread's rows and columns, opaque to the compiler: the output
  // addresses are made here, not held in registers through the loop
  uint32_t me = threadIdx.x;
  fence_operand(me);
  const int out_row = f0 + 16 * ((me & 127) >> 5) + ((me & 31) >> 2);
  const int out_col = (me >> 7) * kHalf + 2 * (me & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = out_row + 8 * h;
    if (r >= n_fixed) continue;
    __nv_bfloat16* dst = out + r * out_stride + out_col;
#pragma unroll
    for (int jj = 0; jj < kHalf / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  }
}

// a tensor-map failure as a negative code: -1 if the CUDA driver lacks
// the call, else -1000 - CUresult
int map_error(int err) { return err < 0 ? -1 : -1000 - err; }

template <int D, int kMode>
int launch(const void* fixed, int64_t fixed_stride, int n_fixed,
           const void* streamed, int64_t streamed_stride, int n_streamed,
           const int* targets, const float* lse, const float* dce, void* out,
           int64_t out_stride, int grid_x, int smem_bytes, void* stream) {
  static bool smem_set[64] = {};
  auto kernel = fused_ce_bwd_kernel<D, kMode>;
  if (grid_x != (n_fixed + kRows - 1) / kRows ||
      smem_bytes != Layout<D>::kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_fixed, tm_streamed;
  if (int err = encode_matrix_map(&tm_fixed, fixed, n_fixed, D, fixed_stride,
                                  kRows))
    return map_error(err);
  if (int err = encode_matrix_map(&tm_streamed, streamed, n_streamed, D,
                                  streamed_stride, kTile))
    return map_error(err);
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
           reinterpret_cast<cudaStream_t>(stream)>>>(
      tm_fixed, tm_streamed, targets, lse, dce,
      static_cast<__nv_bfloat16*>(out), out_stride, n_fixed, n_streamed);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_d(int D, const void* fixed, int64_t fixed_stride, int n_fixed,
             const void* streamed, int64_t streamed_stride, int n_streamed,
             const int* targets, const float* lse, const float* dce,
             void* out, int64_t out_stride, int grid_x, int smem_bytes,
             void* stream) {
  switch (D) {
#define LAH_FUSED_CE_CASE(DD)                                                 \
  case DD:                                                                    \
    return launch<DD, kMode>(fixed, fixed_stride, n_fixed, streamed,          \
                             streamed_stride, n_streamed, targets, lse, dce,  \
                             out, out_stride, grid_x, smem_bytes, stream);
    LAH_FUSED_CE_CASE(128)
    LAH_FUSED_CE_CASE(256)
    LAH_FUSED_CE_CASE(384)
    LAH_FUSED_CE_CASE(512)
#undef LAH_FUSED_CE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns 0 on success, a CUDA error (cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a D other than 128, 256, 384 or 512), or a
// negative code when a tensor map could not be encoded (-1: the CUDA driver
// lacks cuTensorMapEncodeTiled; -1000 - r: it returned CUresult r).
// x is [n, D] and w = head^T is [V, D], both bf16 with D contiguous, row
// strides x_stride / w_stride in bytes (multiples of 16), 16-byte aligned;
// V is a multiple of 64.  targets are int32, lse and dce f32, all [n] and
// contiguous; n and V are positive.  The output's row stride is in
// elements.  `grid_x` and `smem_bytes` are the caller's launch geometry
// (ops/fused_ce.py: ce_bwd_launch_geometry); a mismatch with the kernel's
// is refused with cudaErrorInvalidValue before any launch.

// K2: dx [n, D] (bf16)
extern "C" int lah_fused_ce_dx_bf16(const void* x, int64_t x_stride,
                                    const void* w, int64_t w_stride,
                                    const int* targets, const float* lse,
                                    const float* dce, void* dx,
                                    int64_t dx_stride, int n, int V, int D,
                                    int grid_x, int smem_bytes,
                                    void* stream) {
  return launch_d<kDx>(D, x, x_stride, n, w, w_stride, V, targets, lse, dce,
                       dx, dx_stride, grid_x, smem_bytes, stream);
}

// K3: dw [V, D] = dhead^T (bf16)
extern "C" int lah_fused_ce_dhead_bf16(const void* x, int64_t x_stride,
                                       const void* w, int64_t w_stride,
                                       const int* targets, const float* lse,
                                       const float* dce, void* dw,
                                       int64_t dw_stride, int n, int V, int D,
                                       int grid_x, int smem_bytes,
                                       void* stream) {
  return launch_d<kDhead>(D, w, w_stride, V, x, x_stride, n, targets, lse,
                          dce, dw, dw_stride, grid_x, smem_bytes, stream);
}
