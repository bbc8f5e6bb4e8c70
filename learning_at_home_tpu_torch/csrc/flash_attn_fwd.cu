// Causal flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces: learning_at_home_tpu/models/trunk.py:64-85,
// attention_core(impl="flash"), which calls the Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (causal=True,
// sm_scale=1/sqrt(hd), pallas_call :758 of the installed module).  Like
// that kernel, it never writes the [B,H,S,S] scores to device memory: each
// block streams K/V tiles through shared memory and keeps an online
// softmax in registers.
//
// What bounds it on the H100: the causal work is 4*B*H*hd*S*(S+1)/2
// operations against 4*B*S*H*hd*2 bytes of q, k, v and o, so at the
// serving prefill (B=2, H=8, S=4096, hd=64) it needs ~1000 operations per
// byte, far above the card's ~295: tensor-core throughput bounds it.
//
// Design.  A block of kConsumers + 1 warpgroups owns 64 * kConsumers
// query rows of one (batch, head), the heaviest blocks first.  The first
// kConsumers warpgroups are consumers, 64 query rows each; one thread of
// the last is the producer (setmaxnreg moves the producer's registers to
// the consumers).  The producer loads the block's Q once by TMA
// (128-byte-swizzled [64, 64] tiles) and streams K/V tiles of kKeys keys
// through a ring of kStages slots under full/empty mbarriers; the
// consumers share each tile.  Per tile, a consumer computes S = Q Kᵀ with
// wgmma (both operands K-major from shared memory), folds S into its
// online softmax in registers (exp2, with log2(e) folded into the scale:
// one FFMA and one exp2 a score), rounds P = exp2(S - m) to bf16 straight
// from the accumulator into the A operand of O += P V (V read MN-major),
// and releases the slot once both products are done.  Only a tile that
// crosses the diagonal is masked (a separate instantiation of the softmax
// step, so the others carry no mask test); keys past S come in as zeros
// from TMA and, for every row < S, lie above the diagonal of the last
// tile, so the causal mask covers them; rows at or past S are never
// written.
//
// At head dim 64 a score costs about as much on the SM's exp2 units and
// FP32 pipes (an exp2 at 16 a cycle, a few FP32 operations at 128) as on
// the tensor cores, so the softmax step's instruction count matters as
// much as the products: the mask-free steps off the diagonal and the
// scale folded into the exp2's FFMA took 24 % off the 8k shape.  128-key
// tiles beat 64-key ones.  Measured on the H100 and not kept (PERF.md
// §6): issuing the next tile's S before this tile's softmax (slower;
// with more consumers ptxas serialised the wgmma), ping-ponging the two
// consumers on named barriers, skipping the rescale of O when no row max
// moved, three consumer warpgroups (5 % faster at seq 8192, slower at
// 4096, and ptxas spilled at their 160 registers), and a quarter or half
// of the exp2s from a polynomial on the FP32 pipes (4 % and 16 % slower:
// those pipes, not the exp2 unit, are the busier).
//
// Rounding points are those of the mma.sync kernel this replaces: P is
// rounded to bf16 before the product, the row sums l take the f32 P,
// accumulators are f32, o is rounded once at the end.
//
// For the backward (flash_attn_bwd.cu) it also writes, when given a
// pointer, the row log-sum-exp lse = m + log(l) of the scaled logits in
// natural log, f32 [B, H, S]: one statistic for the library's row max m
// and sum l.  A null pointer writes nothing (serving).

#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;     // rows of every TMA box
constexpr int kConsumers = 2; // consumer warpgroups, 64 query rows each
constexpr int kRows = 128;    // query rows a block
constexpr int kKeys = 128;    // keys a streamed K/V tile
constexpr int kStages = 4;    // K/V ring
constexpr int kThreads = 384;     // the consumers and a producer warpgroup
constexpr int kConsumerThreads = 128 * kConsumers;
// registers a consumer and a producer thread (setmaxnreg)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr uint32_t kBoxBytes = kTile * kHeadDim * 2;  // 8192
constexpr uint32_t kKeyTileBytes = kKeys * kHeadDim * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory, bytes from a 1024-byte-aligned base: Q (a box per
// consumer), the ring (a K tile then a V tile a stage), then the barriers
constexpr uint32_t kQ = 0;
constexpr uint32_t kRing = kConsumers * kBoxBytes;
constexpr uint32_t kStageBytes = 2 * kKeyTileBytes;
constexpr uint32_t kBarOffset = kRing + kStages * kStageBytes;
constexpr uint32_t kBarriers = (2 * kStages + 1) * 8;
constexpr uint32_t kAlignSlack = 1024;
constexpr int kSmemBytes = kBarOffset + kBarriers + kAlignSlack;

static_assert(kKeys == 128, "S = Q K^T is one m64n128 product a tile");
static_assert(kRows == 64 * kConsumers && kThreads == 128 * (kConsumers + 1),
              "a consumer warpgroup a 64-row box, and one producer");
static_assert(kConsumerRegs * kConsumerThreads + kProducerRegs * 128 <= 65536,
              "the register file");

constexpr int kSAcc = kKeys / 2;    // S accumulator floats a thread
constexpr int kPSteps = kKeys / 16; // K steps of O += P V

// S[64 x kKeys] = Q Kᵀ: the warpgroup's 64 query rows (K-major) times a
// key tile read K-major, over the head dim
__device__ __forceinline__ void product_qk(float (&s)[kSAcc], uint32_t q,
                                           uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_m64n128k16_ss<0>(s, desc_kmajor(q, kk), desc_kmajor(k, kk), kk);
}

// O[64 x 64] += P V: P as A fragments in registers, the V tile read
// MN-major (its rows, the keys, are the product's K)
__device__ __forceinline__ void product_pv(float (&o)[32],
                                           const uint32_t (&p)[kPSteps][4],
                                           uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk)
    wgmma_m64n64k16_rs<1>(o, p[kk], desc_mnmajor(v, kk));
}

struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};  // row max of the log2-scaled logits
  float l[2] = {0.f, 0.f};  // row sums over this thread's columns
};

// One tile's online-softmax step.  Takes the row max of S over the quad
// that shares each row (keys above the diagonal masked when kMask; `rel`:
// the thread's first row minus the tile's first key), moves it into the
// log2 domain (the scale is positive), turns s into P = exp2(s * scale *
// log2(e) - m) with one FFMA and one exp2 a score, and adds P to the row
// sums.  Returns in `alpha` the factor the row's O must be rescaled by.
template <bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[kSAcc], Softmax& sm,
                                             float (&alpha)[2],
                                             float scale_log2, int rel) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // column 8 j + 2 t + e holds a key above the row's diagonal
    const int lim = rel + 8 * h - 2 * t;
    auto masked = [&](int j, int e) { return kMask && 8 * j + e > lim; };
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mx = fmaxf(mx, masked(j, e) ? -INFINITY : s[4 * j + 2 * h + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every row sees key 0 in its first tile and its own key on its
    // diagonal, so the max is finite from the first tile on
    const float m = fmaxf(sm.m[h], mx * scale_log2);
    alpha[h] = exp2_approx(sm.m[h] - m);
    sm.m[h] = m;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * h + e];
        v = masked(j, e) ? 0.f : exp2_approx(fmaf(v, scale_log2, -m));
        sum += v;
      }
    sm.l[h] = sm.l[h] * alpha[h] + sum;
  }
}

__device__ __forceinline__ void rescale(float (&o)[32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
}

struct Barriers {
  uint32_t full, empty, q;
  __device__ uint32_t full_at(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_at(int s) const { return empty + 8 * s; }
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int64_t o_sb,
                          int64_t o_ss, int64_t o_sh, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  // the last query blocks see the most keys: start them first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // key tiles up to the block's diagonal, and no further than S
  const int n_iter = min(((qb + 1) * kRows + kKeys - 1) / kKeys,
                         (S + kKeys - 1) / kKeys);
  const Barriers bars{base + kBarOffset, base + kBarOffset + 8 * kStages,
                      base + kBarOffset + 16 * kStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full_at(s), 1);
      mbar_init(bars.empty_at(s), kConsumerThreads);
    }
    mbar_init(bars.q, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;  // one producer thread
    mbar_arrive_expect_tx(bars.q, kConsumers * kBoxBytes);
    for (int i = 0; i < kConsumers; ++i)
      tma_load_rows(base + kQ + i * kBoxBytes, &tm_q, bars.q,
                    qb * kRows + i * kTile, h, b);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      mbar_wait(bars.empty_at(s), ((it / kStages) & 1) ^ 1);
      const uint32_t slot = base + kRing + s * kStageBytes;
      mbar_arrive_expect_tx(bars.full_at(s), kStageBytes);
      for (int i = 0; i < kKeys / kTile; ++i) {
        const int row = it * kKeys + i * kTile;
        tma_load_rows(slot + i * kBoxBytes, &tm_k, bars.full_at(s), row, h,
                      b);
        tma_load_rows(slot + kKeyTileBytes + i * kBoxBytes, &tm_v,
                      bars.full_at(s), row, h, b);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31;
  // this thread's first query row within the warpgroup's 64 (and +8)
  const int row = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int q0 = qb * kRows + wg * kTile;  // the warpgroup's first row
  // key tiles this warpgroup computes: up to the one holding its last row
  const int n_own = min((q0 + kTile - 1) / kKeys + 1, n_iter);
  const uint32_t s_q = base + kQ + wg * kBoxBytes;
  const float scale_log2 = scale * kLog2e;

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  Softmax sm;
  float alpha[2];
  float s[kSAcc];
  uint32_t pa[kPSteps][4];
  mbar_wait(bars.q, 0);

  for (int j = 0; j < n_iter; ++j) {
    const int stage = j % kStages;
    mbar_wait(bars.full_at(stage), (j / kStages) & 1);
    if (j < n_own) {  // tiles past the warpgroup's diagonal: all masked
      const uint32_t slot = base + kRing + stage * kStageBytes;
      // Q's address, opaque to the compiler: its descriptors are made
      // here, not hoisted out of the loop into 2 registers each
      uint32_t q = s_q;
      fence_operand(q);
      wgmma_fence();
      product_qk(s, q, slot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      // the tile holding the warpgroup's diagonal is its last
      if (j == n_own - 1)
        softmax_step<true>(s, sm, alpha, scale_log2, q0 + row - j * kKeys);
      else
        softmax_step<false>(s, sm, alpha, scale_log2, 0);
      rescale(o_acc, alpha);
      pack_a(pa, s);
      wgmma_fence();
      product_pv(o_acc, pa, slot + kKeyTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o_acc);
      fence_operands(pa);
    }
    mbar_arrive(bars.empty_at(stage));
  }

  const int64_t stats = (static_cast<int64_t>(b) * gridDim.y + h) * S;
  __nv_bfloat16* out = o + b * o_sb + h * o_sh;
  const int t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = sm.l[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + row + 8 * hh;
    if (r >= S) continue;
    const float inv = 1.f / l;
    if (lse != nullptr && t == 0) lse[stats + r] = sm.m[hh] * kLn2 + logf(l);
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + r * o_ss + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * hh] * inv,
                                o_acc[4 * j + 2 * hh + 1] * inv);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns 0 on success, a CUDA error (cudaGetLastError() after the
// launch), or a negative code when a tensor map could not be encoded (-1:
// the driver lacks cuTensorMapEncodeTiled; -1000 - r: it returned
// CUresult r).  q, k and v are bf16 [B, S, H, 64] with head dim stride 1
// and 16-byte aligned; `in_strides` holds their byte strides of (seq,
// head, batch), 3 per tensor in the order q, k, v, each a multiple of 16.
// o takes element strides (batch, seq, head); lse, when not null, is
// contiguous f32 [B, H, S].  `grid_x` and `smem_bytes` are the caller's
// launch geometry (ops/flash_attention.py: fwd_launch_geometry); a
// mismatch with the kernel's is refused with cudaErrorInvalidValue before
// any launch.
extern "C" int lah_flash_attn_fwd_bf16(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int S, int H,
                                       const int64_t* in_strides, int64_t o_sb,
                                       int64_t o_ss, int64_t o_sh, int grid_x,
                                       int smem_bytes, float scale,
                                       void* stream) {
  static bool smem_set[64] = {};
  if (grid_x != (S + kRows - 1) / kRows || smem_bytes != kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* const ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int64_t* st = in_strides + 3 * i;
    if (int err = encode_rows_map(&maps[i], ptrs[i], S, H, B, st[0], st[1],
                                  st[2]))
      return err < 0 ? -1 : -1000 - err;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_attn_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  flash_attn_fwd_kernel<<<dim3(grid_x, H, B), kThreads, smem_bytes,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, o_sb, o_ss, o_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
