// Causal flash-attention backward for Hopper (sm_90a), bf16 in, bf16 out:
// two kernels, dK/dV and dQ, each deterministic (no atomics, each output
// element written once).
//
// Replaces: the backward of the library Pallas TPU kernel that
// learning_at_home_tpu/models/trunk.py:64-85 selects, in the installed
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv :941 (kernel _flash_attention_dkv_kernel) and
// _flash_attention_bwd_dq :1287 (kernel _flash_attention_dq_kernel).  Both
// recompute the probabilities from q, k and the forward's row statistics
// instead of reading the [B,H,S,S] scores, as the library does:
//   p  = exp(q k^T * scale - lse)        (masked above the diagonal)
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - di) * scale
//   dk = ds^T q,  dq = ds k
// with lse the forward's row log-sum-exp (flash_attn_fwd.cu) and
// di = rowsum(o * do), both f32 [B, H, S].  As in the library, p and ds
// are rounded to bf16 before the products that consume them, and every
// product accumulates in f32; `scale` multiplies the logits and ds, not q.
// exp is exp2 with log2(e) folded into the scale and into lse.
//
// What bounds them on the H100: the dkv kernel does 4 products over the
// causal pairs (2*B*H*hd*S*(S+1)/2 operations each), the dq kernel 3, on
// 4 bf16 [B,S,H,64] inputs -- ~1000 operations per byte at [4, 8192, 8,
// 64], far above the card's ~295, so tensor-core throughput bounds them.
// The split costs two recomputed products (S and dP in both kernels, 7
// against a fused design's 5) and buys determinism without atomics, an
// f32 dq buffer or a [B,H,S,S] buffer.
//
// Design (both kernels).  A block of 3 warpgroups owns 128 rows of one
// (batch, head): keys for dkv, queries for dq.  Warpgroups 0 and 1 are
// consumers, 64 owned rows each; warpgroup 2 is the producer, of which one
// warp issues TMA loads (setmaxnreg: consumers 240 registers, producer
// 24).  The owned rows' two operands (K and V, or Q and dO) are loaded once
// by TMA; the streamed [64, 64] tiles (Q and dO for dkv, K and V for dq)
// go through a 4-stage ring of 128-byte-swizzled smem slots under
// full/empty mbarriers, and both consumer warpgroups share each tile.
// Every product is wgmma m64n64k16 with f32 accumulators: the owned rows
// are the A operand from smem, P and dS are the A operand from registers
// straight out of the accumulator that made them, and the streamed tile
// is the B operand, read K-major for S and dP and MN-major (transposed)
// for the products that consume P and dS.  A tile's two independent
// products are issued together, and the exp and mask step of the first
// runs while the second is on the tensor cores.  Tiles above the diagonal
// are skipped (the warpgroup still releases the slot); only a tile that
// crosses the diagonal is masked.  Rows past S come in as zeros from TMA,
// with lse and di read as 0, so their terms vanish without a mask, and
// outputs at or past S are never written.  The heaviest blocks start first.
//
// dkv: Sᵀ = K Qᵀ → Pᵀ → dV += Pᵀ dO → dPᵀ = V dOᵀ → dSᵀ → dK += dSᵀ Q over
// the query tiles on and below the diagonal; the rows of every
// accumulator are keys, so lse and di are per column, staged by the
// producer warp beside each tile once it has issued the tile's TMA loads
// (plain loads: a row of lse is not 16-byte aligned for every S).
// dq: S = Q Kᵀ → P → dP = dO Vᵀ → dS → dQ += dS K over the key tiles up to
// the diagonal; lse and di of the thread's two rows stay in registers.
// The dQ product is not waited for at the end of its tile: the next
// tile's S and dP are issued behind it, and its slot is released once S
// is done (groups complete in order), which keeps the tensor cores fed
// across tiles.  (The same deferral made dkv slower on the H100, so dkv
// waits for its last product at the end of each tile.)

#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;     // rows of every TMA tile
constexpr int kRows = 128;    // owned rows a block: two consumer warpgroups
constexpr int kStages = 4;    // streamed-tile ring
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr uint32_t kTileBytes = kTile * kHeadDim * 2;  // 8192
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, bytes from a 1024-byte-aligned base: the owned operands
// (two 64-row tiles each), the ring (two tiles a stage), dkv's per-stage
// lse and di (64 floats each), then the barriers
constexpr uint32_t kOwnedA = 0;
constexpr uint32_t kOwnedB = 2 * kTileBytes;
constexpr uint32_t kRing = 4 * kTileBytes;
constexpr uint32_t kStageBytes = 2 * kTileBytes;
constexpr uint32_t kStats = kRing + kStages * kStageBytes;
constexpr uint32_t kStatsBytes = 2 * kTile * 4;
constexpr uint32_t kBarriers = (2 * kStages + 1) * 8;
constexpr uint32_t kAlignSlack = 1024;
constexpr int kDkvSmemBytes =
    kStats + kStages * kStatsBytes + kBarriers + kAlignSlack;
constexpr int kDqSmemBytes = kStats + kBarriers + kAlignSlack;

struct Barriers {
  uint32_t full, empty, owned;
  __device__ uint32_t full_at(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_at(int s) const { return empty + 8 * s; }
};

// the block's barriers at `at`; thread 0 initialises them, then the whole
// block synchronises once, before the roles split
__device__ __forceinline__ Barriers init_barriers(uint32_t at,
                                                  uint32_t full_count) {
  Barriers bars{at, at + 8 * kStages, at + 16 * kStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full_at(s), full_count);
      mbar_init(bars.empty_at(s), kConsumerThreads);
    }
    mbar_init(bars.owned, 1);
    fence_barrier_init();
  }
  __syncthreads();
  return bars;
}

// acc[64 x 64] = A Tᵀ: the warpgroup's 64 owned rows A (smem, K-major)
// times a streamed tile T read K-major
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a,
                                            uint32_t t) {
#pragma unroll
  for (int k = 0; k < kHeadDim / 16; ++k)
    wgmma_m64n64k16_ss<0>(acc, desc_kmajor(a, k), desc_kmajor(t, k), k);
}

// acc[64 x 64] += X T: X as A fragments in registers, the streamed tile T
// read MN-major (its rows are the product's K)
__device__ __forceinline__ void product_ab(float (&acc)[32],
                                           const uint32_t (&x)[4][4],
                                           uint32_t t) {
#pragma unroll
  for (int k = 0; k < kTile / 16; ++k)
    wgmma_m64n64k16_rs<1>(acc, x[k], desc_mnmajor(t, k));
}

// this thread's rows of a [64 x 64] f32 accumulator to bf16 rows of `out`
// (row0 = the warpgroup's first row), skipping rows at or past S
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          int64_t row_stride,
                                          const float (&acc)[32], int row0,
                                          int S) {
  const int lane = threadIdx.x & 31;
  const int row = row0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r < S)
        *reinterpret_cast<__nv_bfloat162*>(out + r * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int S,
                              int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                              int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                              float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);

  // key block 0 is attended by every query tile: start it first
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = 2 * kb;  // the first query tile: the diagonal of warpgroup 0
  const int n_iter = (S + kTile - 1) / kTile - j0;
  const Barriers bars = init_barriers(base + kStats + kStages * kStatsBytes,
                                      32);  // the producer warp's lanes
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x >= 2 * 128 + 32) return;  // one producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.owned, 4 * kTileBytes);
      for (int i = 0; i < 2; ++i) {
        tma_load_rows(base + kOwnedA + i * kTileBytes, &tm_k, bars.owned,
                      kb * kRows + i * kTile, h, b);
        tma_load_rows(base + kOwnedB + i * kTileBytes, &tm_v, bars.owned,
                      kb * kRows + i * kTile, h, b);
      }
    }
    const int64_t stats = (static_cast<int64_t>(b) * gridDim.y + h) * S;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      mbar_wait(bars.empty_at(s), ((it / kStages) & 1) ^ 1);
      const int row0 = (j0 + it) * kTile;
      if (lane == 0) {  // the tiles first: their latency covers the stats'
        const uint32_t slot = base + kRing + s * kStageBytes;
        mbar_expect_tx(bars.full_at(s), 2 * kTileBytes);
        tma_load_rows(slot, &tm_q, bars.full_at(s), row0, h, b);
        tma_load_rows(slot + kTileBytes, &tm_do, bars.full_at(s), row0, h, b);
      }
      float* s_lse = reinterpret_cast<float*>(smem + kStats + s * kStatsBytes);
      float* s_di = s_lse + kTile;
      for (int r = lane; r < kTile; r += 32) {
        const int row = row0 + r;
        const bool valid = row < S;
        s_lse[r] = valid ? lse[stats + row] * kLog2e : 0.f;
        s_di[r] = valid ? di[stats + row] : 0.f;
      }
      mbar_arrive(bars.full_at(s));  // each lane releases its own stores
    }
    return;
  }

  reg_alloc<240>();
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's first key row within the warpgroup's 64 (and +8)
  const int key = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int diag = j0 + wg;  // the query tile on this warpgroup's diagonal
  const uint32_t s_k = base + kOwnedA + wg * kTileBytes;
  const uint32_t s_v = base + kOwnedB + wg * kTileBytes;
  const float scale_log2 = scale * kLog2e;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(bars.owned, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int j = j0 + it;
    mbar_wait(bars.full_at(s), (it / kStages) & 1);
    if (j >= diag) {  // tiles before the diagonal are all masked
      const uint32_t s_q = base + kRing + s * kStageBytes;
      const uint32_t s_do = s_q + kTileBytes;
      const float* s_lse =
          reinterpret_cast<const float*>(smem + kStats + s * kStatsBytes);
      const float* s_di = s_lse + kTile;
      float p[32], dp[32];
      wgmma_fence();
      product_abt(p, s_k, s_q);  // Sᵀ = K Qᵀ: rows keys, columns queries
      wgmma_commit();
      product_abt(dp, s_v, s_do);  // dPᵀ = V dOᵀ
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(p);
      // Pᵀ = exp(Sᵀ * scale - lse), masked above the diagonal
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * c + 2 * t + (e & 1);
          const float v = exp2_approx(
              fmaf(p[4 * c + e], scale_log2, (e & 1) ? -l.y : -l.x));
          p[4 * c + e] = (j == diag && key + 8 * (e >> 1) > col) ? 0.f : v;
        }
      }
      uint32_t pa[4][4];
      pack_a(pa, p);
      wgmma_fence();
      product_ab(dv_acc, pa, s_do);  // dV += Pᵀ dO
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(dp);
      // dSᵀ = Pᵀ (dPᵀ - di) * scale
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        const float2 d = *reinterpret_cast<const float2*>(s_di + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[4 * c + e] *= (dp[4 * c + e] - ((e & 1) ? d.y : d.x)) * scale;
      }
      uint32_t dsa[4][4];
      pack_a(dsa, p);
      wgmma_fence();
      product_ab(dk_acc, dsa, s_q);  // dK += dSᵀ Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      fence_operands(pa);
      fence_operands(dsa);
    }
    mbar_arrive(bars.empty_at(s));
  }

  const int row0 = kb * kRows + wg * kTile;
  store_acc(dk + b * dk_sb + h * dk_sh, dk_ss, dk_acc, row0, S);
  store_acc(dv + b * dv_sb + h * dv_sh, dv_ss, dv_acc, row0, S);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dq, int S,
                             int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                             float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  // the last query blocks see the most keys: start them first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_iter = min(2 * qb + 2, (S + kTile - 1) / kTile);
  const Barriers bars = init_barriers(base + kStats, 1);
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x != 2 * 128) return;  // one producer thread
    mbar_arrive_expect_tx(bars.owned, 4 * kTileBytes);
    for (int i = 0; i < 2; ++i) {
      tma_load_rows(base + kOwnedA + i * kTileBytes, &tm_q, bars.owned,
                    qb * kRows + i * kTile, h, b);
      tma_load_rows(base + kOwnedB + i * kTileBytes, &tm_do, bars.owned,
                    qb * kRows + i * kTile, h, b);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      mbar_wait(bars.empty_at(s), ((it / kStages) & 1) ^ 1);
      const uint32_t slot = base + kRing + s * kStageBytes;
      mbar_arrive_expect_tx(bars.full_at(s), 2 * kTileBytes);
      tma_load_rows(slot, &tm_k, bars.full_at(s), it * kTile, h, b);
      tma_load_rows(slot + kTileBytes, &tm_v, bars.full_at(s), it * kTile, h,
                    b);
    }
    return;
  }

  reg_alloc<240>();
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's first query row within the warpgroup's 64 (and +8)
  const int row = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int diag = 2 * qb + wg;  // the key tile on this warpgroup's diagonal
  const uint32_t s_q = base + kOwnedA + wg * kTileBytes;
  const uint32_t s_do = base + kOwnedB + wg * kTileBytes;
  const float scale_log2 = scale * kLog2e;

  const int64_t stats = (static_cast<int64_t>(b) * gridDim.y + h) * S;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = qb * kRows + wg * kTile + row + 8 * half;
    lse_r[half] = r < S ? lse[stats + r] * kLog2e : 0.f;
    di_r[half] = r < S ? di[stats + r] : 0.f;
  }

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  // the A fragments of the last tile's dQ product, read by the tensor
  // cores until that product completes, and the slot it reads
  uint32_t dsa[4][4];
  int held = -1;
  mbar_wait(bars.owned, 0);

  for (int j = 0; j < n_iter; ++j) {
    const int s = j % kStages;
    mbar_wait(bars.full_at(s), (j / kStages) & 1);
    if (j > diag) {  // tiles past the diagonal are all masked
      mbar_arrive(bars.empty_at(s));
      continue;
    }
    const uint32_t s_kt = base + kRing + s * kStageBytes;
    const uint32_t s_vt = s_kt + kTileBytes;
    float p[32], dp[32];
    wgmma_fence();
    product_abt(p, s_q, s_kt);  // S = Q Kᵀ
    wgmma_commit();
    product_abt(dp, s_do, s_vt);  // dP = dO Vᵀ
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last tile's dQ before it, are done
    fence_operands(p);
    fence_operands(dq_acc);
    fence_operands(dsa);
    if (held >= 0) mbar_arrive(bars.empty_at(held));
    // P = exp(S * scale - lse), masked above the diagonal
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const float v = exp2_approx(
            fmaf(p[4 * c + e], scale_log2, -lse_r[e >> 1]));
        p[4 * c + e] = (j == diag && col > row + 8 * (e >> 1)) ? 0.f : v;
      }
    wgmma_wait<0>();
    fence_operands(dp);
    // dS = P (dP - di) * scale
#pragma unroll
    for (int i = 0; i < 32; ++i)
      p[i] *= (dp[i] - di_r[(i >> 1) & 1]) * scale;
    pack_a(dsa, p);
    wgmma_fence();
    product_ab(dq_acc, dsa, s_kt);  // dQ += dS K: waited for next tile
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  fence_operands(dq_acc);
  fence_operands(dsa);
  if (held >= 0) mbar_arrive(bars.empty_at(held));

  store_acc(dq + b * dq_sb + h * dq_sh, dq_ss, dq_acc,
            qb * kRows + wg * kTile, S);
}

// the 4 tensor maps of q, k, v and do; 0 or the encoding's error
int encode_inputs(CUtensorMap (&maps)[4], const void* const (&ptrs)[4], int B,
                  int S, int H, const int64_t* byte_strides) {
  for (int i = 0; i < 4; ++i) {
    const int64_t* st = byte_strides + 3 * i;
    int err = encode_rows_map(&maps[i], ptrs[i], S, H, B, st[0], st[1], st[2]);
    if (err) return err;
  }
  return 0;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize for `kernel`, once per
// device; 0 or the CUDA error
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

// a tensor-map failure as a negative code: -1 if the driver lacks the
// call, else -1000 - CUresult
int map_error(int err) { return err < 0 ? -1 : -1000 - err; }

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns 0 on success, a CUDA error (cudaGetLastError() after the launch),
// or a negative code when a tensor map could not be encoded (-1: the driver
// lacks cuTensorMapEncodeTiled; -1000 - r: it returned CUresult r).
// q, k, v and do are bf16 [B, S, H, 64] with head dim stride 1 and 16-byte
// aligned; `in_strides` holds their byte strides of (seq, head, batch),
// 3 per tensor in the order q, k, v, do, each a multiple of 16.  Outputs
// take element strides (batch, seq, head); lse and di are contiguous f32
// [B, H, S].  `grid_x` and `smem_bytes` are the caller's launch geometry
// (ops/flash_attention.py: bwd_launch_geometry); a mismatch with the
// kernel's is refused with cudaErrorInvalidValue before any launch.
extern "C" int lah_flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int B, int S, int H,
    const int64_t* in_strides, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, int grid_x, int smem_bytes,
    float scale, void* stream) {
  static bool smem_set[64] = {};
  if (grid_x != (S + kRows - 1) / kRows || smem_bytes != kDkvSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  if (int err = encode_inputs(maps, ptrs, B, S, H, in_strides))
    return map_error(err);
  if (int err = allow_smem(flash_attn_bwd_dkv_kernel, smem_bytes, smem_set))
    return err;
  flash_attn_bwd_dkv_kernel<<<dim3(grid_x, H, B), kThreads, smem_bytes,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,
      dv_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lah_flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int B, int S, int H,
    const int64_t* in_strides, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int grid_x, int smem_bytes, float scale, void* stream) {
  static bool smem_set[64] = {};
  if (grid_x != (S + kRows - 1) / kRows || smem_bytes != kDqSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  if (int err = encode_inputs(maps, ptrs, B, S, H, in_strides))
    return map_error(err);
  if (int err = allow_smem(flash_attn_bwd_dq_kernel, smem_bytes, smem_set))
    return err;
  flash_attn_bwd_dq_kernel<<<dim3(grid_x, H, B), kThreads, smem_bytes,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), S, dq_sb,
      dq_ss, dq_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
