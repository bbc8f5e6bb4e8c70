// Causal flash-attention backward for Hopper (sm_90a), bf16 in, bf16 out:
// two kernels, dK/dV and dQ, each deterministic (no atomics).
//
// Replaces: the backward of the library Pallas TPU kernel that
// learning_at_home_tpu/models/trunk.py:64-85 selects, in the installed
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv (kernel _flash_attention_dkv_kernel) and
// _flash_attention_bwd_dq (kernel _flash_attention_dq_kernel).  Both
// recompute the probabilities from q, k and the forward's row statistics
// instead of reading the [B,H,S,S] scores, as the library does:
//   p  = exp(q k^T * scale - lse)        (masked above the diagonal)
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - di) * scale
//   dk = ds^T q,  dq = ds k
// with lse the forward's row log-sum-exp (flash_attn_fwd.cu) and
// di = rowsum(o * do), both f32 [B, H, S].  As in the library, p and ds
// are rounded to bf16 before the products that consume them, and every
// product accumulates in f32; `scale` multiplies the logits and ds, not q.
//
// What bounds them on the H100: the dkv kernel does 4 products over the
// causal pairs (2*B*H*hd*S*(S+1)/2 operations each), the dq kernel 3, on
// 4 bf16 [B,S,H,64] inputs -- ~1000 operations per byte at [4, 8192, 8,
// 64], far above the card's ~295, so tensor-core throughput bounds them.
// The split costs two recomputed products (S and dP in both kernels) and
// buys determinism without atomics or a [B,H,S,S] buffer.  The design
// keeps every product on the tensor cores (mma.sync m16n8k16, f32
// accumulators), keeps P and dS in registers between the products that
// make and consume them, skips every tile above the causal diagonal and
// starts the heaviest blocks first.  wgmma, TMA and warp specialisation
// are left for a later change.
//
// dkv: one block of 4 warps owns 64 keys of one (batch, head); each warp
// owns 16 keys and holds its K and V rows as A fragments and its dK and
// dV rows as f32 accumulators (32 floats each a thread).  The block loops
// over the query tiles on and below the diagonal, Q, dO, lse and di tiles
// double-buffered with cp.async.  It computes the *transposed* scores
// S^T = K Q^T, so each warp's accumulator rows are keys: P^T and dS^T then
// sit in registers in the A layout of dV += P^T dO and dK += dS^T Q (the
// same register reuse as the forward's P V), and lse and di are read per
// column from shared memory.  The other choice, staging P and dS through
// shared memory and reading them back with ldmatrix.trans, would cost two
// [64, 64] smem round trips a tile and a barrier between them.
//
// dq: one block owns 64 query rows; each warp holds its Q and dO rows as A
// fragments and its dQ rows as f32 accumulators, and loops over the K/V
// tiles up to the diagonal (double-buffered), recomputing S, P, dP and dS.
//
// Both stage the tile the block owns through the second buffers of the
// streamed tiles, so shared memory stays at 37 KB of static storage.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

// lse and di of query rows [row0, row0 + 64) into smem; rows at or past S
// read as zero (their probabilities are masked)
__device__ __forceinline__ void load_stats(float* s_lse, float* s_di,
                                           const float* lse, const float* di,
                                           int row0, int S, int tid) {
  const int r = tid & (kTile - 1);
  const int row = row0 + r;
  const bool valid = row < S;
  const float* src = (tid < kTile ? lse : di) + (valid ? row : 0);
  cp_async4((tid < kTile ? s_lse : s_di) + r, src, valid);
}

__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int S,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh,
                              int64_t v_sb, int64_t v_ss, int64_t v_sh,
                              int64_t do_sb, int64_t do_ss, int64_t do_sh,
                              int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                              int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                              float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sO[2][kTile * kStride];  // dO
  __shared__ __align__(16) float sL[2][kTile];
  __shared__ __align__(16) float sD[2][kTile];

  // key tile 0 is attended by every query tile: start it first
  const int k_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = k_tile * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const int64_t stats = (static_cast<int64_t>(b) * gridDim.y + h) * S;
  const float* lse_b = lse + stats;
  const float* di_b = di + stats;
  const int n_q_tiles = (S + kTile - 1) / kTile;

  // K and V through the second buffers, the diagonal query tile into the
  // first
  load_tile(sQ[1], k + b * k_sb + h * k_sh, k_ss, k0, S, tid);
  load_tile(sO[1], v + b * v_sb + h * v_sh, v_ss, k0, S, tid);
  load_tile(sQ[0], qb, q_ss, k0, S, tid);
  load_tile(sO[0], dob, do_ss, k0, S, tid);
  load_stats(sL[0], sD[0], lse_b, di_b, k0, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a_rows(kf, sQ[1], warp, lane);
  load_a_rows(vf, sO[1], warp, lane);
  __syncthreads();  // the second buffers are refilled below

  float dk_acc[kHeadDim / 8][4], dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // this thread's two keys

  for (int j = k_tile; j < n_q_tiles; ++j) {
    const int buf = (j - k_tile) & 1;
    if (j + 1 < n_q_tiles) {
      const int r1 = (j + 1) * kTile;
      load_tile(sQ[buf ^ 1], qb, q_ss, r1, S, tid);
      load_tile(sO[buf ^ 1], dob, do_ss, r1, S, tid);
      load_stats(sL[buf ^ 1], sD[buf ^ 1], lse_b, di_b, r1, S, tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile j has landed
    __syncthreads();

    // P^T = exp(K Q^T * scale - lse): rows are keys, columns queries
    float p[kTile / 8][4];
    product_abt(p, kf, sQ[buf], lane);
    const int q0 = j * kTile;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t + (e & 1);
        const int query = q0 + col;
        const int key = key_a + (e >> 1) * 8;
        p[nb][e] = (key > query || query >= S)
                       ? 0.f
                       : __expf(p[nb][e] * scale - sL[buf][col]);
      }
    }
    // dV += P^T dO
    product_ab(dv_acc, p, sO[buf], lane);

    // dP^T = V dO^T, then dS^T = P^T (dP^T - di) * scale in place of P^T
    float dp[kTile / 8][4];
    product_abt(dp, vf, sO[buf], lane);
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nb][e] *= (dp[nb][e] - sD[buf][nb * 8 + 2 * t + (e & 1)]) * scale;
    // dK += dS^T Q
    product_ab(dk_acc, p, sQ[buf], lane);
    __syncthreads();  // buffer buf is refilled at iteration j + 1
  }

  store_rows(dk + b * dk_sb + h * dk_sh, dk_ss, dk_acc, key_a, S, lane);
  store_rows(dv + b * dv_sb + h * dv_sh, dv_ss, dv_acc, key_a, S, lane);
}

__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dq, int S,
                             int64_t q_sb, int64_t q_ss, int64_t q_sh,
                             int64_t k_sb, int64_t k_ss, int64_t k_sh,
                             int64_t v_sb, int64_t v_ss, int64_t v_sh,
                             int64_t do_sb, int64_t do_ss, int64_t do_sh,
                             int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                             float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kTile * kStride];

  // the last query tiles see the most keys: start them first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int kv_end = min(q0 + kTile, S);
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  // Q and dO through the second buffers, K/V tile 0 into the first
  load_tile(sK[1], q + b * q_sb + h * q_sh, q_ss, q0, S, tid);
  load_tile(sV[1], dout + b * do_sb + h * do_sh, do_ss, q0, S, tid);
  load_tile(sK[0], kb, k_ss, 0, S, tid);
  load_tile(sV[0], vb, v_ss, 0, S, tid);
  cp_async_commit();

  // this thread's two query rows and their statistics
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int64_t stats = (static_cast<int64_t>(b) * gridDim.y + h) * S;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse_r[r] = row < S ? lse[stats + row] : 0.f;
    di_r[r] = row < S ? di[stats + row] : 0.f;
  }

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kHeadDim / 16][4], dof[kHeadDim / 16][4];
  load_a_rows(qf, sK[1], warp, lane);
  load_a_rows(dof, sV[1], warp, lane);
  __syncthreads();  // the second buffers are refilled below

  float dq_acc[kHeadDim / 8][4];
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], kb, k_ss, (j + 1) * kTile, S, tid);
      load_tile(sV[buf ^ 1], vb, v_ss, (j + 1) * kTile, S, tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile j has landed
    __syncthreads();

    // P = exp(Q K^T * scale - lse)
    float p[kTile / 8][4];
    product_abt(p, qf, sK[buf], lane);
    const int key0 = j * kTile;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nb * 8 + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        p[nb][e] = (key > row || key >= S)
                       ? 0.f
                       : __expf(p[nb][e] * scale - lse_r[e >> 1]);
      }
    }
    // dP = dO V^T, then dS = P (dP - di) * scale in place of P
    float dp[kTile / 8][4];
    product_abt(dp, dof, sV[buf], lane);
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nb][e] *= (dp[nb][e] - di_r[e >> 1]) * scale;
    // dQ += dS K
    product_ab(dq_acc, p, sK[buf], lane);
    __syncthreads();  // buffer buf is refilled at iteration j + 1
  }

  store_rows(dq + b * dq_sb + h * dq_sh, dq_ss, dq_acc, row_a, S, lane);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() (0 on success).  Strides are in elements, in
// (batch, seq, head) order for each [B, S, H, 64] tensor; lse and di are
// contiguous f32 [B, H, S].  The caller guarantees head dim 64 with stride
// 1, other strides that are multiples of 8, and 16-byte aligned pointers.
extern "C" int lah_flash_attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int B, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb,
    int64_t do_ss, int64_t do_sh, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, float scale, void* stream) {
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dkv_kernel<<<grid, kThreads, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
      do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lah_flash_attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int B, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb,
    int64_t do_ss, int64_t do_sh, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    float scale, void* stream) {
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dq_kernel<<<grid, kThreads, 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dq), S, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
