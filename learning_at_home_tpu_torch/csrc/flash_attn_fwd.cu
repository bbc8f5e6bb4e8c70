// Causal flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces: learning_at_home_tpu/models/trunk.py:64-85,
// attention_core(impl="flash"), which calls the Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (causal=True,
// sm_scale=1/sqrt(hd)).  Like that kernel, it never writes the
// [B,H,S,S] scores to device memory: each block streams K/V tiles
// through shared memory and keeps an online softmax in registers.
//
// What bounds it on the H100: the causal work is 4*B*H*hd*S*(S+1)/2
// operations against 4*B*S*H*hd*2 bytes of q, k, v and o, so at the
// serving prefill (B=2, H=8, S=4096, hd=64) it needs ~1000 operations per
// byte, far above the card's ~295: tensor-core throughput bounds it.
// The design keeps both products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulators), keeps P in registers
// between the two products, stops the K/V loop at the causal diagonal,
// and hands out the heaviest query tiles first.  wgmma, TMA and warp
// specialisation are left for a later change.
//
// Layout: q, k, v and o are [B, S, H, 64] with the head dim contiguous;
// the other strides are passed in elements, so no transpose is needed.
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 rows.  K/V tiles of 64 keys are double-buffered with cp.async.
//
// For the backward (flash_attn_bwd.cu) it also writes, when given a
// pointer, the row log-sum-exp lse = m + log(l) of the scaled logits,
// f32 [B, H, S]: one statistic for the library's row max m and sum l.
// A null pointer writes nothing (serving).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S,
                          int64_t q_sb, int64_t q_ss, int64_t q_sh,
                          int64_t k_sb, int64_t k_ss, int64_t k_sh,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh,
                          float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile * kStride];
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
  const int t = lane & 3;  // fragment column pair

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // keys up to the block's last valid query row
  const int kv_end = min(q0 + kTile, S);
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  load_tile(sQ, qb, q_ss, q0, S, tid);
  load_tile(sK[0], kb, k_ss, 0, S, tid);
  load_tile(sV[0], vb, v_ss, 0, S, tid);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + (lane >> 2);  // this thread's two rows
  const int row_b = row_a + 8;

  uint32_t qf[kHeadDim / 16][4];
  float o_acc[kHeadDim / 8][4];
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // partial row sums over this thread's columns

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], kb, k_ss, (j + 1) * kTile, S, tid);
      load_tile(sV[buf ^ 1], vb, v_ss, (j + 1) * kTile, S, tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile j (and, at j == 0, Q) has landed
    __syncthreads();

    if (j == 0) load_a_rows(qf, sQ, warp, lane);

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kTile / 8][4];
    product_abt(s, qf, sK[buf], lane);

    // scale, causal and ragged-edge mask, online softmax
    const int key0 = j * kTile;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nb * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = s[nb][e] * scale;
        if (key > row || key >= S) x = -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      msub[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float alpha = __expf(m_run[r] - msub[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha;
#pragma unroll
      for (int nb = 0; nb < kHeadDim / 8; ++nb) {
        o_acc[nb][2 * r] *= alpha;
        o_acc[nb][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = __expf(s[nb][e] - msub[e >> 1]);
        l_run[e >> 1] += s[nb][e];
      }
    }

    // O += P V: P goes from the S accumulators straight into A fragments
    product_ab(o_acc, s, sV[buf], lane);
    __syncthreads();  // buffer buf is refilled at iteration j + 1
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    // the row log-sum-exp of the scaled logits, for the backward
    const int row = r ? row_b : row_a;
    if (lse != nullptr && t == 0 && row < S)
      lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + row] =
          m_run[r] + logf(l);
  }
  store_rows(o + b * o_sb + h * o_sh, o_ss, o_acc, row_a, S, lane, inv[0],
             inv[1]);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  lse may be null.  Strides
// are in elements; the caller guarantees head dim 64 with stride 1, other
// strides that are multiples of 8, and 16-byte aligned pointers.
extern "C" int lah_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, void* stream) {
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attn_fwd_kernel<<<grid, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}
