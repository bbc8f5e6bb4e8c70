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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
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
  for (int i = tid; i < kBlockN * (kHeadDim / 8); i += kThreads) {
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

__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int S,
                          int64_t q_sb, int64_t q_ss, int64_t q_sh,
                          int64_t k_sb, int64_t k_ss, int64_t k_sh,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh,
                          float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockN * kStride];

  // the last query tiles see the most keys: start them first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within 8
  const int t = lane & 3;   // fragment column pair

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // keys up to the block's last valid query row
  const int kv_end = min(q0 + kBlockM, S);
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  load_tile(sQ, qb, q_ss, q0, S, tid);
  load_tile(sK[0], kb, k_ss, 0, S, tid);
  load_tile(sV[0], vb, v_ss, 0, S, tid);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
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
      load_tile(sK[buf ^ 1], kb, k_ss, (j + 1) * kBlockN, S, tid);
      load_tile(sV[buf ^ 1], vb, v_ss, (j + 1) * kBlockN, S, tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile j (and, at j == 0, Q) has landed
    __syncthreads();

    if (j == 0) {
      const __nv_bfloat16* qr = sQ + (warp * 16 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        qf[kk][0] = lds32(qr + kk * 16);
        qf[kk][1] = lds32(qr + 8 * kStride + kk * 16);
        qf[kk][2] = lds32(qr + kk * 16 + 8);
        qf[kk][3] = lds32(qr + 8 * kStride + kk * 16 + 8);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb) {
        const __nv_bfloat16* kr =
            sK[buf] + (nb * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16_16816(s[nb], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // scale, causal and ragged-edge mask, online softmax
    const int key0 = j * kBlockN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
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
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = __expf(s[nb][e] - msub[e >> 1]);
        l_run[e >> 1] += s[nb][e];
      }
    }

    // O += P V: P goes from the S accumulators straight into A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < kHeadDim / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV[buf] + key * kStride + np * 16 +
                                  (lane >> 4) * 8);
        mma_bf16_16816(o_acc[2 * np], a, bv[0], bv[1]);
        mma_bf16_16816(o_acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // buffer buf is refilled at iteration j + 1
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
#pragma unroll
  for (int nb = 0; nb < kHeadDim / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * o_ss + col) =
          __floats2bfloat162_rn(o_acc[nb][0] * inv[0], o_acc[nb][1] * inv[0]);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * o_ss + col) =
          __floats2bfloat162_rn(o_acc[nb][2] * inv[1], o_acc[nb][3] * inv[1]);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  Strides are in elements;
// the caller guarantees head dim 64 with stride 1, other strides that are
// multiples of 8, and 16-byte aligned pointers.
extern "C" int lah_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, float scale, void* stream) {
  dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_attn_fwd_kernel<<<grid, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}
