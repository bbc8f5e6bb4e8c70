// MoE token dispatch for Hopper (sm_90a): a row gather into capacity
// buckets.
//
// Replaces: learning_at_home_tpu/ops/pallas_dispatch.py:44,
// _dispatch_kernel (reached through dispatch_tokens_pallas :92).  It
// computes out[s, :] = x[idx[s], :] for every expert slot s of the
// flattened [E*C] plan, and zeros where idx[s] < 0 (an empty slot).
//
// What bounds it on the H100: it does no arithmetic.  It reads the index
// of every slot (4 bytes), reads each filled slot's row once and writes
// every slot's row once: 2*d*(E*C + filled) + 4*E*C bytes for bf16, over
// 3.35 TB/s.  At the flagship's training plans (E*C = 112,640, d = 512,
// a quarter to two thirds of the slots filled) that is 0.04-0.06 ms, so
// the design is about keeping enough independent 16-byte loads in
// flight: one warp per slot reads the slot's index once (a broadcast
// load), then its lanes copy the row with 16-byte non-coherent loads
// (ld.global.nc.v4) and 16-byte stores, neighbouring lanes on
// neighbouring addresses; an empty slot only stores zeros.
//
// The TPU kernel DMAs the 8-row aligned chunk holding each token and picks
// the row with a masked sum (Mosaic cannot copy a single row), which turns
// a -0.0 into +0.0.  This kernel copies the row's bits, so it equals the
// plain gather (moe_dispatch.dispatch_tokens_indexed) bit for bit, NaN
// payloads and signed zeros included.
//
// It takes any dtype (it copies bytes), any d, any n >= 1 and any
// E*C >= 1: the unit of the copy is 16 bytes when the row length, the row
// stride of x and both base pointers are multiples of 16 bytes, else 4,
// else 2 (the narrowest element is 2 bytes).  An index >= n is outside
// the plan's contract and traps, as the plain gather's bounds check does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Unit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    token_dispatch_kernel(const Unit* __restrict__ x, int64_t x_row_units,
                          const int32_t* __restrict__ idx,
                          Unit* __restrict__ out, int64_t n, int64_t slots,
                          int64_t row_units) {
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= slots) return;
  const int lane = threadIdx.x & 31;
  const int32_t token = __ldg(idx + slot);
  Unit* dst = out + slot * row_units;
  if (token < 0) {
    const Unit zero{};
    for (int64_t j = lane; j < row_units; j += 32) dst[j] = zero;
    return;
  }
  if (token >= n) __trap();
  const Unit* src = x + static_cast<int64_t>(token) * x_row_units;
#pragma unroll 4
  for (int64_t j = lane; j < row_units; j += 32) dst[j] = __ldg(src + j);
}

template <typename Unit>
cudaError_t launch(const void* x, int64_t x_row_bytes, const int32_t* idx,
                   void* out, int64_t n, int64_t slots, int64_t row_bytes,
                   cudaStream_t stream) {
  const int64_t blocks = (slots + kWarpsPerBlock - 1) / kWarpsPerBlock;
  token_dispatch_kernel<Unit><<<static_cast<unsigned>(blocks),
                                kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const Unit*>(x), x_row_bytes / sizeof(Unit), idx,
      static_cast<Unit*>(out), n, slots, row_bytes / sizeof(Unit));
  return cudaGetLastError();
}

}  // namespace

// out [slots, row_bytes] (contiguous) <- rows of x [n, *] (row stride
// x_row_bytes) picked by idx [slots] int32; -1 gives a zero row.  Returns
// the launch's CUDA error (0 when it was accepted).
extern "C" int lah_token_dispatch(const void* x, int64_t x_row_bytes,
                                  const int32_t* idx, void* out, int64_t n,
                                  int64_t slots, int64_t row_bytes,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (slots <= 0 || row_bytes <= 0) return 0;
  if ((slots + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t px = static_cast<int64_t>(reinterpret_cast<intptr_t>(x));
  const int64_t po = static_cast<int64_t>(reinterpret_cast<intptr_t>(out));
  auto fits = [&](int64_t unit) {
    return row_bytes % unit == 0 && x_row_bytes % unit == 0 &&
           px % unit == 0 && po % unit == 0;
  };
  cudaError_t err;
  if (fits(16)) {
    err = launch<uint4>(x, x_row_bytes, idx, out, n, slots, row_bytes,
                        stream);
  } else if (fits(4)) {
    err = launch<uint32_t>(x, x_row_bytes, idx, out, n, slots, row_bytes,
                           stream);
  } else if (fits(2)) {
    err = launch<uint16_t>(x, x_row_bytes, idx, out, n, slots, row_bytes,
                           stream);
  } else {
    err = cudaErrorMisalignedAddress;
  }
  return static_cast<int>(err);
}
