// The index machinery of K6 (planar_bwd_fused.cu) and the block reduction
// it shares with K5 (planar_grad.cu); K1 and K5 index the state through
// planar_quad.cuh.
//
// A gate on k <= 3 wires splits the 2^n amplitudes into 2^(n - k) groups of
// D = 2^k amplitudes that differ only in the gate's bits. One thread owns
// one group: its base index is the group number with zero bits inserted at
// the gate's bit positions (wire 0 is the most significant bit). bits[j] is
// the amplitude bit of the j-th sorted wire (n - 1 - wire), so
// bits[0] > bits[1] > bits[2]; gate row/column index bit (K - 1 - j) belongs
// to wire j.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dq {

constexpr int kGateThreads = 256;

// Insert a zero bit at position b of i: the bits at and above b move up one.
__device__ __forceinline__ uint64_t insert_zero(uint64_t i, int b) {
  const uint64_t low = i & ((uint64_t(1) << b) - 1);
  return ((i >> b) << (b + 1)) | low;
}

// Base index (all gate bits zero) of group g.
template <int K>
__device__ __forceinline__ uint64_t group_base(uint64_t g, const int (&bits)[3]) {
  uint64_t base = g;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) base = insert_zero(base, bits[j]);  // ascending bits
  return base;
}

// Index of the amplitude of a group whose gate bits spell row/column c.
template <int K>
__device__ __forceinline__ uint64_t group_offset(uint64_t base, int c, const int (&bits)[3]) {
  uint64_t o = base;
#pragma unroll
  for (int j = 0; j < K; ++j) o |= uint64_t((c >> (K - 1 - j)) & 1) << bits[j];
  return o;
}

// Sum the per-thread partial cotangent planes of one block and write the
// block's (2, D, D) partial to `out`, in a fixed order (warp shuffles, then
// the warps' sums through shared memory): the result does not change from
// run to run. A thread holds ROWS = D / SPLIT rows starting at row
// (threadIdx.x % SPLIT) * ROWS; all threads of the block call this together.
template <int D, int SPLIT>
__device__ __forceinline__ void block_reduce_planes(float (&are)[D / SPLIT * D],
                                                    float (&aim)[D / SPLIT * D],
                                                    float* __restrict__ out,
                                                    float (*red)[2 * D * D]) {
  constexpr int ROWS = D / SPLIT;
  constexpr unsigned kFull = 0xffffffffu;
#pragma unroll
  for (int e = 0; e < ROWS * D; ++e) {
#pragma unroll
    for (int o = 16; o >= SPLIT; o >>= 1) {   // lanes of equal (lane % SPLIT)
      are[e] += __shfl_xor_sync(kFull, are[e], o);
      aim[e] += __shfl_xor_sync(kFull, aim[e], o);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < SPLIT) {
    const int r0 = lane * ROWS;
#pragma unroll
    for (int e = 0; e < ROWS * D; ++e) {
      red[warp][r0 * D + e] = are[e];
      red[warp][D * D + r0 * D + e] = aim[e];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * D * D; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kGateThreads / 32; ++w) s += red[w][e];
    out[e] = s;
  }
}

}  // namespace dq
