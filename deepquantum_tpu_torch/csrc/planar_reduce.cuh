// The sum of the cotangent planes over a launch, shared by K5
// (planar_grad.cu) and K6 (planar_bwd_fused.cu).
//
// Each thread of a block holds partial sums of some rows or some columns of
// the (2, D, D) planes (dRe, dIm). The block adds them in a fixed order
// (warp shuffles, then the warps' sums through shared memory), writes its
// partial to a workspace, fences, and counts itself in at its sample's
// arrival counter; the block that arrives last sums the sample's partials in
// a fixed order (slice s of its threads adds blocks s, s + S, ... in
// ascending order, eight 16-byte loads in flight a thread, then the S
// slices in order), writes the final planes and sets the counter back to 0
// for the next launch. The order does not depend on which block arrives
// last, so the planes are the same bits from run to run; float atomics into
// them would not be. The workspace and the zeroed counters belong to the
// wrapper (one set per device and stream, grown when needed); the kernels
// allocate nothing.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "planar_quad.cuh"

namespace dq {

constexpr int kSumBatch = 8;   // loads in flight per thread in the last block's sum

// Element e of a thread's partial arrays as (row, column) of the planes. The
// block's threads come in SPLIT shares (threadIdx.x % SPLIT); share `sub`
// holds rows sub * D / SPLIT ... (BY_COL false: e = local row * D + column)
// or columns sub * D / SPLIT ... (BY_COL true: e = row * D / SPLIT + local
// column).
template <int D, int SPLIT, bool BY_COL>
__device__ __forceinline__ int plane_index(int sub, int e) {
  constexpr int PART = D / SPLIT;
  return BY_COL ? (e / PART) * D + sub * PART + e % PART : (sub * PART + e / D) * D + e % D;
}

// Sum the partial planes of a launch into out (2, D, D) of `sample`: every
// thread of the block calls this once, after its last group. The block is
// block lb of the sample's bps blocks; parts holds bps * 2 * D * D floats a
// sample, count one counter a sample (0 on entry, left 0).
template <int D, int SPLIT, bool BY_COL>
__device__ __forceinline__ void sum_planes(float (&are)[D / SPLIT * D],
                                           float (&aim)[D / SPLIT * D], float* __restrict__ out,
                                           float* __restrict__ parts,
                                           unsigned* __restrict__ count, unsigned sample,
                                           unsigned lb, unsigned bps) {
  constexpr int E = 2 * D * D;
  constexpr int P = D / SPLIT * D;   // partial sums a thread holds per plane
  constexpr int E4 = E / 4;          // float4 of a partial
  constexpr int S = kQuadThreads / E4;   // slices of the last block's sum
  constexpr unsigned kFull = 0xffffffffu;
  static_assert(kQuadThreads % E4 == 0 && SPLIT <= 32, "whole float4 slices, shares in a warp");
  __shared__ float red[kQuadThreads / 32][E];
  __shared__ float4 fin[kQuadThreads];
  __shared__ unsigned arrived;

  // the block's partial: lanes of one share, then the warps in order
#pragma unroll
  for (int e = 0; e < P; ++e) {
#pragma unroll
    for (int o = 16; o >= SPLIT; o >>= 1) {   // lanes of equal (lane % SPLIT)
      are[e] += __shfl_xor_sync(kFull, are[e], o);
      aim[e] += __shfl_xor_sync(kFull, aim[e], o);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < SPLIT) {
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int ij = plane_index<D, SPLIT, BY_COL>(lane, e);
      red[warp][ij] = are[e];
      red[warp][D * D + ij] = aim[e];
    }
  }
  __syncthreads();
  float* smp = parts + size_t(sample) * bps * E;
  for (int e = threadIdx.x; e < E; e += kQuadThreads) {
    float s = 0.f;
    for (int w = 0; w < kQuadThreads / 32; ++w) s += red[w][e];
    smp[size_t(lb) * E + e] = s;
  }

  // the sample's arrival count
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) arrived = atomicAdd(count + sample, 1u);
  __syncthreads();
  if (arrived != bps - 1) return;

  // the last block: the sample's partials in a fixed order. Thread t adds
  // float4 t % E4 of blocks t / E4, t / E4 + S, ... (S slices), kSumBatch
  // independent 16-byte loads in flight; then the slices in order.
  __threadfence();
  const int e4 = threadIdx.x % E4;
  const unsigned sl = threadIdx.x / E4;
  const float4* p4 = reinterpret_cast<const float4*>(smp) + e4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (unsigned b0 = sl; b0 < bps; b0 += kSumBatch * S) {
    float4 v[kSumBatch];
#pragma unroll
    for (int r = 0; r < kSumBatch; ++r) {
      const unsigned b = b0 + r * S;
      v[r] = b < bps ? __ldcg(p4 + size_t(b) * E4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kSumBatch; ++r) {
      sum.x += v[r].x;
      sum.y += v[r].y;
      sum.z += v[r].z;
      sum.w += v[r].w;
    }
  }
  fin[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < E) {
    const float* f = reinterpret_cast<const float*>(fin);
    float t = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) t += f[j * E + threadIdx.x];   // slice j, element e
    out[size_t(sample) * E + threadIdx.x] = t;
  }
  if (threadIdx.x == 0) count[sample] = 0u;
}

}  // namespace dq
