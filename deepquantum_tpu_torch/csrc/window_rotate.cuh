// The relabel step of the window chains K3 (window_chain.cu) and K4
// (window_chain_bwd.cu): one or two states, each two float32 planes viewed
// as (P, Q) = (2^d, 2^(n-d)), transposed into another buffer as (Q, P), so
// that the qubit positions rotate left by d (the TPU kernels' _rot2). A run
// of consecutive relabels arrives as one delta (chain_kernel._merged_rows
// adds them mod n), so any 1 <= d < n is taken.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dq {

constexpr int kRotThreads = 256;   // the chains' block
constexpr int kRotTile = 4096;     // entries of a transpose tile
constexpr int kRotEdge = 64;       // its edge when both sides allow
// shared memory a transpose tile takes: the largest padded tile, 2048 x (2 + 1)
constexpr int kRotSmemFloats = kRotTile / 2 * 3;

// y -> ynext and, unless g is null, g -> gnext. A tile is TI x TJ = 4096
// entries: 64 x 64, or P x 4096 / P when P is smaller (Q x 4096 / Q
// likewise), so that a merged delta far from n / 2 still reads and writes
// runs of at least 256 bytes; each thread keeps 16 loads in flight. All
// threads of the block call this together, and the blocks of the grid
// share the tiles. Reads bypass L1: other blocks wrote the states earlier in
// the launch. `tile` holds kRotSmemFloats floats of shared memory.
__device__ __forceinline__ void rotate_states(const float* y, float* ynext, const float* g,
                                              float* gnext, int n, int d, float* tile) {
  constexpr int kEach = kRotTile / kRotThreads;
  const int64_t N = int64_t(1) << n;
  const int64_t P = int64_t(1) << d;
  const int64_t Q = int64_t(1) << (n - d);
  const int ti_n = P < kRotEdge   ? static_cast<int>(P)
                   : Q < kRotEdge ? kRotTile / static_cast<int>(Q)
                                  : kRotEdge;
  const int tj_n = kRotTile / ti_n;
  const int stride = tj_n + 1;   // odd: the column reads of the write phase hit distinct banks
  const int64_t tiles_q = Q / tj_n;
  const int64_t per_plane = (P / ti_n) * tiles_q;
  const int64_t planes = g == nullptr ? 2 : 4;   // y re, y im, g re, g im
  for (int64_t tt = blockIdx.x; tt < planes * per_plane; tt += gridDim.x) {
    const int64_t plane = tt / per_plane;
    const int64_t ti = (tt % per_plane) / tiles_q;
    const int64_t tj = (tt % per_plane) % tiles_q;
    const float* src = (plane < 2 ? y : g) + (plane % 2) * N + ti * ti_n * Q + tj * tj_n;
    float* dst = (plane < 2 ? ynext : gnext) + (plane % 2) * N + tj * tj_n * P + ti * ti_n;
    float v[kEach];
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = threadIdx.x + u * kRotThreads;
      v[u] = __ldcg(src + (e / tj_n) * Q + e % tj_n);
    }
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = threadIdx.x + u * kRotThreads;
      tile[(e / tj_n) * stride + e % tj_n] = v[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = threadIdx.x + u * kRotThreads;
      const int j = e / ti_n;
      const int i = e % ti_n;
      dst[j * P + i] = tile[i * stride + j];
    }
    __syncthreads();
  }
}

}  // namespace dq
