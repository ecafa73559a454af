// The tile bodies of K3 (window_chain.cu). K2 and K4 run their window
// products on the tensor cores (window_mma.cuh).
//
// window_tile: y = W x for one tile of TC columns of the state viewed as two
// (128, R) float32 planes, R = 2^(n - 7), written back in place or into
// another buffer. rotate_planes: a wire relabel of both planes, a transpose
// through 32 x 32 shared-memory tiles into another buffer.
//
// The tile of both planes is staged in shared memory, W is staged in chunks
// of 32 columns (transposed, so a thread reads its rows as float4), and each
// thread accumulates 128 * TC / 256 outputs of one column in FP32 FMA. No
// TF32 and no tensor cores: the sums keep full float32 products.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dq {

constexpr int kWinRows = 128;                 // 2^w, w = 7
constexpr int kWinThreads = 256;
constexpr int kChunk = 32;                    // columns of W staged at a time
constexpr int kChunkStride = kWinRows + 4;    // padded, keeps float4 alignment

template <int TC>
struct WindowSmem {
  float xr[kWinRows][TC];
  float xi[kWinRows][TC];
  float wr[kChunk][kChunkStride];   // wr[kk][r] = W_re[r][k0 + kk]
  float wi[kChunk][kChunkStride];
};

// All kWinThreads threads of the block call this together. W (wre, wim,
// row-major 128 x 128) must not change during the kernel (read through the
// read-only cache); the state planes xr/xi are read with plain loads, since
// a persistent kernel writes them between calls. The result goes to yr/yi,
// which may be xr/xi themselves (in place) or the planes of another buffer.
template <int TC>
__device__ __forceinline__ void window_tile(const float* __restrict__ wre,
                                            const float* __restrict__ wim, const float* xr,
                                            const float* xi, float* yr, float* yi, int64_t R,
                                            int64_t c0, WindowSmem<TC>& s) {
  constexpr int kRows = kWinRows * TC / kWinThreads;   // outputs per thread
  static_assert(kRows % 4 == 0, "rows per thread must be a multiple of 4");
  const int t = threadIdx.x;
  const int col = t % TC;
  const int r0 = (t / TC) * kRows;
  for (int e = t; e < kWinRows * TC; e += kWinThreads) {
    const int r = e / TC;
    const int c = e % TC;
    s.xr[r][c] = xr[r * R + c0 + c];
    s.xi[r][c] = xi[r * R + c0 + c];
  }
  float acc_r[kRows];
  float acc_i[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
  }
  for (int k0 = 0; k0 < kWinRows; k0 += kChunk) {
    __syncthreads();   // tile staged; previous chunk consumed
    for (int e = t; e < kWinRows * kChunk; e += kWinThreads) {
      const int r = e / kChunk;
      const int kk = e % kChunk;
      s.wr[kk][r] = __ldg(wre + r * kWinRows + k0 + kk);
      s.wi[kk][r] = __ldg(wim + r * kWinRows + k0 + kk);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      const float vr = s.xr[k0 + kk][col];
      const float vi = s.xi[k0 + kk][col];
#pragma unroll
      for (int i = 0; i < kRows; i += 4) {
        const float4 mr = *reinterpret_cast<const float4*>(&s.wr[kk][r0 + i]);
        const float4 mi = *reinterpret_cast<const float4*>(&s.wi[kk][r0 + i]);
        acc_r[i + 0] = fmaf(-mi.x, vi, fmaf(mr.x, vr, acc_r[i + 0]));
        acc_i[i + 0] = fmaf(mi.x, vr, fmaf(mr.x, vi, acc_i[i + 0]));
        acc_r[i + 1] = fmaf(-mi.y, vi, fmaf(mr.y, vr, acc_r[i + 1]));
        acc_i[i + 1] = fmaf(mi.y, vr, fmaf(mr.y, vi, acc_i[i + 1]));
        acc_r[i + 2] = fmaf(-mi.z, vi, fmaf(mr.z, vr, acc_r[i + 2]));
        acc_i[i + 2] = fmaf(mi.z, vr, fmaf(mr.z, vi, acc_i[i + 2]));
        acc_r[i + 3] = fmaf(-mi.w, vi, fmaf(mr.w, vr, acc_r[i + 3]));
        acc_i[i + 3] = fmaf(mi.w, vr, fmaf(mr.w, vi, acc_i[i + 3]));
      }
    }
  }
  // in place is safe: only this block reads these columns, and it has staged them
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    yr[(r0 + i) * R + c0 + col] = acc_r[i];
    yi[(r0 + i) * R + c0 + col] = acc_i[i];
  }
  __syncthreads();   // shared memory is reused by the next tile
}

constexpr int kT = 32;   // edge of a transpose tile

// Both planes of `in`, each viewed as (P, Q) = (2^d, 2^(n - d)), transposed
// into `out` as (Q, P): the qubit positions rotate left by d. All threads of
// the block call this together; the blocks of the grid share the tiles.
// Plain loads: `in` was written earlier in the launch.
__device__ __forceinline__ void rotate_planes(const float* in, float* out, int n, int d,
                                              float (*tile)[kT + 1]) {
  const int64_t N = int64_t(1) << n;
  const int64_t P = int64_t(1) << d;
  const int64_t Q = int64_t(1) << (n - d);
  const int64_t tiles_q = Q / kT;
  const int64_t per_plane = (P / kT) * tiles_q;
  const int tx = threadIdx.x % kT;
  const int ty = threadIdx.x / kT;
  constexpr int kRowStep = kWinThreads / kT;
  for (int64_t tt = blockIdx.x; tt < 2 * per_plane; tt += gridDim.x) {
    const int64_t plane = tt / per_plane;
    const int64_t ti = (tt % per_plane) / tiles_q;
    const int64_t tj = (tt % per_plane) % tiles_q;
    const float* src = in + plane * N;
    float* dst = out + plane * N;
    for (int r = ty; r < kT; r += kRowStep) tile[r][tx] = src[(ti * kT + r) * Q + tj * kT + tx];
    __syncthreads();
    for (int r = ty; r < kT; r += kRowStep) dst[(tj * kT + r) * P + ti * kT + tx] = tile[tx][r];
    __syncthreads();
  }
}

}  // namespace dq
