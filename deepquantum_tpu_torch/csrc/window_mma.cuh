// The tensor-core window body shared by K2 (window_apply.cu), K3
// (window_chain.cu) and K4 (window_chain_bwd.cu): y = W x for a tile of
// columns, W a complex 128 x 128 window held as split float32 planes in
// shared memory, x the tile of one state (both planes) in shared memory.
// The real work is the block product [[Wr, -Wi], [Wi, Wr]] [xr; xi], run as
//   yr += Wr xr + (-Wi) xi,   yi += Wi xr + Wr xi.
//
// K2 replaces deepquantum_tpu/ops/window_gate.py::window_apply, K3 and K4
// deepquantum_tpu/ops/chain_kernel.py::window_chain_fwd / window_chain_bwd;
// the TPU kernels run these products on the MXU at Precision.HIGHEST.
//
// The body: FP64 tensor cores (DMMA), mma.sync.m16n8k8 with f64 operands
// and f64 sums. Every float32 operand is widened to f64 as it leaves shared
// memory (exact), the product of two float32 values is exact in f64 and the
// sums run in f64, so the only rounding of a window product is the one
// float32 rounding, to nearest, of each result. That rounding is unbiased:
// over a walk of L windows the error grows like sqrt(L).
//
// The body it replaces ran each real product as three TF32 products
// (3xTF32: a = hi + lo, lo*hi + hi*lo + hi*hi) with float32 sums. The tensor
// core does not round its float32 sums to nearest: it aligns the products
// to the largest exponent among them and C, drops the low bits toward zero
// and truncates the result (Fasi, Higham, Mikaitis and Pranesh, PeerJ
// Computer Science 2021). Six mma.sync chained through C per 8-deep step
// shrank every result by a fraction of an ulp in the same direction, a bias
// that grew linearly with the windows walked: K4 missed its 1e-5 bar from 10
// layers on at n=18 (tests/test_torch_tf32.py emulates it). 3xTF32 with
// every mma started from a zero fragment and added in float32 still grew
// x1.88 from 10 to 20 layers on the card, against x1.40 for this body, and
// was slower on K2, K3 and K4 (PERF.md, rows 4-6).
//
// Cost: DMMA peaks at 67 TFLOP/s on the H100 SXM against 495 / 3 for
// 3xTF32, one instruction where there were three, and no operand split.
// mma.sync is the only route to the FP64 tensor cores (wgmma has no f64).
//
// Fragment layouts of m16n8k8 (PTX ISA; the same for .tf32 and .f64),
// lane = 4 g + t:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Shared-memory layouts keep both fragment reads free of bank conflicts:
// W rows of 128 floats with their 16-byte chunks permuted by row % 8 (a
// bank of 4 g + t), state tile rows padded to TC + 8 (a bank of 8 t + g).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dq {
namespace mma {

constexpr int kRows = 128;      // 2^w, w = 7
constexpr int kThreads = 256;   // 8 warps, 16 window rows each
constexpr int kWFloats = 2 * kRows * kRows;

// entry (r, k) of a W plane in shared memory
__device__ __forceinline__ int w_at(int r, int k) { return r * kRows + (k ^ ((r & 7) << 2)); }

// a state tile: 2 planes x 128 rows x TC columns, rows padded to TC + 8
template <int TC>
struct Tile {
  static constexpr int kStride = TC + 8;
  static constexpr int kFloats = 2 * kRows * kStride;
};

// d += a b for one 8-deep step on the FP64 tensor cores
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying W (row-major 128 x 128 planes wre, wim) into ws; all
// threads of the block call this, then commit and wait as they need.
__device__ __forceinline__ void load_window(float* ws, const float* wre, const float* wim) {
  for (int e = threadIdx.x; e < 2 * kRows * kRows / 4; e += kThreads) {
    const int p = e / (kRows * kRows / 4);
    const int r = (e / (kRows / 4)) % kRows;
    const int c = (e % (kRows / 4)) * 4;
    cp_async16(ws + p * kRows * kRows + w_at(r, c), (p ? wim : wre) + r * kRows + c);
  }
}

// Start copying columns [c0, c0 + TC) of the state planes (x, x + N), each
// viewed as (128, R), into the tile xs.
template <int TC>
__device__ __forceinline__ void load_tile(float* xs, const float* x, int64_t N, int64_t R,
                                          int64_t c0) {
  for (int e = threadIdx.x; e < 2 * kRows * TC / 4; e += kThreads) {
    const int row = e / (TC / 4);   // plane * 128 + window row
    const int c = (e % (TC / 4)) * 4;
    const int64_t src = (row / kRows) * N + int64_t(row % kRows) * R + c0 + c;
    cp_async16(xs + row * Tile<TC>::kStride + c, x + src);
  }
}

// acc[j][0] / [1]: the C fragments of the real / imaginary plane of the
// warp's 16 rows (16 * warp + g, + 8) by the 8 columns of n-tile j
// (8 j + 2t, + 1). All warps call this together; it only reads shared
// memory.
template <int TC>
__device__ __forceinline__ void window_product(const float* ws, const float* xs,
                                               double (&acc)[TC / 8][2][4]) {
  constexpr int NT = TC / 8;
  constexpr int XS = Tile<TC>::kStride;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q / 4][q % 4] = 0;
  const float* wr = ws + (m0 + g) * kRows;   // rows m0 + g and m0 + g + 8: both r % 8 = g
  const float* wi = wr + kRows * kRows;
  const float* xr = xs + t * XS + g;
  const float* xi = xr + kRows * XS;
#pragma unroll 2
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    double ar[4], ai[4], ni[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int off = (q & 1) * 8 * kRows + ((k0 + (q >> 1) * 4 + t) ^ (g << 2));
      ar[q] = wr[off];
      ai[q] = wi[off];
      ni[q] = -ai[q];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int at = k0 * XS + j * 8;
      const double br[2] = {xr[at], xr[at + 4 * XS]};
      const double bi[2] = {xi[at], xi[at + 4 * XS]};
      mma_f64(acc[j][0], ar, br);
      mma_f64(acc[j][0], ni, bi);
      mma_f64(acc[j][1], ai, br);
      mma_f64(acc[j][1], ar, bi);
    }
  }
}

// Write the accumulators, rounded to float32, to columns [c0, c0 + TC) of
// the planes (y, y + N), each viewed as (128, R).
template <int TC>
__device__ __forceinline__ void store_product(const double (&acc)[TC / 8][2][4], float* y,
                                              int64_t N, int64_t R, int64_t c0) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int j = 0; j < TC / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t at = int64_t(m0 + g + 8 * h) * R + c0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(y + at) =
          make_float2(float(acc[j][0][2 * h]), float(acc[j][0][2 * h + 1]));
      *reinterpret_cast<float2*>(y + N + at) =
          make_float2(float(acc[j][1][2 * h]), float(acc[j][1][2 * h + 1]));
    }
  }
}

}  // namespace mma
}  // namespace dq
