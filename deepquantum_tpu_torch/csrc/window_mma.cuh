// The tensor-core window body shared by K2 (window_apply.cu) and K4
// (window_chain_bwd.cu): y = W x for a tile of columns, W a complex
// 128 x 128 window held as split float32 planes in shared memory, x the
// tile of one or two states (both planes) in shared memory. The real work
// is the block product [[Wr, -Wi], [Wi, Wr]] [xr; xi], run as
//   yr += Wr xr + (-Wi) xi,   yi += Wi xr + Wr xi.
//
// K2 replaces the TPU kernel deepquantum_tpu/ops/window_gate.py::window_apply
// and K4 deepquantum_tpu/ops/chain_kernel.py::window_chain_bwd; both TPU
// kernels run these products on the MXU at Precision.HIGHEST. Here they
// replace the FP32 FMA loop of window_tile.cuh (which K3 keeps). What bounds
// that loop on the H100 is the CUDA cores' 67 TFLOP/s; the tensor cores do
// TF32 at 495 TFLOP/s. TF32 keeps 10 mantissa bits, so every operand is
// split, a = hi + lo with hi = round-to-TF32(a) and lo = a - hi (the tensor
// core reads the top 10 mantissa bits of lo), and a product is taken as
// lo*hi + hi*lo + hi*hi with FP32 accumulators (3xTF32): the lost terms are
// below 2^-21 of |a b|, under float32's own rounding of the 128-term sums.
// Operands are split as they leave shared memory: hi and lo of both W
// planes would take 256 KB, more than a block has.
//
// The instruction is mma.sync.m16n8k8 (TF32 in, FP32 out), not wgmma:
// wgmma reads B from shared memory in its own swizzled layout, so the
// split operands would first have to be written back there (two extra
// planes per operand, which do not fit beside W), and its 64-row tiles
// want four warps per product where this body gives each warp 16 rows of
// its own. mma.sync takes its operands from registers, which is where the
// split puts them.
//
// Fragment layouts of m16n8k8 (PTX ISA), lane = 4 g + t:
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

// round to nearest at 10 mantissa bits (ties away from zero); the low 13
// bits of the result are zero, which is what the tensor core reads
__device__ __forceinline__ float tf32_round(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32_round(a);
  lo = a - hi;   // exact in float32
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// d += a b in 3xTF32, the small terms first. The tensor core does not round
// its float32 sums to nearest, so an accumulator that takes all 96
// instructions of a 128-deep window product drifts in one direction: on the
// H100 that missed K2's bar of 1e-6 against its twin. The callers therefore
// start each 8-deep step from a zero fragment and add it to their sums with
// a float32 add, which rounds to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const float (&ah)[4], const float (&al)[4],
                                     const float (&bh)[2], const float (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// sums += step, plane by plane, in float32 (round to nearest)
__device__ __forceinline__ void add_step(float (&sums)[2][4], const float (&step)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) sums[p][q] += step[p][q];
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

// acc[s][j][0] / [1]: the C fragments of the real / imaginary plane of
// the warp's 16 rows (16 * warp + g, + 8) by the 8 columns of n-tile j
// (8 j + 2t, + 1) of state s. All warps call this together; it only reads
// shared memory.
template <int TC, int NS>
__device__ __forceinline__ void window_product(const float* ws, const float* const (&xs)[NS],
                                               float (&acc)[NS][TC / 8][2][4]) {
  constexpr int NT = TC / 8;
  constexpr int XS = Tile<TC>::kStride;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[s][j][q / 4][q % 4] = 0.f;
  const float* wr = ws + (m0 + g) * kRows;   // rows m0 + g and m0 + g + 8: both r % 8 = g
  const float* wi = wr + kRows * kRows;
#pragma unroll 2
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    float arh[4], arl[4], aih[4], ail[4], nih[4], nil[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int off = (q & 1) * 8 * kRows + ((k0 + (q >> 1) * 4 + t) ^ (g << 2));
      split(wr[off], arh[q], arl[q]);
      split(wi[off], aih[q], ail[q]);
      nih[q] = -aih[q];
      nil[q] = -ail[q];
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float* xr = xs[s] + (k0 + t) * XS + g;
      const float* xi = xr + kRows * XS;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float brh[2], brl[2], bih[2], bil[2];
        split(xr[j * 8], brh[0], brl[0]);
        split(xr[4 * XS + j * 8], brh[1], brl[1]);
        split(xi[j * 8], bih[0], bil[0]);
        split(xi[4 * XS + j * 8], bih[1], bil[1]);
        float step[2][4] = {};
        mma3(step[0], arh, arl, brh, brl);
        mma3(step[0], nih, nil, bih, bil);
        mma3(step[1], aih, ail, brh, brl);
        mma3(step[1], arh, arl, bih, bil);
        add_step(acc[s][j], step);
      }
    }
  }
}

// Write one state's accumulators to columns [c0, c0 + TC) of the planes
// (y, y + N), each viewed as (128, R).
template <int TC>
__device__ __forceinline__ void store_product(const float (&acc)[TC / 8][2][4], float* y,
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
      *reinterpret_cast<float2*>(y + at) = make_float2(acc[j][0][2 * h], acc[j][0][2 * h + 1]);
      *reinterpret_cast<float2*>(y + N + at) = make_float2(acc[j][1][2 * h], acc[j][1][2 * h + 1]);
    }
  }
}

}  // namespace mma
}  // namespace dq
