// K5 planar_grad: the matrix-plane cotangents of one gate on k <= 3 wires,
//   dRe[i][j] = sum_m gr_i[m] xr_j[m] + gi_i[m] xi_j[m]
//   dIm[i][j] = sum_m gi_i[m] xr_j[m] - gr_i[m] xi_j[m]
// over the 2^(n - k) groups m, from the output cotangent g and the gate's
// input x (float32 re/im planes), rows/columns in sorted-wire order.
//
// Replaces the TPU kernel deepquantum_tpu/ops/planar_gate.py::_planar_grad
// (Pallas; body _grad_kernel_body, reduction _reduce_vpu).
//
// Bound on the H100: device memory. A call reads g and x once (2 x 2 planes
// x 2^n x 4 B) and writes 2 x 4^k floats per block; it does 4 * 4^k FMA per
// group that moves 32 * 2^k bytes, at most 2 flop/B at k = 3. So the design
// is K1's: one thread owns one group (planar_group.cuh), loads its
// amplitudes once and keeps its 2 x 4^k partial sums in registers over a
// grid-stride loop. At k = 3 that would be 128 accumulators beside 32
// loaded values, so two neighbouring threads share a group and take four
// rows each (SPLIT = 2; x is loaded by both, g's rows by their owner).
// The sum over groups is a reduction across blocks: each block reduces its
// threads in a fixed order (warp shuffles, then shared memory) and writes
// ONE (2, D, D) partial; the wrapper adds the partials with one torch.sum,
// as the JAX package sums its kernel's per-block partials outside the
// kernel. Float atomics into the final planes would make the order of the
// sum, and so the last bits of a gradient, change from run to run. The TPU
// kernel's version/roll machinery and its SMEM scalar stores are not
// carried over.
//
// Batched form (the JAX kernel's leading batch grid axis): g and x are
// (B, 2, 2^n) stacks and the planes (B, 2^k, 2^k). The sample is a grid
// axis: each sample owns nblocks consecutive blocks, and every block leaves
// its partial at its own grid index, so the partials form a
// (B, nblocks, 2, D, D) stack that the wrapper sums over nblocks in a fixed
// order. No atomics: dW is the same bits from run to run.

#include "planar_group.cuh"

namespace {

constexpr int kThreads = dq::kGateThreads;

template <int K, int SPLIT, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
planar_grad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   float* __restrict__ parts, uint64_t ngroups, uint64_t dim, unsigned nblocks,
                   int bit0, int bit1, int bit2) {
  constexpr int D = 1 << K;
  constexpr int ROWS = D / SPLIT;
  __shared__ float red[kThreads / 32][2 * D * D];
  uint64_t sample = 0;
  unsigned lb = blockIdx.x;
  if constexpr (BATCHED) {
    sample = blockIdx.x / nblocks;
    lb = blockIdx.x - unsigned(sample) * nblocks;
  }
  const float* gr = g + sample * 2 * dim;
  const float* gi = gr + dim;
  const float* xr = x + sample * 2 * dim;
  const float* xi = xr + dim;
  const int bits[3] = {bit0, bit1, bit2};
  const int r0 = (threadIdx.x % SPLIT) * ROWS;
  float are[ROWS * D];
  float aim[ROWS * D];
#pragma unroll
  for (int e = 0; e < ROWS * D; ++e) {
    are[e] = 0.f;
    aim[e] = 0.f;
  }
  const uint64_t stride = uint64_t(nblocks) * blockDim.x / SPLIT;
  for (uint64_t gg = (uint64_t(lb) * blockDim.x + threadIdx.x) / SPLIT; gg < ngroups;
       gg += stride) {
    const uint64_t base = dq::group_base<K>(gg, bits);
    float vxr[D];
    float vxi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const uint64_t o = dq::group_offset<K>(base, c, bits);
      vxr[c] = xr[o];
      vxi[c] = xi[o];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const uint64_t o = dq::group_offset<K>(base, r0 + i, bits);
      const float a = gr[o];
      const float b = gi[o];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        are[i * D + j] = fmaf(a, vxr[j], fmaf(b, vxi[j], are[i * D + j]));
        aim[i * D + j] = fmaf(b, vxr[j], fmaf(-a, vxi[j], aim[i * D + j]));
      }
    }
  }
  dq::block_reduce_planes<D, SPLIT>(are, aim, parts + uint64_t(blockIdx.x) * 2 * D * D, red);
}

template <int K, int SPLIT>
void launch_grad(const float* g, const float* x, float* p, int batch, int nblocks,
                 uint64_t ngroups, uint64_t dim, int bit0, int bit1, int bit2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(uint64_t(nblocks) * uint64_t(batch)));
  if (batch == 1) {
    planar_grad_kernel<K, SPLIT, false><<<grid, kThreads, 0, s>>>(
        g, x, p, ngroups, dim, static_cast<unsigned>(nblocks), bit0, bit1, bit2);
  } else {
    planar_grad_kernel<K, SPLIT, true><<<grid, kThreads, 0, s>>>(
        g, x, p, ngroups, dim, static_cast<unsigned>(nblocks), bit0, bit1, bit2);
  }
}

}  // namespace

// g, x: (batch, 2, 2^n) float32 planes, read only (batch 1: one (2, 2^n)
// state each); parts: (batch, nblocks, 2, 2^k, 2^k) float32, one partial per
// block, all written; bit0..bit2: amplitude bits of the sorted wires (unused
// ones 0). nblocks * 256 threads must not exceed one thread per group (two
// at k = 3). Returns a cudaError_t.
extern "C" int dq_planar_grad_f32(const void* g, const void* x, void* parts, int batch,
                                  int nblocks, int n, int k, int bit0, int bit1, int bit2,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || n < k || n > 40 || nblocks < 1 || batch < 1) return cudaErrorInvalidValue;
  const uint64_t ngroups = uint64_t(1) << (n - k);
  const uint64_t split = k == 3 ? 2 : 1;
  if (uint64_t(nblocks) * kThreads > ngroups * split) return cudaErrorInvalidValue;
  if (uint64_t(nblocks) * uint64_t(batch) >= (uint64_t(1) << 31)) return cudaErrorInvalidValue;
  const float* gs = static_cast<const float*>(g);
  const float* xs = static_cast<const float*>(x);
  float* p = static_cast<float*>(parts);
  const uint64_t dim = uint64_t(1) << n;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      launch_grad<1, 1>(gs, xs, p, batch, nblocks, ngroups, dim, bit0, bit1, bit2, s);
      break;
    case 2:
      launch_grad<2, 1>(gs, xs, p, batch, nblocks, ngroups, dim, bit0, bit1, bit2, s);
      break;
    default:
      launch_grad<3, 2>(gs, xs, p, batch, nblocks, ngroups, dim, bit0, bit1, bit2, s);
      break;
  }
  return cudaGetLastError();
}
