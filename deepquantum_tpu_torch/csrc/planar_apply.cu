// K1 planar_apply: one gate on k <= 3 wires, applied in place to the
// float32 re/im planes of an n-qubit state.
//
// Replaces the TPU kernel deepquantum_tpu/ops/planar_gate.py::_planar_apply
// (Pallas; body _kernel_body, block machinery _block_machinery/_geometry).
//
// Bound on the H100: device memory. A call reads and writes the whole state
// once (2 planes x 2^n x 4 B, both ways) and does 8 * 4^k flops per group of
// 2^k amplitudes that moves 16 * 2^k bytes: 2^k / 2 flop/B, at most 4 at
// k = 3, far below the card's ridge. So the design spends nothing on
// arithmetic: one thread owns one group of 2^k amplitudes (the base index
// with zero bits inserted at the gate's bit positions, wire 0 the most
// significant bit), loads them, multiplies by the <= 8x8 matrix planes held
// in shared memory, and writes them back. Each thread owns its amplitudes,
// so the update is in place with no synchronisation. None of the TPU
// machinery (XOR lane/sublane rolls, head/mid/tail split, row blocks) is
// carried over: the card gathers amplitudes by address.

#include "planar_group.cuh"

namespace {

constexpr int kThreads = dq::kGateThreads;

template <int K>
__global__ void __launch_bounds__(kThreads)
planar_apply_kernel(float* xr, float* xi, const float* __restrict__ mre,
                    const float* __restrict__ mim, uint64_t ngroups, int bit0,
                    int bit1, int bit2) {
  constexpr int D = 1 << K;
  __shared__ float sre[D * D];
  __shared__ float sim[D * D];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    sre[e] = mre[e];
    sim[e] = mim[e];
  }
  __syncthreads();
  const int bits[3] = {bit0, bit1, bit2};
  const uint64_t stride = uint64_t(gridDim.x) * blockDim.x;
  for (uint64_t g = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x; g < ngroups;
       g += stride) {
    const uint64_t base = dq::group_base<K>(g, bits);
    uint64_t off[D];
    float vr[D];
    float vi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const uint64_t o = dq::group_offset<K>(base, c, bits);
      off[c] = o;
      vr[c] = xr[o];
      vi[c] = xi[o];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float yr = 0.f;
      float yi = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float mr = sre[a * D + c];
        const float mi = sim[a * D + c];
        yr = fmaf(mr, vr[c], yr);
        yr = fmaf(-mi, vi[c], yr);
        yi = fmaf(mr, vi[c], yi);
        yi = fmaf(mi, vr[c], yi);
      }
      xr[off[a]] = yr;
      xi[off[a]] = yi;
    }
  }
}

}  // namespace

// x: (2, 2^n) float32 planes, updated in place; mre/mim: (2^k, 2^k) float32
// planes in sorted-wire order; bit0..bit2: amplitude bits of the sorted
// wires (unused ones 0). Returns a cudaError_t.
extern "C" int dq_planar_apply_f32(void* x, const void* mre, const void* mim, int n, int k,
                                   int bit0, int bit1, int bit2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || n < k || n > 40) return cudaErrorInvalidValue;
  float* xr = static_cast<float*>(x);
  float* xi = xr + (uint64_t(1) << n);
  const float* mr = static_cast<const float*>(mre);
  const float* mi = static_cast<const float*>(mim);
  const uint64_t ngroups = uint64_t(1) << (n - k);
  uint64_t blocks = (ngroups + kThreads - 1) / kThreads;
  if (blocks > (uint64_t(1) << 20)) blocks = uint64_t(1) << 20;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (k) {
    case 1:
      planar_apply_kernel<1><<<grid, kThreads, 0, s>>>(xr, xi, mr, mi, ngroups, bit0, bit1, bit2);
      break;
    case 2:
      planar_apply_kernel<2><<<grid, kThreads, 0, s>>>(xr, xi, mr, mi, ngroups, bit0, bit1, bit2);
      break;
    default:
      planar_apply_kernel<3><<<grid, kThreads, 0, s>>>(xr, xi, mr, mi, ngroups, bit0, bit1, bit2);
      break;
  }
  return cudaGetLastError();
}
