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
//
// Batched form (the JAX kernel's leading batch grid axis): a (B, 2, 2^n)
// stack with per-sample (B, 2^k, 2^k) planes, or one plane broadcast to
// every sample. The sample is a grid axis: each sample owns bps consecutive
// blocks, and each block stages its own sample's planes in shared memory.
// A single state (B = 1) runs the unbatched instance.

#include "planar_group.cuh"

namespace {

constexpr int kThreads = dq::kGateThreads;

template <int K, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
planar_apply_kernel(float* x, const float* __restrict__ mre, const float* __restrict__ mim,
                    uint64_t ngroups, uint64_t dim, unsigned bps, int pstride, int bit0,
                    int bit1, int bit2) {
  constexpr int D = 1 << K;
  // a batched grid gives each sample bps consecutive blocks; the sample's
  // planes sit pstride floats apart (0: one plane broadcast to every sample)
  uint64_t sample = 0;
  unsigned lb = blockIdx.x;
  unsigned nb = gridDim.x;
  if constexpr (BATCHED) {
    sample = blockIdx.x / bps;
    lb = blockIdx.x - unsigned(sample) * bps;
    nb = bps;
  }
  float* xr = x + sample * 2 * dim;
  float* xi = xr + dim;
  const float* pr = mre + sample * pstride;
  const float* pi = mim + sample * pstride;
  __shared__ float sre[D * D];
  __shared__ float sim[D * D];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    sre[e] = pr[e];
    sim[e] = pi[e];
  }
  __syncthreads();
  const int bits[3] = {bit0, bit1, bit2};
  const uint64_t stride = uint64_t(nb) * blockDim.x;
  for (uint64_t g = uint64_t(lb) * blockDim.x + threadIdx.x; g < ngroups; g += stride) {
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

template <int K>
void launch_apply(float* x, const float* mr, const float* mi, int batch, int pstride,
                  uint64_t ngroups, uint64_t dim, int bit0, int bit1, int bit2,
                  cudaStream_t s) {
  // at most 2^20 blocks in all: each sample gets an equal share of them and
  // its threads walk the rest of its groups
  const uint64_t cap = uint64_t(1) << 20;
  uint64_t bps = (ngroups + kThreads - 1) / kThreads;
  const uint64_t share = cap / uint64_t(batch) > 0 ? cap / uint64_t(batch) : 1;
  if (bps > share) bps = share;
  const dim3 grid(static_cast<unsigned>(bps * uint64_t(batch)));
  if (batch == 1) {
    planar_apply_kernel<K, false><<<grid, kThreads, 0, s>>>(x, mr, mi, ngroups, dim, 0, 0, bit0,
                                                            bit1, bit2);
  } else {
    planar_apply_kernel<K, true><<<grid, kThreads, 0, s>>>(
        x, mr, mi, ngroups, dim, static_cast<unsigned>(bps), pstride, bit0, bit1, bit2);
  }
}

}  // namespace

// x: (batch, 2, 2^n) float32 planes, updated in place (batch 1: one
// (2, 2^n) state); mre/mim: (2^k, 2^k) float32 planes in sorted-wire order,
// one per sample pstride floats apart (pstride 0: the same planes for every
// sample); bit0..bit2: amplitude bits of the sorted wires (unused ones 0).
// Returns a cudaError_t.
extern "C" int dq_planar_apply_f32(void* x, const void* mre, const void* mim, int batch,
                                   int pstride, int n, int k, int bit0, int bit1, int bit2,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || n < k || n > 40 || batch < 1 || pstride < 0) return cudaErrorInvalidValue;
  float* xs = static_cast<float*>(x);
  const float* mr = static_cast<const float*>(mre);
  const float* mi = static_cast<const float*>(mim);
  const uint64_t dim = uint64_t(1) << n;
  const uint64_t ngroups = uint64_t(1) << (n - k);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      launch_apply<1>(xs, mr, mi, batch, pstride, ngroups, dim, bit0, bit1, bit2, s);
      break;
    case 2:
      launch_apply<2>(xs, mr, mi, batch, pstride, ngroups, dim, bit0, bit1, bit2, s);
      break;
    default:
      launch_apply<3>(xs, mr, mi, batch, pstride, ngroups, dim, bit0, bit1, bit2, s);
      break;
  }
  return cudaGetLastError();
}
