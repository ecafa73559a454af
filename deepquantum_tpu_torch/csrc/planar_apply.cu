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
// arithmetic and everything on the loads and stores:
// - every access is a 16-byte float4 (planar_quad.cuh): a thread owns a unit
//   of 2^(k - LOW) quads per plane, 4 / 2^LOW whole groups, and pairs the
//   gate's partners in registers. Where the gate holds amplitude bit 0 or 1
//   the quad holds the partners themselves (LOW = 1, 2), so neighbouring
//   threads still take neighbouring 16-byte words; the gate's bits >= 2 are
//   the unit's quads. Each thread owns every amplitude it reads and writes,
//   so the update is in place with no synchronisation;
// - the grid is one wave of the blocks the card keeps resident for the
//   instance, spread over the batch (the wrapper's gate_blocks, from
//   dq_planar_apply_blocks_per_sm), not one thread per group: each thread
//   walks several units, two at a time at k <= 2 so that two loads per
//   plane are in flight;
// - indices are 32-bit within a sample;
// - the matrix planes sit in registers at k <= 2 (32 floats at k = 2) and
//   in shared memory at k = 3 (128 floats, read inside the loop).
// None of the TPU machinery (XOR lane/sublane rolls, head/mid/tail split,
// row blocks) is carried over: the card gathers amplitudes by address.
//
// Batched form (the JAX kernel's leading batch grid axis): a (B, 2, 2^n)
// stack with per-sample (B, 2^k, 2^k) planes, or one plane broadcast to
// every sample. The sample is a grid axis: each sample owns bps consecutive
// blocks, and each block stages its own sample's planes. A single state is
// B = 1.

#include "planar_quad.cuh"

namespace {

constexpr int kThreads = dq::kQuadThreads;

// y = M v for every group of one unit, stored quad by quad as it is done
template <int K, int LOW>
__device__ __forceinline__ void apply_unit(float4* xr, float4* xi, unsigned q0,
                                           const dq::QuadPlan<K - LOW>& plan,
                                           const float4 (&vr)[1 << (K - LOW)],
                                           const float4 (&vi)[1 << (K - LOW)],
                                           const dq::Planes<K>& m, bool swap) {
  constexpr int NQ = 1 << (K - LOW);
  float ar[NQ][4];
  float ai[NQ][4];
#pragma unroll
  for (int ch = 0; ch < NQ; ++ch) {
    dq::unpack_quad(vr[ch], ar[ch], swap);
    dq::unpack_quad(vi[ch], ai[ch], swap);
  }
#pragma unroll
  for (int ah = 0; ah < NQ; ++ah) {
    float yr[4];
    float yi[4];
    dq::mat_quad<K, LOW>(m, ah, ar, ai, yr, yi);
    xr[q0 + plan.off[ah]] = dq::pack_quad(yr, swap);
    xi[q0 + plan.off[ah]] = dq::pack_quad(yi, swap);
  }
}

template <int K, int LOW>
__global__ void __launch_bounds__(kThreads)
planar_apply_kernel(float* __restrict__ x, const float* __restrict__ mre,
                    const float* __restrict__ mim, unsigned units, unsigned quads, unsigned bps,
                    int pstride, int hb0, int hb1, int hb2, int swap_lanes) {
  constexpr int D = 1 << K;
  constexpr int NQ = 1 << (K - LOW);
  constexpr int UNROLL = K <= 2 ? 2 : 1;
  const unsigned sample = blockIdx.x / bps;
  const unsigned lb = blockIdx.x - sample * bps;
  float4* xr = reinterpret_cast<float4*>(x) + size_t(sample) * 2 * quads;
  float4* xi = xr + quads;
  // the sample's planes sit pstride floats apart (0: one set for every sample)
  const float* pr = mre + size_t(sample) * pstride;
  const float* pi = mim + size_t(sample) * pstride;
  __shared__ float sre[D * D];
  __shared__ float sim[D * D];
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    sre[e] = pr[e];
    sim[e] = pi[e];
  }
  __syncthreads();
  const dq::Planes<K> m(sre, sim);
  const dq::QuadPlan<K - LOW> plan(hb0, hb1, hb2);
  const bool swap = LOW == 1 && swap_lanes;
  const unsigned stride = bps * kThreads;
  unsigned u = lb * kThreads + threadIdx.x;
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    unsigned q[UNROLL];
    float4 vr[UNROLL][NQ];
    float4 vi[UNROLL][NQ];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      q[r] = plan.base(u + r * stride);
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        vr[r][ch] = xr[q[r] + plan.off[ch]];
        vi[r][ch] = xi[q[r] + plan.off[ch]];
      }
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) apply_unit<K, LOW>(xr, xi, q[r], plan, vr[r], vi[r], m, swap);
  }
  if constexpr (UNROLL > 1) {
    if (u < units) {   // the last unit of a thread with an odd count
      const unsigned q = plan.base(u);
      float4 vr[NQ];
      float4 vi[NQ];
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        vr[ch] = xr[q + plan.off[ch]];
        vi[ch] = xi[q + plan.off[ch]];
      }
      apply_unit<K, LOW>(xr, xi, q, plan, vr, vi, m, swap);
    }
  }
}

struct Launch {
  float* x;
  const float* mr;
  const float* mi;
  int batch, pstride, n, bps, swap;
  const int* hb;
  cudaStream_t s;

  template <int K, int LOW>
  int run() const {
    const unsigned quads = 1u << (n - 2);
    const unsigned units = quads >> (K - LOW);
    const dim3 grid(static_cast<unsigned>(bps) * static_cast<unsigned>(batch));
    planar_apply_kernel<K, LOW><<<grid, kThreads, 0, s>>>(
        x, mr, mi, units, quads, static_cast<unsigned>(bps), pstride, hb[0], hb[1], hb[2], swap);
    return cudaGetLastError();
  }
};

struct Resident {
  int* out;

  template <int K, int LOW>
  int run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, planar_apply_kernel<K, LOW>,
                                                         kThreads, 0);
  }
};

}  // namespace

// x: (batch, 2, 2^n) float32 planes, 16-byte aligned, updated in place
// (batch 1: one (2, 2^n) state); mre/mim: (2^k, 2^k) float32 planes in
// sorted-wire order, one per sample pstride floats apart (pstride 0: the
// same planes for every sample); low, swap, hb0..hb2: the access plan of
// planar_quad.cuh (the gate's amplitude bits among 0-1, whether it holds bit
// 1 but not bit 0, its other bits minus 2, descending, unused ones 0); bps:
// blocks per sample. 2 <= n <= 33. Returns a cudaError_t.
extern "C" int dq_planar_apply_f32(void* x, const void* mre, const void* mim, int batch,
                                   int pstride, int n, int k, int low, int swap, int hb0, int hb1,
                                   int hb2, int bps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int hb[3] = {hb0, hb1, hb2};
  if (dq::bad_plan(n, k, low, swap, hb) || batch < 1 || pstride < 0 || bps < 1 ||
      bps > (1 << 22) || uint64_t(bps) * uint64_t(batch) >= (uint64_t(1) << 31) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return cudaErrorInvalidValue;
  return dq::quad_dispatch(k, low, Launch{static_cast<float*>(x), static_cast<const float*>(mre),
                                          static_cast<const float*>(mim), batch, pstride, n, bps,
                                          swap, hb, static_cast<cudaStream_t>(stream)});
}

// out: a host int, set to the blocks of the (k, low) instance one SM keeps
// resident (the wrapper sizes the grid to one wave of them). Returns a
// cudaError_t.
extern "C" int dq_planar_apply_blocks_per_sm(int k, int low, void* out, int device, void*) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || low < 0 || low > 2 || low > k) return cudaErrorInvalidValue;
  return dq::quad_dispatch(k, low, Resident{static_cast<int*>(out)});
}
