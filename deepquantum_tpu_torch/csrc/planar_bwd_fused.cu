// K6 planar_bwd_fused: one backward step of a gate on k <= 3 wires in one
// pass over two states. From the gate's output y, the output cotangent g
// and the planes of U^H it gives, in place, x = U^H y (the gate's input)
// and g' = U^H g (the input cotangent), and the matrix-plane cotangents
//   dRe[i][j] = sum_m gr_i[m] xr_j[m] + gi_i[m] xi_j[m]
//   dIm[i][j] = sum_m gi_i[m] xr_j[m] - gr_i[m] xi_j[m]
// reduced from the RAW g (as loaded, before it is overwritten) against the
// recovered x.
//
// Replaces the TPU kernel deepquantum_tpu/ops/planar_gate.py::_planar_bwd_fused
// (Pallas; body _bwd_fused_kernel_body).
//
// Bound on the H100: device memory. The three-launch step (K1 on y, K5,
// K1 on g) moves six state units (R+W, 2R, R+W); this pass moves four
// (2R + 2W: 4 x 2 planes x 2^n x 4 B) for the same arithmetic, at most
// 6 flop/B at k = 3. The design is K1's and K5's together: one thread owns
// one group of y AND the same group of g (planar_group.cuh), so both updates
// are in place with no hazard between groups, and the partial sums stay in
// registers over a grid-stride loop and leave as one deterministic partial
// per block (see planar_grad.cu), summed by the wrapper. At k = 3 two
// neighbouring threads share a group (SPLIT = 2): both load all of y and g,
// meet at __syncwarp() so that neither stores before the other has loaded,
// both compute all of x (the reduction needs every column), and each stores
// and reduces its own four rows.
//
// Batched form (the JAX kernel's leading batch grid axis): y and g are
// (B, 2, 2^n) stacks, the planes (B, 2^k, 2^k) or one set broadcast to every
// sample. The sample is a grid axis of nblocks consecutive blocks; each
// block stages its own sample's planes and leaves its partial at its grid
// index ((B, nblocks, 2, D, D), summed by the wrapper in a fixed order).

#include "planar_group.cuh"

namespace {

constexpr int kThreads = dq::kGateThreads;

template <int K, int SPLIT, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
planar_bwd_fused_kernel(float* y, float* g, const float* __restrict__ mre,
                        const float* __restrict__ mim, float* __restrict__ parts,
                        uint64_t ngroups, uint64_t dim, unsigned nblocks, int pstride, int bit0,
                        int bit1, int bit2) {
  constexpr int D = 1 << K;
  constexpr int ROWS = D / SPLIT;
  uint64_t sample = 0;
  unsigned lb = blockIdx.x;
  if constexpr (BATCHED) {
    sample = blockIdx.x / nblocks;
    lb = blockIdx.x - unsigned(sample) * nblocks;
  }
  float* yr = y + sample * 2 * dim;
  float* yi = yr + dim;
  float* gr = g + sample * 2 * dim;
  float* gi = gr + dim;
  const float* pr = mre + sample * pstride;
  const float* pi = mim + sample * pstride;
  __shared__ float sre[D * D];
  __shared__ float sim[D * D];
  __shared__ float red[kThreads / 32][2 * D * D];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    sre[e] = pr[e];
    sim[e] = pi[e];
  }
  __syncthreads();
  const int bits[3] = {bit0, bit1, bit2};
  const int sub = threadIdx.x % SPLIT;
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
    float vyr[D];
    float vyi[D];
    float vgr[D];
    float vgi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const uint64_t o = dq::group_offset<K>(base, c, bits);
      vyr[c] = yr[o];
      vyi[c] = yi[o];
      vgr[c] = gr[o];
      vgi[c] = gi[o];
    }
    if (SPLIT > 1) __syncwarp();   // the group's other thread has loaded too
    // x = U^H y: every row (the reduction needs all of x), own rows stored
    float vxr[D];
    float vxi[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float r = 0.f;
      float i = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float mr = sre[a * D + c];
        const float mi = sim[a * D + c];
        r = fmaf(-mi, vyi[c], fmaf(mr, vyr[c], r));
        i = fmaf(mi, vyr[c], fmaf(mr, vyi[c], i));
      }
      vxr[a] = r;
      vxi[a] = i;
      if (a / ROWS == sub) {   // offsets are recomputed, not kept: registers are scarce here
        const uint64_t o = dq::group_offset<K>(base, a, bits);
        yr[o] = r;
        yi[o] = i;
      }
    }
    // own rows: the cotangent partials from the raw g, then g' = U^H g
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if (a / ROWS == sub) {
        const float ga = vgr[a];
        const float gb = vgi[a];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const int e = (a % ROWS) * D + j;
          are[e] = fmaf(ga, vxr[j], fmaf(gb, vxi[j], are[e]));
          aim[e] = fmaf(gb, vxr[j], fmaf(-ga, vxi[j], aim[e]));
        }
        float r = 0.f;
        float i = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float mr = sre[a * D + c];
          const float mi = sim[a * D + c];
          r = fmaf(-mi, vgi[c], fmaf(mr, vgr[c], r));
          i = fmaf(mi, vgr[c], fmaf(mr, vgi[c], i));
        }
        const uint64_t o = dq::group_offset<K>(base, a, bits);
        gr[o] = r;
        gi[o] = i;
      }
    }
  }
  dq::block_reduce_planes<D, SPLIT>(are, aim, parts + uint64_t(blockIdx.x) * 2 * D * D, red);
}

template <int K, int SPLIT>
void launch_bwd_fused(float* y, float* g, const float* mr, const float* mi, float* p, int batch,
                      int pstride, int nblocks, uint64_t ngroups, uint64_t dim, int bit0,
                      int bit1, int bit2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(uint64_t(nblocks) * uint64_t(batch)));
  if (batch == 1) {
    planar_bwd_fused_kernel<K, SPLIT, false><<<grid, kThreads, 0, s>>>(
        y, g, mr, mi, p, ngroups, dim, static_cast<unsigned>(nblocks), 0, bit0, bit1, bit2);
  } else {
    planar_bwd_fused_kernel<K, SPLIT, true><<<grid, kThreads, 0, s>>>(
        y, g, mr, mi, p, ngroups, dim, static_cast<unsigned>(nblocks), pstride, bit0, bit1,
        bit2);
  }
}

}  // namespace

// y, g: (batch, 2, 2^n) float32 planes, both updated in place (two
// different buffers; batch 1: one (2, 2^n) state each); mre/mim:
// (2^k, 2^k) float32 planes of U^H in sorted-wire order, one per sample
// pstride floats apart (pstride 0: the same planes for every sample); parts:
// (batch, nblocks, 2, 2^k, 2^k) float32, one partial per block, all written;
// bit0..bit2: amplitude bits of the sorted wires (unused ones 0).
// nblocks * 256 threads must divide one thread per group (two at k = 3), so
// that the threads that share a group stay in step. Returns a cudaError_t.
extern "C" int dq_planar_bwd_fused_f32(void* y, void* g, const void* mre, const void* mim,
                                       void* parts, int batch, int pstride, int nblocks, int n,
                                       int k, int bit0, int bit1, int bit2, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || n < k || n > 40 || nblocks < 1 || batch < 1 || pstride < 0 || y == g)
    return cudaErrorInvalidValue;
  const uint64_t ngroups = uint64_t(1) << (n - k);
  const uint64_t split = k == 3 ? 2 : 1;
  const uint64_t threads = uint64_t(nblocks) * kThreads;
  if (threads > ngroups * split || (ngroups * split) % threads != 0) return cudaErrorInvalidValue;
  if (uint64_t(nblocks) * uint64_t(batch) >= (uint64_t(1) << 31)) return cudaErrorInvalidValue;
  float* ys = static_cast<float*>(y);
  float* gs = static_cast<float*>(g);
  const float* mr = static_cast<const float*>(mre);
  const float* mi = static_cast<const float*>(mim);
  float* p = static_cast<float*>(parts);
  const uint64_t dim = uint64_t(1) << n;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      launch_bwd_fused<1, 1>(ys, gs, mr, mi, p, batch, pstride, nblocks, ngroups, dim, bit0, bit1,
                             bit2, s);
      break;
    case 2:
      launch_bwd_fused<2, 1>(ys, gs, mr, mi, p, batch, pstride, nblocks, ngroups, dim, bit0, bit1,
                             bit2, s);
      break;
    default:
      launch_bwd_fused<3, 2>(ys, gs, mr, mi, p, batch, pstride, nblocks, ngroups, dim, bit0, bit1,
                             bit2, s);
      break;
  }
  return cudaGetLastError();
}
