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
// 6 flop/B at k = 3. The design is K1's and K5's (planar_quad.cuh,
// planar_reduce.cuh):
// - 16-byte float4 accesses: a unit is 2^(k - LOW) quads per plane, 4 / 2^LOW
//   whole groups, of y and of g, both updated in place;
// - at k = 3 a unit's 2 x 64 loaded floats, its 64 recovered x and the
//   2 x 64 partial sums would not fit one thread, so SPLIT neighbouring
//   threads share a unit (4, or 2 where the gate holds amplitude bits 0-1
//   and a quad is one group's four rows). Each loads the whole unit (the
//   same addresses in one warp instruction: one L1 access), computes and
//   stores its own quads of x and of g', and reduces every row of the raw g
//   against its own columns of x, so no value has to pass between them and
//   nothing is computed twice. They meet at __syncwarp before the first
//   store, so that none overwrites what another has still to load;
// - a grid of one wave of the blocks the card keeps resident for the
//   instance, spread over the batch (the wrapper's gate_blocks, from
//   dq_planar_bwd_fused_blocks_per_sm), each thread walking many units
//   (two at a time at k = 1) with its partial sums in registers;
// - the sum over blocks in the same launch (planar_reduce.cuh): a partial
//   per block, an arrival counter per sample, the last block sums them in
//   a fixed order; dW is the same bits from run to run and a call is one
//   device operation.
//
// Batched form (the JAX kernel's leading batch grid axis): y and g are
// (B, 2, 2^n) stacks, the planes (B, 2^k, 2^k) or one set broadcast to every
// sample. The sample is a grid axis of bps consecutive blocks, each staging
// its own sample's planes, with its own counter and partial slots.

#include "planar_quad.cuh"
#include "planar_reduce.cuh"

namespace {

constexpr int kThreads = dq::kQuadThreads;

// threads that share a unit: 4 at k = 3 (2 where the quads are one group's
// rows), else 1
template <int K, int LOW>
__host__ __device__ constexpr int split_of() {
  return K < 3 ? 1 : (LOW == 2 ? 2 : 4);
}

// one unit: x = M y and g' = M g stored for the thread's own quads, and the
// raw g's rows against its own columns of x added to the partial sums
template <int K, int LOW, int SPLIT>
__device__ __forceinline__ void step_unit(float4* yr, float4* yi, float4* gr, float4* gi,
                                          unsigned q0, const unsigned (&own)[(1 << K) / SPLIT >> LOW],
                                          const float4 (&q)[4][1 << (K - LOW)],
                                          const dq::Planes<K>& m, int sub, unsigned mask,
                                          float (&are)[(1 << K) * (1 << K) / SPLIT],
                                          float (&aim)[(1 << K) * (1 << K) / SPLIT], bool swap) {
  constexpr int NQ = 1 << (K - LOW);
  constexpr int COLS = (1 << K) / SPLIT;   // the thread's columns sub * COLS ...
  constexpr int NQO = COLS >> LOW;          // ... in its quads sub * NQO ...
  constexpr int CL = 1 << LOW;
  float ya[NQ][4];
  float yb[NQ][4];
  float ga[NQ][4];
  float gb[NQ][4];
#pragma unroll
  for (int ch = 0; ch < NQ; ++ch) {
    dq::unpack_quad(q[0][ch], ya[ch], swap);
    dq::unpack_quad(q[1][ch], yb[ch], swap);
    dq::unpack_quad(q[2][ch], ga[ch], swap);
    dq::unpack_quad(q[3][ch], gb[ch], swap);
  }
  float xa[NQO][4];
  float xb[NQO][4];
#pragma unroll
  for (int mq = 0; mq < NQO; ++mq) dq::mat_quad<K, LOW>(m, sub * NQO + mq, ya, yb, xa[mq], xb[mq]);
  if constexpr (SPLIT > 1) __syncwarp(mask);   // the unit's other threads have loaded it too
#pragma unroll
  for (int mq = 0; mq < NQO; ++mq) {
    yr[q0 + own[mq]] = dq::pack_quad(xa[mq], swap);
    yi[q0 + own[mq]] = dq::pack_quad(xb[mq], swap);
  }
  // every row i of the raw g against the own columns j of x
#pragma unroll
  for (int mq = 0; mq < NQO; ++mq) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int s = LOW == 0 ? l : (LOW == 1 ? l >> 1 : 0);   // the lane's group
      const int j = (mq << LOW) | (LOW == 0 ? 0 : (LOW == 1 ? (l & 1) : l));   // own column
      const float xr = xa[mq][l];
      const float xi = xb[mq][l];
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
#pragma unroll
        for (int cl = 0; cl < CL; ++cl) {
          const int i = (ch << LOW) | cl;
          const int lc = dq::quad_lane<LOW>(s, cl);
          are[i * COLS + j] = fmaf(ga[ch][lc], xr, fmaf(gb[ch][lc], xi, are[i * COLS + j]));
          aim[i * COLS + j] = fmaf(gb[ch][lc], xr, fmaf(-ga[ch][lc], xi, aim[i * COLS + j]));
        }
      }
    }
  }
  // g' = M g, own quads
#pragma unroll
  for (int mq = 0; mq < NQO; ++mq) {
    float r[4];
    float i[4];
    dq::mat_quad<K, LOW>(m, sub * NQO + mq, ga, gb, r, i);
    gr[q0 + own[mq]] = dq::pack_quad(r, swap);
    gi[q0 + own[mq]] = dq::pack_quad(i, swap);
  }
}

template <int K, int LOW>
__global__ void __launch_bounds__(kThreads, 1)
planar_bwd_fused_kernel(float* y, float* g, const float* __restrict__ mre,
                        const float* __restrict__ mim, float* __restrict__ out,
                        float* __restrict__ parts, unsigned* __restrict__ count, unsigned units,
                        unsigned quads, unsigned bps, int pstride, int hb0, int hb1, int hb2,
                        int swap_lanes) {
  constexpr int D = 1 << K;
  constexpr int NQ = 1 << (K - LOW);
  constexpr int SPLIT = split_of<K, LOW>();
  constexpr int NQO = (D / SPLIT) >> LOW;
  constexpr int UNROLL = K == 1 ? 2 : 1;
  static_assert(NQO >= 1, "a thread's columns fill whole quads");
  const unsigned sample = blockIdx.x / bps;
  const unsigned lb = blockIdx.x - sample * bps;
  float4* yr = reinterpret_cast<float4*>(y) + size_t(sample) * 2 * quads;
  float4* yi = yr + quads;
  float4* gr = reinterpret_cast<float4*>(g) + size_t(sample) * 2 * quads;
  float4* gi = gr + quads;
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
  const int sub = threadIdx.x % SPLIT;
  // the lanes of the thread's unit, for __syncwarp
  const unsigned mask = ((1u << SPLIT) - 1u) << ((threadIdx.x & 31) & ~(SPLIT - 1));
  unsigned own[NQO];
#pragma unroll
  for (int mq = 0; mq < NQO; ++mq) own[mq] = plan.offset(sub * NQO + mq);
  float are[D * D / SPLIT];
  float aim[D * D / SPLIT];
#pragma unroll
  for (int e = 0; e < D * D / SPLIT; ++e) {
    are[e] = 0.f;
    aim[e] = 0.f;
  }
  // the threads of a unit take the same units, so they meet at __syncwarp
  // equally often
  const unsigned stride = bps * (kThreads / SPLIT);
  unsigned u = (lb * kThreads + threadIdx.x) / SPLIT;
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    unsigned q0[UNROLL];
    float4 q[UNROLL][4][NQ];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      q0[r] = plan.base(u + r * stride);
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        q[r][0][ch] = yr[q0[r] + plan.off[ch]];
        q[r][1][ch] = yi[q0[r] + plan.off[ch]];
        q[r][2][ch] = gr[q0[r] + plan.off[ch]];
        q[r][3][ch] = gi[q0[r] + plan.off[ch]];
      }
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r)
      step_unit<K, LOW, SPLIT>(yr, yi, gr, gi, q0[r], own, q[r], m, sub, mask, are, aim, swap);
  }
  if constexpr (UNROLL > 1) {
    if (u < units) {   // the last unit of a thread with an odd count
      const unsigned q0 = plan.base(u);
      float4 q[4][NQ];
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        q[0][ch] = yr[q0 + plan.off[ch]];
        q[1][ch] = yi[q0 + plan.off[ch]];
        q[2][ch] = gr[q0 + plan.off[ch]];
        q[3][ch] = gi[q0 + plan.off[ch]];
      }
      step_unit<K, LOW, SPLIT>(yr, yi, gr, gi, q0, own, q, m, sub, mask, are, aim, swap);
    }
  }
  dq::sum_planes<D, SPLIT, true>(are, aim, out, parts, count, sample, lb, bps);
}

struct Launch {
  float* y;
  float* g;
  const float* mr;
  const float* mi;
  float* out;
  float* parts;
  unsigned* count;
  int batch, pstride, n, bps, swap;
  const int* hb;
  cudaStream_t s;

  template <int K, int LOW>
  int run() const {
    const unsigned quads = 1u << (n - 2);
    const unsigned units = quads >> (K - LOW);
    const dim3 grid(static_cast<unsigned>(bps) * static_cast<unsigned>(batch));
    planar_bwd_fused_kernel<K, LOW><<<grid, kThreads, 0, s>>>(
        y, g, mr, mi, out, parts, count, units, quads, static_cast<unsigned>(bps), pstride, hb[0],
        hb[1], hb[2], swap);
    return cudaGetLastError();
  }
};

struct Resident {
  int* out;

  template <int K, int LOW>
  int run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, planar_bwd_fused_kernel<K, LOW>,
                                                         kThreads, 0);
  }
};

}  // namespace

// y, g: (batch, 2, 2^n) float32 planes, 16-byte aligned, both updated in
// place (two different buffers; batch 1: one (2, 2^n) state each);
// mre/mim: (2^k, 2^k) float32 planes of U^H in sorted-wire order, one per
// sample pstride floats apart (pstride 0: the same planes for every sample);
// out: (batch, 2, 2^k, 2^k) float32, all written; parts: batch * bps * 2 *
// 4^k float32 of workspace; count: batch unsigned arrival counters, 0 on
// entry and left 0; low, swap, hb0..hb2: the access plan of planar_quad.cuh;
// bps: blocks per sample. Launches on one stream must not overlap on one
// workspace. 2 <= n <= 33. Returns a cudaError_t.
extern "C" int dq_planar_bwd_fused_f32(void* y, void* g, const void* mre, const void* mim,
                                       void* out, void* parts, void* count, int batch, int pstride,
                                       int n, int k, int low, int swap, int hb0, int hb1, int hb2,
                                       int bps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int hb[3] = {hb0, hb1, hb2};
  if (dq::bad_plan(n, k, low, swap, hb) || batch < 1 || pstride < 0 || bps < 1 ||
      bps > (1 << 22) || uint64_t(bps) * uint64_t(batch) >= (uint64_t(1) << 31) || y == g ||
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(g)) & 15) != 0)
    return cudaErrorInvalidValue;
  return dq::quad_dispatch(
      k, low, Launch{static_cast<float*>(y), static_cast<float*>(g),
                     static_cast<const float*>(mre), static_cast<const float*>(mim),
                     static_cast<float*>(out), static_cast<float*>(parts),
                     static_cast<unsigned*>(count), batch, pstride, n, bps, swap, hb,
                     static_cast<cudaStream_t>(stream)});
}

// out: a host int, set to the blocks of the (k, low) instance one SM keeps
// resident (the wrapper sizes the grid to one wave of them). Returns a
// cudaError_t.
extern "C" int dq_planar_bwd_fused_blocks_per_sm(int k, int low, void* out, int device, void*) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || low < 0 || low > 2 || low > k) return cudaErrorInvalidValue;
  return dq::quad_dispatch(k, low, Resident{static_cast<int*>(out)});
}
