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
// x 2^n x 4 B) and writes 2 x 4^k floats per sample; it does 4 * 4^k FMA per
// group that moves 32 * 2^k bytes, at most 2 flop/B at k = 3. So the design
// spends nothing on arithmetic and as little as it can on the sum over
// groups:
// - K1's access plan (planar_quad.cuh): 16-byte float4 loads, a unit of
//   2^(k - LOW) quads per plane holding 4 / 2^LOW whole groups, 32-bit
//   indices. At k = 3 the 2 x 64 partial sums would not fit beside the 64
//   loaded x values, so two neighbouring threads share a unit and take four
//   rows each (SPLIT = 2; x is loaded by both, g's quads by their owner);
// - a grid of one wave of the blocks the card keeps resident for the
//   instance, spread over the batch (the wrapper's gate_blocks, from
//   dq_planar_grad_blocks_per_sm), each thread
//   walking many groups (two units at a time at k = 1) with its 2 x 4^k / SPLIT
//   partial sums in registers, so the block reduction (warp shuffles, then
//   shared memory; planar_group.cuh) is paid once per many groups;
// - the sum across blocks in the same launch: every block writes its
//   (2, D, D) partial to a workspace, fences, and counts itself in at its
//   sample's arrival counter; the block that arrives last sums the sample's
//   partials in a fixed order (slice s of its threads adds blocks s, s + S,
//   ... in ascending order, eight 16-byte loads in flight a thread, then the
//   S slices in order), writes the final
//   planes and sets the counter back to 0 for the next launch. The order does
//   not depend on which block arrives last, so dW is the same bits from run
//   to run; float atomics into the planes would not be. The workspace and
//   the zeroed counters belong to the wrapper (one set per device and
//   stream, grown when needed); the kernel allocates nothing.
// The JAX package sums its kernel's per-block partials outside the kernel
// because a TPU grid runs in order on one core; here the blocks run in
// parallel and the sum finishes in the same launch. The TPU kernel's
// version/roll machinery and its SMEM scalar stores are not carried over.
//
// Batched form (the JAX kernel's leading batch grid axis): g and x are
// (B, 2, 2^n) stacks and the planes (B, 2^k, 2^k). The sample is a grid
// axis of bps consecutive blocks, with its own counter and partial slots.

#include "planar_group.cuh"
#include "planar_quad.cuh"

namespace {

constexpr int kThreads = dq::kQuadThreads;
constexpr int kBatch = 8;   // loads in flight per thread in the last block's sum
static_assert(kThreads == dq::kGateThreads, "block_reduce_planes sums kGateThreads threads");

// add one unit's groups into a thread's rows of the partial sums
template <int K, int LOW, int SPLIT>
__device__ __forceinline__ void reduce_unit(const float4 (&xq)[2][1 << (K - LOW)],
                                            const float4 (&gq)[2][(1 << K) / SPLIT >> LOW],
                                            float (&are)[(1 << K) / SPLIT * (1 << K)],
                                            float (&aim)[(1 << K) / SPLIT * (1 << K)],
                                            bool swap) {
  constexpr int D = 1 << K;
  constexpr int NQ = 1 << (K - LOW);
  constexpr int NQO = D / SPLIT >> LOW;
  constexpr int CL = 1 << LOW;
  float xa[NQ][4];
  float xb[NQ][4];
  float ga[NQO][4];
  float gb[NQO][4];
#pragma unroll
  for (int ch = 0; ch < NQ; ++ch) {
    dq::unpack_quad(xq[0][ch], xa[ch], swap);
    dq::unpack_quad(xq[1][ch], xb[ch], swap);
  }
#pragma unroll
  for (int m = 0; m < NQO; ++m) {
    dq::unpack_quad(gq[0][m], ga[m], swap);
    dq::unpack_quad(gq[1][m], gb[m], swap);
  }
#pragma unroll
  for (int m = 0; m < NQO; ++m) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int s = LOW == 0 ? l : (LOW == 1 ? l >> 1 : 0);   // the lane's group
      const int i = (m << LOW) | (LOW == 0 ? 0 : (LOW == 1 ? (l & 1) : l));   // own row
      const float a = ga[m][l];
      const float b = gb[m][l];
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
#pragma unroll
        for (int cl = 0; cl < CL; ++cl) {
          const int j = (ch << LOW) | cl;
          const int lc = dq::quad_lane<LOW>(s, cl);
          are[i * D + j] = fmaf(a, xa[ch][lc], fmaf(b, xb[ch][lc], are[i * D + j]));
          aim[i * D + j] = fmaf(b, xa[ch][lc], fmaf(-a, xb[ch][lc], aim[i * D + j]));
        }
      }
    }
  }
}

// min 1 block an SM: left to itself ptxas holds the k = 3, low = 1 instance
// at 128 registers and spills; it takes 164 without a spill
template <int K, int LOW, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
planar_grad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   float* __restrict__ out, float* __restrict__ parts,
                   unsigned* __restrict__ count, unsigned units, unsigned quads, unsigned bps,
                   int hb0, int hb1, int hb2, int swap_lanes) {
  constexpr int D = 1 << K;
  constexpr int NQ = 1 << (K - LOW);
  constexpr int ROWS = D / SPLIT;
  constexpr int NQO = ROWS >> LOW;   // the quads of g that hold a thread's rows
  constexpr int E = 2 * D * D;
  constexpr int E4 = E / 4;          // float4 of a partial
  constexpr int S = kThreads / E4;   // slices of the last block's sum
  constexpr int UNROLL = K == 1 ? 2 : 1;
  static_assert(NQO >= 1 && kThreads % E4 == 0, "a thread's rows fill whole quads");
  __shared__ float red[kThreads / 32][E];
  __shared__ float4 fin[kThreads];
  __shared__ unsigned arrived;
  const unsigned sample = blockIdx.x / bps;
  const unsigned lb = blockIdx.x - sample * bps;
  const float4* gr = reinterpret_cast<const float4*>(g) + size_t(sample) * 2 * quads;
  const float4* gi = gr + quads;
  const float4* xr = reinterpret_cast<const float4*>(x) + size_t(sample) * 2 * quads;
  const float4* xi = xr + quads;
  const dq::QuadPlan<K - LOW> plan(hb0, hb1, hb2);
  const bool swap = LOW == 1 && swap_lanes;
  const int sub = threadIdx.x % SPLIT;   // the thread's rows: sub * ROWS ...
  unsigned goff[NQO];
#pragma unroll
  for (int m = 0; m < NQO; ++m) goff[m] = plan.offset(sub * NQO + m);
  float are[ROWS * D];
  float aim[ROWS * D];
#pragma unroll
  for (int e = 0; e < ROWS * D; ++e) {
    are[e] = 0.f;
    aim[e] = 0.f;
  }
  const unsigned stride = bps * (kThreads / SPLIT);
  unsigned u = (lb * kThreads + threadIdx.x) / SPLIT;
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    float4 xq[UNROLL][2][NQ];
    float4 gq[UNROLL][2][NQO];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const unsigned q = plan.base(u + r * stride);
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        xq[r][0][ch] = xr[q + plan.off[ch]];
        xq[r][1][ch] = xi[q + plan.off[ch]];
      }
#pragma unroll
      for (int m = 0; m < NQO; ++m) {
        gq[r][0][m] = gr[q + goff[m]];
        gq[r][1][m] = gi[q + goff[m]];
      }
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) reduce_unit<K, LOW, SPLIT>(xq[r], gq[r], are, aim, swap);
  }
  if constexpr (UNROLL > 1) {
    if (u < units) {   // the last unit of a thread with an odd count
      const unsigned q = plan.base(u);
      float4 xq[2][NQ];
      float4 gq[2][NQO];
#pragma unroll
      for (int ch = 0; ch < NQ; ++ch) {
        xq[0][ch] = xr[q + plan.off[ch]];
        xq[1][ch] = xi[q + plan.off[ch]];
      }
#pragma unroll
      for (int m = 0; m < NQO; ++m) {
        gq[0][m] = gr[q + goff[m]];
        gq[1][m] = gi[q + goff[m]];
      }
      reduce_unit<K, LOW, SPLIT>(xq, gq, are, aim, swap);
    }
  }

  // the block's partial, then the sample's arrival count
  float* smp = parts + size_t(sample) * bps * E;
  dq::block_reduce_planes<D, SPLIT>(are, aim, smp + size_t(lb) * E, red);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) arrived = atomicAdd(count + sample, 1u);
  __syncthreads();
  if (arrived != bps - 1) return;

  // the last block: the sample's partials in a fixed order. Thread t adds
  // float4 t % E4 of blocks t / E4, t / E4 + S, ... (S slices), kBatch
  // independent 16-byte loads in flight; then the slices in order.
  __threadfence();
  const int e4 = threadIdx.x % E4;
  const unsigned sl = threadIdx.x / E4;
  const float4* p4 = reinterpret_cast<const float4*>(smp) + e4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (unsigned b0 = sl; b0 < bps; b0 += kBatch * S) {
    float4 v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const unsigned b = b0 + r * S;
      v[r] = b < bps ? __ldcg(p4 + size_t(b) * E4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      sum.x += v[r].x;
      sum.y += v[r].y;
      sum.z += v[r].z;
      sum.w += v[r].w;
    }
  }
  fin[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < E) {
    const float* f = reinterpret_cast<const float*>(fin);
    float t = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) t += f[j * E + threadIdx.x];   // slice j, element e
    out[size_t(sample) * E + threadIdx.x] = t;
  }
  if (threadIdx.x == 0) count[sample] = 0u;
}

struct Launch {
  const float* g;
  const float* x;
  float* out;
  float* parts;
  unsigned* count;
  int batch, n, bps, swap;
  const int* hb;
  cudaStream_t s;

  template <int K, int LOW>
  int run() const {
    constexpr int SPLIT = K == 3 ? 2 : 1;
    const unsigned quads = 1u << (n - 2);
    const unsigned units = quads >> (K - LOW);
    const dim3 grid(static_cast<unsigned>(bps) * static_cast<unsigned>(batch));
    planar_grad_kernel<K, LOW, SPLIT><<<grid, kThreads, 0, s>>>(
        g, x, out, parts, count, units, quads, static_cast<unsigned>(bps), hb[0], hb[1], hb[2],
        swap);
    return cudaGetLastError();
  }
};

struct Resident {
  int* out;

  template <int K, int LOW>
  int run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, planar_grad_kernel<K, LOW, K == 3 ? 2 : 1>, kThreads, 0);
  }
};

}  // namespace

// g, x: (batch, 2, 2^n) float32 planes, 16-byte aligned, read only (batch
// 1: one (2, 2^n) state each); out: (batch, 2, 2^k, 2^k) float32, all
// written; parts: batch * bps * 2 * 4^k float32 of workspace; count: batch
// unsigned arrival counters, 0 on entry and left 0; low, swap, hb0..hb2:
// the access plan of planar_quad.cuh; bps: blocks per sample. Launches on
// one stream must not overlap on one workspace. 2 <= n <= 33. Returns a
// cudaError_t.
extern "C" int dq_planar_grad_f32(const void* g, const void* x, void* out, void* parts,
                                  void* count, int batch, int n, int k, int low, int swap,
                                  int hb0, int hb1, int hb2, int bps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int hb[3] = {hb0, hb1, hb2};
  if (dq::bad_plan(n, k, low, swap, hb) || batch < 1 || bps < 1 || bps > (1 << 22) ||
      uint64_t(bps) * uint64_t(batch) >= (uint64_t(1) << 31) ||
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(x)) & 15) != 0)
    return cudaErrorInvalidValue;
  return dq::quad_dispatch(
      k, low, Launch{static_cast<const float*>(g), static_cast<const float*>(x),
                     static_cast<float*>(out), static_cast<float*>(parts),
                     static_cast<unsigned*>(count), batch, n, bps, swap, hb,
                     static_cast<cudaStream_t>(stream)});
}

// out: a host int, set to the blocks of the (k, low) instance one SM keeps
// resident (the wrapper sizes the grid to one wave of them). Returns a
// cudaError_t.
extern "C" int dq_planar_grad_blocks_per_sm(int k, int low, void* out, int device, void*) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || k > 3 || low < 0 || low > 2 || low > k) return cudaErrorInvalidValue;
  return dq::quad_dispatch(k, low, Resident{static_cast<int*>(out)});
}
