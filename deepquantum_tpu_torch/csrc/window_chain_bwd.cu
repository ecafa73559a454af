// K4 window_chain_bwd: the adjoint backward of a whole scheduled sequence of
// ('win', 7) and ('rot', d) steps in ONE cooperative persistent launch. It
// carries the chain's final state y and its cotangent g through the steps
// in reverse: at a window x = W^H y, dW = g x^H in split planes
//   dWre = gr xr^T + gi xi^T,  dWim = gi xr^T - gr xi^T
// (old g, new x), then g = W^H g; at a relabel both are relabelled back. It
// leaves the chain's input state, the input cotangent and one dW per window.
//
// Replaces the TPU kernel deepquantum_tpu/ops/chain_kernel.py::window_chain_bwd
// (Pallas; body _bwd_kernel, tables _step_tables).
//
// Bound on the H100: by count the FP32 CUDA cores (per window 2 x 2^(n-7)
// columns x 131k flop for the two W^H products and 4 real (128 x R)(R x 128)
// products for dW; the states, at most 4 x 4 MiB, and the window stacks
// stay in the 50 MB L2), in practice the latency of the walk, as for K3.
// The design is K3's (window_chain.cu): one cooperative launch sized by the
// occupancy calculator, a device-side step table (here in walk order: the
// forward's reversed, every delta n - d), grid.sync() between phases,
// relabels through shared-memory transposes into the partner buffer. What
// the backward adds:
//
// - W^H without a transposed tile body: the wrapper hands over the
//   (W_re^T, -W_im^T) stacks, so a window step is the same window_tile.
// - Ordering inside a win step. dW needs the OLD g and the NEW x, so phase 1
//   writes x in place over y but writes g' = W^H g into g's partner buffer,
//   leaving the old g intact; after a grid.sync() phase 2 reduces dW from
//   (old g, new x); the g buffers then swap, as they do at a relabel. Two
//   grid-wide barriers per win step, one per rot step.
// - dW is a reduction over all 2^(n-7) columns, which phase 1 spreads over
//   blocks. Phase 2 is therefore tiled over the OUTPUT: each 8 x 16 patch of
//   the 128 x 128 planes belongs to one block, which streams its 8 rows of g
//   and 16 rows of x from L2 over all columns in 64-column chunks through
//   shared memory, two threads per entry (one per half chunk) in FP32 FMA.
//   The sum's order is fixed, so a gradient is reproducible from run to
//   run; per-block partial sums added with float atomics would not be.
//   dW goes straight to the window's slot in forward order (the table
//   carries the forward index), so nothing is reversed afterwards.
//
// The TPU kernel's per-step zero window blocks, its zero dW at rot steps and
// its bf16 x6 / x3 split products are not carried over.

#include <cooperative_groups.h>

#include "window_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChainCols = 16;   // tile columns of a win step
constexpr int kDwRows = 8;       // dW patch: rows of g
constexpr int kDwCols = 16;      // dW patch: rows of x
constexpr int kDwChunk = 64;     // columns staged at a time
constexpr int kDwTiles = (dq::kWinRows / kDwRows) * (dq::kWinRows / kDwCols);
using dq::kT;

struct DwSmem {
  float g[2][kDwRows][kDwChunk + 1];   // padded: conflict-free row reads
  float x[2][kDwCols][kDwChunk + 1];
  float red[2][kDwRows * kDwCols];
};

static_assert(kDwRows * kDwCols * 2 == dq::kWinThreads, "two threads per dW entry");
static_assert(sizeof(dq::WindowSmem<kChainCols>) >= sizeof(float) * kT * (kT + 1),
              "the transpose tile must fit the window tile's shared memory");
static_assert(sizeof(dq::WindowSmem<kChainCols>) >= sizeof(DwSmem),
              "the dW patch must fit the window tile's shared memory");

// One 8 x 16 patch of dW = g x^H (both planes) over all R columns. g and x
// are (2, 128, R) planes written earlier in the launch (plain loads).
__device__ void dw_tile(const float* g, const float* x, float* dwre, float* dwim, int64_t N,
                        int64_t R, int tile, DwSmem& s) {
  constexpr int kPatch = kDwRows * kDwCols;
  const int i0 = (tile / (dq::kWinRows / kDwCols)) * kDwRows;
  const int j0 = (tile % (dq::kWinRows / kDwCols)) * kDwCols;
  const int t = threadIdx.x;
  const int o = t % kPatch;
  const int half = t / kPatch;
  const int i = o / kDwCols;
  const int j = o % kDwCols;
  float are = 0.f;
  float aim = 0.f;
  for (int64_t c0 = 0; c0 < R; c0 += kDwChunk) {
    __syncthreads();   // the previous chunk is consumed
    for (int e = t; e < 2 * kDwRows * kDwChunk; e += dq::kWinThreads) {
      const int p = e / (kDwRows * kDwChunk);
      const int r = (e / kDwChunk) % kDwRows;
      const int c = e % kDwChunk;
      s.g[p][r][c] = g[p * N + (i0 + r) * R + c0 + c];
    }
    for (int e = t; e < 2 * kDwCols * kDwChunk; e += dq::kWinThreads) {
      const int p = e / (kDwCols * kDwChunk);
      const int r = (e / kDwChunk) % kDwCols;
      const int c = e % kDwChunk;
      s.x[p][r][c] = x[p * N + (j0 + r) * R + c0 + c];
    }
    __syncthreads();
    const int cb = half * (kDwChunk / 2);
#pragma unroll 8
    for (int c = cb; c < cb + kDwChunk / 2; ++c) {
      const float gr = s.g[0][i][c];
      const float gi = s.g[1][i][c];
      const float xr = s.x[0][j][c];
      const float xi = s.x[1][j][c];
      are = fmaf(gr, xr, fmaf(gi, xi, are));
      aim = fmaf(gi, xr, fmaf(-gr, xi, aim));
    }
  }
  if (half == 1) {
    s.red[0][o] = are;
    s.red[1][o] = aim;
  }
  __syncthreads();
  if (half == 0) {
    dwre[(i0 + i) * dq::kWinRows + j0 + j] = are + s.red[0][o];
    dwim[(i0 + i) * dq::kWinRows + j0 + j] = aim + s.red[1][o];
  }
  __syncthreads();   // shared memory is reused by the next patch
}

// table: nstep rows of (kind, delta, window index) in WALK order; kind 1 =
// window (index into the stacks, forward order), 0 = relabel by delta.
// ya/ga hold the final state and its cotangent. y changes buffer at every
// relabel, g at every step.
__global__ void __launch_bounds__(dq::kWinThreads)
window_chain_bwd_kernel(const int* __restrict__ table, int nstep,
                        const float* __restrict__ wre_t, const float* __restrict__ wim_t,
                        float* ya, float* yb, float* ga, float* gb, float* dwre, float* dwim,
                        int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem_raw[];
  auto& win = *reinterpret_cast<dq::WindowSmem<kChainCols>*>(smem_raw);
  auto& dws = *reinterpret_cast<DwSmem*>(smem_raw);
  auto tile = reinterpret_cast<float (*)[kT + 1]>(smem_raw);
  constexpr int64_t kPlane = int64_t(dq::kWinRows) * dq::kWinRows;
  const int64_t N = int64_t(1) << n;
  const int64_t R = N >> 7;
  const int64_t win_tiles = R / kChainCols;
  float* ycur = ya;
  float* ynxt = yb;
  float* gcur = ga;
  float* gnxt = gb;
  for (int s = 0; s < nstep; ++s) {
    if (table[3 * s] == 1) {
      const int64_t w = table[3 * s + 2];
      const float* wr = wre_t + w * kPlane;
      const float* wi = wim_t + w * kPlane;
      // phase 1: x = W^H y in place, g' = W^H g into the partner buffer
      for (int64_t item = blockIdx.x; item < 2 * win_tiles; item += gridDim.x) {
        const int64_t c0 = (item >> 1) * kChainCols;
        if (item & 1) {
          dq::window_tile<kChainCols>(wr, wi, gcur, gcur + N, gnxt, gnxt + N, R, c0, win);
        } else {
          dq::window_tile<kChainCols>(wr, wi, ycur, ycur + N, ycur, ycur + N, R, c0, win);
        }
      }
      grid.sync();
      // phase 2: dW from the old g and the new x
      for (int t = blockIdx.x; t < kDwTiles; t += gridDim.x) {
        dw_tile(gcur, ycur, dwre + w * kPlane, dwim + w * kPlane, N, R, t, dws);
      }
    } else {
      const int d = table[3 * s + 1];
      dq::rotate_planes(ycur, ynxt, n, d, tile);
      dq::rotate_planes(gcur, gnxt, n, d, tile);
      float* tmp = ycur;
      ycur = ynxt;
      ynxt = tmp;
    }
    float* tmp = gcur;
    gcur = gnxt;
    gnxt = tmp;
    grid.sync();
  }
}

}  // namespace

// table: (nstep, 3) int32 on the device, walk order; wre_t/wim_t:
// (n_win, 128, 128) float32 planes of W^H per window, forward order; ya, ga:
// (2, 2^n) float32 final state and cotangent, also work buffers; yb, gb:
// (2, 2^n) work buffers; dwre/dwim: (n_win, 128, 128) float32, every slot
// written; 14 <= n <= 19 and every relabel delta in [7, n - 7]. The input
// state ends in ya after an even number of relabels, else in yb; the input
// cotangent in ga after an even number of steps, else in gb. Returns a
// cudaError_t; cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident.
extern "C" int dq_window_chain_bwd_f32(const void* table, int nstep, const void* wre_t,
                                       const void* wim_t, void* ya, void* yb, void* ga, void* gb,
                                       void* dwre, void* dwim, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 14 || n > 19 || nstep < 1) return cudaErrorInvalidValue;
  int coop = 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(dq::WindowSmem<kChainCols>));
  err = cudaFuncSetAttribute(window_chain_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_chain_bwd_kernel,
                                                      dq::kWinThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t N = int64_t(1) << n;
  int64_t work = 2 * ((N >> 7) / kChainCols);               // win items, y and g
  if (work < 2 * N / (kT * kT)) work = 2 * N / (kT * kT);   // transpose tiles of one state
  if (work < kDwTiles) work = kDwTiles;
  int64_t blocks = int64_t(per_sm) * sms;
  if (blocks > work) blocks = work;
  const int* tab = static_cast<const int*>(table);
  const float* wr = static_cast<const float*>(wre_t);
  const float* wi = static_cast<const float*>(wim_t);
  float* pya = static_cast<float*>(ya);
  float* pyb = static_cast<float*>(yb);
  float* pga = static_cast<float*>(ga);
  float* pgb = static_cast<float*>(gb);
  float* pdr = static_cast<float*>(dwre);
  float* pdi = static_cast<float*>(dwim);
  void* args[] = {&tab, &nstep, &wr, &wi, &pya, &pyb, &pga, &pgb, &pdr, &pdi, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(window_chain_bwd_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(dq::kWinThreads),
                                    args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
