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
// Bound on the H100: per window 2 x 2^(n-7) columns x 131k flop for the two
// W^H products and 4 real (128 x R)(R x 128) products for dW, 26.6 GFLOP at
// n = 18 with the bench sequence: 0.397 ms on the FP64 tensor cores this
// body runs (67 TFLOP/s; the FP32 CUDA cores have the same peak), 0.161 ms
// in 3xTF32 (the earlier body, which truncated its sums and missed the 1e-5 bar
// from 10 layers on: window_mma.cuh); the states (at most 4 x 4 MiB) stay
// in the 50 MB L2. The first design reached 8 % of the FP32 bound: its dW
// phase was tiled over 128 output patches, so half of the grid idled while
// each patch streamed 393 KB of states in FP32 FMA, every work item
// re-staged the 128 KB W^H, and it took 119 grid-wide barriers. This design:
//
// - Window step, one pass per block and no barrier inside: a block owns a
//   tile of TC columns (16, or 32 when 16-column tiles would outnumber the
//   blocks). It stages W^H once (the wrapper hands over the
//   (W_re^T, -W_im^T) stacks, so W^H is a plain window product) and both
//   its y tile and its g tile, runs x = W^H y, then g' = W^H g, on the
//   tensor cores (window_mma.cuh: f64 operands and sums, one float32
//   rounding to nearest per result; one state at a time, so that the f64
//   sums of one state are live), writes both back in place (its columns are
//   its own; the old g stays in shared memory), and forms its share of
//   dW = g_old x_new^H from the same shared tiles on the same tensor cores:
//   a rank-TC product in passes of 32 rows, written to the block's slot of a
//   partial buffer. Where the tiles outnumber the grid (n = 19 on a card of
//   fewer than 128 SMs), a block takes tiles blockIdx.x, + gridDim.x, ... in
//   turn, keeps W^H, and adds each tile's product onto its slot in that
//   order.
// - The partials are reduced in a fixed order (slot 0, 1, ...) by all blocks
//   at the start of the next step, after the barrier that ends the window
//   step: no barrier of its own, no float atomics, a gradient bitwise equal
//   from run to run. Two partial buffers alternate by window parity, so a
//   window may follow a window. One barrier more at the end when the walk
//   ends on a window.
// - Relabel step: a run of consecutive relabels arrives as one row (the
//   wrapper adds the deltas mod n), relabelled by one transpose of the
//   (2^d, 2^(n-d)) view (window_rotate.cuh, shared with K3). While it runs,
//   each block that has columns prefetches the next window's W^H into
//   shared memory with cp.async.
// One barrier per table row: 33 window rows and 33 relabel rows at n = 18
// on the bench sequence, against 119.
//
// The TPU kernel's per-step zero window blocks, its zero dW at rot steps and
// its bf16 x6 / x3 split products are not carried over.

#include <cooperative_groups.h>

#include "window_mma.cuh"
#include "window_rotate.cuh"

namespace cg = cooperative_groups;

namespace {

using dq::mma::kRows;
using dq::mma::kThreads;
using dq::mma::kWFloats;
using dq::mma::Tile;
constexpr int64_t kPlane = int64_t(kRows) * kRows;

template <int TC>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (kWFloats + 2 * Tile<TC>::kFloats);
}

static_assert(dq::kRotSmemFloats <= Tile<16>::kFloats, "the transpose tile must fit the g tile");

// The new x of the tile, from the y product's accumulators, into xs as
// [2][128][TC + 4] (this stride keeps the dW product's reads of it free of
// bank conflicts).
template <int TC>
__device__ __forceinline__ void stash_x(const double (&acc)[TC / 8][2][4], float* xs) {
  constexpr int XS = TC + 4;
  static_assert(2 * kRows * XS <= Tile<TC>::kFloats, "the x tile must fit the y tile");
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int j = 0; j < TC / 8; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* at = xs + (p * kRows + m0 + g + 8 * h) * XS + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(at) =
            make_float2(float(acc[j][p][2 * h]), float(acc[j][p][2 * h + 1]));
      }
}

// This block's share of dW = g x^H over the TC columns of its tile, on the
// window body's tensor cores: A = the old g tile (gs, [2][128][TC + 8]),
// B[k][j] = x[j][k] (xs, [2][128][TC + 4]). Warp w owns dW rows
// 64 (w / 4) .. + 64 and columns 32 (w % 4) .. + 32 of each plane, taken
// in passes of 32 rows (32 f64 sums a thread):
//   dWre = gr xr^T + gi xi^T,  dWim = gi xr^T + (-gr) xi^T.
// The result goes to `out` ([2][128][128]) or, with `add`, onto it.
template <int TC>
__device__ __forceinline__ void dw_partial(const float* gs, const float* xs, float* out, bool add) {
  constexpr int GS = Tile<TC>::kStride;
  constexpr int XS = TC + 4;
  constexpr int kMt = 2;                // 16-row tiles a pass
  constexpr int kPasses = 4 / kMt;      // passes a plane
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int i0 = (threadIdx.x / 32 / 4) * 64;
  const int j0 = (threadIdx.x / 32 % 4) * 32;
#pragma unroll 1
  for (int pass = 0; pass < 2 * kPasses; ++pass) {
    const int p = pass / kPasses;       // 0: dWre, 1: dWim
    const int r0 = i0 + (pass % kPasses) * kMt * 16;
    // A for the xr and the xi products: (gr, gi) for dWre, (gi, -gr) for dWim
    const float* ga = gs + (p ? kRows * GS : 0);
    const float* gb = gs + (p ? 0 : kRows * GS);
    double acc[kMt][4][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
    // k is not unrolled, so that one k-step's operands are live at a time
#pragma unroll 1
    for (int k0 = 0; k0 < TC; k0 += 8) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        double aa[4], ab[4];
        const int row = (r0 + mt * 16 + g) * GS + k0 + t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = row + (q & 1) * 8 * GS + (q >> 1) * 4;
          aa[q] = ga[off];
          ab[q] = p ? -gb[off] : gb[off];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* xr = xs + (j0 + nt * 8 + g) * XS + k0 + t;
          const float* xi = xr + kRows * XS;
          const double br[2] = {xr[0], xr[4]};
          const double bi[2] = {xi[0], xi[4]};
          dq::mma::mma_f64(acc[mt][nt], aa, br);
          dq::mma::mma_f64(acc[mt][nt], ab, bi);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* at = reinterpret_cast<float2*>(out + p * kPlane +
                                                 (r0 + mt * 16 + g + 8 * h) * kRows + j0 +
                                                 nt * 8 + 2 * t);
          float2 v = make_float2(float(acc[mt][nt][2 * h]), float(acc[mt][nt][2 * h + 1]));
          if (add) {
            const float2 old = *at;
            v.x += old.x;
            v.y += old.y;
          }
          *at = v;
        }
  }
}

// dW of one window = the sum of slots 0 .. parts - 1 of a partial buffer,
// in that order; every thread of the grid takes entries of both planes.
__device__ void reduce_partials(const float* part, int64_t parts, float* dwre, float* dwim) {
  constexpr int kUnroll = 16;
  const int64_t nth = int64_t(gridDim.x) * kThreads;
  for (int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x; e < 2 * kPlane; e += nth) {
    const float* p = part + e;
    float s = 0.f;
    int64_t k = 0;
    for (; k + kUnroll <= parts; k += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(p + (k + u) * 2 * kPlane);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += v[u];
    }
    for (; k < parts; ++k) s += __ldcg(p + k * 2 * kPlane);
    if (e < kPlane) {
      dwre[e] = s;
    } else {
      dwim[e - kPlane] = s;
    }
  }
}

// table: nstep rows of (kind, delta, window index) in WALK order; kind 1 =
// window (index into the stacks, forward order), 0 = relabel by delta
// (1 <= delta < n; consecutive relabels already merged). ya/ga hold the
// final state and its cotangent; both change buffer at every relabel.
// part: two buffers of `slots` partial slots of (2, 128, 128) floats.
template <int TC>
__global__ void __launch_bounds__(kThreads, 1)
window_chain_bwd_kernel(const int* __restrict__ table, int nstep,
                        const float* __restrict__ wre_t, const float* __restrict__ wim_t,
                        float* ya, float* yb, float* ga, float* gb, float* dwre, float* dwim,
                        float* part, int64_t slots, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);   // W^H of the current window
  float* ys = ws + kWFloats;                        // y tile, then the new x
  float* gs = ys + Tile<TC>::kFloats;               // g tile; a relabel's transpose tile
  const int64_t N = int64_t(1) << n;
  const int64_t R = N >> 7;
  const int64_t items = R / TC;
  const int64_t parts = items < gridDim.x ? items : gridDim.x;
  float* ycur = ya;
  float* ynxt = yb;
  float* gcur = ga;
  float* gnxt = gb;
  int loaded = -1;    // the window whose W^H is in ws or on its way there
  int pending = -1;   // the window whose partials wait for their reduction
  int wins = 0;       // windows walked; their parity picks the partial buffer
  for (int s = 0; s < nstep; ++s) {
    if (pending >= 0) {
      reduce_partials(part + ((wins - 1) & 1) * slots * 2 * kPlane, parts,
                      dwre + pending * kPlane, dwim + pending * kPlane);
      pending = -1;
    }
    if (table[3 * s] == 1) {
      const int w = table[3 * s + 2];
      float* pbuf = part + (wins & 1) * slots * 2 * kPlane + blockIdx.x * 2 * kPlane;
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t c0 = item * TC;
        if (loaded != w) {
          dq::mma::load_window(ws, wre_t + w * kPlane, wim_t + w * kPlane);
          loaded = w;
        }
        dq::mma::load_tile<TC>(ys, ycur, N, R, c0);
        dq::mma::load_tile<TC>(gs, gcur, N, R, c0);
        dq::mma::cp_async_commit();
        dq::mma::cp_async_wait<0>();
        __syncthreads();
        // x = W^H y and g' = W^H g in place, one state after the other:
        // only this block touches these columns in this step, and the old g
        // stays in gs for dW
        double acc[TC / 8][2][4];
        dq::mma::window_product<TC>(ws, ys, acc);
        __syncthreads();   // every warp is done with the y tile
        dq::mma::store_product<TC>(acc, ycur, N, R, c0);
        stash_x<TC>(acc, ys);
        dq::mma::window_product<TC>(ws, gs, acc);
        dq::mma::store_product<TC>(acc, gcur, N, R, c0);
        __syncthreads();
        dw_partial<TC>(gs, ys, pbuf, item != blockIdx.x);
        __syncthreads();   // the tiles are reloaded for the next item
      }
      pending = w;
      ++wins;
    } else {
      if (blockIdx.x < items) {   // prefetch the next window's W^H
        int next = s + 1;
        while (next < nstep && table[3 * next] != 1) ++next;
        if (next < nstep && table[3 * next + 2] != loaded) {
          loaded = table[3 * next + 2];
          dq::mma::load_window(ws, wre_t + loaded * kPlane, wim_t + loaded * kPlane);
          dq::mma::cp_async_commit();
        }
      }
      dq::rotate_states(ycur, ynxt, gcur, gnxt, n, table[3 * s + 1], gs);
      float* tmp = ycur;
      ycur = ynxt;
      ynxt = tmp;
      tmp = gcur;
      gcur = gnxt;
      gnxt = tmp;
    }
    if (s + 1 < nstep || pending >= 0) {
      grid.sync();
    }
  }
  if (pending >= 0) {
    reduce_partials(part + ((wins - 1) & 1) * slots * 2 * kPlane, parts, dwre + pending * kPlane,
                    dwim + pending * kPlane);
  }
  dq::mma::cp_async_wait<0>();
}

template <int TC>
cudaError_t launch(int sms, void** args, int64_t N, int64_t slots, cudaStream_t stream) {
  const int smem = smem_bytes<TC>();
  auto kernel = window_chain_bwd_kernel<TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t items = (N >> 7) / TC;
  int64_t work = items;
  if (work < 4 * N / dq::kRotTile) work = 4 * N / dq::kRotTile;   // transpose tiles of y and g
  int64_t blocks = int64_t(per_sm) * sms;
  if (blocks > work) blocks = work;
  if ((items < blocks ? items : blocks) > slots) return cudaErrorInvalidValue;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                                     static_cast<size_t>(smem), stream);
}

}  // namespace

// table: (nstep, 3) int32 on the device, walk order, consecutive relabels
// merged (every delta in [1, n - 1]); wre_t/wim_t: (n_win, 128, 128) float32
// planes of W^H per window, forward order; ya, ga: (2, 2^n) float32 final
// state and cotangent, also work buffers; yb, gb: (2, 2^n) work buffers;
// dwre/dwim: (n_win, 128, 128) float32, every slot written; part: float32
// scratch of 2 * slots * 2 * 128 * 128, slots >= the column tiles,
// 2^(n-7) / TC; sms: the multiprocessors the grid may fill (1 .. the card's
// count; fewer stands in for a smaller card), which also picks TC;
// 14 <= n <= 19. The input state and cotangent end in ya / ga after an even
// number of relabel rows, else in yb / gb. Returns a cudaError_t;
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident.
extern "C" int dq_window_chain_bwd_f32(const void* table, int nstep, const void* wre_t,
                                       const void* wim_t, void* ya, void* yb, void* ga, void* gb,
                                       void* dwre, void* dwim, void* part, int slots, int sms,
                                       int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 14 || n > 19 || nstep < 1 || slots < 1 || sms < 1) return cudaErrorInvalidValue;
  int coop = 0;
  int card_sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&card_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (sms > card_sms) return cudaErrorInvalidValue;
  const int64_t N = int64_t(1) << n;
  const int* tab = static_cast<const int*>(table);
  const float* wr = static_cast<const float*>(wre_t);
  const float* wi = static_cast<const float*>(wim_t);
  float* pya = static_cast<float*>(ya);
  float* pyb = static_cast<float*>(yb);
  float* pga = static_cast<float*>(ga);
  float* pgb = static_cast<float*>(gb);
  float* pdr = static_cast<float*>(dwre);
  float* pdi = static_cast<float*>(dwim);
  float* ppart = static_cast<float*>(part);
  int64_t nslots = slots;
  void* args[] = {&tab, &nstep, &wr, &wi, &pya, &pyb, &pga, &pgb, &pdr, &pdi, &ppart, &nslots, &n};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-column tiles while they do not outnumber the blocks, else 32
  err = ((N >> 7) / 16 <= sms) ? launch<16>(sms, args, N, nslots, s)
                               : launch<32>(sms, args, N, nslots, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
