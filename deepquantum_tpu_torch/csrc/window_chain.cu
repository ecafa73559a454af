// K3 window_chain_fwd: a whole scheduled sequence of ('win', 7) and
// ('rot', d) steps in ONE cooperative persistent launch.
//
// Replaces the TPU kernel deepquantum_tpu/ops/chain_kernel.py::window_chain_fwd
// (Pallas; body _fwd_kernel, relabel _rot2, tables _step_tables).
//
// Bound on the H100: per window 2^(n-7) columns x 131k flop, 8.86 GFLOP at
// n = 18 on the bench sequence (33 windows): 0.132 ms on the FP64 tensor
// cores this kernel runs (67 TFLOP/s), 0.054 ms in 3xTF32; the state (2 MiB
// at n = 18, 4 MiB at n = 19) stays in the 50 MB L2 in two ping-pong
// buffers, and what stands between the walk and that bound is its grid-wide
// barriers. The first design ran an FP32 FMA loop that re-staged W in every
// tile, relabelled through 32 x 32 tiles one step at a time and took one
// barrier per step (86 at n = 18), at 9.7 % of its bound. This design is
// K4's (window_chain_bwd.cu) for one state:
//
// - Window row: a block owns a tile of TC columns (16, or 32 when 16-column
//   tiles would outnumber the blocks), stages W once into shared memory and
//   its tile beside it, runs y = W x on the FP64 tensor cores
//   (window_mma.cuh: f64 operands and sums, one float32 rounding to nearest
//   per result, so no bias grows with the windows walked), and writes the
//   tile back in place: its columns are its own. A block with two tiles
//   (n = 19 on fewer than 128 SMs) keeps W for the second. Two windows in a
//   row touch the same columns of each block, so no barrier parts them; the
//   second window's W loads at its row.
// - Relabel row: a run of consecutive relabels arrives as one row (the
//   wrapper adds the deltas mod n), relabelled by one transpose of the
//   (2^d, 2^(n-d)) view into the other buffer (window_rotate.cuh, shared
//   with K4). While it runs, each block that has columns prefetches the next
//   window's W with cp.async.
// A barrier between two rows unless both are windows, none after the last:
// 66 rows and 65 barriers at n = 18 on the bench sequence, against 86.
// The grid is sized from the occupancy calculator so that every block is
// resident, which grid.sync() requires; blocks without columns (n = 14 has
// 8 tiles) take part in the relabels and reach every barrier.

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
  return static_cast<int>(sizeof(float)) * (kWFloats + Tile<TC>::kFloats);
}

static_assert(dq::kRotSmemFloats <= Tile<16>::kFloats, "the transpose tile must fit the tile");

// table: nstep rows of (kind, delta, window index) in walk order; kind 1 =
// window (index into the stacks), 0 = relabel by delta (1 <= delta < n;
// consecutive relabels already merged). a holds the input state; the
// result ends in a after an even number of relabel rows, in b after an odd
// number.
template <int TC>
__global__ void __launch_bounds__(kThreads, 1)
window_chain_fwd_kernel(const int* __restrict__ table, int nstep, const float* __restrict__ wre,
                        const float* __restrict__ wim, float* a, float* b, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);   // W of the current window
  float* xs = ws + kWFloats;                        // the column tile; a relabel's transpose tile
  const int64_t N = int64_t(1) << n;
  const int64_t R = N >> 7;
  const int64_t items = R / TC;
  float* cur = a;
  float* nxt = b;
  int loaded = -1;   // the window whose W is in ws or on its way there
  for (int s = 0; s < nstep; ++s) {
    const bool win = table[3 * s] == 1;
    if (win) {
      const int w = table[3 * s + 2];
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t c0 = item * TC;
        if (loaded != w) {
          dq::mma::load_window(ws, wre + w * kPlane, wim + w * kPlane);
          loaded = w;
        }
        dq::mma::load_tile<TC>(xs, cur, N, R, c0);
        dq::mma::cp_async_commit();
        dq::mma::cp_async_wait<0>();
        __syncthreads();
        double acc[TC / 8][2][4];
        dq::mma::window_product<TC>(ws, xs, acc);
        // in place: only this block touches these columns in this row
        dq::mma::store_product<TC>(acc, cur, N, R, c0);
        __syncthreads();   // ws and xs are reloaded for the next tile or row
      }
    } else {
      if (blockIdx.x < items) {   // prefetch the next window's W
        int next = s + 1;
        while (next < nstep && table[3 * next] != 1) ++next;
        if (next < nstep && table[3 * next + 2] != loaded) {
          loaded = table[3 * next + 2];
          dq::mma::load_window(ws, wre + loaded * kPlane, wim + loaded * kPlane);
          dq::mma::cp_async_commit();
        }
      }
      dq::rotate_states(cur, nxt, nullptr, nullptr, n, table[3 * s + 1], xs);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (s + 1 < nstep && !(win && table[3 * (s + 1)] == 1)) {
      grid.sync();
    }
  }
  dq::mma::cp_async_wait<0>();
}

template <int TC>
cudaError_t launch(int sms, void** args, int64_t N, cudaStream_t stream) {
  const int smem = smem_bytes<TC>();
  auto kernel = window_chain_fwd_kernel<TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int64_t work = (N >> 7) / TC;                                      // column tiles
  if (work < 2 * N / dq::kRotTile) work = 2 * N / dq::kRotTile;     // transpose tiles
  int64_t blocks = int64_t(per_sm) * sms;
  if (blocks > work) blocks = work;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                                     static_cast<size_t>(smem), stream);
}

}  // namespace

// table: (nstep, 3) int32 on the device, walk order, consecutive relabels
// merged (every delta in [1, n - 1]); wre/wim: (n_win, 128, 128) float32
// planes of W per window; a: (2, 2^n) float32 input, also a work buffer;
// b: (2, 2^n) work buffer; sms: the multiprocessors the grid may fill (1 ..
// the card's count; fewer stands in for a smaller card), which also picks
// TC; 14 <= n <= 19. Returns a cudaError_t;
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident.
extern "C" int dq_window_chain_fwd_f32(const void* table, int nstep, const void* wre,
                                       const void* wim, void* a, void* b, int sms, int n,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 14 || n > 19 || nstep < 1 || sms < 1) return cudaErrorInvalidValue;
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
  const float* wr = static_cast<const float*>(wre);
  const float* wi = static_cast<const float*>(wim);
  float* pa = static_cast<float*>(a);
  float* pb = static_cast<float*>(b);
  void* args[] = {&tab, &nstep, &wr, &wi, &pa, &pb, &n};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-column tiles while they do not outnumber the blocks, else 32
  err = ((N >> 7) / 16 <= sms) ? launch<16>(sms, args, N, s) : launch<32>(sms, args, N, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
