// K3 window_chain_fwd: a whole scheduled sequence of ('win', 7) and
// ('rot', d) steps in ONE cooperative persistent launch.
//
// Replaces the TPU kernel deepquantum_tpu/ops/chain_kernel.py::window_chain_fwd
// (Pallas; body _fwd_kernel, relabel _rot2, tables _step_tables).
//
// Bound on the H100: at 14 <= n <= 19 the state is at most 4 MiB in
// complex64, so the per-step kernel launches and device-memory round trips
// of a step-per-kernel chain, not arithmetic, would bound it. The design
// keeps the state in two ping-pong buffers that stay in the 50 MB L2 (2 MiB
// each at n = 18; the counterpart of the TPU kernel's VMEM-resident state)
// and walks a device-side step table of (kind, delta, window index) inside
// one launch, with grid.sync() between steps. A win step is K2's tile body
// (window_tile.cuh, 16-column tiles for more blocks at small n) run in
// place on the current buffer; its windows arrive as a compact
// (n_win, 128, 128) stack. A rot step relabels the qubit positions like
// _rot2 / _rotate_planar: the plane viewed as (2^d, 2^(n - d)) is
// transposed, through 32 x 32 shared-memory tiles (rotate_planes in
// window_tile.cuh), into the other buffer, and the buffers swap roles. The
// grid is sized from the occupancy calculator so that every block is
// resident, which grid.sync() requires.
// (A thread-block cluster holding the state in distributed shared memory
// does not fit at n = 18: 8 x 227 KB is less than 2 MiB.)

#include <cooperative_groups.h>

#include "window_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChainCols = 16;   // tile columns of a win step
using dq::kT;

static_assert(sizeof(dq::WindowSmem<kChainCols>) >= sizeof(float) * kT * (kT + 1),
              "the transpose tile must fit the window tile's shared memory");

// table: nstep rows of (kind, delta, window index); kind 1 = window,
// 0 = relabel by delta. a holds the input state; the result ends in a after
// an even number of relabels, in b after an odd number.
__global__ void __launch_bounds__(dq::kWinThreads)
window_chain_fwd_kernel(const int* __restrict__ table, int nstep, const float* __restrict__ wre,
                        const float* __restrict__ wim, float* a, float* b, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem_raw[];
  auto& win = *reinterpret_cast<dq::WindowSmem<kChainCols>*>(smem_raw);
  auto tile = reinterpret_cast<float (*)[kT + 1]>(smem_raw);
  const int64_t N = int64_t(1) << n;
  const int64_t R = N >> 7;
  const int64_t win_tiles = R / kChainCols;
  float* cur = a;
  float* nxt = b;
  for (int s = 0; s < nstep; ++s) {
    const int kind = table[3 * s];
    if (kind == 1) {
      const int64_t w = table[3 * s + 2];
      const float* wr = wre + w * dq::kWinRows * dq::kWinRows;
      const float* wi = wim + w * dq::kWinRows * dq::kWinRows;
      for (int64_t t = blockIdx.x; t < win_tiles; t += gridDim.x) {
        dq::window_tile<kChainCols>(wr, wi, cur, cur + N, cur, cur + N, R, t * kChainCols, win);
      }
    } else {
      dq::rotate_planes(cur, nxt, n, table[3 * s + 1], tile);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    grid.sync();
  }
}

}  // namespace

// table: (nstep, 3) int32 on the device; wre/wim: (n_win, 128, 128) float32;
// a: (2, 2^n) float32 input, also a work buffer; b: (2, 2^n) work buffer;
// 14 <= n <= 19 and every relabel delta in [7, n - 7]. Returns a
// cudaError_t; cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident.
extern "C" int dq_window_chain_fwd_f32(const void* table, int nstep, const void* wre,
                                       const void* wim, void* a, void* b, int n, int device,
                                       void* stream) {
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
  err = cudaFuncSetAttribute(window_chain_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_chain_fwd_kernel,
                                                      dq::kWinThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t N = int64_t(1) << n;
  const int64_t win_tiles = (N >> 7) / kChainCols;
  const int64_t rot_tiles = 2 * N / (kT * kT);
  const int64_t work = win_tiles > rot_tiles ? win_tiles : rot_tiles;
  int64_t blocks = int64_t(per_sm) * sms;
  if (blocks > work) blocks = work;
  const int* tab = static_cast<const int*>(table);
  const float* wr = static_cast<const float*>(wre);
  const float* wi = static_cast<const float*>(wim);
  float* pa = static_cast<float*>(a);
  float* pb = static_cast<float*>(b);
  void* args[] = {&tab, &nstep, &wr, &wi, &pa, &pb, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(window_chain_fwd_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(dq::kWinThreads),
                                    args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
