// K2 window_apply: a dense 128 x 128 complex window W applied in place to
// the top 7 wires of an n-qubit state held as float32 re/im planes, i.e.
// y = W x on the state viewed as (2, 128, 2^(n - 7)).
//
// Replaces the TPU kernel deepquantum_tpu/ops/window_gate.py::window_apply
// (Pallas; body _window_kernel).
//
// Bound on the H100: each column of 128 complex amplitudes moves 2 KiB
// (read + write) for 4 * 2 * 128^2 = 131k flops, 17.2 GFLOP at n = 24
// against 0.080 ms for the bytes. The first design (an FMA loop on the FP32
// CUDA cores that re-staged W for every 32-column tile) reached half of its
// 0.256 ms bound and lost to one cuBLAS float32 matmul. The second design
// moved the products to the tensor cores in 3xTF32 (bound 0.104 ms), whose sums the
// tensor core truncates: a bias that grows with every window a state walks
// (window_mma.cuh). The body is now the FP64 tensor cores (DMMA, 67 TFLOP/s:
// 0.256 ms at n = 24, operations bound), exact products and f64 sums:
//
// - a persistent grid of one block per SM; each block copies W (both
//   float32 planes, 128 KB) into shared memory ONCE and keeps it for all of
//   its tiles;
// - the block's 32-column tiles stream through a ring of two stages with
//   cp.async, so the next tile loads while the current one multiplies;
// - each warp owns 16 rows of W and all 32 columns of the tile and widens
//   its operands to f64 as they leave shared memory;
// - the result, rounded once to float32, goes from the accumulators straight
//   back over the tile's columns in device memory.
// tools/mma_rate.py measures the DMMA instruction's own rate on the card.

#include "window_mma.cuh"

namespace {

constexpr int kTileCols = 32;
using Tile = dq::mma::Tile<kTileCols>;
constexpr int kStages = 2;
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) * (dq::mma::kWFloats + kStages * Tile::kFloats);

__global__ void __launch_bounds__(dq::mma::kThreads, 1)
window_apply_kernel(const float* __restrict__ wre, const float* __restrict__ wim, float* x,
                    int64_t N, int64_t R) {
  extern __shared__ float4 smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);
  float* stages = ws + dq::mma::kWFloats;   // kStages tiles, one after the other
  const int64_t tiles = R / kTileCols;
  // cp.async groups: W, then one per tile (empty past the last)
  dq::mma::load_window(ws, wre, wim);
  dq::mma::cp_async_commit();
  int64_t tile = blockIdx.x;
  if (tile < tiles) dq::mma::load_tile<kTileCols>(stages, x, N, R, tile * kTileCols);
  dq::mma::cp_async_commit();
  for (int i = 0; tile < tiles; ++i, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles) {
      dq::mma::load_tile<kTileCols>(stages + ((i + 1) % kStages) * Tile::kFloats, x, N, R,
                                    next * kTileCols);
    }
    dq::mma::cp_async_commit();
    dq::mma::cp_async_wait<1>();   // W and this tile have landed
    __syncthreads();
    double acc[kTileCols / 8][2][4];
    dq::mma::window_product<kTileCols>(ws, stages + (i % kStages) * Tile::kFloats, acc);
    // in place is safe: only this block reads these columns, and it has
    // staged them; the load in flight is another tile's
    dq::mma::store_product<kTileCols>(acc, x, N, R, tile * kTileCols);
    __syncthreads();   // the stage is free for the load issued next
  }
  dq::mma::cp_async_wait<0>();
}

}  // namespace

// x: (2, 2^n) float32 planes, updated in place; mre/mim: (128, 128) float32
// row-major planes of W; 12 <= n <= 40. Returns a cudaError_t.
extern "C" int dq_window_apply_f32(void* x, const void* mre, const void* mim, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 12 || n > 40) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(window_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t N = int64_t(1) << n;
  const int64_t R = N >> 7;
  int64_t blocks = R / kTileCols;
  if (blocks > sms) blocks = sms;
  window_apply_kernel<<<static_cast<unsigned>(blocks), dq::mma::kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mre), static_cast<const float*>(mim), static_cast<float*>(x), N,
      R);
  return cudaGetLastError();
}
