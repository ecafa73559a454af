// K2 window_apply: a dense 128 x 128 complex window W applied in place to
// the top 7 wires of an n-qubit state held as float32 re/im planes, i.e.
// y = W x on the state viewed as (2, 128, 2^(n - 7)).
//
// Replaces the TPU kernel deepquantum_tpu/ops/window_gate.py::window_apply
// (Pallas; body _window_kernel).
//
// Bound on the H100: the FP32 CUDA cores. Each column of 128 complex
// amplitudes moves 2 KiB (read + write) and costs 4 * 2 * 128^2 = 131k
// flops, 64 flop/B, above the card's FP32 ridge of about 20 flop/B (67
// TFLOP/s over 3.35 TB/s). The design therefore keeps every state element
// read once from device memory: one block per tile of 32 columns stages
// both planes of the tile in shared memory (32 KB) and W in chunks, each
// thread accumulates 16 outputs of one column in FP32 FMA, and the tile is
// written back over itself (see window_tile.cuh). Tensor-core routes
// (3xTF32, DMMA in f64) are later work.

#include "window_tile.cuh"

namespace {

constexpr int kTileCols = 32;

__global__ void __launch_bounds__(dq::kWinThreads)
window_apply_kernel(const float* __restrict__ wre, const float* __restrict__ wim, float* xr,
                    float* xi, int64_t R) {
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<dq::WindowSmem<kTileCols>*>(smem_raw);
  const int64_t tiles = R / kTileCols;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    dq::window_tile<kTileCols>(wre, wim, xr, xi, xr, xi, R, tile * kTileCols, s);
  }
}

}  // namespace

// x: (2, 2^n) float32 planes, updated in place; mre/mim: (128, 128) float32
// row-major planes of W; n >= 12. Returns a cudaError_t.
extern "C" int dq_window_apply_f32(void* x, const void* mre, const void* mim, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 12 || n > 40) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(dq::WindowSmem<kTileCols>));
  err = cudaFuncSetAttribute(window_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  float* xr = static_cast<float*>(x);
  float* xi = xr + (int64_t(1) << n);
  const int64_t R = int64_t(1) << (n - 7);
  int64_t blocks = R / kTileCols;
  if (blocks > (int64_t(1) << 20)) blocks = int64_t(1) << 20;
  window_apply_kernel<<<static_cast<unsigned>(blocks), dq::kWinThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mre), static_cast<const float*>(mim), xr, xi, R);
  return cudaGetLastError();
}
