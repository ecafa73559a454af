// K7 permanent_ryser: the permanent of every matrix of a (B, n, n) complex
// stack by Ryser's formula,
//   perm(A) = (-1)^n sum_{S subseteq [n]} (-1)^{|S|} prod_j sum_{i in S} A_ij,
// in float64 whatever the input type (complex64 or complex128, interleaved).
//
// Replaces the TPU kernel
// deepquantum_tpu/ops/pallas_kernels.py::permanent_pallas_batch (Pallas; body
// _ryser_df32_kernel). That kernel emulates float64 with double-single
// arithmetic over 12-bit fixed-point planes and recomputes all n column sums
// for every subset, because its chip has no float64 and its lanes must run
// in lockstep. Neither is carried over: the card has float64 units, and a
// thread here walks its subsets in Gray-code order, so one step changes the
// n column sums by one row (n complex adds) and multiplies them up (n
// complex multiplies).
//
// Bound on the H100: float64 operations (2^n * 8n per matrix against
// 2 * 16 n^2 bytes). The design keeps everything a step touches on chip:
//  - the matrices a block needs sit in shared memory as complex128; at a
//    given step every thread of a run-aligned warp flips the same bit, so
//    the row it adds is a broadcast read;
//  - the n column sums live in registers: n is a run-time value, so the
//    kernel is instantiated for a few capacities NMAX and its loops over
//    columns are fully unrolled with a uniform `j < n` guard (a per-thread
//    array indexed by a run-time loop variable would go to local memory);
//  - a thread owns 2^L consecutive Gray-code indices of one matrix (L from
//    the wrapper: many threads per matrix when the stack is small, many
//    matrices per block when the matrices are small), starts from the
//    column sums of its first subset and then steps;
//  - no float atomics: a warp that lies inside one matrix adds its lanes'
//    sums with shuffles in a fixed order and leaves one partial, otherwise
//    each thread leaves one; the wrapper adds the partials with torch.sum,
//    so the result does not change from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
ryser_kernel(const void* __restrict__ mats, int is_c64, double2* __restrict__ parts,
             uint64_t nthreads, int n, int level) {
  extern __shared__ double2 sm[];   // the block's matrices, [matrix][row][column]
  const int run_bits = n - level;                         // log2(runs per matrix)
  const uint64_t t0 = uint64_t(blockIdx.x) * kThreads;    // first thread of the block
  const uint64_t t = t0 + threadIdx.x;
  const uint64_t b0 = t0 >> run_bits;                     // first matrix of the block
  const uint64_t last = (t0 + kThreads - 1 < nthreads ? t0 + kThreads - 1 : nthreads - 1);
  const int nmat = int((last >> run_bits) - b0) + 1;
  const int nn = n * n;
  for (int e = threadIdx.x; e < nmat * nn; e += kThreads) {
    const uint64_t g = b0 * nn + e;
    if (is_c64) {
      const float2 v = static_cast<const float2*>(mats)[g];
      sm[e] = make_double2(double(v.x), double(v.y));
    } else {
      sm[e] = static_cast<const double2*>(mats)[g];
    }
  }
  __syncthreads();
  const bool live = t < nthreads;
  const uint64_t b = (live ? t : last) >> run_bits;
  const uint32_t run = uint32_t((live ? t : last) & ((uint64_t(1) << run_bits) - 1));
  const double2* a = sm + (b - b0) * nn;

  // column sums of the run's first subset
  uint32_t gray = (run << level) ^ ((run << level) >> 1);
  double sr[NMAX], si[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    sr[j] = 0.0;
    si[j] = 0.0;
  }
  for (int i = 0; i < n; ++i) {
    if ((gray >> i) & 1u) {
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const double2 v = a[i * n + j];
          sr[j] += v.x;
          si[j] += v.y;
        }
      }
    }
  }
  double accr = 0.0, acci = 0.0;
  const uint32_t steps = uint32_t(1) << level;
  for (uint32_t s = 0; s < steps; ++s) {
    if (s > 0) {
      // Gray code: index s flips bit ctz(s); the run's start is a multiple
      // of 2^L, so the bit is the same for every thread at this step
      const int bit = __ffs(int(s)) - 1;
      gray ^= uint32_t(1) << bit;
      const double sgn = ((gray >> bit) & 1u) ? 1.0 : -1.0;
      const double2* row = a + bit * n;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const double2 v = row[j];
          sr[j] = fma(sgn, v.x, sr[j]);
          si[j] = fma(sgn, v.y, si[j]);
        }
      }
    }
    double pr = sr[0], pi = si[0];
#pragma unroll
    for (int j = 1; j < NMAX; ++j) {
      if (j < n) {
        const double qr = pr * sr[j] - pi * si[j];
        pi = pr * si[j] + pi * sr[j];
        pr = qr;
      }
    }
    if (__popc(gray) & 1) {
      accr -= pr;
      acci -= pi;
    } else {
      accr += pr;
      acci += pi;
    }
  }
  if (n & 1) {
    accr = -accr;
    acci = -acci;
  }
  if (!live) {
    accr = 0.0;
    acci = 0.0;
  }
  if (run_bits >= 5) {
    // the warp lies inside one matrix (nthreads is then a multiple of 32)
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      accr += __shfl_xor_sync(kFull, accr, o);
      acci += __shfl_xor_sync(kFull, acci, o);
    }
    if (live && (threadIdx.x & 31) == 0) parts[t >> 5] = make_double2(accr, acci);
  } else if (live) {
    parts[t] = make_double2(accr, acci);
  }
}

template <int NMAX>
cudaError_t launch(const void* mats, int is_c64, double2* parts, uint64_t nthreads, int n,
                   int level, size_t smem, cudaStream_t s) {
  const uint64_t nblocks = (nthreads + kThreads - 1) / kThreads;
  if (nblocks > 0x7fffffffull) return cudaErrorInvalidValue;
  ryser_kernel<NMAX><<<unsigned(nblocks), kThreads, smem, s>>>(mats, is_c64, parts, nthreads, n,
                                                                level);
  return cudaGetLastError();
}

}  // namespace

// mats: (b, n, n) complex64 (is_c64 != 0) or complex128, interleaved, read
// only; parts: (b, P) complex128, all written, with P = 2^(n - level) / 32
// when a matrix has 32 or more runs and 2^(n - level) otherwise; level: a
// thread sweeps 2^level subsets. The matrices one block touches must fit
// 48 KB of shared memory as complex128. Returns a cudaError_t.
extern "C" int dq_permanent_ryser(const void* mats, int is_c64, void* parts, int b, int n,
                                  int level, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b < 1 || n < 1 || n > 26 || level < 0 || level > n || level > 30) {
    return cudaErrorInvalidValue;
  }
  const int run_bits = n - level;
  const uint64_t nthreads = uint64_t(b) << run_bits;
  const int per_block = run_bits >= 7 ? 1 : (kThreads >> run_bits);
  const size_t smem = size_t(per_block) * n * n * sizeof(double2);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  auto* p = static_cast<double2*>(parts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch<8>(mats, is_c64, p, nthreads, n, level, smem, s);
  if (n <= 12) return launch<12>(mats, is_c64, p, nthreads, n, level, smem, s);
  if (n <= 16) return launch<16>(mats, is_c64, p, nthreads, n, level, smem, s);
  if (n <= 20) return launch<20>(mats, is_c64, p, nthreads, n, level, smem, s);
  return launch<26>(mats, is_c64, p, nthreads, n, level, smem, s);
}
