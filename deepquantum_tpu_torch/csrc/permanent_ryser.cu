// K7 permanent_ryser: the permanent of every matrix of a (B, n, n) complex
// stack by Ryser's formula,
//   perm(A) = (-1)^n sum_{S subseteq [n]} (-1)^{|S|} prod_j sum_{i in S} A_ij,
// in float64 whatever the input type (complex64 or complex128, interleaved),
// written as complex64 or complex128.
//
// Replaces the TPU kernel
// deepquantum_tpu/ops/pallas_kernels.py::permanent_pallas_batch (Pallas; body
// _ryser_df32_kernel). That kernel emulates float64 with double-single
// arithmetic over 12-bit fixed-point planes and recomputes all n column sums
// for every subset, because its chip has no float64 and its lanes must run
// in lockstep. Neither is carried over: the card has float64 units, and a
// thread here walks its subsets in Gray-code order, so one step changes the
// n column sums by one row (n complex adds) and multiplies them up (n - 1
// complex multiplies).
//
// Bound on the H100: float64 operations (2^n * 8n per matrix against
// 16 n^2 bytes). The design keeps the float64 units fed and everything a
// step touches on chip:
//  - a matrix's 2^n subsets are 2^rb runs of 2^L steps (rb + L = n): run r
//    takes the subsets (r << L) | gray(s), s < 2^L, so its rows >= L are the
//    bits of r (summed once at its start) and step s flips row ctz(s), the
//    same row with the same sign in every run and every thread;
//  - a thread walks WAYS runs side by side (4 at n <= 8, 2 up to n = 20,
//    where the registers hold them), so each step issues WAYS independent
//    chains of multiplies, and multiplies the column sums as four chains
//    (columns j mod 4) joined by a tree, not as one chain of n - 1;
//  - the column sums live in registers: n is a run-time value, so the
//    kernel is instantiated for a few capacities NMAX and its loops over
//    columns are fully unrolled with a uniform `j < n` guard (a per-thread
//    array indexed by a run-time loop variable would go to local memory);
//  - the block's matrices sit in shared memory as complex128, staged with
//    coalesced loads (16 bytes a thread), one matrix every odd number of
//    16-byte words so that a warp's threads on different matrices read
//    different banks; threads of one matrix read a row as a broadcast;
//  - the wrapper's plan (rb, L) fills a few waves of the card: one or two
//    threads a matrix where the stack is large (little start-up per run),
//    many threads and blocks to one matrix where it is small;
//  - the sum ends in the same launch, in a fixed order and without float
//    atomics, so the result is the same bits from run to run: a thread adds
//    its runs, the threads of a matrix in a warp by shuffles, the warps of a
//    block through shared memory, and where a matrix spans blocks, each
//    block leaves its partial in a workspace and the last to arrive at the
//    matrix's counter adds them in order and writes the permanent.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 96 * 1024;   // dynamic shared memory a block may take
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(-a.y, b.y, a.x * b.x), fma(a.y, b.x, a.x * b.y));
}

// the product of the n column sums: four chains (j mod 4), then a tree
template <int NMAX>
__device__ __forceinline__ double2 col_product(const double (&sr)[NMAX], const double (&si)[NMAX],
                                               int n) {
  double2 ch[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ch[c] = make_double2(sr[c], si[c]);
#pragma unroll
  for (int j = 4; j < NMAX; ++j) {
    if (j < n) ch[j & 3] = cmul(ch[j & 3], make_double2(sr[j], si[j]));
  }
  return cmul(cmul(ch[0], ch[1]), cmul(ch[2], ch[3]));
}

__device__ __forceinline__ void write_perm(void* out, int out_c64, unsigned m, double2 v, int n) {
  if (n & 1) v = make_double2(-v.x, -v.y);
  if (out_c64)
    static_cast<float2*>(out)[m] = make_float2(float(v.x), float(v.y));
  else
    static_cast<double2*>(out)[m] = v;
}

// the sum of a block's 32-lane groups' values, warps in order (all threads)
__device__ __forceinline__ double2 block_sum(double2 v, double2* wsum) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
  }
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  double2 t = wsum[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    t.x += wsum[w].x;
    t.y += wsum[w].y;
  }
  return t;
}

// every thread copies elements threadIdx.x, + kThreads, ... of count:
// kStage loads in flight (a block stages up to 96 KB: a few loads a thread
// in flight would each wait out the latency of device memory), then their
// stores
template <class Load, class Store>
__device__ __forceinline__ void staged(unsigned count, const Load& load, const Store& store) {
  constexpr int kStage = 8;
  for (unsigned e0 = threadIdx.x; e0 < count; e0 += kStage * kThreads) {
    decltype(load(0u)) v[kStage];
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const unsigned e = e0 + r * kThreads;
      if (e < count) v[r] = load(e);
    }
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const unsigned e = e0 + r * kThreads;
      if (e < count) store(e, v[r]);
    }
  }
}

// tpm threads a matrix (a power of two): up to kThreads a block holds
// kThreads / tpm matrices, above a matrix spans tpm / kThreads blocks
template <int NMAX, int WAYS>
__global__ void __launch_bounds__(kThreads)
ryser_kernel(const void* __restrict__ mats, int is_c64, void* __restrict__ out, int out_c64,
             double2* __restrict__ parts, unsigned* __restrict__ count, unsigned b, int n,
             int level, unsigned tpm, unsigned stride) {
  extern __shared__ double2 sm[];   // the block's matrices, [matrix * stride + row * n + column]
  __shared__ double2 wsum[kThreads / 32];
  __shared__ unsigned arrived;
  const unsigned nn = unsigned(n) * unsigned(n);
  const bool wide = tpm > kThreads;
  const unsigned bpm = wide ? tpm / kThreads : 1;                 // blocks a matrix
  const unsigned m0 = wide ? blockIdx.x / bpm : blockIdx.x * (kThreads / tpm);
  const unsigned lb = wide ? blockIdx.x - m0 * bpm : 0;
  const unsigned nmat = wide ? 1 : min(kThreads / tpm, b - m0);

  // stage the block's matrices, widened to complex128
  const unsigned total = nmat * nn;
  auto put = [&](unsigned e, double2 v) { sm[(e / nn) * stride + e % nn] = v; };
  if (is_c64) {
    const float2* src = static_cast<const float2*>(mats) + size_t(m0) * nn;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {   // two elements a 16-byte load
      const float4* s4 = reinterpret_cast<const float4*>(src);
      staged(
          total / 2, [&](unsigned p) { return s4[p]; },
          [&](unsigned p, float4 v) {
            put(2 * p, make_double2(double(v.x), double(v.y)));
            put(2 * p + 1, make_double2(double(v.z), double(v.w)));
          });
      if ((total & 1) && threadIdx.x == 0) {
        const float2 v = src[total - 1];
        put(total - 1, make_double2(double(v.x), double(v.y)));
      }
    } else {
      staged(
          total, [&](unsigned e) { return src[e]; },
          [&](unsigned e, float2 v) { put(e, make_double2(double(v.x), double(v.y))); });
    }
  } else {
    const double2* src = static_cast<const double2*>(mats) + size_t(m0) * nn;
    staged(total, [&](unsigned e) { return src[e]; }, put);
  }
  __syncthreads();

  const unsigned mloc = wide ? 0 : threadIdx.x / tpm;            // the thread's matrix in the block
  const unsigned tin = wide ? lb * kThreads + threadIdx.x : threadIdx.x % tpm;
  const bool live = mloc < nmat;
  const double2* a = sm + (live ? mloc : 0) * stride;
  const unsigned r0 = tin * WAYS;   // the thread's first run; way w takes run r0 | w

  // column sums of each run's first subset: rows level + i for the bits i of
  // the run, those of r0 once and then each way's own bits
  double sr[WAYS][NMAX], si[WAYS][NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    sr[0][j] = 0.0;
    si[0][j] = 0.0;
  }
  for (int i = 0; level + i < n; ++i) {
    if ((r0 >> i) & 1u) {
      const double2* row = a + (level + i) * n;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          sr[0][j] += row[j].x;
          si[0][j] += row[j].y;
        }
      }
    }
  }
  int par[WAYS];
  par[0] = __popc(r0) & 1;
#pragma unroll
  for (int w = 1; w < WAYS; ++w) {
    par[w] = __popc(r0 | w) & 1;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      sr[w][j] = sr[0][j];
      si[w][j] = si[0][j];
    }
#pragma unroll
    for (int i = 0; (1 << i) < WAYS; ++i) {
      if ((w >> i) & 1) {
        const double2* row = a + (level + i) * n;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            sr[w][j] += row[j].x;
            si[w][j] += row[j].y;
          }
        }
      }
    }
  }

  double2 acc[WAYS];
#pragma unroll
  for (int w = 0; w < WAYS; ++w) acc[w] = make_double2(0.0, 0.0);
  const unsigned steps = 1u << level;
  unsigned gray = 0;
  for (unsigned s = 0; s < steps; ++s) {
    if (s > 0) {
      // step s flips row ctz(s), added where the bit turns on
      const int bit = __ffs(int(s)) - 1;
      gray ^= 1u << bit;
      const double sgn = ((gray >> bit) & 1u) ? 1.0 : -1.0;
      const double2* row = a + bit * n;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const double2 v = row[j];
#pragma unroll
          for (int w = 0; w < WAYS; ++w) {
            sr[w][j] = fma(sgn, v.x, sr[w][j]);
            si[w][j] = fma(sgn, v.y, si[w][j]);
          }
        }
      }
    }
    // (-1)^|S|: the run's bits and gray(s), whose parity is that of s
#pragma unroll
    for (int w = 0; w < WAYS; ++w) {
      const double2 p = col_product<NMAX>(sr[w], si[w], n);
      if (par[w] ^ int(s & 1u)) {
        acc[w].x -= p.x;
        acc[w].y -= p.y;
      } else {
        acc[w].x += p.x;
        acc[w].y += p.y;
      }
    }
  }
  double2 t = acc[0];
#pragma unroll
  for (int w = 1; w < WAYS; ++w) {
    t.x += acc[w].x;
    t.y += acc[w].y;
  }
  if (!live) t = make_double2(0.0, 0.0);

  if (tpm == 1) {
    if (live) write_perm(out, out_c64, m0 + mloc, t, n);
    return;
  }
  if (tpm < 32) {   // a matrix's lanes in one warp: a butterfly, the same bits on each
#pragma unroll
    for (unsigned o = 1; o < 32; o <<= 1) {
      if (o < tpm) {
        t.x += __shfl_xor_sync(kFull, t.x, o);
        t.y += __shfl_xor_sync(kFull, t.y, o);
      }
    }
    if (live && tin == 0) write_perm(out, out_c64, m0 + mloc, t, n);
    return;
  }
  if (!wide) {      // a matrix's warps in one block, in order
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      t.x += __shfl_xor_sync(kFull, t.x, o);
      t.y += __shfl_xor_sync(kFull, t.y, o);
    }
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = t;
    __syncthreads();
    if (live && tin == 0) {
      const unsigned w0 = threadIdx.x >> 5;
      double2 v = wsum[w0];
      for (unsigned w = 1; w < tpm / 32; ++w) {
        v.x += wsum[w0 + w].x;
        v.y += wsum[w0 + w].y;
      }
      write_perm(out, out_c64, m0 + mloc, v, n);
    }
    return;
  }

  // a matrix over bpm blocks: the block's partial, then the last to arrive
  const double2 part = block_sum(t, wsum);
  if (threadIdx.x == 0) {
    parts[size_t(m0) * bpm + lb] = part;
    __threadfence();
    arrived = atomicAdd(count + m0, 1u);
  }
  __syncthreads();
  if (arrived != bpm - 1) return;
  __threadfence();
  // thread i adds partials i, i + kThreads, ... in ascending order, then the
  // threads are added as a block's are: an order fixed by the indices alone
  double2 v = make_double2(0.0, 0.0);
  for (unsigned p = threadIdx.x; p < bpm; p += kThreads) {
    const double2 q = __ldcg(parts + size_t(m0) * bpm + p);
    v.x += q.x;
    v.y += q.y;
  }
  __syncthreads();   // wsum is read above by every thread
  const double2 total_sum = block_sum(v, wsum);
  if (threadIdx.x == 0) {
    write_perm(out, out_c64, m0, total_sum, n);
    count[m0] = 0u;
  }
}

struct Launch {
  const void* mats;
  int is_c64;
  void* out;
  int out_c64;
  double2* parts;
  unsigned* count;
  unsigned b;
  int n, level;
  unsigned tpm, stride;
  unsigned grid;
  size_t smem;
  int device;
  cudaStream_t s;

  template <int NMAX, int WAYS>
  int run() const {
    // above 48 KB a block's dynamic shared memory is opt-in: once per
    // instance and card, for the most any launch takes
    static int opted[kMaxDevices];
    if (smem > 48 * 1024 && opted[device] < kSmemMax) {
      const cudaError_t err = cudaFuncSetAttribute(
          ryser_kernel<NMAX, WAYS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return err;
      opted[device] = kSmemMax;
    }
    ryser_kernel<NMAX, WAYS><<<grid, kThreads, smem, s>>>(mats, is_c64, out, out_c64, parts,
                                                           count, b, n, level, tpm, stride);
    return cudaGetLastError();
  }
};

struct Resident {
  int* out;
  size_t smem;

  template <int NMAX, int WAYS>
  int run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, ryser_kernel<NMAX, WAYS>, kThreads,
                                                         smem);
  }
};

// the instance for n: (NMAX, WAYS), as ops/permanent_kernel.py's _NMAX_WAYS
template <class F>
int nmax_dispatch(int n, const F& f) {
  if (n <= 8) return f.template run<8, 4>();
  if (n <= 12) return f.template run<12, 2>();
  if (n <= 16) return f.template run<16, 2>();
  if (n <= 20) return f.template run<20, 2>();
  return f.template run<26, 1>();   // two runs of 26 column sums spill at 255 registers
}

int ways_of(int n) { return n <= 8 ? 4 : (n <= 20 ? 2 : 1); }

// complex128 words between two matrices in shared memory: n^2 made odd
unsigned smem_stride(int n) { return unsigned(n * n) | 1u; }

}  // namespace

// mats: (b, n, n) complex64 (is_c64 != 0) or complex128, interleaved, read
// only; out: (b,) complex64 (out_c64 != 0) or complex128, all written;
// parts: b * tpm / 128 complex128 of workspace and count: b unsigned
// arrival counters, 0 on entry and left 0 (both used only where a matrix
// spans blocks, tpm > 128); level: a run sweeps 2^level subsets; ways: the
// runs a thread walks, the instance's own (4 at n <= 8, 2 to n = 20, else 1); so a
// matrix has 2^(n - level) runs and tpm = 2^(n - level) / ways threads.
// 4 <= n <= 26. Launches on one stream must not overlap on one workspace.
// Returns a cudaError_t.
extern "C" int dq_permanent_ryser(const void* mats, int is_c64, void* out, int out_c64,
                                  void* parts, void* count, int b, int n, int level, int ways,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b < 1 || n < 4 || n > 26 || ways != ways_of(n) || level < 0 || level > n || device < 0 ||
      device >= kMaxDevices) {
    return cudaErrorInvalidValue;
  }
  const int rb = n - level;
  if ((1 << rb) < ways || rb > 30) return cudaErrorInvalidValue;
  const unsigned tpm = (1u << rb) / unsigned(ways);
  const unsigned stride = smem_stride(n);
  uint64_t grid;
  size_t smem;
  if (tpm > kThreads) {
    grid = uint64_t(b) * (tpm / kThreads);
    smem = size_t(stride) * sizeof(double2);
  } else {
    const unsigned mpb = kThreads / tpm;
    grid = (uint64_t(b) + mpb - 1) / mpb;
    smem = size_t(b < int(mpb) ? b : mpb) * stride * sizeof(double2);
  }
  if (grid > 0x7fffffffull || smem > size_t(kSmemMax)) return cudaErrorInvalidValue;
  return nmax_dispatch(n, Launch{mats, is_c64, out, out_c64, static_cast<double2*>(parts),
                                 static_cast<unsigned*>(count), unsigned(b), n, level, tpm,
                                 stride, unsigned(grid), smem, device,
                                 static_cast<cudaStream_t>(stream)});
}

// out: a host int, set to the blocks of the instance for n that one SM keeps
// resident with one matrix in shared memory (the wrapper's plan fills one
// wave of them). Returns a cudaError_t.
extern "C" int dq_permanent_blocks_per_sm(int n, void* out, int device, void*) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 4 || n > 26) return cudaErrorInvalidValue;
  return nmax_dispatch(n, Resident{static_cast<int*>(out), smem_stride(n) * sizeof(double2)});
}
