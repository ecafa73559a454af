// K8 tor_dets and K9 tor_dets_quads: for every nonempty subset Z of the m
// modes of each (2m, 2m) complex matrix O of a stack of B, det(I - O_Z), and
// for K9 also the quadratic form gamma_Z^T (I - O_Z)^{-1} conj(gamma_Z), in
// float64 whatever the input type (complex64 or complex128, interleaved).
// O_Z keeps the rows and columns (y, y + m) of the modes y in Z, sorted;
// these are the terms of the torontonian's inclusion-exclusion sum. B = 1 is
// the single torontonian.
//
// Replaces the TPU kernels
// deepquantum_tpu/photonic/tor_kernel.py::tor_dets_pallas (body
// _tor_click_kernel) and ::tor_dets_quads_pallas (body _tor_loop_kernel),
// and their vmapped form (torontonian_.py::torontonian_batch), where the
// batch is one more grid axis of each size bucket's pallas_call. Those run
// double-single arithmetic (the chip has no float64) with 128 subsets
// across the lanes, on (p, p, S) planes that the wrapper gathers through
// device memory. None of that is carried over: the card has float64 units,
// and each subset gathers its own rows of O.
//
// Bound on the H100: float64 operations on the CUDA cores (about 8 p^3 / 3
// per subset of size p = 2|Z|, 34 TFLOP/s), against 16 (2m)^2 bytes of
// input per matrix and 16 bytes out per subset. An unpivoted LU of at most
// 28 x 28 is a chain of rank-1 updates, too small and too sequential for
// the tensor cores' 8 x 8 x 4 FP64 tiles, so their rate is not the bound.
// The design:
//  - one launch per subset size p (m launches per call, in one stream), a
//    kernel instance per p (p even, 2 <= p <= 28), so every loop is unrolled
//    at its true size and the working storage is what p needs;
//  - a group of G lanes owns one subset, G the least power of two >= p, so a
//    warp works on 32 / G subsets at once (16 at p = 2, 8 at p = 4, 4 at
//    p <= 8, 2 at p <= 16, 1 above), and lane r holds row r of I - O_Z (with K9's
//    right-hand side conj(gamma_Z) as one more column) in registers;
//  - the work items are (matrix, subset) pairs of the whole stack, so a
//    batch of small matrices fills the card as one large matrix does;
//  - LU without pivoting, multipliers from the pivot COLUMN (O is not
//    symmetric): at step j the pivot row's lane writes its row once to a
//    double-buffered slab in shared memory, the group reads it back as
//    broadcasts, and every lane below the pivot forms its own multiplier
//    once and updates its row. I - O_Z has its spectrum away from zero for a
//    physical covariance; a singular input gives inf/nan as a library det
//    would;
//  - K9 back-substitutes on the right-hand side column, x_k passed from its
//    lane by a shuffle, and sums gamma_Z^T x over the group's lanes in a
//    fixed butterfly; gamma_Z enters unconjugated;
//  - each subset's det and form are written by one lane, and no sum crosses
//    warps or depends on timing, so the results do not change from run to
//    run. The epilogue (1 / sqrt(det), exp(quad / 2), the signed sum) stays
//    in the wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSize = 28;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// The complex arithmetic is written in explicit round-to-nearest
// intrinsics, so the compiler contracts nothing on its own and K8 and K9
// (two template instances) give the same determinant bits.
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -__dmul_rn(a.y, b.y)),
                      __fma_rn(a.x, b.y, __dmul_rn(a.y, b.x)));
}

// a - l * u in four fused multiply-adds
__device__ __forceinline__ double2 cmsub(double2 a, double2 l, double2 u) {
  return make_double2(__fma_rn(-l.x, u.x, __fma_rn(l.y, u.y, a.x)),
                      __fma_rn(-l.x, u.y, __fma_rn(-l.y, u.x, a.y)));
}

// 1 / a through the correctly rounded reciprocal (a division's slow path
// would sit in every elimination step)
__device__ __forceinline__ double2 cinv(double2 a) {
  const double s = __drcp_rn(__fma_rn(a.x, a.x, __dmul_rn(a.y, a.y)));
  return make_double2(__dmul_rn(a.x, s), -__dmul_rn(a.y, s));
}

__device__ __forceinline__ double2 load_c(const void* p, int is_c64, size_t i) {
  if (is_c64) {
    const float2 v = __ldg(static_cast<const float2*>(p) + i);
    return make_double2(double(v.x), double(v.y));
  }
  return __ldg(static_cast<const double2*>(p) + i);
}

__device__ __forceinline__ double2 shfl(double2 v, int src) {
  return make_double2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

// lanes per subset: the least power of two >= p
template <int P>
struct Lanes {
  static constexpr int value = P <= 2 ? 2 : P <= 4 ? 4 : P <= 8 ? 8 : P <= 16 ? 16 : 32;
};

// Subsets first .. first + nsize - 1 of the scaffold (all of size P) of each
// of the stack's matrices: work item w is matrix w / nsize, subset
// first + w % nsize.
template <int P, bool AUG>
__global__ void __launch_bounds__(kWarps * 32)
tor_lu_kernel(const void* __restrict__ o_mat, const void* __restrict__ gamma, int is_c64,
              const long long* __restrict__ idx, double2* __restrict__ det_out,
              double2* __restrict__ quad_out, long long nwork, int nsize, int first, int nsub,
              int pm) {
  constexpr int G = Lanes<P>::value;
  constexpr int W = AUG ? P + 1 : P;            // a row, with the right-hand side
  __shared__ double2 slab[kWarps][32 / G][2][W];  // the pivot row, double-buffered
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int r = lane % G;                       // this lane's row
  const int base = grp * G;                     // the group's first lane
  const long long w = (static_cast<long long>(blockIdx.x) * kWarps + warp) * (32 / G) + grp;
  const bool live = w < nwork && r < P;
  const long long b = w < nwork ? w / nsize : 0;
  const int s = first + static_cast<int>(w < nwork ? w - b * nsize : 0);
  const int zr = live ? static_cast<int>(idx[static_cast<size_t>(s) * pm + r]) : 0;
  const size_t ob = static_cast<size_t>(b) * pm * pm + static_cast<size_t>(zr) * pm;

  // row r of I - O_Z (a lane outside the subset holds a row of I)
  double2 a[W];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const int zc = __shfl_sync(kFull, zr, base + c);
    double2 v = make_double2(c == r ? 1.0 : 0.0, 0.0);
    if (live) {
      const double2 o = load_c(o_mat, is_c64, ob + zc);
      v = make_double2(__dsub_rn(v.x, o.x), -o.y);
    }
    a[c] = v;
  }
  double2 gz = make_double2(0.0, 0.0);
  if (AUG) {
    if (live) gz = load_c(gamma, is_c64, static_cast<size_t>(b) * pm + zr);
    a[W - 1] = make_double2(gz.x, -gz.y);       // conj(gamma_Z)
  }

  double2 det = make_double2(1.0, 0.0);
  double2 own_inv = make_double2(0.0, 0.0);     // K9: 1 / U_rr, kept by lane r
#pragma unroll
  for (int j = 0; j < P; ++j) {
    double2* row = slab[warp][grp][j & 1];
    if (r == j) {
#pragma unroll
      for (int c = j; c < W; ++c) row[c] = a[c];
    }
    __syncwarp();
    const double2 d = row[j];
    det = cmul(det, d);
    const double2 inv = cinv(d);
    if (AUG && r == j) own_inv = inv;
    if (r > j) {                                // the rows below the pivot
      const double2 l = cmul(a[j], inv);
#pragma unroll
      for (int c = j + 1; c < W; ++c) a[c] = cmsub(a[c], l, row[c]);
    }
  }

  double2 quad = make_double2(0.0, 0.0);
  if (AUG) {
    // back substitution: lane r holds row r of U and y_r; x_k goes to every
    // lane of the group, the rows above k take it out of their y
    double2 x = make_double2(0.0, 0.0);
#pragma unroll
    for (int k = P - 1; k >= 0; --k) {
      if (r == k) x = cmul(a[W - 1], own_inv);
      const double2 xk = shfl(x, base + k);
      if (r < k) a[W - 1] = cmsub(a[W - 1], a[k], xk);
    }
    quad = live ? cmul(gz, x) : make_double2(0.0, 0.0);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      quad.x = __dadd_rn(quad.x, __shfl_xor_sync(kFull, quad.x, off));
      quad.y = __dadd_rn(quad.y, __shfl_xor_sync(kFull, quad.y, off));
    }
  }
  if (live && r == 0) {
    const size_t out = static_cast<size_t>(b) * nsub + s;
    det_out[out] = det;
    if (AUG) quad_out[out] = quad;
  }
}

template <int P, bool AUG>
cudaError_t launch_size(const void* o_mat, const void* gamma, int is_c64, const long long* idx,
                        double2* det, double2* quad, long long nwork, int nsize, int first,
                        int nsub, int pm, cudaStream_t s) {
  constexpr long long per_block = kWarps * (32 / Lanes<P>::value);
  const long long nblocks = (nwork + per_block - 1) / per_block;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tor_lu_kernel<P, AUG><<<static_cast<unsigned>(nblocks), kWarps * 32, 0, s>>>(
      o_mat, gamma, is_c64, idx, det, quad, nwork, nsize, first, nsub, pm);
  return cudaGetLastError();
}

template <bool AUG>
cudaError_t launch_all(const void* o_mat, const void* gamma, int is_c64, const long long* idx,
                       double2* det, double2* quad, int batch, int m, cudaStream_t s) {
  const int pm = 2 * m;
  const int nsub = (1 << m) - 1;
  int first = 0;
  int nsize = 1;
  for (int k = 1; k <= m; ++k) {
    nsize = nsize * (m - k + 1) / k;            // C(m, k)
    const long long nwork = static_cast<long long>(batch) * nsize;
    cudaError_t err = cudaErrorInvalidValue;
    switch (2 * k) {
#define DQ_TOR_SIZE(P)                                                                          \
  case P:                                                                                       \
    err = launch_size<P, AUG>(o_mat, gamma, is_c64, idx, det, quad, nwork, nsize, first, nsub, \
                              pm, s);                                                           \
    break;
      DQ_TOR_SIZE(2) DQ_TOR_SIZE(4) DQ_TOR_SIZE(6) DQ_TOR_SIZE(8) DQ_TOR_SIZE(10)
      DQ_TOR_SIZE(12) DQ_TOR_SIZE(14) DQ_TOR_SIZE(16) DQ_TOR_SIZE(18) DQ_TOR_SIZE(20)
      DQ_TOR_SIZE(22) DQ_TOR_SIZE(24) DQ_TOR_SIZE(26) DQ_TOR_SIZE(28)
#undef DQ_TOR_SIZE
      default:
        break;
    }
    if (err != cudaSuccess) return err;
    first += nsize;
  }
  return cudaSuccess;
}

}  // namespace

// o_mat: (batch, 2m, 2m) complex64 (is_c64 != 0) or complex128, interleaved,
// read only, 1 <= m <= 14; gamma: (batch, 2m) of the same type, or null: then
// only the determinants are computed (K8) and quad is not touched; idx:
// (2^m - 1, 2m) int64, the rows of each subset grouped by size, smallest
// first, the first 2|Z| of a row valid (torontonian_.py::_padded_tor_indices);
// det, quad: (batch, 2^m - 1) complex128, written. One launch per subset
// size, in order, on ``stream``. Returns a cudaError_t.
extern "C" int dq_tor_lu(const void* o_mat, const void* gamma, int is_c64, const void* idx,
                         void* det, void* quad, int batch, int m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || m < 1 || 2 * m > kMaxSize) return cudaErrorInvalidValue;
  const auto* ix = static_cast<const long long*>(idx);
  auto* dt = static_cast<double2*>(det);
  auto* qd = static_cast<double2*>(quad);
  const auto s = static_cast<cudaStream_t>(stream);
  if (gamma == nullptr) return launch_all<false>(o_mat, nullptr, is_c64, ix, dt, qd, batch, m, s);
  return launch_all<true>(o_mat, gamma, is_c64, ix, dt, qd, batch, m, s);
}
