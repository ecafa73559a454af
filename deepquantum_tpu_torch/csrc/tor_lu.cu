// K8 tor_dets and K9 tor_dets_quads: for every nonempty subset Z of the m
// modes of a (2m, 2m) complex matrix O, det(I - O_Z), and for K9 also the
// quadratic form gamma_Z^T (I - O_Z)^{-1} conj(gamma_Z), in float64
// whatever the input type (complex64 or complex128, interleaved). O_Z keeps
// the rows and columns (y, y + m) of the modes y in Z, sorted; these are the
// terms of the torontonian's inclusion-exclusion sum.
//
// Replaces the TPU kernels
// deepquantum_tpu/photonic/tor_kernel.py::tor_dets_pallas (body
// _tor_click_kernel) and ::tor_dets_quads_pallas (body _tor_loop_kernel).
// Those run double-single arithmetic (the chip has no float64) with 128
// subsets across the lanes, one launch per subset size, on (p, p, S) planes
// that the wrapper gathers through device memory. None of that is carried
// over: the card has float64 units, and one launch covers all sizes.
//
// Bound on the H100: float64 operations (about 8 p^3 / 3 per subset of size
// p = 2|Z| against 16 (2m)^2 bytes of input and 16 bytes out per subset).
// The design:
//  - O (at most 28 x 28) sits in shared memory as complex128 and each
//    subset builds I - O_Z from its row of the index scaffold there, so no
//    gathered tensor goes through device memory;
//  - one warp owns one subset: a 28 x 29 complex128 working matrix (13 KB)
//    does not fit a thread's registers, so it lives in shared memory and
//    the lanes share each elimination step's trailing block, entry by
//    entry, with __syncwarp() between pivot steps. The scaffold is grouped
//    by size, so the warps of a block work on equal sizes; the true size p
//    comes from the scaffold's validity column, and the padding is never
//    touched;
//  - LU without pivoting, multipliers from the pivot COLUMN: O is not
//    symmetric. I - O_Z has its spectrum away from zero for a physical
//    covariance, and a singular input gives inf/nan as a library det would;
//  - K9 carries conj(gamma_Z) as one more column through the elimination
//    and back-substitutes (a third of the work of the TPU body's full
//    Gauss-Jordan); gamma_Z enters the dot product unconjugated;
//  - every subset's result is written by one lane: nothing is summed across
//    warps, so the results do not change from run to run. The epilogue
//    (1 / sqrt(det), exp(quad / 2), the signed sum) stays in the wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSize = 28;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cinv(double2 a) {
  const double s = 1.0 / (a.x * a.x + a.y * a.y);
  return make_double2(a.x * s, -a.y * s);
}

__device__ __forceinline__ double2 load_c(const void* p, int is_c64, int i) {
  if (is_c64) {
    const float2 v = static_cast<const float2*>(p)[i];
    return make_double2(double(v.x), double(v.y));
  }
  return static_cast<const double2*>(p)[i];
}

template <bool AUG>
__global__ void __launch_bounds__(kThreads)
tor_lu_kernel(const void* __restrict__ o_mat, const void* __restrict__ gamma, int is_c64,
              const long long* __restrict__ idx, const float* __restrict__ valid,
              double2* __restrict__ det_out, double2* __restrict__ quad_out, int nsub, int pm) {
  extern __shared__ double2 sm[];
  __shared__ int sidx[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ld = pm + 1;                         // row stride of a working matrix
  double2* so = sm;                              // O, (pm, pm)
  double2* sg = so + pm * pm;                    // gamma, (pm,)
  double2* a = sg + pm + warp * (pm * ld);       // this warp's working matrix
  for (int e = threadIdx.x; e < pm * pm; e += kThreads) so[e] = load_c(o_mat, is_c64, e);
  if (AUG) {
    for (int e = threadIdx.x; e < pm; e += kThreads) sg[e] = load_c(gamma, is_c64, e);
  }
  __syncthreads();

  for (int s = blockIdx.x * kWarps + warp; s < nsub; s += gridDim.x * kWarps) {
    // the subset's rows: the first p entries of its scaffold row are valid
    const bool ok = lane < pm && valid[size_t(s) * pm + lane] != 0.f;
    sidx[warp][lane] = lane < pm ? int(idx[size_t(s) * pm + lane]) : 0;
    const int p = __popc(__ballot_sync(kFull, ok));
    __syncwarp();
    const int* z = sidx[warp];
    const int nc = p + (AUG ? 1 : 0);
    for (int e = lane; e < p * nc; e += 32) {
      const int r = e / nc;
      const int c = e - r * nc;
      if (c < p) {
        const double2 o = so[z[r] * pm + z[c]];
        a[r * ld + c] = make_double2((r == c ? 1.0 : 0.0) - o.x, -o.y);
      } else {
        const double2 g = sg[z[r]];
        a[r * ld + c] = make_double2(g.x, -g.y);
      }
    }
    __syncwarp();

    double2 det = make_double2(1.0, 0.0);
    for (int j = 0; j < p; ++j) {
      const double2 d = a[j * ld + j];
      det = cmul(det, d);
      const double2 inv = cinv(d);
      const int w = nc - j - 1;                  // trailing columns (with the rhs)
      const int cnt = (p - j - 1) * w;
      for (int e = lane; e < cnt; e += 32) {
        const int r = j + 1 + e / w;
        const int c = j + 1 + e % w;
        const double2 mult = cmul(a[r * ld + j], inv);
        const double2 u = cmul(mult, a[j * ld + c]);
        double2 v = a[r * ld + c];
        v.x -= u.x;
        v.y -= u.y;
        a[r * ld + c] = v;
      }
      __syncwarp();
    }

    double2 quad = make_double2(0.0, 0.0);
    if (AUG) {
      // back substitution on the rhs column; every lane follows the same x_k
      for (int k = p - 1; k >= 0; --k) {
        const double2 xk = cmul(a[k * ld + p], cinv(a[k * ld + k]));
        const double2 t = cmul(sg[z[k]], xk);
        quad.x += t.x;
        quad.y += t.y;
        if (lane < k) {                          // rows above k; row k itself is not written
          const double2 u = cmul(a[lane * ld + k], xk);
          a[lane * ld + p].x -= u.x;
          a[lane * ld + p].y -= u.y;
        }
        __syncwarp();
      }
    }
    if (lane == 0) {
      det_out[s] = det;
      if (AUG) quad_out[s] = quad;
    }
    __syncwarp();
  }
}

template <bool AUG>
cudaError_t launch(const void* o_mat, const void* gamma, int is_c64, const long long* idx,
                   const float* valid, double2* det, double2* quad, int nsub, int pm,
                   cudaStream_t s) {
  const size_t smem = size_t(pm * pm + pm + kWarps * pm * (pm + 1)) * sizeof(double2);
  cudaError_t err = cudaFuncSetAttribute(tor_lu_kernel<AUG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int nblocks = (nsub + kWarps - 1) / kWarps;
  if (nblocks > 8 * 132) nblocks = 8 * 132;      // further subsets: the warps' stride loop
  tor_lu_kernel<AUG><<<nblocks, kThreads, smem, s>>>(o_mat, gamma, is_c64, idx, valid, det, quad,
                                                     nsub, pm);
  return cudaGetLastError();
}

}  // namespace

// o_mat: (pm, pm) complex64 (is_c64 != 0) or complex128, interleaved, read
// only, pm = 2m <= 28; gamma: (pm,) of the same type, or null: then only the
// determinants are computed (K8) and quad is not touched; idx: (nsub, pm)
// int64 rows of each subset, the first p valid; valid: (nsub, pm) float32,
// non-zero where idx is valid; det, quad: (nsub,) complex128, written.
// Returns a cudaError_t.
extern "C" int dq_tor_lu(const void* o_mat, const void* gamma, int is_c64, const void* idx,
                         const void* valid, void* det, void* quad, int nsub, int pm, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nsub < 1 || pm < 2 || pm > kMaxSize || (pm & 1)) return cudaErrorInvalidValue;
  const auto* ix = static_cast<const long long*>(idx);
  const auto* va = static_cast<const float*>(valid);
  auto* dt = static_cast<double2*>(det);
  auto* qd = static_cast<double2*>(quad);
  const auto s = static_cast<cudaStream_t>(stream);
  if (gamma == nullptr) {
    return launch<false>(o_mat, nullptr, is_c64, ix, va, dt, qd, nsub, pm, s);
  }
  return launch<true>(o_mat, gamma, is_c64, ix, va, dt, qd, nsub, pm, s);
}
