// K1b / K6b redesigned: a scheduled run of k <= 3 wire gate steps applied to
// a (B, 2, 2^n) float32 stack in ONE launch per direction, each sample's
// state held in shared memory for the whole run.
//
// Replaces, for the batched chain, the TPU kernels
//   deepquantum_tpu/ops/planar_gate.py::_planar_apply, batched branch
//     (:377-393, pallas_call :412): the forward entry below;
//   deepquantum_tpu/ops/planar_gate.py::_planar_bwd_fused, batched branch
//     (:636-705, pallas_call :687): the backward entry below.
// On the TPU each gate is one Pallas call inside one jitted program, the
// batch a grid axis, and a call costs no host time. On the card the same
// shape is one launch and one wrapper call per gate, and a full pass of the
// stack through L2 per gate.
//
// Bound on the H100. One call must read the stack and write it once (the
// backward: y and g in, x and g_in out) and do 8 * 4^k flops per group of
// 2^k amplitudes per step (the backward three times that: U^H y, U^H g and
// the cotangent planes). At n=14, B=100 and the QML chain's 52 steps that is
// 2.10 GFLOP, 31 us of FP32 against 26.2 MB, 7.8 us of memory: the chain is
// bound by operations, which the per-step route never reached because each
// step paid a launch, a wrapper call and a pass over the stack.
//
// Design. Each sample gets a cluster of C = 2^c blocks; block r holds, in
// dynamic shared memory, both planes (the backward: y and g) of the
// amplitudes whose top c index bits equal r: 2^(n-c) of them. The stack is
// read once in 16-byte loads and written once. A step splits the 2^n
// amplitudes into 2^(n-k) groups of 2^k that differ in the gate's bits;
// block r owns groups r * 2^(n-k-c) ... (r + 1) * 2^(n-k-c) - 1, so a group
// has exactly one owning thread in the cluster (at k = 3 in the backward,
// SPLIT = 4 neighbouring lanes share it, each storing its own rows) and the
// update is in place with no conflict. A gate on none of the top c bits
// touches only the owner's own amplitudes; a gate on one of them reaches the
// other blocks' amplitudes through distributed shared memory
// (cluster.map_shared_rank). Steps are separated by a block barrier, or a
// cluster barrier where this step or the last one reached another block.
// The step's planes are staged in shared memory, double-buffered so that
// the next step's planes load before the barrier that ends this one: the
// sample's own planes, or one set read by every sample (stride 0). The
// backward stages U^H from U's planes (transposed, imaginary plane negated)
// and reduces dW = g x^H per step with warp shuffles and one block sum, one
// partial per (sample, block) and step, summed by the wrapper in a fixed
// order: dW is the same bits on every launch.
//
// The step table (one row per gate step, forward order): k, shared, the
// planes' float offset (into the per-sample rows or the shared buffer), the
// partial's float offset, the amplitude bits of the planes' row bits in
// their order (a relabel that the scheduler put before the step is folded
// into these), and the same bits sorted high to low for the group index.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 10;          // ints per step-table row
constexpr int kStage = 128;        // floats of one staged step: re and im of up to 8 x 8
constexpr int kMaxC = 8;           // the portable cluster size
constexpr int kMaxLocalBits = 14;  // 2^14 amplitudes of two planes: 128 KB a block

struct Step {
  int k;
  int shared;
  int off;
  int doff;
  int obits[3];
  int sbits[3];
};

__device__ __forceinline__ Step read_step(const int* __restrict__ table, int s) {
  const int* r = table + s * kCols;
  Step st;
  st.k = __ldg(r);
  st.shared = __ldg(r + 1);
  st.off = __ldg(r + 2);
  st.doff = __ldg(r + 3);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    st.obits[j] = __ldg(r + 4 + j);
    st.sbits[j] = __ldg(r + 7 + j);
  }
  return st;
}

__device__ __forceinline__ uint32_t insert_zero(uint32_t i, int b) {
  return ((i >> b) << (b + 1)) | (i & ((1u << b) - 1));
}

// base index (the gate's bits zero) of group g; sbits high to low
template <int K>
__device__ __forceinline__ uint32_t group_base(uint32_t g, const int (&sbits)[3]) {
#pragma unroll
  for (int j = K - 1; j >= 0; --j) g = insert_zero(g, sbits[j]);
  return g;
}

// index of the group's amplitude whose gate bits spell row/column a: row
// bit (K - 1 - j) is amplitude bit obits[j]
template <int K>
__device__ __forceinline__ uint32_t group_offset(uint32_t base, int a, const int (&obits)[3]) {
#pragma unroll
  for (int j = 0; j < K; ++j) base |= uint32_t((a >> (K - 1 - j)) & 1) << obits[j];
  return base;
}

// Stage one step's planes into buf (re at 0, im at 64): U, or with ADJOINT
// U^H = (U_re^T, -U_im^T).
template <bool ADJOINT>
__device__ __forceinline__ void stage(float* buf, const Step& st, const float* __restrict__ ps_re,
                                      const float* __restrict__ ps_im,
                                      const float* __restrict__ sh_re,
                                      const float* __restrict__ sh_im, size_t soff) {
  const int d = 1 << st.k;
  const float* pr = st.shared ? sh_re + st.off : ps_re + soff + st.off;
  const float* pi = st.shared ? sh_im + st.off : ps_im + soff + st.off;
  for (int e = threadIdx.x; e < d * d; e += kThreads) {
    if (ADJOINT) {
      const int t = (e % d) * d + e / d;
      buf[e] = pr[t];
      buf[64 + e] = -pi[t];
    } else {
      buf[e] = pr[e];
      buf[64 + e] = pi[e];
    }
  }
}

// The step's planes as the group loop reads them. At k <= 2 the compiler
// keeps the (up to 32) values in registers across the loop; at k = 3 the
// 128 would spill, so the pointer is hidden from it in every iteration and
// the values are read from shared memory where they are used.
template <int K>
__device__ __forceinline__ const float* planes_in_loop(const float* m) {
  if (K == 3) asm volatile("" : "+l"(m));
  return m;
}

// where amplitude idx lives: its block's shared memory (another block's
// through the cluster window when REMOTE) at the local offset
template <bool REMOTE>
__device__ __forceinline__ float* amp(float* sm, float* const* peers, uint32_t idx, int lbits) {
  const uint32_t loc = idx & ((1u << lbits) - 1);
  return (REMOTE ? peers[idx >> lbits] : sm) + loc;
}

// Forward step: every owned group of 2^K amplitudes becomes M times itself.
template <int K, bool REMOTE>
__device__ __forceinline__ void apply_step(float* sm, float* const* peers,
                                           const float* __restrict__ m, const Step& st,
                                           uint32_t rank, int lbits) {
  constexpr int D = 1 << K;
  const uint32_t L = 1u << lbits;
  const uint32_t gpb = 1u << (lbits - K);
  for (uint32_t j = threadIdx.x; j < gpb; j += kThreads) {
    const float* mk = planes_in_loop<K>(m);
    const uint32_t base = group_base<K>(rank * gpb + j, st.sbits);
    float* p[D];
    float vr[D];
    float vi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      p[c] = amp<REMOTE>(sm, peers, group_offset<K>(base, c, st.obits), lbits);
      vr[c] = p[c][0];
      vi[c] = p[c][L];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float yr = 0.f;
      float yi = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float mr = mk[a * D + c];
        const float mi = mk[64 + a * D + c];
        yr = fmaf(mr, vr[c], yr);
        yr = fmaf(-mi, vi[c], yr);
        yi = fmaf(mr, vi[c], yi);
        yi = fmaf(mi, vr[c], yi);
      }
      p[a][0] = yr;
      p[a][L] = yi;
    }
  }
}

// Backward step with the U^H planes staged in m: y becomes x = U^H y, g
// becomes U^H g, and the block's partial of dRe / dIm (from the raw g and
// the recovered x) goes to part[0 .. 2 D^2). SPLIT neighbouring lanes share
// a group: all load it, meet at __syncwarp() so that no lane stores before
// the others have loaded, all compute x (the reduction needs every column),
// each stores and reduces its own D / SPLIT rows.
template <int K, int SPLIT, bool REMOTE>
__device__ __forceinline__ void adjoint_step(float* sm, float* const* peers,
                                             const float* __restrict__ m, const Step& st,
                                             uint32_t rank, int lbits, float* red,
                                             float* __restrict__ part) {
  constexpr int D = 1 << K;
  constexpr int ROWS = D / SPLIT;
  constexpr unsigned kFull = 0xffffffffu;
  const uint32_t L = 1u << lbits;
  const uint32_t gpb = 1u << (lbits - K);
  const int sub = threadIdx.x % SPLIT;
  float are[ROWS * D];
  float aim[ROWS * D];
#pragma unroll
  for (int e = 0; e < ROWS * D; ++e) {
    are[e] = 0.f;
    aim[e] = 0.f;
  }
  for (uint32_t j0 = 0; j0 < gpb; j0 += kThreads / SPLIT) {
    const uint32_t j = j0 + threadIdx.x / SPLIT;
    const bool on = j < gpb;
    const uint32_t base = on ? group_base<K>(rank * gpb + j, st.sbits) : 0;
    float vyr[D];
    float vyi[D];
    float vgr[D];
    float vgi[D];
    if (on) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float* p = amp<REMOTE>(sm, peers, group_offset<K>(base, c, st.obits), lbits);
        vyr[c] = p[0];
        vyi[c] = p[L];
        vgr[c] = p[2 * L];
        vgi[c] = p[3 * L];
      }
    }
    if (SPLIT > 1) __syncwarp();
    if (!on) continue;
    const float* mk = planes_in_loop<K>(m);
    float vxr[D];
    float vxi[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float r = 0.f;
      float i = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float mr = mk[a * D + c];
        const float mi = mk[64 + a * D + c];
        r = fmaf(-mi, vyi[c], fmaf(mr, vyr[c], r));
        i = fmaf(mi, vyr[c], fmaf(mr, vyi[c], i));
      }
      vxr[a] = r;
      vxi[a] = i;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if (a / ROWS != sub) continue;
      float* p = amp<REMOTE>(sm, peers, group_offset<K>(base, a, st.obits), lbits);
      p[0] = vxr[a];
      p[L] = vxi[a];
      const float ga = vgr[a];
      const float gb = vgi[a];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const int e = (a % ROWS) * D + c;
        are[e] = fmaf(ga, vxr[c], fmaf(gb, vxi[c], are[e]));
        aim[e] = fmaf(gb, vxr[c], fmaf(-ga, vxi[c], aim[e]));
      }
      float r = 0.f;
      float i = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float mr = mk[a * D + c];
        const float mi = mk[64 + a * D + c];
        r = fmaf(-mi, vgi[c], fmaf(mr, vgr[c], r));
        i = fmaf(mi, vgr[c], fmaf(mr, vgi[c], i));
      }
      p[2 * L] = r;
      p[3 * L] = i;
    }
  }
  // the block's partial, in a fixed order: lanes of equal (lane % SPLIT),
  // then the warps in turn
#pragma unroll
  for (int e = 0; e < ROWS * D; ++e) {
#pragma unroll
    for (int o = 16; o >= SPLIT; o >>= 1) {
      are[e] += __shfl_xor_sync(kFull, are[e], o);
      aim[e] += __shfl_xor_sync(kFull, aim[e], o);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < SPLIT) {
    const int r0 = lane * ROWS;
#pragma unroll
    for (int e = 0; e < ROWS * D; ++e) {
      red[warp * kStage + r0 * D + e] = are[e];
      red[warp * kStage + D * D + r0 * D + e] = aim[e];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * D * D; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kStage + e];
    part[e] = s;
  }
}

// ends a step: a cluster barrier where this step or the next reaches
// another block's amplitudes, else a block barrier
__device__ __forceinline__ void step_barrier(bool cluster_wide) {
  if (cluster_wide) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Copy `planes` planes of this block's 2^lbits amplitudes between the
// stack (sample stride 2 * 2^n floats for each plane pair) and shared memory.
template <bool TO_SHARED>
__device__ __forceinline__ void copy_block(float* sm, float* gmem, int planes, uint32_t rank,
                                           int n, int lbits) {
  const uint32_t q = (1u << lbits) / 4;
  float4* s4 = reinterpret_cast<float4*>(sm);
  for (int p = 0; p < planes; ++p) {
    float4* g4 = reinterpret_cast<float4*>(gmem + (size_t(p) << n) + (size_t(rank) << lbits));
    for (uint32_t i = threadIdx.x; i < q; i += kThreads) {
      if (TO_SHARED) {
        s4[p * q + i] = g4[i];
      } else {
        g4[i] = s4[p * q + i];
      }
    }
  }
}

__device__ __forceinline__ uint32_t cluster_rank(int c) {
  return c ? cg::this_cluster().block_rank() : 0u;
}

__device__ __forceinline__ void set_peers(float* sm, float** peers, int c) {
  if (c && threadIdx.x < (1u << c)) {
    peers[threadIdx.x] = cg::this_cluster().map_shared_rank(sm, threadIdx.x);
  }
}

// at most 64 registers a thread: two 64 KB blocks (n - c = 13) share an SM
__global__ void __launch_bounds__(kThreads, 2)
chain_fwd_kernel(const int* __restrict__ table, int nstep, const float* __restrict__ ps_re,
                 const float* __restrict__ ps_im, const float* __restrict__ sh_re,
                 const float* __restrict__ sh_im, int pstride, const float* __restrict__ x,
                 float* __restrict__ y, int n, int c) {
  extern __shared__ float4 smem4[];
  __shared__ float* peers[kMaxC];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lbits = n - c;
  float* mbuf = sm + (2u << lbits);
  const uint32_t rank = cluster_rank(c);
  const size_t sample = blockIdx.x >> c;
  const size_t soff = sample * size_t(pstride);
  set_peers(sm, peers, c);
  copy_block<true>(sm, const_cast<float*>(x) + sample * (size_t(2) << n), 2, rank, n, lbits);
  Step st = read_step(table, 0);
  stage<false>(mbuf, st, ps_re, ps_im, sh_re, sh_im, soff);
  bool rem = st.sbits[0] >= lbits;
  step_barrier(c && rem);
  for (int s = 0; s < nstep; ++s) {
    const float* m = mbuf + (s & 1) * kStage;
    switch (st.k * 2 + rem) {
      case 2: apply_step<1, false>(sm, peers, m, st, rank, lbits); break;
      case 3: apply_step<1, true>(sm, peers, m, st, rank, lbits); break;
      case 4: apply_step<2, false>(sm, peers, m, st, rank, lbits); break;
      case 5: apply_step<2, true>(sm, peers, m, st, rank, lbits); break;
      case 6: apply_step<3, false>(sm, peers, m, st, rank, lbits); break;
      default: apply_step<3, true>(sm, peers, m, st, rank, lbits); break;
    }
    bool next_rem = false;
    if (s + 1 < nstep) {
      st = read_step(table, s + 1);
      stage<false>(mbuf + ((s + 1) & 1) * kStage, st, ps_re, ps_im, sh_re, sh_im, soff);
      next_rem = st.sbits[0] >= lbits;
    }
    step_barrier(c && (rem || next_rem));
    rem = next_rem;
  }
  copy_block<false>(sm, y + sample * (size_t(2) << n), 2, rank, n, lbits);
}

__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_kernel(const int* __restrict__ table, int nstep, const float* __restrict__ ps_re,
                 const float* __restrict__ ps_im, const float* __restrict__ sh_re,
                 const float* __restrict__ sh_im, int pstride, const float* __restrict__ y,
                 const float* __restrict__ g, float* __restrict__ x_out,
                 float* __restrict__ g_out, float* __restrict__ parts, int fd, int n, int c) {
  extern __shared__ float4 smem4[];
  __shared__ float* peers[kMaxC];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lbits = n - c;
  float* mbuf = sm + (4u << lbits);
  float* red = mbuf + 2 * kStage;
  const uint32_t rank = cluster_rank(c);
  const size_t sample = blockIdx.x >> c;
  const size_t soff = sample * size_t(pstride);
  float* part = parts + size_t(blockIdx.x) * size_t(fd);
  set_peers(sm, peers, c);
  copy_block<true>(sm, const_cast<float*>(y) + sample * (size_t(2) << n), 2, rank, n, lbits);
  copy_block<true>(sm + (2u << lbits), const_cast<float*>(g) + sample * (size_t(2) << n), 2,
                   rank, n, lbits);
  Step st = read_step(table, nstep - 1);
  stage<true>(mbuf, st, ps_re, ps_im, sh_re, sh_im, soff);
  bool rem = st.sbits[0] >= lbits;
  step_barrier(c && rem);
  for (int t = 0; t < nstep; ++t) {
    const float* m = mbuf + (t & 1) * kStage;
    float* out = part + st.doff;
    switch (st.k * 2 + rem) {
      case 2: adjoint_step<1, 1, false>(sm, peers, m, st, rank, lbits, red, out); break;
      case 3: adjoint_step<1, 1, true>(sm, peers, m, st, rank, lbits, red, out); break;
      case 4: adjoint_step<2, 1, false>(sm, peers, m, st, rank, lbits, red, out); break;
      case 5: adjoint_step<2, 1, true>(sm, peers, m, st, rank, lbits, red, out); break;
      case 6: adjoint_step<3, 4, false>(sm, peers, m, st, rank, lbits, red, out); break;
      default: adjoint_step<3, 4, true>(sm, peers, m, st, rank, lbits, red, out); break;
    }
    bool next_rem = false;
    if (t + 1 < nstep) {
      st = read_step(table, nstep - 2 - t);
      stage<true>(mbuf + ((t + 1) & 1) * kStage, st, ps_re, ps_im, sh_re, sh_im, soff);
      next_rem = st.sbits[0] >= lbits;
    }
    step_barrier(c && (rem || next_rem));
    rem = next_rem;
  }
  copy_block<false>(sm, x_out + sample * (size_t(2) << n), 2, rank, n, lbits);
  copy_block<false>(sm + (2u << lbits), g_out + sample * (size_t(2) << n), 2, rank, n, lbits);
}

size_t fwd_smem(int lbits) { return (size_t(2) << lbits) * 4 + 2 * kStage * 4; }

size_t bwd_smem(int lbits) {
  return (size_t(4) << lbits) * 4 + 2 * kStage * 4 + size_t(kWarps) * kStage * 4;
}

// A launch of `kernel` on batch * 2^c blocks in clusters of 2^c, with the
// dynamic shared memory limit raised to what it needs.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int batch, int c, size_t smem, cudaStream_t s,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) << c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int nstep, int pstride, int batch, int n, int c, int max_local) {
  return nstep < 1 || pstride < 0 || batch < 1 || c < 0 || (1 << c) > kMaxC || n - c < 5 ||
         n - c > max_local || (int64_t(batch) << c) >= (int64_t(1) << 31);
}

}  // namespace

// table: (nstep, 10) int32 rows in forward order (see the note above);
// ps_re / ps_im: the per-sample planes, (batch, pstride) float32; sh_re /
// sh_im: the shared planes, float32; x: (batch, 2, 2^n) float32, read; y:
// the same shape, written. c: log2 of the cluster size (0..3), n - c in
// [5, 14]. Returns a cudaError_t.
extern "C" int dq_planar_chain_batched_fwd_f32(const void* table, int nstep, const void* ps_re,
                                               const void* ps_im, const void* sh_re,
                                               const void* sh_im, int pstride, const void* x,
                                               void* y, int batch, int n, int c, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(nstep, pstride, batch, n, c, kMaxLocalBits) || x == y) return cudaErrorInvalidValue;
  return launch_clusters(chain_fwd_kernel, batch, c, fwd_smem(n - c),
                         static_cast<cudaStream_t>(stream), static_cast<const int*>(table), nstep,
                         static_cast<const float*>(ps_re), static_cast<const float*>(ps_im),
                         static_cast<const float*>(sh_re), static_cast<const float*>(sh_im),
                         pstride, static_cast<const float*>(x), static_cast<float*>(y), n, c);
}

// The reverse walk from the chain's output y and its cotangent g (both
// (batch, 2, 2^n), read): x_out gets the chain's input, g_out the input
// cotangent, parts (batch, 2^c, fd) float32 the per-block partials of every
// step's (2, 2^k, 2^k) cotangent planes at the step's offset. c: 0..3,
// n - c in [5, 13]. Returns a cudaError_t.
extern "C" int dq_planar_chain_batched_bwd_f32(const void* table, int nstep, const void* ps_re,
                                               const void* ps_im, const void* sh_re,
                                               const void* sh_im, int pstride, const void* y,
                                               const void* g, void* x_out, void* g_out,
                                               void* parts, int fd, int batch, int n, int c,
                                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(nstep, pstride, batch, n, c, kMaxLocalBits - 1) || fd < 8 || y == g ||
      x_out == g_out)
    return cudaErrorInvalidValue;
  return launch_clusters(chain_bwd_kernel, batch, c, bwd_smem(n - c),
                         static_cast<cudaStream_t>(stream), static_cast<const int*>(table), nstep,
                         static_cast<const float*>(ps_re), static_cast<const float*>(ps_im),
                         static_cast<const float*>(sh_re), static_cast<const float*>(sh_im),
                         pstride, static_cast<const float*>(y), static_cast<const float*>(g),
                         static_cast<float*>(x_out), static_cast<float*>(g_out),
                         static_cast<float*>(parts), fd, n, c);
}

// How many clusters of 2^c blocks of one direction's kernel (backward != 0:
// the backward) at n qubits the card keeps resident at once, from
// cudaOccupancyMaxActiveClusters, into *out (a host int). Returns a
// cudaError_t.
extern "C" int dq_planar_chain_batched_clusters(int n, int c, int backward, void* out,
                                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_shape(1, 0, 1, n, c, backward ? kMaxLocalBits - 1 : kMaxLocalBits))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << c);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int* count = static_cast<int*>(out);
  if (backward) {
    cfg.dynamicSmemBytes = bwd_smem(n - c);
    err = cudaFuncSetAttribute(chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(count, chain_bwd_kernel, &cfg);
  } else {
    cfg.dynamicSmemBytes = fwd_smem(n - c);
    err = cudaFuncSetAttribute(chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(count, chain_fwd_kernel, &cfg);
  }
  return err;
}
