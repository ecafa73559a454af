// The 16-byte access plan of the per-gate kernels K1 (planar_apply.cu), K5
// (planar_grad.cu) and K6 (planar_bwd_fused.cu).
//
// A float32 plane of 2^n amplitudes is read as 2^(n - 2) aligned float4
// "quads": amplitude bits 0-1 pick the lane of a quad, bits >= 2 the quad.
// A gate on k <= 3 wires holds LOW of the amplitude bits 0-1 and H = k - LOW
// bits >= 2, which sit at quad bits hb[0] > ... > hb[H - 1] (amplitude bit
// minus 2; wire 0 is the most significant amplitude bit). A unit is the
// 2^H quads that differ only in those bits: 4 * 2^H amplitudes, which are
// G = 4 / 2^LOW whole groups (a group: the 2^k amplitudes that differ only
// in the gate's bits). Units are numbered by their quad index with the H
// gate bits taken out, so unit u's first quad is u with zero bits inserted
// at hb. In a unit, quad ch (its gate bits; hb[0] the most significant bit
// of ch) and lane l hold the amplitude of group s at gate index
// c = (ch << LOW) | cl:
//   LOW = 0: s = l, cl = 0          each quad holds one gate index of 4 groups;
//   LOW = 1: s = l >> 1, cl = l & 1 the gate holds bit 0 (a gate on bit 1
//                                   swaps lanes 1 and 2 after each load and
//                                   before each store, and is then the same);
//   LOW = 2: s = 0, cl = l          the quad holds 4 partners of one group.
// c is the row / column of the gate's planes in sorted-wire order: its bit
// (k - 1 - j) belongs to the j-th sorted wire. So LOW = 0 is the variant
// whose quads hold 4 groups' same partner, LOW = 1, 2 the variant whose
// quads hold the gate's own partners, paired in registers.
//
// Indices are 32-bit: the wrappers take n <= 33 (a 2^33-amplitude state is
// 64 GB a tensor), so a quad index within one sample is below 2^31; a
// sample's first quad is the only 64-bit offset, taken once per block.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dq {

constexpr int kQuadThreads = 256;

// lane of group s's amplitude at low gate index cl
template <int LOW>
__device__ __forceinline__ constexpr int quad_lane(int s, int cl) {
  return LOW == 0 ? s : (LOW == 1 ? (s << 1) | cl : cl);
}

template <int H>
struct QuadPlan {
  int hb[3];
  unsigned off[1 << H];   // quad offset of gate bits ch within a unit

  __device__ __forceinline__ QuadPlan(int hb0, int hb1, int hb2) : hb{hb0, hb1, hb2} {
#pragma unroll
    for (int ch = 0; ch < (1 << H); ++ch) off[ch] = offset(ch);
  }

  __device__ __forceinline__ unsigned offset(int ch) const {
    unsigned o = 0;
#pragma unroll
    for (int j = 0; j < H; ++j) o |= unsigned((ch >> (H - 1 - j)) & 1) << hb[j];
    return o;
  }

  // the first quad of unit u: zero bits inserted at hb, lowest first
  __device__ __forceinline__ unsigned base(unsigned u) const {
#pragma unroll
    for (int j = H - 1; j >= 0; --j) {
      const int b = hb[j];
      u = ((u >> b) << (b + 1)) | (u & ((1u << b) - 1u));
    }
    return u;
  }
};

// a quad as four lanes in registers, lanes 1 and 2 swapped where the gate
// holds amplitude bit 1 but not bit 0
__device__ __forceinline__ void unpack_quad(const float4 q, float (&a)[4], bool swap) {
  a[0] = q.x;
  a[1] = swap ? q.z : q.y;
  a[2] = swap ? q.y : q.z;
  a[3] = q.w;
}

__device__ __forceinline__ float4 pack_quad(const float (&a)[4], bool swap) {
  return make_float4(a[0], swap ? a[2] : a[1], swap ? a[1] : a[2], a[3]);
}

// the gate's planes, in registers at k <= 2, read from shared memory at k = 3
template <int K>
struct Planes {
  static constexpr int D = 1 << K;
  static constexpr bool kRegs = K <= 2;
  float re[kRegs ? D * D : 1];
  float im[kRegs ? D * D : 1];
  const float* sre;
  const float* sim;

  __device__ __forceinline__ Planes(const float* r, const float* i) : sre(r), sim(i) {
    if constexpr (kRegs) {
#pragma unroll
      for (int e = 0; e < D * D; ++e) {
        re[e] = r[e];
        im[e] = i[e];
      }
    }
  }
  __device__ __forceinline__ float mr(int e) const {
    if constexpr (kRegs) return re[e];
    return sre[e];
  }
  __device__ __forceinline__ float mi(int e) const {
    if constexpr (kRegs) return im[e];
    return sim[e];
  }
};

// rows (ah << LOW) | cl of y = M v for the groups of one unit: quad ah of
// the result, lane by lane, from the unit's quads v unpacked (K1 and K6)
template <int K, int LOW>
__device__ __forceinline__ void mat_quad(const Planes<K>& m, int ah,
                                         const float (&vr)[1 << (K - LOW)][4],
                                         const float (&vi)[1 << (K - LOW)][4], float (&yr)[4],
                                         float (&yi)[4]) {
  constexpr int D = 1 << K;
  constexpr int NQ = 1 << (K - LOW);
  constexpr int CL = 1 << LOW;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int s = LOW == 0 ? l : (LOW == 1 ? l >> 1 : 0);   // the lane's group
    const int a = (ah << LOW) | (LOW == 0 ? 0 : (LOW == 1 ? (l & 1) : l));
    float sr = 0.f;
    float si = 0.f;
#pragma unroll
    for (int ch = 0; ch < NQ; ++ch) {
#pragma unroll
      for (int cl = 0; cl < CL; ++cl) {
        const int c = (ch << LOW) | cl;
        const int lc = quad_lane<LOW>(s, cl);
        const float mr = m.mr(a * D + c);
        const float mi = m.mi(a * D + c);
        sr = fmaf(mr, vr[ch][lc], sr);
        sr = fmaf(-mi, vi[ch][lc], sr);
        si = fmaf(mr, vi[ch][lc], si);
        si = fmaf(mi, vr[ch][lc], si);
      }
    }
    yr[l] = sr;
    yi[l] = si;
  }
}

// f.template run<K, LOW>() of the kernel instance for (k, low); the entry
// points check 1 <= k <= 3 and 0 <= low <= min(k, 2) first
template <class F>
int quad_dispatch(int k, int low, const F& f) {
  switch (k * 4 + low) {
    case 4: return f.template run<1, 0>();
    case 5: return f.template run<1, 1>();
    case 8: return f.template run<2, 0>();
    case 9: return f.template run<2, 1>();
    case 10: return f.template run<2, 2>();
    case 12: return f.template run<3, 0>();
    case 13: return f.template run<3, 1>();
    default: return f.template run<3, 2>();
  }
}

// the plan's arguments as the entry points take them: 0 if they hold
inline bool bad_plan(int n, int k, int low, int swap, const int (&hb)[3]) {
  if (k < 1 || k > 3 || n < 2 || n > 33 || low < 0 || low > 2 || low > k ||
      (swap != 0 && low != 1))
    return true;
  for (int j = 0; j < k - low; ++j)
    if (hb[j] < 0 || hb[j] > n - 3 || (j > 0 && hb[j] >= hb[j - 1])) return true;
  return false;
}

}  // namespace dq
