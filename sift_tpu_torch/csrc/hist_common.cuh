// Device helpers shared by K3-ori (ori_hist.cu) and K3-desc
// (descr_hist.cu): the clamped window load, fastAtan2, and the
// deterministic warp-private histogram update.
//
// Numerics: every float operation is one IEEE operation with its own
// rounding (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, sqrtf,
// expf; no FMA contraction, no fast math), in the order of the plain
// PyTorch versions beside the wrappers, so a sample's bins are those the
// plain version computes on the same card.

#pragma once

#include <cuda_runtime.h>

namespace sift_hist {

constexpr unsigned kFullMask = 0xffffffffu;

// Copies rows and columns [lo, lo + span) of the (p, p) window of the
// padded stack src (L, Hp, Wp) into win (p, p, row stride p). The start
// (layer, row, col) is clamped as lax.dynamic_slice clamps it
// (ori_gather_pallas.py:133-135, csrc/gather.cu). Warp w copies rows
// w, w + nwarps, ...; its lanes copy neighbouring columns, so each row
// is read with coalesced loads.
__device__ __forceinline__ void load_window(
    float* win, const float* __restrict__ src, int layer, int row, int col,
    int L, int Hp, int Wp, int p, int lo, int span, int warp, int nwarps,
    int lane) {
  const int l = min(max(layer, 0), L - 1);
  const int r0 = min(max(row, 0), Hp - p);
  const int c0 = min(max(col, 0), Wp - p);
  const float* base = src + ((size_t)l * Hp + r0 + lo) * Wp + c0 + lo;
  for (int i = warp; i < span; i += nwarps) {
    for (int j = lane; j < span; j += 32) {
      win[(lo + i) * p + lo + j] = base[(size_t)i * Wp + j];
    }
  }
}

// cv::hal::fastAtan2 in degrees, [0, 360): ops/mathutil.py
// fast_atan2_deg operation by operation (the DBL_EPSILON guard taken in
// float32, the polynomial in Horner form, the three quadrant folds).
__device__ __forceinline__ float fast_atan2_deg(float y, float x) {
  constexpr double kDeg = 180.0 / 3.141592653589793;
  constexpr float kP1 = static_cast<float>(0.9997878412794807 * kDeg);
  constexpr float kP3 = static_cast<float>(-0.3258083974640975 * kDeg);
  constexpr float kP5 = static_cast<float>(0.1555786518463281 * kDeg);
  constexpr float kP7 = static_cast<float>(-0.04432655554792128 * kDeg);
  constexpr float kEps = static_cast<float>(2.220446049250313e-16);
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ax < ay;
  const float c = swap ? __fdiv_rn(ax, __fadd_rn(ay, kEps))
                       : __fdiv_rn(ay, __fadd_rn(ax, kEps));
  const float c2 = __fmul_rn(c, c);
  float a = __fadd_rn(__fmul_rn(kP7, c2), kP5);
  a = __fadd_rn(__fmul_rn(a, c2), kP3);
  a = __fadd_rn(__fmul_rn(a, c2), kP1);
  a = __fmul_rn(a, c);
  if (swap) a = __fsub_rn(90.f, a);
  if (x < 0.f) a = __fsub_rn(180.f, a);
  if (y < 0.f) a = __fsub_rn(360.f, a);
  return a;
}

// Lanes of one warp that share a key: the lowest of them leads, and
// `rest` holds the others, in increasing lane order. Lanes with key < 0
// belong to no histogram and never lead.
struct Group {
  bool leader;
  unsigned rest;
};

__device__ __forceinline__ Group group_of(int key, int lane) {
  const unsigned grp = __match_any_sync(kFullMask, key);
  const bool leader = key >= 0 && __ffs(grp) - 1 == lane;
  return {leader, leader ? grp & (grp - 1) : 0u};
}

// hist[key] += v over the warp's 32 lanes (lanes with key < 0 add
// nothing). The leader of each key sums its group's values in lane
// order and alone stores, so no two lanes touch one address and
// nothing depends on scheduling. hist is private to the warp. All 32
// lanes must call it.
__device__ __forceinline__ void warp_add(float* hist, int key, float v,
                                         int lane) {
  Group g = group_of(key, lane);
  float acc = v;
  while (__any_sync(kFullMask, g.rest != 0)) {
    const int src = g.rest ? __ffs(g.rest) - 1 : lane;
    const float t = __shfl_sync(kFullMask, v, src);
    if (g.rest) {
      acc = __fadd_rn(acc, t);
      g.rest &= g.rest - 1;
    }
  }
  if (g.leader) hist[key] = __fadd_rn(hist[key], acc);
  __syncwarp();
}

}  // namespace sift_hist
