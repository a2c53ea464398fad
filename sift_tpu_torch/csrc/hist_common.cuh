// Device code shared by K3-ori (ori_hist.cu) and K3-desc
// (descr_hist.cu): the clamped load of a keypoint's window band,
// fastAtan2, and the order-free integer histogram that a thread block
// cluster of 1..8 CTAs fills for one keypoint.
//
// Numerics: every float operation of a sample is one IEEE operation
// with its own rounding (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn,
// sqrtf, expf; no FMA contraction, no fast math), in the order of the
// plain PyTorch versions beside the wrappers, so a sample lands in the
// bins the plain version computes and adds the same float32 value. That
// value v >= 0 is then added as the integer q = rn(v * 2^e) (an exact
// multiply and one rounding to nearest) to a 64-bit bin, with 32-bit
// shared-memory atomics (add_units), and each bin leaves as
// float(sum) * 2^-e (one rounding, an exact multiply). The scale 2^e is
// the keypoint's, from the largest finite gradient component of its box
// (scale_exponent), so every q is below 2^31 and no bin can overflow. Integer addition is associative, so the bits depend on
// neither the order of the adds nor on how the box is split across
// threads, warps or CTAs: two launches agree bit for bit, and so do one
// keypoint's rows under any cluster size and in a one- or a many-frame
// launch. Against the float sums of the plain version each bin differs
// by its summation order and by at most half a unit 2^-e per added
// sample, that is 2^-30 of that largest component (so a finite outlier
// in the box that it does not bin, far above the gradients it does,
// coarsens the unit). A keypoint one of whose binned samples has a
// value that is not finite (a NaN or an infinity in its gradient, or a
// magnitude that overflows) gets a row of NaN; a NaN or an infinity
// that it does not bin never touches the row.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace sift_hist {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kUnitBits = 29;    // scale_exponent: q < 2^(kUnitBits + 2)
constexpr int kMaxExponent = 100;

// One CTA's share of a keypoint: sample rows [lo, hi) of its
// (2R + 1)-row box, near-equal bands over the cluster's CTAs.
struct Band {
  int lo, hi;
};

__device__ __forceinline__ Band band_of(int side, int rank, int size) {
  return {side * rank / size, side * (rank + 1) / size};
}

// Window rows a CTA needs for a band of `rows` sample rows: the band
// plus the one-row gradient halo above and below.
__host__ __device__ constexpr int band_window_rows(int rows) {
  return rows + 2;
}

// Largest band of a (2 rmax + 1)-row box over `size` CTAs.
__host__ __device__ constexpr int max_band_rows(int rmax, int size) {
  return (2 * rmax + 1 + size - 1) / size;
}

// The band's samples row-major, thread t of n taking samples t, t + n,
// ...; (i, j) is the sample's row in the band and column in the box.
struct SampleWalk {
  int i, j, di, dj, side;
  __device__ __forceinline__ SampleWalk(int t, int n, int side_)
      : i(t / side_), j(t % side_), di(n / side_), dj(n % side_),
        side(side_) {}
  __device__ __forceinline__ void next() {
    i += di;
    j += dj;
    if (j >= side) {
      j -= side;
      ++i;
    }
  }
};

// Copies window rows [lo, lo + rows) and columns [c_lo, c_lo + span) of
// the (p, p) window of the padded stack src into win (rows, span). src
// holds the frames' planes back to back, (frames * lpf, Hp, Wp) with lpf
// planes a frame; the keypoint belongs to `frame`. The window's start
// (layer, row, col) is clamped as lax.dynamic_slice clamps it inside one
// frame's (lpf, Hp, Wp) stack (ori_gather_pallas.py:133-135,
// csrc/gather.cu), then offset to that frame's planes, so a slot of
// frame b with layer -1 reads frame b's first plane, never frame b - 1's
// last. With one frame this is the clamp to the whole stack. Warp w
// copies rows w, w + nwarps, ...; its lanes copy neighbouring columns,
// so each row is read with coalesced loads.
__device__ __forceinline__ void load_band(
    float* win, const float* __restrict__ src, int layer, int row, int col,
    int frame, int lpf, int Hp, int Wp, int p, int lo, int rows, int c_lo,
    int span, int warp, int nwarps, int lane) {
  const int l = frame * lpf + min(max(layer, 0), lpf - 1);
  const int r0 = min(max(row, 0), Hp - p);
  const int c0 = min(max(col, 0), Wp - p);
  const float* base = src + ((size_t)l * Hp + r0 + lo) * Wp + c0 + c_lo;
  for (int i = warp; i < rows; i += nwarps) {
    for (int j = lane; j < span; j += 32) {
      win[i * span + j] = base[(size_t)i * Wp + j];
    }
  }
}

__device__ __forceinline__ float warp_max(float g) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, k));
  }
  return g;
}

// This thread's share of the band's largest finite gradient component
// |dx|, |dy|, over every sample of the band's rows, binned or not; the
// band's window (rows + 2, span) must be in shared memory. The sample at
// band row i, box column j sits at window (i + 1, j + 1), and its
// components are the differences the samples take. A NaN or an infinity
// never sets the scale.
__device__ __forceinline__ float band_gradient(const float* win, int span,
                                               int side, int nband, int tid,
                                               int nthreads) {
  float g = 0.f;
  SampleWalk w(tid, nthreads, side);
  for (int s = tid; s < nband; s += nthreads, w.next()) {
    const float* px = win + (w.i + 1) * span + w.j + 1;
    const float m = fmaxf(fabsf(__fsub_rn(px[1], px[-1])),
                          fabsf(__fsub_rn(px[-span], px[span])));
    // m > g is false for NaN; m <= FLT_MAX for an infinity
    if (m > g && m <= 3.402823466e38f) g = m;
  }
  return g;
}

// The scale 2^e of a keypoint's integer histogram from G, the largest
// finite gradient component of its box. With E = ilogb(G), every finite
// component is below 2^(E + 1), a magnitude (the square root of the sum
// of two squares) below 1.42 * 2^(E + 1), and every contribution, that
// magnitude times weights in [0, 1] (bf16 rounding included, at most
// 2^-8 up), below 2^(E + 2); so with e = kUnitBits - E every q is below
// 2^(kUnitBits + 2) = 2^31, and a bin, the sum of at most one q per
// sample of a box of under 2^32 samples, below 2^63. A sample with a
// non-finite component has a non-finite value, which turns the row to
// NaN (cluster_store), so its q does not matter. The unit 2^-e is
// 2^(E - 29), at most 2^-29 of G. e stops at kMaxExponent for G near or
// at zero, so 2^e and 2^-e are normal floats.
__device__ __forceinline__ int scale_exponent(float g) {
  if (g == 0.f) return kMaxExponent;
  return min(kUnitBits - ilogbf(g), kMaxExponent);
}

// The keypoint's scale exponent from the per-warp maxima every CTA of
// the cluster left in grads[0..nwarps) of its shared memory, after a
// cluster.sync(). Each warp computes it on its own.
__device__ __forceinline__ int cluster_scale_exponent(
    cg::cluster_group& cluster, const float* grads, int nwarps, int lane) {
  const int size = static_cast<int>(cluster.num_blocks());
  float g = 0.f;
  for (int k = lane; k < size * nwarps; k += 32) {
    g = fmaxf(g, cluster.map_shared_rank(grads, k / nwarps)[k % nwarps]);
  }
  return scale_exponent(warp_max(g));
}

__device__ __forceinline__ float exp2_float(int e) {
  return __int_as_float((127 + e) << 23);
}

// v (>= 0, float32) as an integer count of the unit 2^-e; scale = 2^e
__device__ __forceinline__ unsigned to_units(float v, float scale) {
  return __float2uint_rn(__fmul_rn(v, scale));
}

// *bin += v, exactly, with 32-bit atomics (ATOMS.ADD in shared memory;
// a 64-bit shared atomic add compiles to a compare-and-swap loop on
// sm_90a, ATOMS.CAST.SPIN.64): the low word's add returns the old word,
// so the add that wraps it knows it and carries one into the high word,
// which it adds only when the high half plus that carry is not zero (for
// a sample's q < 2^31, only on a wrap). bin may lie in another CTA's
// shared memory (distributed shared memory). Only the pair's final value
// is meaningful; it is read after a barrier.
__device__ __forceinline__ void add_units(unsigned long long* bin,
                                          unsigned long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(bin);   // little-endian
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(word, lo);
  const unsigned hi = static_cast<unsigned>(v >> 32) + (old + lo < old);
  if (hi) atomicAdd(word + 1, hi);
}

// Every other CTA of the cluster adds its integer histogram into CTA
// 0's through distributed shared memory, and raises CTA 0's *flag if
// its own is raised (a binned value that was not finite); then CTA 0
// writes the keypoint's row out[0..bins) as floats, all NaN if its flag
// is raised. *flag must be zeroed before the cluster's first barrier.
// Call after the last sample of every CTA, from all threads of all CTAs.
__device__ __forceinline__ void cluster_store(cg::cluster_group& cluster,
                                              unsigned long long* hist,
                                              int* flag, int bins, int e,
                                              float* out, int tid,
                                              int nthreads) {
  __syncthreads();
  if (cluster.block_rank() != 0) {
    unsigned long long* lead = cluster.map_shared_rank(hist, 0);
    for (int b = tid; b < bins; b += nthreads) {
      if (hist[b]) add_units(&lead[b], hist[b]);
    }
    if (tid == 0 && *flag) atomicOr(cluster.map_shared_rank(flag, 0), 1);
  }
  cluster.sync();   // every add has landed; no CTA leaves before them
  if (cluster.block_rank() == 0) {
    const bool nan = *flag != 0;
    const float inv = exp2_float(-e);
    for (int b = tid; b < bins; b += nthreads) {
      out[b] = nan ? __int_as_float(0x7fffffff)
                   : __fmul_rn(__ull2float_rn(hist[b]), inv);
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

// Launches kernel over N keypoints with `cluster` CTAs each (clusters
// of consecutive blockIdx.x), nthreads threads and smem bytes of dynamic
// shared memory; returns the launch's own error (the caller then checks
// cudaGetLastError). One CTA a keypoint launches without the cluster
// attribute, which costs time even at size 1 (PERF.md §6); the CTA
// is then a cluster of one, and its cluster barriers are CTA barriers.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int N, int cluster,
                            int nthreads, size_t smem, cudaStream_t stream,
                            Args... args) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (cluster == 1) {
    kernel<<<N, nthreads, smem, stream>>>(args...);
    return cudaSuccess;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)N * cluster);
  config.blockDim = dim3(nthreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace sift_hist
