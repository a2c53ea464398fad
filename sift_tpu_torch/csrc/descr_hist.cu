// K3-desc: per-keypoint raw SIFT descriptor histograms, (d+2) x (d+2)
// spatial cells x (n+2) orientation bins = 6 x 6 x 10, read straight
// from the padded octave stack.
//
// Replaces, for the descriptor stage, the Pallas patch gather
// sift_tpu/ops/ori_gather_pallas.py:109 (gather_patches) together with
// the soft one-hot contraction that consumes its patches,
// sift_tpu/ops/descriptor.py:140-171 (rw x cw one-hots against
// magnitude-weighted orientation one-hots, one einsum). On the TPU the
// trilinear scatter of calcSIFTDescriptor (src/sift.cpp:579-753) became
// a matrix product because the TPU has a matrix unit and no cheap
// scatter; the port's plain version keeps that form
// (ops/descr_hist_cuda.py, torch.bmm over 64-keypoint chunks). Here each
// keypoint's window is staged in shared memory and every sample adds its
// 8 trilinear weights to a shared-memory histogram: neither the 85 x 85
// patch nor the (P, 36) one-hot reaches device memory, and one launch
// covers all keypoints of an octave, of one frame or of all B frames of
// a batch (the frames' planes stacked, load_band's per-frame clamp).
// The output is `hist` before the circular fold; the fold and the
// normalization chain stay in PyTorch.
//
// Work: a thread block cluster of 1..8 CTAs of 8 warps per keypoint,
// the cluster size chosen by the wrapper from the keypoint count
// (ori_hist_cuda.cluster_size), so that an octave with fewer keypoints
// than the card has SMs still spreads over the card. CTA k of a cluster
// bins the k-th band of rows of the keypoint's (2R + 1)^2 sample box,
// R = min(radius, rd), and loads only that band's window rows plus the
// one-row gradient halo, with coalesced row loads. Samples outside the
// box are masked in the plain version, so they are skipped. The CTAs
// agree on the keypoint's integer scale through distributed shared
// memory (each CTA's largest gradient component, one cluster barrier);
// each sample adds its 8 corner weights as integers (hist_common.cuh)
// with 32-bit shared-memory atomics into its CTA's 64-bit histogram;
// after a cluster barrier CTA 0 adds the other CTAs' histograms through
// distributed shared memory and writes the row. One CTA a keypoint is a
// plain launch. Slots with valid false write zeros.
//
// What bounds it on the H100: neither bytes nor float rate, but the
// latency of each CTA's phases and the serialised adds of lanes that hit
// one bin. Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6,
// run Y9: tools/torch_kernel_times.py, tools/torch_k3_split.py): the
// 1,024 slots of a 1080p octave 0 take 0.0534 ms (the previous design,
// a warp vote that summed floats in a fixed order, 0.0783); of the
// split's 0.0536 ms the window load with the scale's pass and barriers
// is 0.0204, the per-sample arithmetic 0.0131 and the integer adds
// 0.0201; the batch step's 8 x 1,024 take 0.2805 ms (0.4213), 64
// keypoints split over clusters of 5 CTAs 0.0150 (one CTA each,
// 0.0276). The bound, the function's float operations at the 33.5 T/s
// issue rate, is 0.0038 ms.
//
// Numerics (hist_common.cuh): each sample's bins and its 8 float32
// weights are the plain version's, operation by operation; the sums are
// integers at a per-keypoint power-of-two scale taken from the largest
// finite gradient component of the keypoint's box, so no bin can
// overflow, and every CTA of a cluster uses the same scale. The bits do
// not depend on the order of the adds, the cluster size or the number
// of frames in the launch. The result differs from the plain version's
// bmm by that version's float summation order and by at most half a
// unit 2^-e per sample and bin, 2^-30 of that largest component. A
// binned sample whose magnitude is not finite makes the row NaN; a NaN
// or an infinity that is not binned never touches it (the plain
// version's one-hot product turns a masked-out sample's NaN angle into
// a NaN row, 0 * NaN).
//
// The bf16 arm (rc_bf16, sift_tpu's descr_rc_bf16=True,
// sift_tpu/ops/descriptor.py:139-165): JAX casts the two einsum operands
// to bfloat16, the row x column weight rc = wr wc and the
// magnitude-weighted orientation weight ow = wo mag, and sums their
// products in float32. Here each corner rounds the same two factors
// (round to nearest even) before their product; the product of two
// bfloat16 values is exact in float32. A template parameter, so the f32
// arm's inner loop is unchanged.

#include <cuda_bf16.h>

#include "hist_common.cuh"

namespace {

using namespace sift_hist;

constexpr int kD = 4;                           // spatial cells per side
constexpr int kN = 8;                           // orientation bins
constexpr int kRowStride = (kD + 2) * (kN + 2);
constexpr int kBins = (kD + 2) * kRowStride;    // 360
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBinShift = kD / 2 - 0.5f;      // 1.5
constexpr float kWgtScale = -1.f / (kD * kD * 0.5f);   // -0.125
constexpr float kObinScale = static_cast<float>(kN / 360.0);

// x rounded to bfloat16 (round to nearest even) and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The 8 trilinear weights of one sample, corner k = 4 dr + 2 dc + do:
// ((1 - fr | fr) * (1 - fc | fc)) * ((1 - fo | fo) * mag), the
// product of the plain version's rw x cw one-hot and its
// magnitude-weighted orientation one-hot; under kBf16 each of the two
// factors is rounded to bfloat16 first.
template <bool kBf16>
__device__ __forceinline__ void corner_weights(float fr, float fc, float fo,
                                               float mag, float (&v)[8]) {
  const float wr[2] = {__fsub_rn(1.f, fr), fr};
  const float wc[2] = {__fsub_rn(1.f, fc), fc};
  float wo[2] = {__fmul_rn(__fsub_rn(1.f, fo), mag), __fmul_rn(fo, mag)};
  if (kBf16) {
    wo[0] = round_bf16(wo[0]);
    wo[1] = round_bf16(wo[1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float rc = __fmul_rn(wr[k >> 2], wc[(k >> 1) & 1]);
    if (kBf16) rc = round_bf16(rc);
    v[k] = __fmul_rn(rc, wo[k & 1]);
  }
}

// hist[key + corner k] += the 8 weights as integer units (key is the
// lower bin); the 8 bins are distinct.
template <bool kBf16>
__device__ __forceinline__ void add_corners(unsigned long long* hist, int key,
                                            float fr, float fc, float fo,
                                            float mag, float scale) {
  float v[8];
  corner_weights<kBf16>(fr, fc, fo, mag, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = key + (k >> 2) * kRowStride + ((k >> 1) & 1) * (kN + 2)
                  + (k & 1);
    add_units(&hist[b], to_units(v[k], scale));
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
descr_hist_kernel(const float* __restrict__ src,
                  const int* __restrict__ layer, const int* __restrict__ row,
                  const int* __restrict__ col,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const int* __restrict__ radius,
                  const float* __restrict__ ori,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out, int kpf, int lpf, int Hp, int Wp,
                  int rd, int w, int row_lo, int row_hi) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* hist = smem;                        // (kBins,)
  float* grads = reinterpret_cast<float*>(hist + kBins);   // (kWarps,)
  int* flag = reinterpret_cast<int*>(grads + kWarps);      // (1,)
  float* win = reinterpret_cast<float*>(flag + 1);         // (rows, span)
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int n = blockIdx.x / size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* o = out + (size_t)n * kBins;
  const int R = min(radius[n], rd);
  if (!valid[n] || R < 0) {   // alike for every CTA of the cluster
    if (cluster.block_rank() == 0) {
      for (int t = tid; t < kBins; t += kThreads) o[t] = 0.f;
    }
    return;
  }

  const int side = 2 * R + 1, span = 2 * R + 3;
  const Band band = band_of(side, static_cast<int>(cluster.block_rank()),
                            size);
  const int kr = row[n], kc = col[n];
  for (int t = tid; t < kBins; t += kThreads) hist[t] = 0ull;
  if (tid == 0) *flag = 0;
  load_band(win, src, layer[n], kr, kc, n / kpf, lpf, Hp, Wp, 2 * rd + 3,
            rd - R + band.lo, band_window_rows(band.hi - band.lo), rd - R,
            span, warp, kWarps, lane);
  __syncthreads();
  const int nband = (band.hi - band.lo) * side;
  const float g = warp_max(band_gradient(win, span, side, nband, tid,
                                         kThreads));
  if (lane == 0) grads[warp] = g;
  cluster.sync();
  const int e = cluster_scale_exponent(cluster, grads, kWarps, lane);
  const float scale = exp2_float(e);

  const float ct = cos_t[n], st = sin_t[n], ori_n = ori[n];
  SampleWalk walk(tid, kThreads, side);
  for (int s = tid; s < nband; s += kThreads, walk.next()) {
    const int i = walk.i, j = walk.j;
    const int ii = band.lo + i - R, jj = j - R;
    const float fi = static_cast<float>(ii), fj = static_cast<float>(jj);
    const float c_rot = __fsub_rn(__fmul_rn(fj, ct), __fmul_rn(fi, st));
    const float r_rot = __fadd_rn(__fmul_rn(fj, st), __fmul_rn(fi, ct));
    const float rbin = __fadd_rn(r_rot, kBinShift);
    const float cbin = __fadd_rn(c_rot, kBinShift);
    const int rr = kr + ii, cc = kc + jj;
    if (rbin > -1.f && rbin < kD && cbin > -1.f && cbin < kD &&
        rr > row_lo && rr < row_hi - 1 && cc > 0 && cc < w - 1) {
      // the sample sits at band window (i + 1, j + 1)
      const float* px = win + (i + 1) * span + j + 1;
      const float dx = __fsub_rn(px[1], px[-1]);
      const float dy = __fsub_rn(px[-span], px[span]);
      const float wgt = expf(__fmul_rn(
          __fadd_rn(__fmul_rn(c_rot, c_rot), __fmul_rn(r_rot, r_rot)),
          kWgtScale));
      const float mag_g = sqrtf(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)));
      const float theta = fast_atan2_deg(dy, dx);
      const float obin = __fmul_rn(__fsub_rn(theta, ori_n), kObinScale);
      const float mag = __fmul_rn(mag_g, wgt);
      const float r0 = floorf(rbin), c0 = floorf(cbin), o0 = floorf(obin);
      const float fr = __fsub_rn(rbin, r0);
      const float fc = __fsub_rn(cbin, c0);
      const float fo = __fsub_rn(obin, o0);
      int oi = static_cast<int>(o0);
      if (oi < 0) oi += kN;
      if (oi >= kN) oi -= kN;
      const int key = (static_cast<int>(r0) + 1) * kRowStride
                      + (static_cast<int>(c0) + 1) * (kN + 2) + oi;
      // the 8 values are at most mag, so finite where it is (a finite
      // mag is below 2^65: dx * dx overflows beyond)
      if (!isfinite(mag)) *flag = 1;   // every writer writes 1
      add_corners<kBf16>(hist, key, fr, fc, fo, mag, scale);
    }
  }
  cluster_store(cluster, hist, flag, kBins, e, o, tid, kThreads);
}

template <bool kBf16>
cudaError_t launch(const float* src, const int* layer, const int* row,
                   const int* col, const float* cos_t, const float* sin_t,
                   const int* radius, const float* ori,
                   const unsigned char* valid, float* out, int N, int B,
                   int L, int Hp, int Wp, int rd, int w, int row_lo,
                   int row_hi, int cluster, cudaStream_t stream) {
  const int p = 2 * rd + 3;
  const size_t smem =
      sizeof(unsigned long long) * kBins + sizeof(float) * kWarps +
      sizeof(int) +
      sizeof(float) * (size_t)band_window_rows(max_band_rows(rd, cluster)) * p;
  const cudaError_t err = launch_clusters(
      descr_hist_kernel<kBf16>, N, cluster, kThreads, smem, stream, src,
      layer, row, col, cos_t, sin_t, radius, ori, valid, out, N / B, L / B,
      Hp, Wp, rd, w, row_lo, row_hi);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// src (L, Hp, Wp) padded by rd + 1 around an (h, w) image: B frames of
// L / B planes each, back to back, as in sift_ori_hist; layer (the
// index into its frame's planes), row, col, radius (N,) int32; cos_t,
// sin_t, ori (N,) float32; valid (N,) bool -> out (N, 6, 6, 10).
// Keypoints [b N / B, (b + 1) N / B) belong to frame b. A sample counts
// where its row lies strictly inside (row_lo, row_hi - 1), as in
// sift_ori_hist: (0, h) for a whole image. rc_bf16 != 0 takes the bf16
// arm. cluster (1..8): CTAs per keypoint; the result does not depend on
// it.
extern "C" int sift_descr_hist(const float* src, const int* layer,
                               const int* row, const int* col,
                               const float* cos_t, const float* sin_t,
                               const int* radius, const float* ori,
                               const unsigned char* valid, float* out, int N,
                               int B, int L, int Hp, int Wp, int rd,
                               int row_lo, int row_hi, int rc_bf16,
                               int cluster, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  const int h = Hp - 2 * (rd + 1), w = Wp - 2 * (rd + 1);
  if (B < 1 || N % B != 0 || L % B != 0 || rd < 0 || L < B || h < 1 ||
      w < 1 || cluster < 1 || cluster > kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  return rc_bf16
             ? launch<true>(src, layer, row, col, cos_t, sin_t, radius, ori,
                            valid, out, N, B, L, Hp, Wp, rd, w, row_lo,
                            row_hi, cluster, stream)
             : launch<false>(src, layer, row, col, cos_t, sin_t, radius, ori,
                             valid, out, N, B, L, Hp, Wp, rd, w, row_lo,
                             row_hi, cluster, stream);
}
