// K3-ori: per-keypoint 36-bin gradient-orientation histograms, read
// straight from the padded octave stack.
//
// Replaces, for the orientation stage, the Pallas patch gather
// sift_tpu/ops/ori_gather_pallas.py:109 (gather_patches) together with
// the one-hot contraction that consumes its patches,
// sift_tpu/ops/orientation.py:34 (_hist_bins, "onehot_t"). The TPU has
// a matrix unit and no cheap scatter, so sift_tpu writes each patch to
// device memory and turns the histogram into a one-hot product. Here
// each keypoint's window is staged in shared memory and its samples are
// binned there: neither the patch nor a one-hot tensor reaches device
// memory, and the only output is the raw (N, 36) histogram, `hist` of
// ops/orientation.py before smoothing (calcOrientationHist,
// src/sift.cpp:389-458).
//
// Work: one launch for all keypoints of an octave, of one frame or of
// all B frames of a batch (the frames' planes stacked, load_band's
// per-frame clamp); a thread block cluster of 1..8 CTAs of 4 warps per
// keypoint, the cluster size chosen by the wrapper from the keypoint
// count (cluster_size), as in K3-desc, whose skeleton this shares
// (hist_common.cuh): CTA k loads the k-th band of rows of the keypoint's
// (2R + 1)^2 sample box, R = min(radius, rp), plus the gradient halo,
// the CTAs agree on the keypoint's integer scale through distributed
// shared memory, each bins its band into a 64-bit integer histogram
// with 32-bit shared atomics, and CTA 0 adds the cluster's histograms
// through distributed shared memory. One CTA a keypoint is a plain
// launch. Samples outside the box are masked in the plain version, so
// they are skipped.
//
// What bounds it on the H100: neither bytes nor float rate, but the
// latency of each CTA's window load, scale pass and barriers. Measured
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6, run Y9:
// tools/torch_kernel_times.py, tools/torch_k3_split.py): the 1,024
// keypoints of a 1080p octave 0 take 0.0171 ms (the previous design, a
// warp vote that summed floats in a fixed order, 0.0204); of the
// split's 0.0171 ms the window load with the scale's pass and barriers
// is 0.0121, the per-sample arithmetic 0.0033 and the integer adds
// 0.0017; the batch step's 8 x 1,024 take 0.0626 ms (0.0720), 64
// keypoints over clusters of 5 CTAs 0.0098 (one CTA each, 0.0134). One
// warp a keypoint (32-thread CTAs) took 0.0383 ms at 1,024 and 0.0140
// at 64, so the kernel keeps 4 warps a CTA. The bound, the pixels'
// bytes at 3.35 TB/s, is 0.0007 ms.
//
// Numerics (hist_common.cuh): each sample's bin (cvRound of its
// fastAtan2 angle) and its float32 value wgt * mag are the plain
// version's, operation by operation; the sums are integers at a
// per-keypoint power-of-two scale from the largest finite gradient
// component of the keypoint's box, so no bin can overflow, and the bits
// depend on neither the order of the adds, the cluster size nor the
// number of frames in the launch. The result differs from the plain
// version's one-hot product by that product's float summation order and
// by at most half a unit 2^-e per sample and bin, 2^-30 of that largest
// component. A binned sample whose value is not finite makes the row
// NaN (the plain version's product makes the row non-finite too: 0 * NaN
// and 0 * inf are NaN); a NaN or an infinity that is not binned never
// touches it.

#include "hist_common.cuh"

namespace {

using namespace sift_hist;

constexpr int kBins = 36;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kBinScale = static_cast<float>(36.0 / 360.0);

__device__ __forceinline__ void hist_add(unsigned long long* hist, int bin,
                                         float v, float scale) {
  add_units(&hist[bin], to_units(v, scale));
}

__global__ void __launch_bounds__(kThreads)
ori_hist_kernel(const float* __restrict__ src, const int* __restrict__ layer,
                const int* __restrict__ row, const int* __restrict__ col,
                const int* __restrict__ radius,
                const float* __restrict__ expf_scale,
                float* __restrict__ out, int kpf, int lpf, int Hp, int Wp,
                int rp, int w, int row_lo, int row_hi) {
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
  const int R = min(radius[n], rp);
  if (R < 0) {   // alike for every CTA of the cluster
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
  load_band(win, src, layer[n], kr, kc, n / kpf, lpf, Hp, Wp, 2 * rp + 3,
            rp - R + band.lo, band_window_rows(band.hi - band.lo), rp - R,
            span, warp, kWarps, lane);
  __syncthreads();
  const int nband = (band.hi - band.lo) * side;
  const float g = warp_max(band_gradient(win, span, side, nband, tid,
                                         kThreads));
  if (lane == 0) grads[warp] = g;
  cluster.sync();
  const int e = cluster_scale_exponent(cluster, grads, kWarps, lane);
  const float scale = exp2_float(e);

  const float es = expf_scale[n];
  SampleWalk walk(tid, kThreads, side);
  for (int s = tid; s < nband; s += kThreads, walk.next()) {
    const int i = walk.i, j = walk.j;
    const int ii = band.lo + i - R, jj = j - R;
    const int yy = kr + ii, xx = kc + jj;
    if (yy > row_lo && yy < row_hi - 1 && xx > 0 && xx < w - 1) {
      // the sample sits at band window (i + 1, j + 1)
      const float* px = win + (i + 1) * span + j + 1;
      const float dx = __fsub_rn(px[1], px[-1]);
      const float dy = __fsub_rn(px[-span], px[span]);
      const float wgt =
          expf(__fmul_rn(static_cast<float>(ii * ii + jj * jj), es));
      const float mag = sqrtf(__fadd_rn(__fmul_rn(dx, dx),
                                        __fmul_rn(dy, dy)));
      const float theta = fast_atan2_deg(dy, dx);
      const float v = __fmul_rn(wgt, mag);
      int bin = __float2int_rn(__fmul_rn(kBinScale, theta));  // cvRound
      if (bin >= kBins) bin -= kBins;
      if (bin < 0) bin += kBins;
      if (!isfinite(v)) *flag = 1;   // every writer writes 1
      hist_add(hist, bin, v, scale);
    }
  }
  cluster_store(cluster, hist, flag, kBins, e, o, tid, kThreads);
}

}  // namespace

// src (L, Hp, Wp) padded by rp + 1 around an (h, w) image: B frames of
// L / B planes each, back to back; layer (the index into its frame's
// planes), row, col, radius (N,) int32; expf_scale (N,) float32 -> out
// (N, 36). Keypoints [b N / B, (b + 1) N / B) belong to frame b; B = 1
// is one frame, whose layer clamps to the whole stack. A sample counts
// where its row lies strictly inside (row_lo, row_hi - 1): (0, h) for a
// whole image; a row band of a larger image passes the local rows of
// that image's first row and of one past its last, which may lie
// outside the band (compared, never clamped). cluster (1..8): CTAs per
// keypoint; the result does not depend on it.
extern "C" int sift_ori_hist(const float* src, const int* layer,
                             const int* row, const int* col,
                             const int* radius, const float* expf_scale,
                             float* out, int N, int B, int L, int Hp, int Wp,
                             int rp, int row_lo, int row_hi, int cluster,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  const int p = 2 * rp + 3;
  const int h = Hp - 2 * (rp + 1), w = Wp - 2 * (rp + 1);
  if (B < 1 || N % B != 0 || L % B != 0 || rp < 0 || L < B || h < 1 ||
      w < 1 || cluster < 1 || cluster > kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(unsigned long long) * kBins + sizeof(float) * kWarps +
      sizeof(int) +
      sizeof(float) * (size_t)band_window_rows(max_band_rows(rp, cluster)) * p;
  const cudaError_t err = launch_clusters(
      ori_hist_kernel, N, cluster, kThreads, smem, stream, src, layer, row,
      col, radius, expf_scale, out, N / B, L / B, Hp, Wp, rp, w, row_lo,
      row_hi);
  return err != cudaSuccess ? err : cudaGetLastError();
}
