// K3-ori: per-keypoint 36-bin gradient-orientation histograms, read
// straight from the padded octave stack.
//
// Replaces, for the orientation stage, the Pallas patch gather
// sift_tpu/ops/ori_gather_pallas.py:109 (gather_patches) together with
// the one-hot contraction that consumes its patches,
// sift_tpu/ops/orientation.py:34 (_hist_bins, "onehot_t"). The TPU has
// a matrix unit and no cheap scatter, so sift_tpu writes each patch to
// device memory and turns the histogram into a one-hot product. Here a
// block stages its keypoint's window in shared memory and bins the
// samples there: neither the patch nor a one-hot tensor reaches device
// memory, and the only output is the raw (N, 36) histogram, `hist` of
// ops/orientation.py before smoothing (calcOrientationHist,
// src/sift.cpp:389-458).
//
// Work: one block of 4 warps per keypoint, one launch for all keypoints
// of an octave, of one frame or of all B frames of a batch (the frames'
// planes stacked, load_window's per-frame clamp). A block loads only the
// rows and columns its own radius R = min(radius, rp) can reach, a
// (2R + 3)^2 sub-window of the (2 rp + 3)^2 patch, with coalesced row
// loads; samples outside that box are masked in the plain version, so
// they are skipped. Several blocks share an SM (5.9 KB of shared memory
// each), so one block's loads overlap another's binning; there is no
// TMA or cp.async pipeline: the window starts at arbitrary columns,
// and the per-sample arithmetic dominates the load.
//
// What bounds it on the H100: neither traffic nor float rate. The
// windows of 1024 keypoints are at most 12 MB (3.7 us at 3.35 TB/s),
// with ~26 float operations a sample; measured on an H100 80GB HBM3 at
// 700 W, the 1024 keypoints of a 1080p octave 0 take 0.06-0.07 ms, over
// 100x the 0.5 us byte bound of the pixels their windows touch. The
// dependent per-sample chain (expf, sqrtf, a division) and the warp
// vote of the histogram update are the likely limits (not profiled).
//
// Summation order (fixed, so two launches are bit-identical): samples
// are numbered row-major over the (2R + 1)^2 box; warp w takes samples
// 32 (w + 4 k) + lane for k = 0, 1, ...; within one such step the
// lanes hitting one bin are summed in lane order and added to the
// warp's private histogram; the 4 warp histograms are summed in warp
// order. No float atomics. The result differs from the plain version's
// bmm only by that order.

#include "hist_common.cuh"

namespace {

using namespace sift_hist;

constexpr int kBins = 36;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kBinScale = static_cast<float>(36.0 / 360.0);

__global__ void __launch_bounds__(kThreads)
ori_hist_kernel(const float* __restrict__ src, const int* __restrict__ layer,
                const int* __restrict__ row, const int* __restrict__ col,
                const int* __restrict__ radius,
                const float* __restrict__ expf_scale,
                float* __restrict__ out, int kpf, int lpf, int Hp, int Wp,
                int rp, int w, int row_lo, int row_hi) {
  extern __shared__ float smem[];
  const int p = 2 * rp + 3;
  float* win = smem;                      // (p, p)
  float* whist = smem + p * p;            // (kWarps, kBins)
  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = min(radius[n], rp);

  for (int t = tid; t < kWarps * kBins; t += kThreads) whist[t] = 0.f;
  if (R >= 0) {
    load_window(win, src, layer[n], row[n], col[n], n / kpf, lpf, Hp, Wp, p,
                rp - R, 2 * R + 3, warp, kWarps, lane);
  }
  __syncthreads();

  const int kr = row[n], kc = col[n];
  const float es = expf_scale[n];
  const int side = 2 * R + 1;
  const int nsamp = R >= 0 ? side * side : 0;
  float* hist = whist + warp * kBins;
  for (int b = warp * 32; b < nsamp; b += kThreads) {
    const int s = b + lane;
    int key = -1;
    float v = 0.f;
    if (s < nsamp) {
      const int ii = s / side - R, jj = s % side - R;
      const int yy = kr + ii, xx = kc + jj;
      if (yy > row_lo && yy < row_hi - 1 && xx > 0 && xx < w - 1) {
        // sample (ii, jj) sits at window (i + 1, j + 1)
        const int i = ii + rp, j = jj + rp;
        const float dx = __fsub_rn(win[(i + 1) * p + j + 2],
                                   win[(i + 1) * p + j]);
        const float dy = __fsub_rn(win[i * p + j + 1],
                                   win[(i + 2) * p + j + 1]);
        const float wgt =
            expf(__fmul_rn(static_cast<float>(ii * ii + jj * jj), es));
        const float mag = sqrtf(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)));
        const float theta = fast_atan2_deg(dy, dx);
        v = __fmul_rn(wgt, mag);
        int bin = __float2int_rn(__fmul_rn(kBinScale, theta));  // cvRound
        if (bin >= kBins) bin -= kBins;
        if (bin < 0) bin += kBins;
        key = bin;
      }
    }
    warp_add(hist, key, v, lane);
  }
  __syncthreads();

  float* o = out + (size_t)n * kBins;
  for (int t = tid; t < kBins; t += kThreads) {
    float acc = whist[t];
    for (int k = 1; k < kWarps; ++k) acc = __fadd_rn(acc, whist[k * kBins + t]);
    o[t] = acc;
  }
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
// outside the band (compared, never clamped).
extern "C" int sift_ori_hist(const float* src, const int* layer,
                             const int* row, const int* col,
                             const int* radius, const float* expf_scale,
                             float* out, int N, int B, int L, int Hp, int Wp,
                             int rp, int row_lo, int row_hi,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  const int p = 2 * rp + 3;
  const int h = Hp - 2 * (rp + 1), w = Wp - 2 * (rp + 1);
  if (B < 1 || N % B != 0 || L % B != 0 || rp < 0 || L < B || h < 1 ||
      w < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)p * p + kWarps * kBins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ori_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  ori_hist_kernel<<<N, kThreads, smem, stream>>>(src, layer, row, col, radius,
                                                 expf_scale, out, N / B,
                                                 L / B, Hp, Wp, rp, w, row_lo,
                                                 row_hi);
  return cudaGetLastError();
}
