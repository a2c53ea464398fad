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
// (ops/descr_hist_cuda.py, torch.bmm over 64-keypoint chunks). Here a
// block stages its keypoint's window in shared memory and scatters each
// sample's 8 trilinear weights into a shared-memory histogram: neither
// the 85 x 85 patch nor the (P, 36) one-hot reaches device memory, and
// one launch covers all keypoints of an octave. The output is `hist`
// before the circular fold; the fold and the normalization chain stay
// in PyTorch.
//
// Work: one block of 8 warps per keypoint; slots with valid false
// write zeros. The block loads only the rows and columns its radius
// R = min(radius, rd) reaches, a (2R + 3)^2 sub-window of the
// (2 rd + 3)^2 patch, with coalesced row loads; samples outside that
// box are masked in the plain version, so they are skipped. 40 KB of
// shared memory a block lets 5 blocks share an SM, so one block's loads
// overlap another's binning; there is no TMA or cp.async pipeline: the
// window starts at arbitrary columns, and the per-sample arithmetic
// dominates the load.
//
// What bounds it on the H100: neither traffic nor float rate. The
// windows of 1024 keypoints are at most 30 MB (9 us at 3.35 TB/s), with
// ~70 float operations a sample; measured on an H100 80GB HBM3 at
// 700 W, the 1024 keypoints of a 1080p octave 0 take 0.14 ms, about 40x
// the 3.4 us float32 bound of their samples. The dependent per-sample
// chain (expf, sqrtf, a division) and the warp vote and 8 store passes
// of the histogram update are the likely limits (not profiled).
//
// Summation order (fixed, so two launches are bit-identical): samples
// are numbered row-major over the (2R + 1)^2 box; warp w takes samples
// 32 (w + 8 k) + lane for k = 0, 1, ...; within one such step the lanes
// whose samples share a lower bin (r0, c0, o0) are summed in lane order
// by the lowest of them, corner by corner, and the 8 corners are added
// to the warp's private histogram in 8 passes (in one pass distinct
// lower bins give distinct addresses); the 8 warp histograms are summed
// in warp order. No float atomics. The result differs from the plain
// version's bmm only by that order.

#include "hist_common.cuh"

namespace {

using namespace sift_hist;

constexpr int kD = 4;                           // spatial cells per side
constexpr int kN = 8;                           // orientation bins
constexpr int kRowStride = (kD + 2) * (kN + 2);
constexpr int kBins = (kD + 2) * kRowStride;    // 360
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kBinShift = kD / 2 - 0.5f;      // 1.5
constexpr float kWgtScale = -1.f / (kD * kD * 0.5f);   // -0.125
constexpr float kObinScale = static_cast<float>(kN / 360.0);

// The 8 trilinear weights of one sample, corner k = 4 dr + 2 dc + do:
// ((1 - fr | fr) * (1 - fc | fc)) * ((1 - fo | fo) * mag), the
// product of the plain version's rw x cw one-hot and its
// magnitude-weighted orientation one-hot.
__device__ __forceinline__ void corner_weights(float fr, float fc, float fo,
                                               float mag, float (&v)[8]) {
  const float wr[2] = {__fsub_rn(1.f, fr), fr};
  const float wc[2] = {__fsub_rn(1.f, fc), fc};
  const float wo[2] = {__fmul_rn(__fsub_rn(1.f, fo), mag),
                       __fmul_rn(fo, mag)};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = __fmul_rn(__fmul_rn(wr[k >> 2], wc[(k >> 1) & 1]), wo[k & 1]);
  }
}

// hist[key + corner k] += the 8 weights over the warp's lanes (key is
// the lower bin; lanes with key < 0 add nothing). The leader of each
// key sums its group's weights in lane order; the 8 corners are stored
// in 8 passes, so one pass never has two lanes on one address.
__device__ __forceinline__ void warp_add_trilinear(float* hist, int key,
                                                   float fr, float fc,
                                                   float fo, float mag,
                                                   int lane) {
  Group g = group_of(key, lane);
  float acc[8];
  corner_weights(fr, fc, fo, mag, acc);
  while (__any_sync(kFullMask, g.rest != 0)) {
    const int src = g.rest ? __ffs(g.rest) - 1 : lane;
    const float tr = __shfl_sync(kFullMask, fr, src);
    const float tc = __shfl_sync(kFullMask, fc, src);
    const float to = __shfl_sync(kFullMask, fo, src);
    const float tm = __shfl_sync(kFullMask, mag, src);
    if (g.rest) {
      float v[8];
      corner_weights(tr, tc, to, tm, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      g.rest &= g.rest - 1;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (g.leader) {
      const int b = key + (k >> 2) * kRowStride + ((k >> 1) & 1) * (kN + 2)
                    + (k & 1);
      hist[b] = __fadd_rn(hist[b], acc[k]);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
descr_hist_kernel(const float* __restrict__ src,
                  const int* __restrict__ layer, const int* __restrict__ row,
                  const int* __restrict__ col,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const int* __restrict__ radius,
                  const float* __restrict__ ori,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out, int L, int Hp, int Wp, int rd,
                  int h, int w) {
  extern __shared__ float smem[];
  const int p = 2 * rd + 3;
  float* win = smem;                      // (p, p)
  float* whist = smem + p * p;            // (kWarps, kBins)
  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* o = out + (size_t)n * kBins;
  const int R = min(radius[n], rd);
  if (!valid[n] || R < 0) {
    for (int t = tid; t < kBins; t += kThreads) o[t] = 0.f;
    return;
  }

  for (int t = tid; t < kWarps * kBins; t += kThreads) whist[t] = 0.f;
  load_window(win, src, layer[n], row[n], col[n], L, Hp, Wp, p, rd - R,
              2 * R + 3, warp, kWarps, lane);
  __syncthreads();

  const int kr = row[n], kc = col[n];
  const float ct = cos_t[n], st = sin_t[n], ori_n = ori[n];
  const int side = 2 * R + 1;
  const int nsamp = side * side;
  float* hist = whist + warp * kBins;
  for (int b = warp * 32; b < nsamp; b += kThreads) {
    const int s = b + lane;
    int key = -1;
    float fr = 0.f, fc = 0.f, fo = 0.f, mag = 0.f;
    if (s < nsamp) {
      const int ii = s / side - R, jj = s % side - R;
      const float fi = static_cast<float>(ii), fj = static_cast<float>(jj);
      const float c_rot = __fsub_rn(__fmul_rn(fj, ct), __fmul_rn(fi, st));
      const float r_rot = __fadd_rn(__fmul_rn(fj, st), __fmul_rn(fi, ct));
      const float rbin = __fadd_rn(r_rot, kBinShift);
      const float cbin = __fadd_rn(c_rot, kBinShift);
      const int rr = kr + ii, cc = kc + jj;
      if (rbin > -1.f && rbin < kD && cbin > -1.f && cbin < kD && rr > 0
          && rr < h - 1 && cc > 0 && cc < w - 1) {
        // sample (ii, jj) sits at window (i + 1, j + 1)
        const int i = ii + rd, j = jj + rd;
        const float dx = __fsub_rn(win[(i + 1) * p + j + 2],
                                   win[(i + 1) * p + j]);
        const float dy = __fsub_rn(win[i * p + j + 1],
                                   win[(i + 2) * p + j + 1]);
        const float wgt = expf(__fmul_rn(
            __fadd_rn(__fmul_rn(c_rot, c_rot), __fmul_rn(r_rot, r_rot)),
            kWgtScale));
        const float mag_g = sqrtf(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)));
        const float theta = fast_atan2_deg(dy, dx);
        const float obin = __fmul_rn(__fsub_rn(theta, ori_n), kObinScale);
        mag = __fmul_rn(mag_g, wgt);
        const float r0 = floorf(rbin), c0 = floorf(cbin), o0 = floorf(obin);
        fr = __fsub_rn(rbin, r0);
        fc = __fsub_rn(cbin, c0);
        fo = __fsub_rn(obin, o0);
        int oi = static_cast<int>(o0);
        if (oi < 0) oi += kN;
        if (oi >= kN) oi -= kN;
        key = (static_cast<int>(r0) + 1) * kRowStride
              + (static_cast<int>(c0) + 1) * (kN + 2) + oi;
      }
    }
    warp_add_trilinear(hist, key, fr, fc, fo, mag, lane);
  }
  __syncthreads();

  for (int t = tid; t < kBins; t += kThreads) {
    float acc = whist[t];
    for (int k = 1; k < kWarps; ++k) acc = __fadd_rn(acc, whist[k * kBins + t]);
    o[t] = acc;
  }
}

}  // namespace

// src (L, Hp, Wp) padded by rd + 1 around an (h, w) image; layer (the
// stack index), row, col, radius (N,) int32; cos_t, sin_t, ori (N,)
// float32; valid (N,) bool -> out (N, 6, 6, 10).
extern "C" int sift_descr_hist(const float* src, const int* layer,
                               const int* row, const int* col,
                               const float* cos_t, const float* sin_t,
                               const int* radius, const float* ori,
                               const unsigned char* valid, float* out, int N,
                               int L, int Hp, int Wp, int rd,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  const int p = 2 * rd + 3;
  const int h = Hp - 2 * (rd + 1), w = Wp - 2 * (rd + 1);
  if (rd < 0 || L < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)p * p + kWarps * kBins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        descr_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  descr_hist_kernel<<<N, kThreads, smem, stream>>>(src, layer, row, col, cos_t,
                                                   sin_t, radius, ori, valid,
                                                   out, L, Hp, Wp, rd, h, w);
  return cudaGetLastError();
}
