// K2 and K2-batch: DoG 26-neighbour extremum scores.
//
// Replaces the Pallas kernels sift_tpu/ops/extrema_pallas.py:_make_kernel
// behind _scores (one frame, extrema_scores_pallas) and _scores_batch
// (B frames, extrema_scores_batch_pallas): one body with a frame index,
// as the Pallas body is one for both. The single-frame wrapper passes
// B = 1. For each pixel of DoG layers 1..nL of each frame: score = |v| if
// v is a 26-neighbour extremum (v > 0 and v >= every neighbour, or v < 0
// and v <= every neighbour), |v| > thr and the pixel lies at least
// `border` pixels inside the image; otherwise -1 (src/sift.cpp:487-511,
// 564).
//
// What bounds it on the H100: device-memory traffic, (D + nL) * H * W
// floats a frame (~49 MB at 1920x1080 with D = 4, nL = 2; ~0.4 GB at
// B = 8, ~0.12 ms at HBM rate). The 27 reads per thread overlap heavily
// between neighbouring threads and hit L1/L2, so one thread per output
// with direct loads needs no shared-memory staging; pixels inside the
// border with |v| <= thr exit after one load. Measured on an H100 80GB
// HBM3 at 700 W, B = 8 takes 0.26 ms, about twice that traffic floor.
//
// Frames: the flat index runs over B * nL * H * W and frame b reads
// only dog + b * D * H * W. Neighbour loads stay inside the frame's
// layers and rows because the border test (border >= 1, checked by the
// entry point) runs before any neighbour load.
//
// Numerics: comparisons only, so the output is bit-identical to the
// plain PyTorch version (ops/extrema_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void extrema_kernel(const float* __restrict__ dog,
                               float* __restrict__ out, int B, int D,
                               int nl, int H, int W, float thr, int border) {
  const size_t plane = (size_t)H * W;
  const size_t frame_out = (size_t)nl * plane;
  const size_t n = (size_t)B * frame_out;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t b = e / frame_out;
    const size_t fe = e - b * frame_out;
    const int l = (int)(fe / plane) + 1;  // DoG layer 1..nL
    const int rc = (int)(fe % plane);
    const int r = rc / W, c = rc - r * W;
    float score = -1.f;
    if (r >= border && r < H - border && c >= border && c < W - border) {
      const float* center = dog + b * D * plane + l * plane + rc;
      const float v = *center;
      if (fabsf(v) > thr) {
        float nmax = -CUDART_INF_F, nmin = CUDART_INF_F;
#pragma unroll
        for (int dl = -1; dl <= 1; ++dl)
#pragma unroll
          for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
            for (int dc = -1; dc <= 1; ++dc) {
              if (dl == 0 && dr == 0 && dc == 0) continue;
              const float s = center[dl * (long long)plane + dr * W + dc];
              nmax = fmaxf(nmax, s);
              nmin = fminf(nmin, s);
            }
        if ((v > 0.f && v >= nmax) || (v < 0.f && v <= nmin))
          score = fabsf(v);
      }
    }
    out[e] = score;
  }
}

}  // namespace

// dog (B, D, H, W) -> out (B, nl, H, W), scanning layers 1..nl of each
// frame; needs D >= nl + 2 and border >= 1. B = 1 is the single-frame K2.
extern "C" int sift_extrema_scores(const float* dog, float* out, int B,
                                   int D, int nl, int H, int W, float thr,
                                   int border, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 0 || nl < 0 || D < nl + 2 || border < 1)
    return cudaErrorInvalidValue;
  const size_t n = (size_t)B * nl * H * W;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  extrema_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      dog, out, B, D, nl, H, W, thr, border);
  return cudaGetLastError();
}
