// K2: DoG 26-neighbour extremum scores.
//
// Replaces the Pallas kernel sift_tpu/ops/extrema_pallas.py:_make_kernel /
// _scores. For each pixel of DoG layers 1..nL: score = |v| if v is a
// 26-neighbour extremum (v > 0 and v >= every neighbour, or v < 0 and
// v <= every neighbour), |v| > thr and the pixel lies at least `border`
// pixels inside the image; otherwise -1 (src/sift.cpp:487-511,564).
//
// What bounds it on the H100: device-memory traffic, (D + nL) * H * W
// floats (~49 MB at 1920x1080 with D = 4, nL = 2), a few microseconds
// at HBM rate. The 27 reads per thread overlap heavily between
// neighbouring threads and hit L1/L2, so one thread per output with
// direct loads needs no shared-memory staging; pixels inside the border
// with |v| <= thr exit after one load.
//
// Numerics: comparisons only, so the output is bit-identical to the
// plain PyTorch version (ops/extrema_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void extrema_kernel(const float* __restrict__ dog,
                               float* __restrict__ out,
                               int nl, int H, int W, float thr, int border) {
  const size_t plane = (size_t)H * W;
  const size_t n = (size_t)nl * plane;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int l = (int)(e / plane) + 1;  // DoG layer 1..nL
    const int rc = (int)(e % plane);
    const int r = rc / W, c = rc - r * W;
    float score = -1.f;
    if (r >= border && r < H - border && c >= border && c < W - border) {
      const float* center = dog + l * plane + rc;
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

// dog (D, H, W) -> out (nl, H, W), nl = D - 2 scanned layers 1..nl.
extern "C" int sift_extrema_scores(const float* dog, float* out, int nl,
                                   int H, int W, float thr, int border,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t n = (size_t)nl * H * W;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  extrema_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      dog, out, nl, H, W, thr, border);
  return cudaGetLastError();
}
