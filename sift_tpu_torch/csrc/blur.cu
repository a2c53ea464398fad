// K1 and K1-batch: separable truncated Gaussian blur, octave bases ->
// S planes each.
//
// Replaces the Pallas kernels sift_tpu/ops/conv_pallas.py:_make_vpass /
// _vpass, reached from gaussian_blur_multi_pallas (one frame) and from
// gaussian_blur_multi_batch_pallas through _blur_multi_b (B frames, the
// same body with the frame count folded into the grid, n_batch). One
// body serves both entries here too: sift_blur_multi takes a frame
// count B, and the single-frame wrapper passes B = 1. On the TPU the
// horizontal pass reuses the vertical kernel on the transposed image
// because lane-axis shifts were costly there; on the H100 both
// directions are plain shared-memory stencils, so there is no
// transpose.
//
// Traffic: at 1920x1080 and S = 4 the two passes move ~8 MB in + 33 MB
// out (vertical) and 33 MB in + 33 MB out (horizontal) per frame,
// ~0.86 GB at B = 8, a 0.26 ms floor at HBM rate. So each input element
// is read from device memory once per block: a block stages its tile
// plus the w-pixel halo in shared memory, and the vertical pass
// computes all S output planes of its frame from one staged tile of
// that frame's base. Frames ride grid z (vertical: z = b; horizontal:
// z = b * S + s), so B * S must stay within grid z's 65535.
//
// What bounds it on the H100: instruction throughput, not traffic. Measured
// on an H100 80GB HBM3 at 700 W, B = 8 and S = 4 take 1.62 ms, about 6x
// the traffic floor: each output costs one shared-memory load, one
// multiply and one add per nonzero tap (2 * 4 * 37 taps per pixel, no
// FMA, for the numerics below).
//
// Numerics: each output is summed over the taps in a fixed order
// (tap 0 upward), skipping zero taps, with a separate round after the
// multiply and after the add (__fmul_rn / __fadd_rn: no FMA
// contraction) -- the exact arithmetic of the Pallas kernel's
// `out = out + slab * t` and of the plain PyTorch version beside the
// wrapper (ops/conv_cuda.py). Frames never mix, so each frame of a
// batched call equals the single-frame call on it bit for bit. Zero
// padding outside the image; the caller applies the reference's
// last-row/col quirk before the call.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxTaps = 64;

__constant__ float c_taps[kMaxScales * kMaxTaps];

constexpr int kVTileW = 32;   // vertical pass: columns per block
constexpr int kVTileH = 64;   // vertical pass: output rows per block
constexpr int kVThreadsY = 8;
constexpr int kHTileW = 64;   // horizontal pass: output columns per block
constexpr int kHTileH = 16;   // horizontal pass: rows per block
constexpr int kHThreadsY = 4;

// in (B, H, W) -> out (B, S, H, W):
// out[b][s] = sum_k taps[s][k] * in[b][r + k - w]; frame b = blockIdx.z
template <int S>
__global__ void vpass_kernel(const float* __restrict__ in,
                             float* __restrict__ out,
                             int H, int W, int K, int w) {
  extern __shared__ float tile[];  // (kVTileH + 2w) x kVTileW
  const size_t plane = (size_t)H * W;
  in += blockIdx.z * plane;
  out += blockIdx.z * (size_t)S * plane;
  const int c0 = blockIdx.x * kVTileW;
  const int r0 = blockIdx.y * kVTileH;
  const int rows = kVTileH + 2 * w;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;
  for (int i = ty; i < rows; i += kVThreadsY) {
    const int r = r0 - w + i;
    tile[i * kVTileW + tx] =
        (r >= 0 && r < H && c < W) ? in[(size_t)r * W + c] : 0.f;
  }
  __syncthreads();
  if (c >= W) return;
  for (int i = ty; i < kVTileH; i += kVThreadsY) {
    const int r = r0 + i;
    if (r >= H) break;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = tile[(i + k) * kVTileW + tx];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float t = c_taps[s * kMaxTaps + k];
        if (t != 0.f) acc[s] = __fadd_rn(acc[s], __fmul_rn(v, t));
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      out[s * plane + (size_t)r * W + c] = acc[s];
  }
}

// in (B * S, H, W) -> out (B * S, H, W):
// out[z] = sum_k taps[z % S][k] * in[z][c + k - w]; plane z = blockIdx.z
__global__ void hpass_kernel(const float* __restrict__ in,
                             float* __restrict__ out,
                             int S, int H, int W, int K, int w) {
  extern __shared__ float tile[];  // kHTileH x (kHTileW + 2w)
  const int z = blockIdx.z;
  const int s = z % S;
  const int c0 = blockIdx.x * kHTileW;
  const int r0 = blockIdx.y * kHTileH;
  const int cols = kHTileW + 2 * w;
  const int tid = threadIdx.y * kHTileW + threadIdx.x;
  const int nthreads = kHTileW * kHThreadsY;
  const size_t plane_off = (size_t)z * H * W;
  const float* plane = in + plane_off;
  for (int e = tid; e < kHTileH * cols; e += nthreads) {
    const int i = e / cols, j = e - i * cols;
    const int r = r0 + i, c = c0 - w + j;
    tile[e] = (r < H && c >= 0 && c < W) ? plane[(size_t)r * W + c] : 0.f;
  }
  __syncthreads();
  const int c = c0 + threadIdx.x;
  if (c >= W) return;
  const float* taps = c_taps + s * kMaxTaps;
  for (int i = threadIdx.y; i < kHTileH; i += kHThreadsY) {
    const int r = r0 + i;
    if (r >= H) break;
    const float* row = tile + i * cols + threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float t = taps[k];
      if (t != 0.f) acc = __fadd_rn(acc, __fmul_rn(row[k], t));
    }
    out[plane_off + (size_t)r * W + c] = acc;
  }
}

template <int S>
cudaError_t launch_vpass(const float* in, float* out, int B, int H, int W,
                         int K, int w, cudaStream_t stream) {
  dim3 block(kVTileW, kVThreadsY);
  dim3 grid((W + kVTileW - 1) / kVTileW, (H + kVTileH - 1) / kVTileH, B);
  size_t smem = sizeof(float) * (kVTileH + 2 * w) * kVTileW;
  vpass_kernel<S><<<grid, block, smem, stream>>>(in, out, H, W, K, w);
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W) -> tmp (B, S, H, W) vertical -> out (B, S, H, W)
// horizontal. taps: host (S, K) row-major float32, K = 2w + 1 <= 64,
// S <= 8, B * S <= 65535 (grid z). B = 1 is the single-frame K1.
extern "C" int sift_blur_multi(const float* img, float* tmp, float* out,
                               int B, int H, int W, int S, int K,
                               const float* taps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (S < 1 || S > kMaxScales || K < 1 || K > kMaxTaps || (K & 1) == 0 ||
      B < 1 || (long long)B * S > 65535)
    return cudaErrorInvalidValue;
  const int w = K / 2;
  float staged[kMaxScales * kMaxTaps];
  for (int s = 0; s < S; ++s)
    for (int k = 0; k < kMaxTaps; ++k)
      staged[s * kMaxTaps + k] = k < K ? taps[s * K + k] : 0.f;
  // A copy from pageable host memory is staged before the call returns,
  // so `staged` may go out of scope; the copy is stream-ordered, so
  // earlier blurs on this stream finish reading the old taps first.
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_taps, staged, sizeof(float) * S * kMaxTaps, 0,
      cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  switch (S) {
    case 1: err = launch_vpass<1>(img, tmp, B, H, W, K, w, stream); break;
    case 2: err = launch_vpass<2>(img, tmp, B, H, W, K, w, stream); break;
    case 3: err = launch_vpass<3>(img, tmp, B, H, W, K, w, stream); break;
    case 4: err = launch_vpass<4>(img, tmp, B, H, W, K, w, stream); break;
    case 5: err = launch_vpass<5>(img, tmp, B, H, W, K, w, stream); break;
    case 6: err = launch_vpass<6>(img, tmp, B, H, W, K, w, stream); break;
    case 7: err = launch_vpass<7>(img, tmp, B, H, W, K, w, stream); break;
    default: err = launch_vpass<8>(img, tmp, B, H, W, K, w, stream); break;
  }
  if (err != cudaSuccess) return err;
  dim3 block(kHTileW, kHThreadsY);
  dim3 grid((W + kHTileW - 1) / kHTileW, (H + kHTileH - 1) / kHTileH,
            B * S);
  size_t smem = sizeof(float) * kHTileH * (kHTileW + 2 * w);
  hpass_kernel<<<grid, block, smem, stream>>>(tmp, out, S, H, W, K, w);
  return cudaGetLastError();
}
