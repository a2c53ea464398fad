// K3: keypoint patch gather, (L, Hp, Wp) stack -> (N, p, p) windows.
//
// Replaces the Pallas kernel sift_tpu/ops/ori_gather_pallas.py:
// _make_kernel / gather_patches, which on the TPU had to DMA a
// tile-aligned window and rotate it into place because Mosaic slices
// must start on (8, 128) tile boundaries. A CUDA thread can load any
// address, so here the window is copied directly.
//
// What bounds it on the H100: latency, not traffic. One block of 128
// threads per keypoint walks the window in row-major order, each thread
// ~p*p/128 elements in a serial loop of an integer division and a
// dependent global load (neighbouring threads read neighbouring columns
// of one row). Measured on an H100 80GB HBM3 at 700 W, p = 85 and N = 64
// (3.7 MB read and written, 1.1 us at 3.35 TB/s) take 0.05-0.057 ms,
// about 2 % of that bound: 64 blocks leave half the 132 SMs idle.
//
// Since K3-ori (ori_hist.cu) and K3-desc (descr_hist.cu) read their
// windows themselves, the main path no longer launches this kernel; the
// plain versions of those two use its plain version.
//
// Starts are clamped exactly as lax.dynamic_slice clamps them
// (ori_gather_pallas.py:133-135): layer to [0, L-1], rows to
// [0, Hp - p], cols to [0, Wp - p]. The output is bit-identical to the
// plain PyTorch version (ops/ori_gather_cuda.py): it is a copy.

#include <cuda_runtime.h>

namespace {

__global__ void gather_kernel(const float* __restrict__ src,
                              const int* __restrict__ layer,
                              const int* __restrict__ row,
                              const int* __restrict__ col,
                              float* __restrict__ out,
                              int L, int Hp, int Wp, int p) {
  const int n = blockIdx.x;
  const int l = min(max(layer[n], 0), L - 1);
  const int r0 = min(max(row[n], 0), Hp - p);
  const int c0 = min(max(col[n], 0), Wp - p);
  const float* base = src + ((size_t)l * Hp + r0) * Wp + c0;
  float* dst = out + (size_t)n * p * p;
  for (int e = threadIdx.x; e < p * p; e += blockDim.x) {
    const int i = e / p, j = e - i * p;
    dst[e] = base[(size_t)i * Wp + j];
  }
}

}  // namespace

// src (L, Hp, Wp), layer/row/col (N,) int32 -> out (N, p, p).
extern "C" int sift_gather_patches(const float* src, const int* layer,
                                   const int* row, const int* col,
                                   float* out, int N, int L, int Hp, int Wp,
                                   int p, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  if (p < 1 || p > Hp || p > Wp || L < 1) return cudaErrorInvalidValue;
  gather_kernel<<<N, 128, 0, stream>>>(src, layer, row, col, out, L, Hp, Wp,
                                       p);
  return cudaGetLastError();
}
