// K3: keypoint patch gather, (L, Hp, Wp) stack -> (N, p, p) windows.
//
// Replaces the Pallas kernel sift_tpu/ops/ori_gather_pallas.py:
// _make_kernel / gather_patches, which on the TPU had to DMA a
// tile-aligned window and rotate it into place because Mosaic slices
// must start on (8, 128) tile boundaries. A CUDA thread can load any
// address, so here the window is copied directly.
//
// What bounds it on the H100: bytes (each window written once, the
// source the windows cover read once) where the launch is large, the
// launch itself where it is not.
// The design keeps several loads in flight in every thread and fills
// the card at every N:
//   - the grid is (keypoint, row block): a CTA copies `warps` x kRows
//     rows of one window, so a launch of few keypoints still spreads
//     over the SMs (ops/ori_gather_cuda.gather_shape picks `warps`: 4 a
//     CTA unless fewer give 2 CTAs an SM);
//   - a warp copies kRows = 2 whole window rows at a time; lane j takes
//     columns j, j + 32, j + 64, j + 96 (C of them, a template
//     parameter), so the row comes from the warp index and the column
//     from the lane, with no integer division; every thread issues its
//     kRows x C loads before its first
//     store; windows wider than 32 C columns take the columns in groups
//     of 32 C, and more than 65,535 row blocks stride;
//   - the source is read through the read-only path (__ldg): windows of
//     nearby keypoints overlap, and an octave's padded stack fits in the
//     50 MB L2; the output is written with streaming stores (__stcs), so
//     it does not evict the source.
// No TMA and no 16-byte source loads: a TMA tensor map needs every
// global stride to be a multiple of 16 bytes, and the stacks' widths are
// not (a 1958-wide stack's rows are 7,832 B; the output's rows are p x 4
// = 156 or 340 B); and window starts are arbitrary columns, so source
// rows are not 16-byte aligned (aligned float4 loads over each row,
// realigned in shared memory, would read up to 12 bytes outside it).
// 16-byte stores would need n p^2 % 4 == 0 for every window and were
// not tried.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (tools/torch_kernel_times.py --gather-only, median of 8 processes;
// floor: an empty kernel of the same grid; bound: each window written
// once and the stack elements the windows cover read once, at 3.35 TB/s):
//   p = 39, N = 1024   0.0090 ms  bound 0.0034 (38 %)  floor 0.0078
//   p = 85, N = 64     0.0066 ms  bound 0.0011 (17 %)  floor 0.0051
//   p = 85, N = 1024   0.0204 ms  bound 0.0130 (64 %)  floor 0.0116
// against 0.0093, 0.0177 and 0.0397 ms in the same run for the
// one-block-a-keypoint loop it replaced. At p = 39 the launch of 5,120
// CTAs is most of it (tools/torch_gather_split.py: the loads alone
// 0.0086, the stores alone 0.0083); a grid of 2,115 CTAs that each
// stride over keypoints, whose empty launch takes 0.0061, copied no
// faster (0.0095 against 0.0094 for one CTA column a keypoint, in one
// run).
//
// Since K3-ori (ori_hist.cu) and K3-desc (descr_hist.cu) read their
// windows themselves, the main path does not launch this kernel; the
// plain versions of those two use its plain version.
//
// Starts are clamped exactly as lax.dynamic_slice clamps them
// (ori_gather_pallas.py:133-135): layer to [0, L-1], rows to
// [0, Hp - p], cols to [0, Wp - p]. The output is bit-identical to the
// plain PyTorch version (ops/ori_gather_cuda.py): it is a copy.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 2;            // window rows a warp copies at a time
constexpr int kMaxWarps = 32;       // warps a CTA (1,024 threads)
constexpr int kMaxGridY = 65535;    // row blocks of one launch

// `warps` warps a CTA -> the grid: CTA (n, y) copies row block y (kRows x
// warps rows) of window n; past kMaxGridY row blocks a CTA strides over
// the rest.
bool gather_dims(int N, int p, int warps, dim3* grid, dim3* block) {
  if (N < 1 || p < 1 || warps < 1 || warps > kMaxWarps) return false;
  const int rows = kRows * warps;
  const int blocks = (p + rows - 1) / rows;
  *grid = dim3(N, blocks < kMaxGridY ? blocks : kMaxGridY);
  *block = dim3(32 * warps);
  return true;
}

template <int C>
__global__ void gather_kernel(const float* __restrict__ src,
                              const int* __restrict__ layer,
                              const int* __restrict__ row,
                              const int* __restrict__ col,
                              float* __restrict__ out,
                              int L, int Hp, int Wp, int p) {
  const int n = blockIdx.x;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int i0 = (blockIdx.y * warps + warp) * kRows;
  if (i0 >= p) return;
  const int l = min(max(__ldg(layer + n), 0), L - 1);
  const int r0 = min(max(__ldg(row + n), 0), Hp - p);
  const int c0 = min(max(__ldg(col + n), 0), Wp - p);
  const float* win = src + ((size_t)l * Hp + r0) * Wp + c0 + lane;
  float* dst = out + (size_t)n * p * p + lane;
  for (; i0 < p; i0 += gridDim.y * warps * kRows) {
    for (int g = 0; g < p; g += 32 * C) {
      float v[kRows][C];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (i0 + k < p && g + lane + 32 * q < p)
            v[k][q] = __ldg(win + (size_t)(i0 + k) * Wp + g + 32 * q);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (i0 + k < p && g + lane + 32 * q < p)
            __stcs(dst + (size_t)(i0 + k) * p + g + 32 * q, v[k][q]);
    }
  }
}

}  // namespace

// src (L, Hp, Wp), layer/row/col (N,) int32 -> out (N, p, p); `warps`
// warps a CTA (ori_gather_cuda.gather_shape).
extern "C" int sift_gather_patches(const float* src, const int* layer,
                                   const int* row, const int* col,
                                   float* out, int N, int L, int Hp, int Wp,
                                   int p, int warps, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return cudaSuccess;
  dim3 grid, block;
  if (p > Hp || p > Wp || L < 1 || !gather_dims(N, p, warps, &grid, &block))
    return cudaErrorInvalidValue;
  const int C = p > 96 ? 4 : (p + 31) / 32;   // column chunks a lane
  switch (C) {
    case 1:
      gather_kernel<1><<<grid, block, 0, s>>>(src, layer, row, col, out, L,
                                              Hp, Wp, p);
      break;
    case 2:
      gather_kernel<2><<<grid, block, 0, s>>>(src, layer, row, col, out, L,
                                              Hp, Wp, p);
      break;
    case 3:
      gather_kernel<3><<<grid, block, 0, s>>>(src, layer, row, col, out, L,
                                              Hp, Wp, p);
      break;
    default:
      gather_kernel<4><<<grid, block, 0, s>>>(src, layer, row, col, out, L,
                                              Hp, Wp, p);
  }
  return cudaGetLastError();
}
