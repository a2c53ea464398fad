// Segment sums in a fixed order: out[s, :] += x[i, :] for every source
// row i whose index is s, in ascending i, for every segment of one call.
// It has index_add_'s meaning (it adds into out, starting from out's
// value) and the order of a sequential loop over the rows, which is the
// order in which index_add_ adds on the CPU: every float sum is rounded
// as that loop rounds it, so the card's sums are bit for bit the CPU's.
//
// Replaces no Pallas kernel: sift_tpu/sfm/ba.py takes jax.ops.segment_sum
// and sift_tpu/sfm/posegraph.py an indexed add; no kernel under
// sift_tpu/ops/ serves the back end. The port's plain version is
// index_add_ (ops/segsum.py), which on the card adds with atomics in no
// fixed order: the rounding then differs from run to run, and the BA's
// and the pose graph's accept/reject decisions turn a few ULPs into
// another map.
//
// The order is fixed by a plan made once per index vector
// (ops/segsum.make_plan): a stable sort of the index gives the source
// rows of each segment in ascending order (perm) and where each segment
// starts (offsets, S + 1 entries).
//
// Every add is rounded on its own (__fadd_rn: no FMA), and the only
// dependent chain is the adds of one output column. Two launch shapes,
// chosen from the rows a segment holds on average (known on the host);
// both add in the same order, so they give the same bits:
// - long segments (the BA's camera side: a few dozen segments of
//   thousands of rows): one CTA a (segment, chunk of up to kCols
//   columns); the CTA's threads gather a tile of rows into shared memory
//   together, many loads in flight, then one thread a column adds the
//   tile's values in row order;
// - short segments (the BA's point side, a few rows a point; the pose
//   graph's normal matrix, a block or two an entry): one thread a
//   (segment, column) reads its rows from device memory in order.
// An empty segment leaves its outputs as they are. A segment's chain is
// as long as its rows, so a plan leaves out the rows that add nothing
// (the BA's padded observations, which would all fall in segment 0).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 64;          // columns a CTA
constexpr int kTileElems = 4096;   // floats a tile (16 KiB of shared memory)
// segments of at most this many rows on average take the thread a
// (segment, column) shape
constexpr int kShortRows = 32;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(float* __restrict__ out, const float* __restrict__ x,
              const int* __restrict__ perm, const int* __restrict__ offsets,
              int W) {
  __shared__ float tile[kTileElems];
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int cw = min(kCols, W - c0);
  const int begin = offsets[s];
  const int end = offsets[s + 1];
  if (begin >= end) return;
  const int t = threadIdx.x;
  const int rows_a_tile = kTileElems / cw;
  float* dst = out + (int64_t)s * W + c0;
  float acc = t < cw ? dst[t] : 0.0f;
  for (int r0 = begin; r0 < end; r0 += rows_a_tile) {
    const int n = min(rows_a_tile, end - r0);
    __syncthreads();  // the tile's last values have been added
    for (int e = t; e < n * cw; e += kThreads) {
      const int r = e / cw;
      const int c = e - r * cw;
      tile[e] = x[(int64_t)perm[r0 + r] * W + c0 + c];
    }
    __syncthreads();
    if (t < cw) {
#pragma unroll 8
      for (int r = 0; r < n; ++r) acc = __fadd_rn(acc, tile[r * cw + t]);
    }
  }
  if (t < cw) dst[t] = acc;
}

__global__ void __launch_bounds__(kThreads)
segsum_short_kernel(float* __restrict__ out, const float* __restrict__ x,
                    const int* __restrict__ perm,
                    const int* __restrict__ offsets, int S, int W) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)S * W) return;
  const int s = (int)(i / W);
  const int c = (int)(i - (int64_t)s * W);
  const int begin = offsets[s];
  const int end = offsets[s + 1];
  if (begin >= end) return;
  float acc = out[i];
#pragma unroll 4
  for (int k = begin; k < end; ++k)
    acc = __fadd_rn(acc, x[(int64_t)perm[k] * W + c]);
  out[i] = acc;
}

}  // namespace

// out (S, W) and x (O, W) float32, row-major and contiguous; perm (O,)
// int32, the source rows in segment order; offsets (S + 1,) int32, where
// each segment's rows start in perm.
extern "C" int sift_segsum(float* out, const float* x, const int* perm,
                           const int* offsets, int O, int S, int W,
                           void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (O < 0 || S < 0 || W < 1) return cudaErrorInvalidValue;
  if (S == 0 || O == 0) return cudaSuccess;
  if (O <= (int64_t)kShortRows * S) {
    const int64_t blocks = ((int64_t)S * W + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    segsum_short_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        out, x, perm, offsets, S, W);
  } else {
    const dim3 grid((unsigned)S, (unsigned)((W + kCols - 1) / kCols));
    if (grid.y > 65535) return cudaErrorInvalidValue;
    segsum_kernel<<<grid, kThreads, 0, st>>>(out, x, perm, offsets, W);
  }
  return cudaGetLastError();
}
