// K1 and K1-batch: separable truncated Gaussian blur, octave bases ->
// S planes each, in one kernel.
//
// Replaces the Pallas kernels sift_tpu/ops/conv_pallas.py:_make_vpass /
// _vpass, reached from gaussian_blur_multi_pallas (one frame) and from
// gaussian_blur_multi_batch_pallas through _blur_multi_b (B frames, the
// same body with the frame count folded into the grid, n_batch). One
// body serves both entries here too: sift_blur_multi takes a frame
// count B, and the single-frame wrapper passes B = 1. On the TPU the
// horizontal pass reuses the vertical kernel on the transposed image
// because lane-axis shifts were costly there; on the H100 both
// directions are shared-memory stencils, so there is no transpose.
//
// What bounds it on the H100: the float instructions, not traffic. At
// B = 8, S = 4 and 1920x1080 the kernel must read 66 MB and write
// 265 MB (a 0.099 ms byte bound at 3.35 TB/s), but the numerics below
// forbid FMA: the 2 x 88 nonzero taps per pixel are 352 separate
// multiplies and adds, 5.8 G instructions, about 0.175 ms at one f32
// instruction per lane and clock on 132 SMs. The design keeps everything
// else off that path:
//   - one kernel: a block stages its frame's base tile and halo once in
//     shared memory and, for each scale, runs the vertical pass into a
//     shared-memory intermediate and the horizontal pass from it; the
//     intermediate never reaches device memory;
//   - per-scale tap ranges: scale s loops over exactly its nonzero taps
//     lo_s..hi_s (9, 17, 25 and 37 of the 37 stacked for octaves), with no
//     zero test, and its vertical pass covers only the 128 + n_s - 1
//     columns its horizontal pass reads;
//   - register blocking: each thread computes kR = 8 consecutive outputs
//     along the blur direction from a sliding window in registers, so one
//     shared-memory load feeds up to 8 taps (taps outer, outputs inner);
//   - bank-conflict-free rows: in the horizontal pass the 32 lanes of a
//     warp take 32 rows, and the intermediate's row pitch is odd; each
//     lane then stores its 8 outputs, one 32-byte sector, as two float4;
//   - the base tile is staged with cp.async, in 16-byte pieces where the
//     rows allow, so a thread's loads are all in flight at once and a
//     load outside the image writes zeros;
//   - the taps travel by value in a __grid_constant__ parameter (2.1 KB),
//     so no per-launch copy precedes the kernel and two launches with
//     different taps cannot race.
// Tile: 32 x 128 outputs per block of 256 threads. Shared memory is the
// (32 + 2w + 1) x (128 + 2wl) staged base (wl: w rounded up to a multiple
// of 4) plus a 32 x ((128 + 2wl) | 1) intermediate: 68.0 KB at the
// octaves' w = 18, so 3 blocks share an SM (the launch bounds cap
// registers at 80 for that); up to 97.7 KB at the largest w = 31. Frames
// ride grid z, tile rows grid y.
// When the tiles of all frames are fewer than two for each SM, as for the
// small octaves, grid z also splits the scales, one per block: a block's
// S passes in series would set the launch's time.
//
// Numerics: each output is summed over its scale's nonzero taps from the
// lowest index up, acc = 0 then acc = acc + v * t with a separate round
// after the multiply and after the add (__fmul_rn / __fadd_rn: no FMA
// contraction) -- the arithmetic of the Pallas kernel's
// `out = out + slab * t` and of the plain PyTorch version beside the
// wrapper (ops/conv_cuda.py), which skips the zero taps; so the result is
// bit-identical to it. Frames never mix, so each frame of a batched call
// equals the single-frame call on it bit for bit. Zero padding outside
// the image; the caller applies the reference's last-row/col quirk
// before the call.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxTaps = 64;
constexpr int kTileH = 32;    // output rows per block
constexpr int kTileW = 128;   // output columns per block
constexpr int kR = 8;         // consecutive outputs per thread
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;   // at the octaves' halo (see above)
constexpr int kMaxDevices = 64;

struct BlurTaps {
  float t[kMaxScales][kMaxTaps];  // stacked taps, zero-padded to kMaxTaps
  int lo[kMaxScales];             // first nonzero tap of scale s
  int n[kMaxScales];              // its count of (contiguous) nonzero taps
};

// Copy 4 (or, with kBytes = 16, 16) bytes from global src to shared dst,
// or write zeros there if !fill.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool fill) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(fill ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
                 "l"(src), "r"(fill ? 4 : 0));
}

// acc[r] = sum_{k < n} src[(r + k) * stride] * t[k] for r < kR, the
// taps in order k = 0, 1, ... (taps outer, outputs inner). Whole chunks
// of kR taps run from two register windows, v = src[k0 .. k0 + kR) and
// u = src[k0 + kR .. k0 + 2 kR); the n % kR taps left run in the tail.
// Reads src up to index n + kR - 1, one past what the sums use.
__device__ __forceinline__ void blur_run(const float* src, int stride,
                                         const float* t, int n,
                                         float (&acc)[kR]) {
  float v[kR], u[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    acc[r] = 0.f;
    v[r] = src[r * stride];
  }
  int k0 = 0;
  for (; k0 + kR <= n; k0 += kR) {
#pragma unroll
    for (int j = 0; j < kR; ++j) u[j] = src[(k0 + kR + j) * stride];
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) {
      const float tk = t[k0 + kk];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float x = kk + r < kR ? v[kk + r] : u[kk + r - kR];
        acc[r] = __fadd_rn(acc[r], __fmul_rn(x, tk));
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) v[j] = u[j];
  }
  const int rem = n - k0;  // the same for every thread: a uniform branch
#pragma unroll
  for (int j = 0; j + 1 < kR; ++j)
    u[j] = j + 1 < rem ? src[(k0 + kR + j) * stride] : 0.f;
#pragma unroll
  for (int kk = 0; kk + 1 < kR; ++kk) {
    if (kk < rem) {
      const float tk = t[k0 + kk];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float x = kk + r < kR ? v[kk + r] : u[kk + r - kR];
        acc[r] = __fadd_rn(acc[r], __fmul_rn(x, tk));
      }
    }
  }
}

// in (B, H, W) -> out (B, S, H, W); blockIdx.z = b * (S / spb) + g: frame
// b, scales g * spb .. g * spb + spb - 1. With w = K / 2 the halo of every
// scale, and wl = w rounded up to a multiple of 4, plane s of the output is
//   mid[i][j]  = sum_k taps[s][k] * base[i + k][j + lo + wl - w] (vertical)
//   out[i][x]  = sum_k taps[s][k] * mid[i][x + k - lo]          (horizontal)
// over k = lo..lo + n - 1, where base[a][b] is the input at
// (r0 - w + a, c0 - wl + b), zero outside the image. vec: W % 4 == 0 and
// both tensors 16-byte aligned, so rows are staged and stored in 16-byte
// pieces, each wholly inside or outside the image.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
blur_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
            int W, int S, int spb, int w, bool vec,
            __grid_constant__ const BlurTaps taps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wl = (w + 3) & ~3;
  const int bw = kTileW + 2 * wl;     // staged columns
  const int bh = kTileH + 2 * w;      // staged rows (+1 read-only margin)
  const int mp = bw | 1;              // odd pitch of the intermediate
  float* base = smem;
  float* mid = smem + (bh + 1) * bw;
  const size_t plane = (size_t)H * W;
  const int groups = S / spb;
  const int b = blockIdx.z / groups, s0 = (blockIdx.z % groups) * spb;
  in += b * plane;
  out += b * (size_t)S * plane;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // a warp stages a row at a time, its lanes along the columns; the
  // copies are asynchronous, so all of a thread's loads are in flight at
  // once, and a copy from outside the image writes zeros
  const int piece = vec ? 4 : 1;
  for (int i = warp; i < bh; i += kThreads / 32) {
    const int r = r0 - w + i;
    const bool row_in = r >= 0 && r < H;
    const float* src = in + (size_t)(row_in ? r : 0) * W;
    for (int j = lane * piece; j < bw; j += 32 * piece) {
      const int c = c0 - wl + j;
      const bool ok = row_in && c >= 0 && c < W;
      if (vec)
        cp_async<16>(base + i * bw + j, ok ? src + c : in, ok);
      else
        cp_async<4>(base + i * bw + j, ok ? src + c : in, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int s = s0; s < s0 + spb; ++s) {
    const int lo = taps.lo[s], n = taps.n[s];
    const float* t = &taps.t[s][lo];
    // vertical: kR rows by one column per item; lanes along columns
    const int ncols = kTileW + n - 1;
    for (int e = tid; e < (kTileH / kR) * ncols; e += kThreads) {
      const int g = e / ncols, j = e - g * ncols;
      float acc[kR];
      blur_run(base + (g * kR + lo) * bw + j + lo + wl - w, bw, t, n,
               acc);
#pragma unroll
      for (int r = 0; r < kR; ++r) mid[(g * kR + r) * mp + j] = acc[r];
    }
    __syncthreads();
    // horizontal: one row by kR columns per item; lanes along rows
    constexpr int kItems = kTileH * kTileW / kR / kThreads;
    float* o = out + s * plane;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      const int i = e % kTileH, x = (e / kTileH) * kR;
      float res[kR];
      blur_run(mid + i * mp + x, 1, t, n, res);
      const int r = r0 + i, c = c0 + x;
      if (r < H) {
        float* dst = o + (size_t)r * W + c;
        if (vec && c + kR <= W) {  // whole 32-byte sectors per lane
          float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
          for (int q = 0; q < kR / 4; ++q)
            d4[q] = make_float4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                                res[4 * q + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < kR; ++q)
            if (c + q < W) dst[q] = res[q];
        }
      }
    }
    __syncthreads();  // mid is read before the next scale writes it
  }
}

size_t smem_bytes(int w) {
  const int bw = kTileW + 2 * ((w + 3) & ~3);
  return sizeof(float) *
         ((size_t)(kTileH + 2 * w + 1) * bw + (size_t)kTileH * (bw | 1));
}

// Once per device: raise the kernel's dynamic shared memory limit to the
// largest halo, and read the SM count into *n_sm.
cudaError_t prepare(int* n_sm) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(blur_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxTaps / 2 - 1));
    if (err != cudaSuccess) return err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  *n_sm = sms[dev];
  return cudaSuccess;
}

}  // namespace

// img (B, H, W) -> out (B, S, H, W). taps: host (S, K) row-major
// float32, K = 2w + 1 < kMaxTaps odd, S <= kMaxScales; ranges: host (S, 2)
// int32, the first and last nonzero tap of each scale, every tap between
// them nonzero (ops/conv_cuda.tap_ranges). B <= 65535 frames (grid z;
// B * S of them split by scale). B = 1 is the single-frame K1.
extern "C" int sift_blur_multi(const float* img, float* out, int B, int H,
                               int W, int S, int K, const float* taps,
                               const int* ranges, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (S < 1 || S > kMaxScales || K < 1 || K >= kMaxTaps || (K & 1) == 0 ||
      B < 1 || B > 65535 || H < 1 || W < 1 ||
      (H + kTileH - 1) / kTileH > 65535)
    return cudaErrorInvalidValue;
  BlurTaps p = {};
  for (int s = 0; s < S; ++s) {
    const int lo = ranges[2 * s], hi = ranges[2 * s + 1];
    if (lo < 0 || hi < lo || hi >= K) return cudaErrorInvalidValue;
    p.lo[s] = lo;
    p.n[s] = hi - lo + 1;
    for (int k = 0; k < K; ++k) p.t[s][k] = taps[s * K + k];
  }
  int n_sm = 0;
  const cudaError_t err = prepare(&n_sm);
  if (err != cudaSuccess) return err;
  const int w = K / 2;
  // a block runs all S scales of its tile, unless the tiles of all frames
  // are fewer than two for each SM: then each block runs one scale, so a
  // small image is not one block's S passes in series
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const long long tiles = (long long)grid.x * grid.y * B;
  const int spb =
      tiles < 2LL * n_sm && (long long)B * S <= 65535 ? 1 : S;
  grid.z = B * (S / spb);
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(img) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  blur_kernel<<<grid, kThreads, smem_bytes(w), stream>>>(img, out, H, W, S,
                                                         spb, w, vec, p);
  return cudaGetLastError();
}
