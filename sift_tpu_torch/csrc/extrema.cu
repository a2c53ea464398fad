// K2 and K2-batch: DoG 26-neighbour extremum scan, and the candidate
// selection that consumes it.
//
// Replaces the Pallas kernels sift_tpu/ops/extrema_pallas.py:_make_kernel
// behind _scores (one frame, extrema_scores_pallas) and _scores_batch
// (B frames, extrema_scores_batch_pallas): one body with a frame index,
// as the Pallas body is one for both; the single-frame wrappers pass
// B = 1. For each pixel of DoG layers 1..nL of each frame the pixel is a
// candidate if v is a 26-neighbour extremum (v > 0 and v >= every
// neighbour, or v < 0 and v <= every neighbour), |v| > thr and the pixel
// lies in the candidate box [r_lo, r_hi) x [c_lo, c_hi) (src/sift.cpp:
// 487-511, 564); its score is |v|, every other score -1. The dense mode
// and the main path's compact scan take the border box [border, H -
// border) x [border, W - border); a row band of a larger image
// (parallel/spatial.py) passes the part of it that the band owns. The box
// lies inside the border box, with r_lo, c_lo >= 1, so a tested pixel's
// neighbours lie inside the frame.
//
// The scan body is templated on its output:
//   - dense (sift_extrema_scores): the (B, nL, H, W) score field, the
//     counterpart of the Pallas kernels;
//   - compact (sift_extrema_compact): no score field; each candidate's
//     key is appended to its frame's list, with one atomicAdd per warp
//     (__ballot_sync / __popc), in no particular order. For a candidate
//     at flat index i of its frame's (nL, H, W) field,
//         key = float_bits(score) << 32 | (0xFFFFFFFF - i).
//     Scores are > 0, so their bits order like the floats; keys are
//     unique, and the larger key is the earlier slot of a stable
//     descending sort of the scores (ties keep the lower index first).
// The select kernel (sift_extrema_select) then takes the top `cap` keys
// of each frame without the host, and writes (layer, r, c, valid) as a
// stable descending sort of the dense field would give them: slots
// 0..m-1 (m = min(n, cap)) the m largest keys, slots m..cap-1 the lowest
// flat indices whose score is -1, ascending, and slots past nL*H*W
// (1, 0, 0, false). This replaces sift_tpu's top-k
// (sift_tpu/ops/extrema.py:214) over the Pallas scores of
// extrema_pallas.py:160,167: a sort of the whole dense field (4,147,200
// scores per 1080p frame) of which ~1e-4 are candidates.
//
// What bounds the select on the H100: not bytes (n keys in, 13 bytes a
// slot out: 0.00002 ms at the 1080p octave 0) but the latency of a
// chain of dependent steps, each a trip to memory or a barrier. The
// one-block bitonic network it replaces spent 68 % of its 0.0260 ms
// there (66 barriers at n = 1,103; PERF.md). The design keeps the
// chain short and spreads the work over the card:
//   - a grid of `ctas` CTAs per frame (x) and B frames (y), the count
//     chosen by the host from B, cap and the SM count
//     (ops/extrema_cuda.select_shape: two CTAs an SM, at most one for
//     each 32 slots). Every CTA reads the count and stages the frame's
//     keys (up to `stage` of them) in its own shared memory; CTAs never
//     talk to each other;
//   - no sort network: a key's slot is its rank, the number of staged
//     keys larger than it (keys are unique). CTA g ranks the g-th slice
//     of the staged list against the whole list, each thread two keys of
//     the slice in registers over a part of the list read by broadcast,
//     16 bytes a load; the parts' counts meet in shared memory behind
//     one barrier, and where a thread counts whole ranks (a short list,
//     or a long slice) it writes its keys' slots at once. One barrier
//     before the ranks where n <= stage, and nothing but the count read
//     and the staging before it. No integer division splits the work
//     (only the slots' decode divides): shifts (chunk_of) and float
//     quotients that are exact at these sizes (small_quotient) do, since
//     the divisions' latency showed at the small octaves;
//   - where n > cap, a staged key ranked cap or more is dropped; past
//     `stage` keys every CTA first finds the cap-th largest key by a
//     radix select over device memory (8-bit digit histograms, integer
//     atomics) and packs the kept keys into shared memory in an order
//     every CTA computes alike (each thread's kept keys at an exclusive
//     prefix sum of the counts);
//   - gap slots, written before the ranks are counted so that their
//     stores drain meanwhile: where no candidate lies among the first
//     cap - m indices, slot m + j is index j; else a bitmap of the
//     candidates below min(cap, nL*H*W) and a prefix sum of its zero
//     bits give each free index its slot. The gap and padding slots split
//     evenly over the frame's CTAs, neighbouring threads on neighbouring
//     slots.
// The staged list is the frame's keys in list order (or the packed
// order past `stage`), the same in every CTA, so the slices partition
// the keys and every slot is written once. Up to 16384 slots (min(cap,
// nL*H*W); kMaxSharedKeys) the select runs so; more take a one-block
// bitonic network in a device-memory scratch the caller passes, slower
// but with no limit on cap.
//
// What bounds the scan on the H100: device-memory traffic. Compact mode
// reads the nL + 2 planes once (33 MB at 1920x1080 with nL = 2; 0.0099 ms
// at 3.35 TB/s) and writes a few kilobytes of keys; dense mode also
// writes nL planes. The design keeps the rest off that path:
//   - a 2-D grid of 128 x 16 output tiles (x columns, y rows, z
//     frames), so no thread divides a 64-bit flat index;
//   - each block of 256 threads stages its tile of the nL + 2 planes,
//     with a one-pixel halo, in shared memory with cp.async, every thread
//     over all pieces of all rows (16-byte pieces where W % 4 == 0 and
//     the pointer is aligned, else 4 bytes, as K1 stages in
//     csrc/blur.cu): 39.2 KB at nL = 2, so 4 blocks share an SM. The
//     staging sets the pace; wide rows and busy lanes keep more bytes in
//     flight than 64-column tiles staged a warp a row;
//   - the 3x3x3 max and min are taken including the centre, which gives
//     the same test: v >= max(26 neighbours) exactly when v >= max(27),
//     and the same for min. They are separable: each thread takes 2
//     neighbouring columns of 4 rows, forms the horizontal 3-max and
//     3-min of each staged row from one 8-byte and two 4-byte loads, then
//     the 3x3 box of every plane once, and folds the box of plane p into
//     the running max and min of layers p - 1, p and p + 1;
//   - the layer count of a launch is a template argument (1..6), so the
//     plane loop unrolls, the running max and min stay in registers, and
//     layer l is tested as soon as plane l + 1 is folded in; a larger nL
//     takes one launch per 6 layers (layers l0 + 1 .. l0 + 6 from planes
//     l0 .. l0 + 7), all appending to the same lists.
// Frames: frame b reads dog + b * D * H * W and writes its own score
// planes or key list; frames never mix, so each frame of a batched call
// equals the single-frame call on it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;    // output columns per tile
constexpr int kTileH = 16;     // output rows per tile
constexpr int kCols = 2;       // neighbouring output columns per thread
constexpr int kRows = 4;       // consecutive output rows per thread
constexpr int kThreads = (kTileW / kCols) * (kTileH / kRows);   // 256
constexpr int kPad = 4;        // staged columns each side (halo 1, 16 B)
constexpr int kPitch = kTileW + 2 * kPad;
constexpr int kStagedRows = kTileH + 2;
constexpr int kMaxLayers = 6;  // nL; the block stages nL + 2 planes
constexpr int kMaxSelThreads = 1024;   // the scratch network's block
constexpr int kSelThreads = 256;       // a rank-select CTA
constexpr int kSelWarps = kSelThreads / 32;
// most slots (and staged keys) a rank-select CTA holds in shared memory
// (128 KB); more sort in a device-memory scratch
constexpr int kMaxSharedKeys = 16384;
constexpr int kMaxDevices = 64;

static_assert(kCols == 2, "the horizontal pass is written for 2 columns");

enum class Out { kDense, kCompact };

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

// Stage rows r0 - 1 .. r0 + 16 and columns c0 - 4 .. c0 + 131 of planes
// 0..kPlanes-1 of `frame` into `s` with cp.async; a copy from outside
// the image writes zeros, which no tested pixel reads.
template <int kPlanes>
__device__ __forceinline__ void stage_tile(float* s, const float* frame,
                                           size_t plane, int H, int W,
                                           int r0, int c0, bool vec) {
  // all threads over all 16-byte (or 4-byte) pieces of all staged rows
  const int piece = vec ? 4 : 1;
  const int per_row = kPitch / piece;
  for (int e = threadIdx.x; e < kPlanes * kStagedRows * per_row;
       e += kThreads) {
    const int i = e / per_row, j = (e - i * per_row) * piece;
    const int p = i / kStagedRows, r = r0 - 1 + (i - p * kStagedRows);
    const int c = c0 - kPad + j;
    const bool ok = r >= 0 && r < H && c >= 0 && c < W;
    const float* src = ok ? frame + p * plane + (size_t)r * W + c : frame;
    if (vec)
      cp_async<16>(s + i * kPitch + j, src, ok);
    else
      cp_async<4>(s + i * kPitch + j, src, ok);
  }
}

// Scan one staged 128 x 16 tile at (r0, c0) of frame b: thread t takes
// columns c0 + 2 (t % 64) and the next, rows r0 + 4 (t / 64) .. +3, so a
// warp's lanes are 64 neighbouring columns of the same rows.
template <Out kMode, int kNL>
__device__ __forceinline__ void scan_tile(
    const float* s, float* __restrict__ score,
    unsigned long long* __restrict__ keys, int* __restrict__ count, int b,
    int l0, int nl, size_t plane, int H, int W, int r0, int c0, float thr,
    int r_lo, int r_hi, int c_lo, int c_hi) {
  constexpr int kPlanes = kNL + 2;
  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x % (kTileW / kCols);
  const int g = threadIdx.x / (kTileW / kCols);
  const int c = c0 + kCols * tx;
  // staged row k + 1 is output row k: the thread's output rows are staged
  // rows 4g + 1 .. 4g + 4, its box rows need staged rows 4g .. 4g + 5
  const float* base = s + g * kRows * kPitch + kPad + kCols * tx;
  // running 3x3x3 max / min of layers p - 1, p and p + 1 (slot l % 3)
  float amax[3][kRows][kCols], amin[3][kRows][kCols];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const float* sp = base + p * kStagedRows * kPitch;
    // horizontal 3-max / 3-min of each staged row, for both columns
    float hmax[kRows + 2][kCols], hmin[kRows + 2][kCols];
#pragma unroll
    for (int q = 0; q < kRows + 2; ++q) {
      const float* row = sp + q * kPitch;
      const float2 mid = *reinterpret_cast<const float2*>(row);
      const float a = row[-1], z = row[kCols];
      const float mm = fmaxf(mid.x, mid.y), nn = fminf(mid.x, mid.y);
      hmax[q][0] = fmaxf(a, mm);
      hmax[q][1] = fmaxf(mm, z);
      hmin[q][0] = fminf(a, nn);
      hmin[q][1] = fminf(nn, z);
    }
    // vertical 3-max / 3-min (rows 2k and 2k + 1 share their middle
    // pair), folded into the layers whose cube holds plane p
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float bx = q % 2 == 0
            ? fmaxf(hmax[q][j], fmaxf(hmax[q + 1][j], hmax[q + 2][j]))
            : fmaxf(fmaxf(hmax[q][j], hmax[q + 1][j]), hmax[q + 2][j]);
        const float bn = q % 2 == 0
            ? fminf(hmin[q][j], fminf(hmin[q + 1][j], hmin[q + 2][j]))
            : fminf(fminf(hmin[q][j], hmin[q + 1][j]), hmin[q + 2][j]);
#pragma unroll
        for (int l = p - 1; l <= p + 1; ++l) {
          if (l < 1 || l > kNL) continue;
          float& mx = amax[l % 3][q][j];
          float& mn = amin[l % 3][q][j];
          mx = l == p + 1 ? bx : fmaxf(mx, bx);   // p = l - 1 comes first
          mn = l == p + 1 ? bn : fminf(mn, bn);
        }
      }
    }
    // layer p - 1's cube is complete: test its pixels
    const int l = p - 1;
    if (l < 1 || l > kNL) continue;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = r0 + g * kRows + q;
      const bool row_in = r >= r_lo && r < r_hi;
      const float2 v2 = *reinterpret_cast<const float2*>(
          base + (l * kStagedRows + q + 1) * kPitch);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float v = j == 0 ? v2.x : v2.y;
        const int cj = c + j;
        const bool cand =
            row_in && cj >= c_lo && cj < c_hi && fabsf(v) > thr &&
            (v > 0.f ? v >= amax[l % 3][q][j]
                     : v < 0.f && v <= amin[l % 3][q][j]);
        if (kMode == Out::kDense) {
          if (r < H && cj < W)
            score[((size_t)b * nl + l0 + l - 1) * plane + (size_t)r * W + cj] =
                cand ? fabsf(v) : -1.f;
        } else {
          // every lane of the warp reaches the vote: the loops are uniform
          const unsigned vote = __ballot_sync(0xffffffffu, cand);
          if (vote) {
            const int leader = __ffs(vote) - 1;
            int at = 0;
            if (lane == leader) at = atomicAdd(count + b, __popc(vote));
            at = __shfl_sync(0xffffffffu, at, leader);
            if (cand) {
              const unsigned i =
                  (unsigned)((l0 + l - 1) * plane + (size_t)r * W + cj);
              keys[(size_t)b * nl * plane + at +
                   __popc(vote & ((1u << lane) - 1u))] =
                  ((unsigned long long)__float_as_uint(fabsf(v)) << 32) |
                  (0xFFFFFFFFu - i);
            }
          }
        }
      }
    }
  }
}

// Layers l0 + 1 .. l0 + kNL of dog (B, D, H, W), of nl scanned in all ->
// dense: those planes of score (B, nl, H, W); compact: the keys of frame
// b's candidates appended at keys[b * nl * H * W + 0 .. count[b]), count
// zeroed before the first launch; candidates only inside the box [r_lo,
// r_hi) x [c_lo, c_hi). Block (x, y, z) scans the 128 x 16 tile at
// columns 128x.., rows 16y.. of frame z. vec: W % 4 == 0 and dog 16-byte
// aligned.
template <Out kMode, int kNL>
__global__ void __launch_bounds__(kThreads, 4)
extrema_kernel(const float* __restrict__ dog, float* __restrict__ score,
               unsigned long long* __restrict__ keys, int* __restrict__ count,
               int l0, int nl, int D, int H, int W, float thr, int r_lo,
               int r_hi, int c_lo, int c_hi, bool vec) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const size_t plane = (size_t)H * W;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  stage_tile<kNL + 2>(s, dog + ((size_t)b * D + l0) * plane, plane, H, W, r0,
                      c0, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  scan_tile<kMode, kNL>(s, score, keys, count, b, l0, nl, plane, H, W, r0, c0,
                        thr, r_lo, r_hi, c_lo, c_hi);
}

// Sort a[0..n2) (shared or device memory), n2 a power of two up to 2^31,
// descending or ascending; every thread of the block calls it after a
// barrier. Each step runs its n2 / 2 compare-exchange pairs (i, i + j),
// one a thread.
__device__ __forceinline__ void bitonic_sort(unsigned long long* a,
                                             unsigned n2, bool descending) {
  for (unsigned k = 2; k != 0 && k <= n2; k <<= 1) {
    for (unsigned j = k >> 1; j > 0; j >>= 1) {
      for (unsigned p = threadIdx.x; p < n2 / 2; p += blockDim.x) {
        const unsigned i = p + (p & ~(j - 1));  // (p / j) * 2j + p % j
        const unsigned long long x = a[i], y = a[i + j];
        const bool up = ((i & k) == 0) != descending;
        if (up ? x > y : x < y) {
          a[i] = y;
          a[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The key at or above which exactly `cap` of key[0..n) lie, n > cap:
// a radix select from the top digit down, 8 bits a pass. Each pass counts
// the digits of the keys that share the prefix found so far; the digit
// where the count from the top reaches k fixes 8 more bits. It stops as
// soon as that digit's keys are exactly the k still wanted (at the
// latest at the lowest digit, since keys are unique); every key with the
// prefix is then kept, so the prefix with zero low bits is the threshold.
__device__ unsigned long long radix_threshold(
    const unsigned long long* __restrict__ key, int n, int cap) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ unsigned s_k;
  __shared__ bool s_done;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_k = (unsigned)cap;
    s_done = false;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int q = tid; q < 256; q += blockDim.x) hist[q] = 0;
    __syncthreads();
    const unsigned long long prefix = s_prefix, mask = s_mask;
    for (long long q = tid; q < n; q += blockDim.x) {
      const unsigned long long x = key[q];
      if ((x & mask) == prefix) atomicAdd(&hist[(x >> shift) & 255], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned part = 0;
      for (int d = 0; d < 8; ++d) part += hist[255 - 8 * tid - d];
      unsigned incl = part;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      unsigned above = incl - part;
      const unsigned k = s_k;
      if (above < k && k <= incl) {
        for (int d = 0; d < 8; ++d) {
          const int digit = 255 - 8 * tid - d;
          const unsigned h = hist[digit];
          if (above + h >= k) {
            s_prefix = prefix | ((unsigned long long)digit << shift);
            s_mask = mask | (255ull << shift);
            s_k = k - above;
            s_done = h == k - above;
            break;
          }
          above += h;
        }
      }
    }
    __syncthreads();
    if (s_done) break;
  }
  return s_prefix;
}

__device__ __forceinline__ void write_slot(int* layer, int* row, int* col,
                                           bool* valid, size_t slot,
                                           unsigned i, unsigned hw, int W,
                                           bool ok) {
  const unsigned rem = i % hw;
  layer[slot] = (int)(i / hw) + 1;
  row[slot] = (int)(rem / W);
  col[slot] = (int)(rem % W);
  valid[slot] = ok;
}

// The scratch path, past kMaxSharedKeys slots: one block per frame b
// sorts the kept keys of key[b * nl * H * W + 0 .. count[b]) with the
// bitonic network in scratch + b * sort_keys (sort_keys the power of two
// at or above min(cap, nl * H * W)) and writes layer, row, col, valid
// (B, cap) as the rank select does. The block has a whole number of
// warps, at least one.
__global__ void __launch_bounds__(kMaxSelThreads)
network_select_kernel(const unsigned long long* __restrict__ keys,
                      const int* __restrict__ count,
                      unsigned long long* __restrict__ scratch,
                      int* __restrict__ layer, int* __restrict__ row,
                      int* __restrict__ col, bool* __restrict__ valid,
                      int cap, int nl, int H, int W, unsigned sort_keys) {
  __shared__ int s_m;
  __shared__ unsigned s_min;
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned long long* sk = scratch + (size_t)b * sort_keys;
  const unsigned hw = (unsigned)H * (unsigned)W;
  const long long total = (long long)nl * hw;
  const unsigned long long* key = keys + (size_t)b * total;
  const int n = count[b];
  layer += (size_t)b * cap;
  row += (size_t)b * cap;
  col += (size_t)b * cap;
  valid += (size_t)b * cap;

  const unsigned long long lowest = n > cap ? radix_threshold(key, n, cap)
                                            : 0ull;
  if (tid == 0) {
    s_m = 0;
    s_min = 0xFFFFFFFFu;
  }
  __syncthreads();
  // keep the keys at or above `lowest`, one shared atomic per warp
  const int lane = tid & 31;
  for (long long q0 = tid - lane; q0 < n; q0 += blockDim.x) {
    const long long q = q0 + lane;
    const unsigned long long x = q < n ? key[q] : 0ull;
    const bool keep = q < n && x >= lowest;
    const unsigned vote = __ballot_sync(0xffffffffu, keep);
    const unsigned lowest_index =
        __reduce_min_sync(0xffffffffu, keep ? 0xFFFFFFFFu - (unsigned)x
                                            : 0xFFFFFFFFu);
    int at = 0;
    if (lane == 0 && vote) {
      at = atomicAdd(&s_m, __popc(vote));
      atomicMin(&s_min, lowest_index);
    }
    at = __shfl_sync(0xffffffffu, at, 0);
    if (keep) sk[at + __popc(vote & ((1u << lane) - 1u))] = x;
  }
  __syncthreads();
  const int m = s_m;  // min(n, cap)
  unsigned n2 = 1;
  while (n2 < (unsigned)m) n2 <<= 1;
  for (unsigned q = m + tid; q < n2; q += blockDim.x) sk[q] = 0ull;
  __syncthreads();
  bitonic_sort(sk, n2, true);
  for (int q = tid; q < m; q += blockDim.x)
    write_slot(layer, row, col, valid, q, 0xFFFFFFFFu - (unsigned)sk[q], hw,
               W, true);

  // slots m .. slots - 1: the j-th lowest flat index that is no
  // candidate, j + #{candidates below it}; with the candidates' indices
  // c_0 < c_1 < ... that count is #{q : c_q - q <= j}, since c_q - q
  // indices below c_q are no candidate
  const int slots = (int)(total < cap ? total : cap);
  const int gaps = slots - m;
  if (gaps > 0 && s_min < (unsigned)gaps) {
    __syncthreads();  // every candidate slot has read sk
    for (unsigned q = tid; q < n2; q += blockDim.x)
      sk[q] = q < (unsigned)m ? 0xFFFFFFFFull - (unsigned)sk[q] : ~0ull;
    __syncthreads();
    bitonic_sort(sk, n2, false);
    for (int j = tid; j < gaps; j += blockDim.x) {
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((long long)sk[mid] - mid <= j)
          lo = mid + 1;
        else
          hi = mid;
      }
      write_slot(layer, row, col, valid, m + j, (unsigned)(j + lo), hw, W,
                 false);
    }
  } else {
    // no candidate among the first `gaps` indices: they are 0, 1, ...
    for (int j = tid; j < gaps; j += blockDim.x)
      write_slot(layer, row, col, valid, m + j, (unsigned)j, hw, W, false);
  }
  // slots past the field, as _decode pads them: index 0, score -1
  for (int q = slots + tid; q < cap; q += blockDim.x)
    write_slot(layer, row, col, valid, q, 0u, hw, W, false);
}

// Exclusive prefix sum of each thread's v over a kSelThreads block, in
// thread order; every thread calls it. sums: kSelWarps words of shared
// memory, free again when it returns.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v,
                                                        unsigned* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  unsigned base = 0;
  for (int w = 0; w < warp; ++w) base += sums[w];
  __syncthreads();
  return base + incl - v;
}

// The part [lo, hi) of `span` items that CTA g takes, of G CTAs with
// 2^lg <= G < 2^(lg + 1): contiguous chunks of span / 2^lg + 1 items,
// the first 2^lg CTAs covering the span, with a shift and no division.
__device__ __forceinline__ void chunk_of(int span, int g, int lg, int* lo,
                                         int* hi) {
  const int per = (span >> lg) + 1;
  *lo = min(g * per, span);
  *hi = min(*lo + per, span);
}

// floor(a / b) for 0 <= a < 2^16 and b >= 1, without an integer
// division: (a + 0.5) / b has the same floor and lies more than 2^-17 of
// its value from an integer, far beyond the float quotient's error.
__device__ __forceinline__ int small_quotient(int a, int b) {
  return static_cast<int>(__fdividef(a + 0.5f, static_cast<float>(b)));
}

// c0 += the number of the keys of staged[y0, y1) larger than x0, c1
// the same for x1; staged is 16-byte aligned, and every thread of a warp
// reads the same keys.
__device__ __forceinline__ void count_above(
    const unsigned long long* staged, int y0, int y1, unsigned long long x0,
    unsigned long long x1, unsigned& c0, unsigned& c1) {
  int k = y0;
  if (k < y1 && (k & 1)) {
    c0 += staged[k] > x0;
    c1 += staged[k] > x1;
    ++k;
  }
  const ulonglong2* pair = reinterpret_cast<const ulonglong2*>(staged + k);
#pragma unroll 4
  for (; k + 1 < y1; k += 2) {
    const ulonglong2 v = *pair++;
    c0 += (v.x > x0) + (v.y > x0);
    c1 += (v.x > x1) + (v.y > x1);
  }
  if (k < y1) {
    c0 += staged[k] > x0;
    c1 += staged[k] > x1;
  }
}

// CTA blockIdx.x of the gridDim.x CTAs of frame blockIdx.y: the keys
// key[frame * nl * H * W + 0 .. count[frame]) -> its share of layer,
// row, col, valid (B, cap), the slots of a stable descending sort of the
// frame's dense scores (ops/extrema.py:_decode). Dynamic shared memory:
// `stage` keys, then two words per 32 slots of min(cap, nl * H * W) <=
// stage.
__global__ void __launch_bounds__(kSelThreads)
rank_select_kernel(const unsigned long long* __restrict__ keys,
                   const int* __restrict__ count, int* __restrict__ layer,
                   int* __restrict__ row, int* __restrict__ col,
                   bool* __restrict__ valid, int cap, int nl, int H, int W,
                   int stage) {
  extern __shared__ __align__(16) unsigned long long staged[];
  __shared__ unsigned sums[kSelWarps];
  __shared__ unsigned partial[2 * kSelThreads];   // ranks' parts
  const int frame = blockIdx.y, g = blockIdx.x;
  const int lg = 31 - __clz(gridDim.x);   // chunk_of's shift
  const int tid = threadIdx.x;
  const unsigned hw = (unsigned)H * (unsigned)W;
  const long long total = (long long)nl * hw;
  const int slots = (int)(total < cap ? total : cap);
  const int words = (slots + 31) / 32;
  unsigned* bits = reinterpret_cast<unsigned*>(staged + stage);
  unsigned* zeros = bits + words;   // free indices before each word
  const unsigned long long* key = keys + (size_t)frame * total;
  const int n = count[frame];
  layer += (size_t)frame * cap;
  row += (size_t)frame * cap;
  col += (size_t)frame * cap;
  valid += (size_t)frame * cap;
  const int m = n < cap ? n : cap;
  const int gaps = slots - m;   // n <= nl * H * W, so m <= slots

  // stage the list (past `stage` keys: only the kept ones, below)
  bool low = false;   // a candidate among the first `gaps` indices
  if (n <= stage) {
    for (int q = tid; q < n; q += kSelThreads) {
      const unsigned long long x = key[q];
      staged[q] = x;
      low |= 0xFFFFFFFFu - (unsigned)x < (unsigned)gaps;
    }
  }
  if (gaps > 0)
    for (int w = tid; w < words; w += kSelThreads) bits[w] = 0u;
  const bool general = __syncthreads_or(low);
  const int ny = n <= stage ? n : cap;

  if (n > stage) {
    // the cap-th largest key, then the kept keys packed: thread t's in
    // list order, at the sum of the counts of threads 0..t-1, so every
    // CTA packs them alike
    const unsigned long long lowest = radix_threshold(key, n, cap);
    unsigned c = 0;
    for (int q = tid; q < n; q += kSelThreads) c += key[q] >= lowest;
    unsigned at = block_exclusive_sum(c, sums);
    for (int q = tid; q < n; q += kSelThreads) {
      const unsigned long long x = key[q];
      if (x >= lowest) staged[at++] = x;
    }
    __syncthreads();
  }

  // the gap and padding slots first: their stores drain while the ranks
  // are counted
  int q0, q1;
  if (!general) {
    // slots m .. cap - 1: index q - m below `slots`, 0 past the field
    chunk_of(cap - m, g, lg, &q0, &q1);
    for (int q = m + q0 + tid; q < m + q1; q += kSelThreads)
      write_slot(layer, row, col, valid, q, q < slots ? (unsigned)(q - m) : 0u,
                 hw, W, false);
  } else {
    // slot m + j: the j-th zero bit of the candidates' bitmap over
    // [0, slots), which holds at least `gaps` zeros
    for (int k = tid; k < ny; k += kSelThreads) {
      const unsigned i = 0xFFFFFFFFu - (unsigned)staged[k];
      if (i < (unsigned)slots) atomicOr(bits + (i >> 5), 1u << (i & 31));
    }
    __syncthreads();
    const int per = (words + kSelThreads - 1) / kSelThreads;
    const int w0 = min(tid * per, words), w1 = min(w0 + per, words);
    unsigned z = 0;
    for (int w = w0; w < w1; ++w) z += 32 - __popc(bits[w]);
    unsigned before = block_exclusive_sum(z, sums);
    for (int w = w0; w < w1; ++w) {
      zeros[w] = before;
      before += 32 - __popc(bits[w]);
    }
    __syncthreads();
    chunk_of(words, g, lg, &q0, &q1);
    for (int i = q0 * 32 + tid; i < min(q1 * 32, slots); i += kSelThreads) {
      const unsigned word = bits[i >> 5], bit = i & 31;
      if ((word >> bit) & 1u) continue;
      const unsigned j = zeros[i >> 5] + __popc(~word & ((1u << bit) - 1u));
      if (j < (unsigned)gaps)
        write_slot(layer, row, col, valid, m + (int)j, (unsigned)i, hw, W,
                   false);
    }
    // slots past the field, as _decode pads them: index 0, score -1
    chunk_of(cap - slots, g, lg, &q0, &q1);
    for (int q = slots + q0 + tid; q < slots + q1; q += kSelThreads)
      write_slot(layer, row, col, valid, q, 0u, hw, W, false);
  }

  // rank: each key of this CTA's slice staged[lo, hi) against all ny
  // staged keys; a rank below cap is a kept key's slot. A thread takes
  // the keys i and i + np of the slice (np = ns / 2, rounded up; i + np
  // may be past it, x1 = x0 then) over `parts` contiguous parts of the
  // list of `len` keys each, 32 or more (any parts <= kSelThreads / np
  // and len * parts >= ny cover the list)
  int lo, hi;
  chunk_of(ny, g, lg, &lo, &hi);
  const int ns = hi - lo, np = (ns + 1) / 2;
  if (ns == 0) return;   // alike for the whole CTA
  const int parts =
      np >= kSelThreads
          ? 1
          : max(1, min(small_quotient(kSelThreads, np), ny >> 5));
  if (parts == 1) {
    // whole ranks: a thread writes its keys' slots at once
    for (int i = tid; i < np; i += kSelThreads) {
      const int i1 = i + np < ns ? i + np : i;
      const unsigned long long x0 = staged[lo + i], x1 = staged[lo + i1];
      unsigned r0 = 0, r1 = 0;
      count_above(staged, 0, ny, x0, x1, r0, r1);
      if (r0 < (unsigned)cap)
        write_slot(layer, row, col, valid, r0, 0xFFFFFFFFu - (unsigned)x0,
                   hw, W, true);
      if (i1 != i && r1 < (unsigned)cap)
        write_slot(layer, row, col, valid, r1, 0xFFFFFFFFu - (unsigned)x1,
                   hw, W, true);
    }
    return;
  }
  // parts of ranks: thread p * np + i counts part p for keys i and
  // i + np into partial[tid] and partial[kSelThreads + tid]; after the
  // barrier slice key j sums its parts
  if (tid < np * parts) {
    const int p = small_quotient(tid, np), i = tid - p * np;
    const int i1 = i + np < ns ? i + np : i;
    const int len = small_quotient(ny, parts) + 1;
    const int y0 = min(p * len, ny), y1 = min(y0 + len, ny);
    unsigned c0 = 0, c1 = 0;
    count_above(staged, y0, y1, staged[lo + i], staged[lo + i1], c0, c1);
    partial[tid] = c0;
    partial[kSelThreads + tid] = c1;
  }
  __syncthreads();
  if (tid < ns) {
    const unsigned* from = tid < np ? partial + tid
                                    : partial + kSelThreads + tid - np;
    unsigned r = 0;
    for (int p = 0; p < parts; ++p) r += from[p * np];
    if (r < (unsigned)cap)
      write_slot(layer, row, col, valid, r,
                 0xFFFFFFFFu - (unsigned)staged[lo + tid], hw, W, true);
  }
}

// An empty kernel: the launch floor of a select launch shape (measurement
// only; no path launches it).
__global__ void empty_kernel() {}

// The power of two at or above slots (1 <= slots < 2^31).
unsigned sort_size(long long slots) {
  unsigned n2 = 1;
  while ((long long)n2 < slots) n2 <<= 1;
  return n2;
}

// Dynamic shared memory of a rank-select CTA (rank_select_kernel).
size_t rank_select_smem(int stage, int slots) {
  return sizeof(unsigned long long) * (size_t)stage +
         sizeof(unsigned) * 2 * (size_t)((slots + 31) / 32);
}

// Once per device: raise the rank select's dynamic shared memory limit
// to its largest size (kMaxSharedKeys staged keys, one CTA a frame).
cudaError_t prepare_select() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const int bytes =
        (int)rank_select_smem(kMaxSharedKeys, kMaxSharedKeys);
    err = cudaFuncSetAttribute(
        rank_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <Out kMode, int kNL>
cudaError_t launch_scan_nl(dim3 grid, cudaStream_t stream, const float* dog,
                           float* score, unsigned long long* keys,
                           int* count, int l0, int nl, int D, int H, int W,
                           float thr, int r_lo, int r_hi, int c_lo, int c_hi,
                           bool vec) {
  // the staged tile: 39.2 KB at nL = 2, 78.3 KB at nL = 6; the limit
  // above 48 KB is raised once per device
  constexpr int kSmem = sizeof(float) * (kNL + 2) * kStagedRows * kPitch;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(extrema_kernel<kMode, kNL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  extrema_kernel<kMode, kNL><<<grid, kThreads, kSmem, stream>>>(
      dog, score, keys, count, l0, nl, D, H, W, thr, r_lo, r_hi, c_lo, c_hi,
      vec);
  return cudaGetLastError();
}

template <Out kMode>
int launch_scan(const float* dog, float* score, unsigned long long* keys,
                int* count, int B, int D, int nl, int H, int W, float thr,
                int r_lo, int r_hi, int c_lo, int c_hi, cudaStream_t stream) {
  // the box keeps every neighbour load of a tested pixel inside the frame
  if (B < 0 || B > 65535 || nl < 0 || D < nl + 2 || r_lo < 1 || c_lo < 1 ||
      r_hi > H - 1 || c_hi > W - 1 || H < 0 || W < 0 ||
      (H + kTileH - 1) / kTileH > 65535)
    return cudaErrorInvalidValue;
  if ((size_t)B * nl * H * W == 0) return cudaSuccess;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(dog) % 16 == 0;
  // the layer count of a launch is a template argument, so the plane loop
  // unrolls; more than kMaxLayers layers take one launch per kMaxLayers,
  // each staging its layers and the two planes around them
  for (int l0 = 0; l0 < nl; l0 += kMaxLayers) {
    const int k = nl - l0 < kMaxLayers ? nl - l0 : kMaxLayers;
    cudaError_t err = cudaErrorInvalidValue;
    switch (k) {
#define SIFT_SCAN_CASE(n)                                                    \
  case n:                                                                    \
    err = launch_scan_nl<kMode, n>(grid, stream, dog, score, keys, count, l0, \
                                   nl, D, H, W, thr, r_lo, r_hi, c_lo, c_hi, \
                                   vec);                                     \
    break;
      SIFT_SCAN_CASE(1)
      SIFT_SCAN_CASE(2)
      SIFT_SCAN_CASE(3)
      SIFT_SCAN_CASE(4)
      SIFT_SCAN_CASE(5)
      SIFT_SCAN_CASE(6)
#undef SIFT_SCAN_CASE
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool field_fits(int nl, int H, int W) {
  // flat indices and counts are 32-bit
  return (long long)nl * H * W <= 0x7FFFFFFFLL;
}

}  // namespace

// Dense: dog (B, D, H, W) -> out (B, nl, H, W) scores, scanning layers
// 1..nl of each frame inside the border box; needs D >= nl + 2 and
// border >= 1. B = 1 is the single-frame K2.
extern "C" int sift_extrema_scores(const float* dog, float* out, int B,
                                   int D, int nl, int H, int W, float thr,
                                   int border, void* stream_ptr) {
  return launch_scan<Out::kDense>(dog, out, nullptr, nullptr, B, D, nl, H, W,
                                  thr, border, H - border, border, W - border,
                                  static_cast<cudaStream_t>(stream_ptr));
}

// Compact: dog (B, D, H, W) -> keys (B, nl * H * W) uint64, of which
// frame b's first count[b] hold the keys of its candidates inside the box
// [r_lo, r_hi) x [c_lo, c_hi) in no particular order, and count (B,)
// int32 (zeroed here, on the stream). The box lies inside [1, H - 1) x
// [1, W - 1); r_hi <= r_lo (or c_hi <= c_lo) is an empty box.
extern "C" int sift_extrema_compact(const float* dog,
                                    unsigned long long* keys, int* count,
                                    int B, int D, int nl, int H, int W,
                                    float thr, int r_lo, int r_hi, int c_lo,
                                    int c_hi, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 0 || !field_fits(nl, H, W)) return cudaErrorInvalidValue;
  if (B > 0) {
    const cudaError_t err =
        cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_scan<Out::kCompact>(dog, nullptr, keys, count, B, D, nl, H,
                                    W, thr, r_lo, r_hi, c_lo, c_hi, stream);
}

// Select: keys (B, nl * H * W) and count (B,) from sift_extrema_compact
// -> layer, row, col (int32) and valid (bool), each (B, cap): the top
// `cap` candidates of each frame, in the order of a stable descending
// sort of its dense scores. cap >= 1. Up to kMaxSharedKeys slots
// (min(cap, nl * H * W)) a rank select of `ctas` CTAs a frame, each
// staging up to `stage` keys (slots <= stage <= kMaxSharedKeys); the
// wrapper picks both (ops/extrema_cuda.select_shape), and scratch is
// unused and may be null. Past that, scratch: B * S keys, S the power of
// two at or above min(cap, nl * H * W), where the bitonic network runs
// in device memory, one block a frame; ctas and stage are then unused.
extern "C" int sift_extrema_select(const unsigned long long* keys,
                                   const int* count,
                                   unsigned long long* scratch, int* layer,
                                   int* row, int* col, bool* valid, int B,
                                   int cap, int nl, int H, int W, int ctas,
                                   int stage, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 0 || B > 65535 || cap < 1 || nl < 1 || H < 1 || W < 1 ||
      !field_fits(nl, H, W))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const long long total = (long long)nl * H * W;
  const int slots = (int)(cap < total ? cap : total);
  if (slots <= kMaxSharedKeys) {
    if (ctas < 1 || ctas > 65535 || stage < slots || stage > kMaxSharedKeys)
      return cudaErrorInvalidValue;
    const cudaError_t err = prepare_select();
    if (err != cudaSuccess) return err;
    rank_select_kernel<<<dim3(ctas, B), kSelThreads,
                         rank_select_smem(stage, slots), stream>>>(
        keys, count, layer, row, col, valid, cap, nl, H, W, stage);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  // a thread for each compare-exchange pair of the largest sort
  const unsigned n2 = sort_size(slots);
  const int threads = n2 / 2 > kMaxSelThreads ? kMaxSelThreads : n2 / 2;
  network_select_kernel<<<B, threads, 0, stream>>>(
      keys, count, scratch, layer, row, col, valid, cap, nl, H, W, n2);
  return cudaGetLastError();
}

// An empty kernel launched with the rank select's shape for these
// arguments (grid ctas x B, kSelThreads threads, its dynamic shared
// memory): the launch floor beside the select's time. No path calls it.
extern "C" int sift_extrema_select_floor(int B, int cap, int nl, int H,
                                         int W, int ctas, int stage,
                                         void* stream_ptr) {
  const long long total = (long long)nl * H * W;
  const int slots = (int)(cap < total ? cap : total);
  if (B < 1 || B > 65535 || cap < 1 || nl < 1 || H < 1 || W < 1 ||
      !field_fits(nl, H, W) || ctas < 1 || ctas > 65535 || stage < slots ||
      stage > kMaxSharedKeys)
    return cudaErrorInvalidValue;
  const cudaError_t err = prepare_select();
  if (err != cudaSuccess) return err;
  empty_kernel<<<dim3(ctas, B), kSelThreads,
                 rank_select_smem(stage, slots),
                 static_cast<cudaStream_t>(stream_ptr)>>>();
  return cudaGetLastError();
}
