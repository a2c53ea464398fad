// K4: brute-force top-2 L1 matcher, (N, 128) queries x (M, 128) train,
// for G such pairs in one launch ((G, N, 128) x (G, M, 128); G = 1 is
// one pair).
//
// Replaces the Pallas kernel sift_tpu/ops/match_pallas.py:_kernel /
// _knn2_padded (reference BFMatcher NORM_L1 knnMatch k=2,
// src/main.cpp:25-27), and, with G pairs, that kernel under jax.vmap
// (the batch step's B - 1 consecutive matches, bench.py:511-519), where
// pallas_call's batching rule adds a grid dimension. Per query: the
// best train index, the best distance d1 and the second-best d2; the
// N x M distance matrix never reaches device memory.
//
// What bounds it on the H100: the float instructions. L1 distance is not
// a product, so neither the tensor cores nor FMA can run it: each pair
// and dimension is one subtraction and one add (the |.| rides the add),
// 2 N M 128 separate f32 instructions, 0.6 G at N = M = 1536, an 18 us
// floor at one instruction per lane and clock on 132 SMs. The design
// keeps the card full and the loads off that path:
//   - the train set is split across blocks: the grid is (query tiles x P
//     splits x G pairs), with P chosen by the wrapper
//     (ops/match_cuda.split_plan) so the grid covers the SMs at least
//     twice (24 x 12 blocks at 1536 x 1536 on 132 SMs, 24 x 2 x 7 for 7
//     such pairs). Each block writes a partial (d1, d2, idx) for its
//     split into (P, G N) scratch; a second kernel merges the P partials
//     of each of the G N queries in split order. No atomics, so the
//     result does not depend on block scheduling, and a pair's result is
//     the single launch's on that pair;
//   - a register tile: a block of 256 threads owns 64 queries; thread
//     (tq, tt) keeps 4 queries x 4 train rows of accumulators and reads
//     its operands from shared memory as float4 along the dimension, so 8
//     loads feed 128 instructions. Rows are padded to 132 floats, so the
//     16 train rows a warp reads at one dimension fill all 32 banks;
//   - double-buffered train tiles: a tile is 64 contiguous 512-byte
//     rows, copied with cp.async while the previous tile is consumed.
// Shared memory: 64 query rows + 2 x 64 train rows of 132 floats,
// 99 KB, so 2 blocks share an SM (the launch bounds cap registers at 128).
//
// Determinism and ties: each distance is summed over the 128 dims in
// order 0..127 (__fsub_rn, |.|, __fadd_rn; no reassociation), the order
// of the plain PyTorch version (ops/match_cuda.py), so distances are
// bit-identical to it. A thread visits its rows in increasing index and
// replaces its best only on strict <, so within a thread the lowest index
// wins ties. Partials are then merged -- across the 16 threads that share
// a query by warp shuffles, across splits in split order -- with one rule:
// the other partial wins if its d1 is smaller, or equal with a lower
// index. The rule yields the exact top-2 of the union whatever the
// order, so the lowest train index wins ties, as in the Pallas kernel
// (match_pallas.py:75) and BFMatcher. A split or a thread with no rows
// carries d1 = d2 = 3e38 and index INT_MAX, which never wins; a query
// that no row reaches (M = 0) gets index 0, as the plain version gives.
// Ragged N and M are masked here; nothing is padded.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kD = 128;
constexpr int kQB = 64;           // queries per block
constexpr int kTT = 64;           // train rows per shared-memory tile
constexpr int kThreads = 256;     // 16 query lanes x 16 train lanes
constexpr int kRQ = 4;            // queries per thread: tq + 16 i
constexpr int kRT = 4;            // train rows per thread and tile: tt + 16 j
constexpr int kPitch = kD + 4;    // floats per shared-memory row
constexpr int kChunks = kD / 4;   // 16-byte chunks per row
constexpr int kMergeThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kInf = 3.0e38f;   // as match_pallas._INF
constexpr int kNoRow = INT_MAX;

constexpr size_t kSmemBytes = sizeof(float) * (kQB + 2 * kTT) * kPitch;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row_end) of src (rows of kD floats) into dst (rows of
// kPitch floats) starting at dst row 0; rows past row_end read as zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int nrows, int row_end,
                                          int tid) {
  for (int c = tid; c < nrows * kChunks; c += kThreads) {
    const int i = c / kChunks, k = (c % kChunks) * 4;
    const bool ok = row0 + i < row_end;
    cp_async16(dst + i * kPitch + k,
               ok ? src + (size_t)(row0 + i) * kD + k : src, ok);
  }
}

// Fold partial (x1, x2, xi) into (d1, d2, idx): both are exact top-2s of
// disjoint row sets, the result is that of their union.
__device__ __forceinline__ void merge(float& d1, float& d2, int& idx,
                                      float x1, float x2, int xi) {
  if (x1 < d1 || (x1 == d1 && xi < idx)) {
    d2 = fminf(d1, x2);
    d1 = x1;
    idx = xi;
  } else {
    d2 = fminf(d2, x1);
  }
}

// Block (x, p, g): pair g's queries 64 x .. 64 x + 63 against its train
// rows [p * span, min(M, (p + 1) * span)) -> partials
// pd1/pd2/pidx[p][g N + query].
__global__ void __launch_bounds__(kThreads, 2)
knn2_split_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  int G, int N, int M, int span, float* __restrict__ pd1,
                  float* __restrict__ pd2, int* __restrict__ pidx) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* st = sq + kQB * kPitch;  // two tiles
  const int tid = threadIdx.x, tq = tid >> 4, tt = tid & 15;
  const int q0 = blockIdx.x * kQB, p = blockIdx.y, g = blockIdx.z;
  q += (size_t)g * N * kD;  // pair g's rows; 64-bit offsets
  t += (size_t)g * M * kD;
  const long long first = (long long)p * span;
  const int row0 = first < M ? (int)first : M;
  const int row_end = (int)min((long long)M, first + span);
  const int ntiles = (row_end - row0 + kTT - 1) / kTT;

  load_rows(sq, q, q0, kQB, N, tid);
  if (ntiles > 0) load_rows(st, t, row0, kTT, row_end, tid);
  cp_async_commit();

  float b1[kRQ], b2[kRQ];
  int bi[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    b1[i] = kInf;
    b2[i] = kInf;
    bi[i] = kNoRow;
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    // prefetch the next tile (or commit an empty group), then wait for
    // all but that one: the current tile and the queries have landed
    if (tile + 1 < ntiles)
      load_rows(st + ((tile + 1) & 1) * kTT * kPitch, t,
                row0 + (tile + 1) * kTT, kTT, row_end, tid);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* tb = st + (tile & 1) * kTT * kPitch;
    float acc[kRQ][kRT];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kD; k += 4) {
      float4 a[kRQ], b[kRT];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (tq + 16 * i) * kPitch +
                                                k);
#pragma unroll
      for (int j = 0; j < kRT; ++j)
        b[j] = *reinterpret_cast<const float4*>(tb + (tt + 16 * j) * kPitch +
                                                k);
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          float s = acc[i][j];
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].x, b[j].x)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].y, b[j].y)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].z, b[j].z)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].w, b[j].w)));
          acc[i][j] = s;
        }
    }
    const int rbase = row0 + tile * kTT + tt;
#pragma unroll
    for (int j = 0; j < kRT; ++j) {  // rows in increasing index
      const int row = rbase + 16 * j;
      if (row < row_end) {
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          const float x = acc[i][j];
          if (x < b1[i]) {
            b2[i] = b1[i];
            b1[i] = x;
            bi[i] = row;
          } else if (x < b2[i]) {
            b2[i] = x;
          }
        }
      }
    }
    __syncthreads();  // this tile is read before it is overwritten
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left in flight
  // the 16 train lanes of a query sit in one half-warp
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float x1 = __shfl_xor_sync(0xffffffffu, b1[i], off);
      const float x2 = __shfl_xor_sync(0xffffffffu, b2[i], off);
      const int xi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      merge(b1[i], b2[i], bi[i], x1, x2, xi);
    }
  }
  if (tt != 0) return;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int qq = q0 + tq + 16 * i;
    if (qq < N) {
      const size_t o = ((size_t)p * G + g) * N + qq;
      pd1[o] = b1[i];
      pd2[o] = b2[i];
      pidx[o] = bi[i];
    }
  }
}

// Per query of all G pairs (NG = G N), the P partials merged in split
// order.
__global__ void __launch_bounds__(kMergeThreads)
knn2_merge_kernel(const float* __restrict__ pd1,
                  const float* __restrict__ pd2,
                  const int* __restrict__ pidx, long long NG, int P,
                  int* __restrict__ out_idx, float* __restrict__ out_d1,
                  float* __restrict__ out_d2) {
  const long long qq = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (qq >= NG) return;
  float d1 = pd1[qq], d2 = pd2[qq];
  int idx = pidx[qq];
  for (int p = 1; p < P; ++p) {
    const size_t o = (size_t)p * NG + qq;
    merge(d1, d2, idx, pd1[o], pd2[o], pidx[o]);
  }
  out_idx[qq] = idx == kNoRow ? 0 : idx;
  out_d1[qq] = d1;
  out_d2[qq] = d2;
}

// Raise the split kernel's dynamic shared memory limit, once per device.
cudaError_t allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(knn2_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace

// G pairs: query (G, N, 128), train (G, M, 128), both 16-byte aligned
// (invalid train rows pre-masked by the caller) -> idx (G, N) int32,
// d1 (G, N), d2 (G, N). Split p covers each pair's train rows
// [p * span, (p + 1) * span) and P * span >= M; part_d1, part_d2,
// part_idx are (P, G, N) scratch.
extern "C" int sift_knn2_l1(const float* query, const float* train, int G,
                            int N, int M, int D, int P, int span,
                            float* part_d1, float* part_d2, int* part_idx,
                            int* idx, float* d1, float* d2,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D != kD || G < 1 || G > 65535 || N < 0 || M < 0 || P < 1 ||
      P > 65535 || span < 1 || (long long)P * span < M ||
      (reinterpret_cast<uintptr_t>(query) |
       reinterpret_cast<uintptr_t>(train)) % 16)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  dim3 grid((N + kQB - 1) / kQB, P, G);
  knn2_split_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      query, train, G, N, M, span, part_d1, part_d2, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long ng = (long long)G * N;
  knn2_merge_kernel<<<(unsigned)((ng + kMergeThreads - 1) / kMergeThreads),
                      kMergeThreads, 0, stream>>>(part_d1, part_d2, part_idx,
                                                  ng, P, idx, d1, d2);
  return cudaGetLastError();
}
