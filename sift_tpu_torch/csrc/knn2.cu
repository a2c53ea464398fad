// K4: brute-force top-2 L1 matcher, (N, 128) queries x (M, 128) train.
//
// Replaces the Pallas kernel sift_tpu/ops/match_pallas.py:_kernel /
// _knn2_padded (reference BFMatcher NORM_L1 knnMatch k=2,
// src/main.cpp:25-27). Per query: the best train index, the best
// distance d1 and the second-best d2; the N x M distance matrix never
// reaches device memory.
//
// What bounds it on the H100: L1 distance is not a product, so the
// tensor cores cannot run it; it is CUDA-core work, N * M * 128 * 2
// f32 ops (0.6 G at N = M = 1536), fed from shared memory. A block owns
// 32 queries (one per lane, rows padded to 129 floats so the 32 lanes
// hit 32 different banks) and streams 32-row train tiles through shared
// memory; each of its 8 warps takes 4 rows of every tile, which all of
// its lanes read at one address (a broadcast), so each query element
// loaded from shared memory feeds 4 distances.
//
// Determinism and ties: each distance is summed over the 128 dims in
// order 0..127 (fadd with |.|, no reassociation), the same order as the
// plain PyTorch version (ops/match_cuda.py), so distances are
// bit-identical to it. A warp visits its rows in increasing index order
// and replaces its best only on strict <; the 8 warps' running
// (d1, d2, idx) are then merged in warp order, preferring the lower
// index on equal d1. So the lowest train index wins ties, as in the
// Pallas kernel (match_pallas.py:75) and BFMatcher. Ragged N and M are
// masked here; nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 128;
constexpr int kQB = 32;           // queries per block (one per lane)
constexpr int kTT = 32;           // train rows per shared-memory tile
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTT / kWarps;
constexpr float kInf = 3.0e38f;   // as match_pallas._INF

__global__ void __launch_bounds__(kWarps * 32)
knn2_kernel(const float* __restrict__ q, const float* __restrict__ t,
            int N, int M, int* __restrict__ out_idx,
            float* __restrict__ out_d1, float* __restrict__ out_d2) {
  __shared__ float sq[kQB][kD + 1];
  __shared__ float st[kTT][kD];
  __shared__ float rd1[kWarps][kQB];
  __shared__ float rd2[kWarps][kQB];
  __shared__ int ri[kWarps][kQB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQB;

  for (int e = threadIdx.x; e < kQB * kD; e += blockDim.x) {
    const int i = e / kD, k = e - i * kD;
    sq[i][k] = (q0 + i < N) ? q[(size_t)(q0 + i) * kD + k] : 0.f;
  }

  float b1 = kInf, b2 = kInf;
  int bi = 0;
  for (int t0 = 0; t0 < M; t0 += kTT) {
    __syncthreads();  // previous tile fully read (and queries staged)
    for (int e = threadIdx.x; e < kTT * kD; e += blockDim.x) {
      const int i = e / kD, k = e - i * kD;
      st[i][k] = (t0 + i < M) ? t[(size_t)(t0 + i) * kD + k] : 0.f;
    }
    __syncthreads();
    float acc[kRowsPerWarp];
#pragma unroll
    for (int g = 0; g < kRowsPerWarp; ++g) acc[g] = 0.f;
    const float* qrow = sq[lane];
#pragma unroll 8
    for (int k = 0; k < kD; ++k) {
      const float qk = qrow[k];
#pragma unroll
      for (int g = 0; g < kRowsPerWarp; ++g)
        acc[g] = __fadd_rn(acc[g], fabsf(qk - st[warp + kWarps * g][k]));
    }
#pragma unroll
    for (int g = 0; g < kRowsPerWarp; ++g) {
      const int j = t0 + warp + kWarps * g;
      if (j < M) {
        const float x = acc[g];
        if (x < b1) {
          b2 = b1;
          b1 = x;
          bi = j;
        } else if (x < b2) {
          b2 = x;
        }
      }
    }
  }
  rd1[warp][lane] = b1;
  rd2[warp][lane] = b2;
  ri[warp][lane] = bi;
  __syncthreads();
  if (warp != 0 || q0 + lane >= N) return;
  float d1 = rd1[0][lane], d2 = rd2[0][lane];
  int idx = ri[0][lane];
  for (int w = 1; w < kWarps; ++w) {
    const float x1 = rd1[w][lane], x2 = rd2[w][lane];
    const int xi = ri[w][lane];
    if (x1 < d1 || (x1 == d1 && xi < idx)) {
      d2 = fminf(d1, x2);
      d1 = x1;
      idx = xi;
    } else {
      d2 = fminf(d2, x1);
    }
  }
  out_idx[q0 + lane] = idx;
  out_d1[q0 + lane] = d1;
  out_d2[q0 + lane] = d2;
}

}  // namespace

// query (N, 128), train (M, 128) (invalid rows pre-masked by the caller)
// -> idx (N,) int32, d1 (N,), d2 (N,).
extern "C" int sift_knn2_l1(const float* query, const float* train, int N,
                            int M, int D, int* idx, float* d1, float* d2,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D != kD) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const int blocks = (N + kQB - 1) / kQB;
  knn2_kernel<<<blocks, kWarps * 32, 0, stream>>>(query, train, N, M, idx,
                                                  d1, d2);
  return cudaGetLastError();
}
