// Subpixel refinement: up to max_interp_steps Newton steps on each
// candidate's 3x3x3 DoG cube, then the contrast and edge tests
// (adjustLocalExtrema, src/sift.cpp:287-388), for every candidate slot of
// an octave of B frames in one launch.
//
// Replaces no Pallas kernel: sift_tpu/ops/refine.py leaves refinement to
// XLA, which fuses its elementwise steps. The port's plain version
// (ops/refine.py:refine_candidates_plain) writes ten dense derivative
// fields over the octave (1.33 GB at octave 0 of a B = 8 1080p step, for
// at most 4,096 candidates a frame) and runs each Newton step as ~150
// PyTorch launches, ~800 an octave; this kernel is one launch an octave.
//
// What bounds it on the H100: the launch. Its bytes are the candidate
// arrays in (13 bytes a slot), the eight outputs out (29 bytes a slot)
// and the 19 DoG values a cube's derivatives use (76 bytes a slot and
// fetch), about 3.9 MB at B = 8 x 4,096 slots: ~1.2 us at 3.35 TB/s,
// under an empty launch. So the design is one thread per (frame, slot),
// no shared memory, no intermediate array in device memory and no host
// synchronisation; a thread stops at its slot's last Newton step.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py phase 2, median of 20; floor: an empty kernel of the
// same grid):
//   octave 0, B = 1 (4,096 slots)    0.0128 ms  floor 0.0050
//   octave 0, B = 8 (32,768 slots)   0.0149 ms  floor 0.0052
// against 2.37 and 5.78 ms of device time for the plain version, whose
// ~800 launches cost the host 5.5-9.9 ms a call where this one costs
// 0.07-0.14 ms (tools/torch_kernel_times.py --refine-only). What fills
// the time above the floor was not split; a thread's up to six cube
// fetches each wait on the step before.
//
// Bit for bit the plain version in every field of every slot, valid or
// not. Each PyTorch op rounds on its own, so every product, sum and
// difference here is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn), which nvcc never contracts into an FMA, in
// PyTorch's order of operations; 1 / det is the correctly rounded
// __frcp_rn of torch.reciprocal; cv_round is round-half-even
// (__float2int_rn). Every constant is the float32 rounding of the plain
// version's Python double, as PyTorch casts a scalar beside a float32
// tensor. A cube is read where the plain version's flat gather reads it:
// the int32 index ((layer - 1) * H + r) * W + c (wrapping as int32 does)
// plus the frame's offset into the (B, nl, H, W) field, a negative index
// counted from the end, and its neighbours read as zero outside the
// stack, as the plain version's F.pad does. For the candidates of the
// scan every index lies inside the frame; only a row band's Newton move
// past the band (parallel/spatial.py, row_bounds) lands elsewhere, where
// both read the same wrong plane. An index outside the field, where the
// plain version's gather raises, is clamped into it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// the plain version's constants (ops/refine.py), rounded to float32 from
// the same doubles
constexpr double kImgScaleD = 1.0 / 255.0;             // src/sift.cpp:291
constexpr float kImgScale = (float)kImgScaleD;
constexpr float kDerivScale = (float)(kImgScaleD * 0.5);
constexpr float kSecondDerivScale = (float)kImgScaleD;
constexpr float kCrossDerivScale = (float)(kImgScaleD * 0.25);
constexpr float kDivergeLimit = (float)(2147483648.0 / 3.0);
constexpr float kSingular = (float)1e-30;

struct Geometry {
  const float* dog;   // (B, D, H, W)
  int64_t total;      // B * nl * H * W, the plain version's field
  int D, H, W, nl;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// The plain version's gather of (lay, r, c) in frame b: its field index,
// as (frame, stack layer, row, col) of the DoG stack.
struct Site {
  int64_t plane;   // frame * D + stack layer
  int r, c;
};

__device__ __forceinline__ Site site(const Geometry& g, int b, int lay,
                                     int r, int c) {
  // ((lay - 1) * h + rr) * w + cc in int32, as the plain version computes
  // it before .long()
  const uint32_t i32 =
      ((uint32_t)(lay - 1) * (uint32_t)g.H + (uint32_t)r) * (uint32_t)g.W +
      (uint32_t)c;
  int64_t idx = (int64_t)(int32_t)i32 + (int64_t)b * g.nl * g.H * g.W;
  if (idx < 0) idx += g.total;
  idx = idx < 0 ? 0 : (idx >= g.total ? g.total - 1 : idx);
  const int64_t hw = (int64_t)g.H * g.W;
  const int64_t k = idx / hw;               // frame * nl + layer - 1
  const int64_t rem = idx - k * hw;
  Site s;
  s.plane = (k / g.nl) * g.D + (k % g.nl) + 1;
  s.r = (int)(rem / g.W);
  s.c = (int)(rem - (int64_t)s.r * g.W);
  return s;
}

// The DoG value at (dl, dr, dc) from a site, zero outside the stack.
__device__ __forceinline__ float at(const Geometry& g, const Site& s, int dl,
                                    int dr, int dc) {
  const int64_t frame = s.plane / g.D;
  const int l = (int)(s.plane - frame * g.D) + dl;
  const int r = s.r + dr, c = s.c + dc;
  if (l < 0 || l >= g.D || r < 0 || r >= g.H || c < 0 || c >= g.W)
    return 0.0f;
  return __ldg(g.dog + ((frame * g.D + l) * g.H + r) * g.W + c);
}

// ops/refine.py:derivative_fields at one site.
struct Derivs {
  float d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss, center;
};

__device__ Derivs derivs(const Geometry& g, const Site& s) {
  const float v = at(g, s, 0, 0, 0);
  const float xp = at(g, s, 0, 0, 1), xm = at(g, s, 0, 0, -1);
  const float yp = at(g, s, 0, 1, 0), ym = at(g, s, 0, -1, 0);
  const float sp = at(g, s, 1, 0, 0), sm = at(g, s, -1, 0, 0);
  const float v2 = mul(v, 2.0f);
  Derivs d;
  d.d0 = mul(sub(xp, xm), kDerivScale);
  d.d1 = mul(sub(yp, ym), kDerivScale);
  d.d2 = mul(sub(sp, sm), kDerivScale);
  d.dxx = mul(sub(add(xp, xm), v2), kSecondDerivScale);
  d.dyy = mul(sub(add(yp, ym), v2), kSecondDerivScale);
  d.dss = mul(sub(add(sp, sm), v2), kSecondDerivScale);
  d.dxy = mul(add(sub(sub(at(g, s, 0, 1, 1), at(g, s, 0, 1, -1)),
                      at(g, s, 0, -1, 1)),
                  at(g, s, 0, -1, -1)),
              kCrossDerivScale);
  d.dxs = mul(add(sub(sub(at(g, s, 1, 0, 1), at(g, s, 1, 0, -1)),
                      at(g, s, -1, 0, 1)),
                  at(g, s, -1, 0, -1)),
              kCrossDerivScale);
  d.dys = mul(add(sub(sub(at(g, s, 1, 1, 0), at(g, s, 1, -1, 0)),
                      at(g, s, -1, 1, 0)),
                  at(g, s, -1, -1, 0)),
              kCrossDerivScale);
  d.center = v;
  return d;
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__global__ void refine_kernel(Geometry g, const int* __restrict__ layer,
                              const int* __restrict__ row,
                              const int* __restrict__ col,
                              const bool* __restrict__ valid,
                              int* __restrict__ out_layer,
                              int* __restrict__ out_r,
                              int* __restrict__ out_c,
                              float* __restrict__ out_xi,
                              float* __restrict__ out_xr,
                              float* __restrict__ out_xc,
                              float* __restrict__ out_contr,
                              bool* __restrict__ out_valid, int N, int B,
                              int border, int row_lo, int row_hi, int steps,
                              float contrast_thr, float edge,
                              float edge_sq) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;
  const int b = (int)(i / N);
  int lay = layer[i], r = row[i], c = col[i];
  float xi = 0.0f, xr = 0.0f, xc = 0.0f;
  bool alive = valid[i], converged = false;

  // SIFT_MAX_INTERP_STEPS Newton steps (src/sift.cpp:300-348); a slot
  // that is no longer active never becomes active again
  for (int step = 0; step < steps && alive && !converged; ++step) {
    const Derivs d = derivs(g, site(g, b, lay, r, c));
    // ops/refine.py:_solve3x3(dxx, dxy, dxs, dyy, dys, dss, d0, d1, d2)
    const float h00 = d.dxx, h01 = d.dxy, h02 = d.dxs, h11 = d.dyy,
                h12 = d.dys, h22 = d.dss;
    const float c00 = sub(mul(h11, h22), mul(h12, h12));
    const float c01 = sub(mul(h02, h12), mul(h01, h22));
    const float c02 = sub(mul(h01, h12), mul(h02, h11));
    const float det = add(add(mul(h00, c00), mul(h01, c01)), mul(h02, c02));
    const float c11 = sub(mul(h00, h22), mul(h02, h02));
    const float c12 = sub(mul(h01, h02), mul(h00, h12));
    const float c22 = sub(mul(h00, h11), mul(h01, h01));
    const float inv_det = fabsf(det) > kSingular ? __frcp_rn(det) : 0.0f;
    const float x0 = mul(dot3(c00, d.d0, c01, d.d1, c02, d.d2), inv_det);
    const float x1 = mul(dot3(c01, d.d0, c11, d.d1, c12, d.d2), inv_det);
    const float x2 = mul(dot3(c02, d.d0, c12, d.d1, c22, d.d2), inv_det);
    const float nxi = -x2, nxr = -x1, nxc = -x0;
    const bool finite = isfinite(nxi) && isfinite(nxr) && isfinite(nxc);
    const bool conv_now = fabsf(nxi) < 0.5f && fabsf(nxr) < 0.5f &&
                          fabsf(nxc) < 0.5f && finite;
    const bool diverged = !finite || fabsf(nxi) > kDivergeLimit ||
                          fabsf(nxr) > kDivergeLimit ||
                          fabsf(nxc) > kDivergeLimit;
    // stored offsets follow every step that ran
    xi = nxi;
    xr = nxr;
    xc = nxc;
    const bool move = !conv_now && !diverged;
    int nlay = lay, nr = r, nc = c;
    if (move) {
      nlay += __float2int_rn(nxi);
      nr += __float2int_rn(nxr);
      nc += __float2int_rn(nxc);
    }
    const bool oob = nlay < 1 || nlay > g.nl || nc < border ||
                     nc >= g.W - border || nr < row_lo + border ||
                     nr >= row_hi - border;
    if (diverged || (move && oob)) alive = false;
    converged = converged || conv_now;
    if (move && !oob) {
      lay = nlay;
      r = nr;
      c = nc;
    }
  }
  alive = alive && converged;   // non-convergence rejects (sift.cpp:351)

  // final contrast and edge tests at the last accepted location
  const Derivs d = derivs(g, site(g, b, lay, r, c));
  const float t = dot3(d.d0, xc, d.d1, xr, d.d2, xi);
  const float contr = add(mul(d.center, kImgScale), mul(t, 0.5f));
  alive = alive && mul(fabsf(contr), (float)g.nl) >= contrast_thr;
  const float tr = add(d.dxx, d.dyy);
  const float det = sub(mul(d.dxx, d.dyy), mul(d.dxy, d.dxy));
  alive = alive && det > 0.0f && mul(mul(tr, tr), edge) < mul(edge_sq, det);

  out_layer[i] = lay;
  out_r[i] = r;
  out_c[i] = c;
  out_xi[i] = xi;
  out_xr[i] = xr;
  out_xc[i] = xc;
  out_contr[i] = contr;
  out_valid[i] = alive;
}

}  // namespace

// dog (B, D, H, W) contiguous float32; layer/row/col (B, N) int32 and
// valid (B, N) bool -> the eight (B, N) fields of ops/refine.py:Refined.
// nl: the octave's layers (layers 1..nl are candidates); row_lo/row_hi:
// the true image's rows; steps: max_interp_steps; contrast_thr, edge and
// edge_sq: contrast_threshold, edge_threshold and (edge_threshold + 1)^2,
// each rounded to float32 from the plain version's double.
extern "C" int sift_refine(const float* dog, const int* layer, const int* row,
                           const int* col, const bool* valid, int* out_layer,
                           int* out_r, int* out_c, float* out_xi,
                           float* out_xr, float* out_xc, float* out_contr,
                           bool* out_valid, int N, int B, int D, int H, int W,
                           int nl, int border, int row_lo, int row_hi,
                           int steps, float contrast_thr, float edge,
                           float edge_sq, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (N < 0 || B < 0 || nl < 1 || D < nl + 2 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const int64_t slots = (int64_t)B * N;
  if (slots == 0) return cudaSuccess;
  const int64_t blocks = (slots + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  Geometry g{dog, (int64_t)B * nl * H * W, D, H, W, nl};
  refine_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      g, layer, row, col, valid, out_layer, out_r, out_c, out_xi, out_xr,
      out_xc, out_contr, out_valid, N, B, border, row_lo, row_hi, steps,
      contrast_thr, edge, edge_sq);
  return cudaGetLastError();
}
