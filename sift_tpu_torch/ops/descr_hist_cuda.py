"""K3-desc wrapper: per-keypoint raw descriptor histograms, the patch
gather fused with the trilinear histogram that consumes it.

Counterpart of sift_tpu/ops/ori_gather_pallas.py (gather_patches) plus
the soft one-hot contraction of sift_tpu/ops/descriptor.py (its
exact-f32 einsum). `descriptor_hist` launches the CUDA kernel
(csrc/descr_hist.cu) for a CUDA tensor, once for all keypoints, and runs
`descriptor_hist_plain` for a CPU tensor. Both return the
(N, d+2, d+2, n+2) histogram of calcSIFTDescriptor (src/sift.cpp:579-753)
before the circular fold, zero for slots with valid false, with the
per-sample arithmetic of the plain version; they differ only in the
order of the sums.

The plain version writes the scatter as a contraction of soft one-hots
in float32,

    hist[(row,col), ori] = sum_p RC[p, (row,col)] * OM[p, ori]

over chunks of 64 keypoints, so the RC intermediate stays at
(64, 6889, 36) floats (~63 MB).
"""

from __future__ import annotations

import torch

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig
from sift_tpu_torch.ops.mathutil import fast_atan2_deg
from sift_tpu_torch.ops.ori_gather_cuda import gather_patches_plain

_KERNEL_WIDTH = 4     # csrc/descr_hist.cu: kD
_KERNEL_BINS = 8      # csrc/descr_hist.cu: kN


def _check_args(padded, layer, r, c, cos_t, sin_t, radius, ori, valid,
                cfg: SIFTConfig) -> None:
    rd = cfg.descr_patch_radius
    if padded.dtype != torch.float32 or padded.dim() != 3:
        raise ValueError(f"descriptor source must be (L, Hp, Wp) float32, "
                         f"got {tuple(padded.shape)} {padded.dtype}")
    if min(padded.shape[1:]) < 2 * rd + 3:
        raise ValueError(f"source {tuple(padded.shape)} is not padded by "
                         f"{rd + 1}")
    args = (layer, r, c, cos_t, sin_t, radius, ori, valid)
    if layer.dim() != 1 or any(a.shape != layer.shape for a in args):
        raise ValueError("keypoint arguments must be (N,) tensors of one "
                         "shape")


def _soft_onehot(i0: torch.Tensor, frac: torch.Tensor, width: int,
                 shift: int) -> torch.Tensor:
    """(B, P) lower bins and fractions -> (B, P, width) trilinear
    weights: (1 - frac) at bin i0 + shift, frac at i0 + shift + 1."""
    bins = torch.arange(width, device=i0.device)
    lo = (bins == (i0 + shift)[..., None]).to(torch.float32)
    hi = (bins == (i0 + shift + 1)[..., None]).to(torch.float32)
    return lo * (1.0 - frac)[..., None] + hi * frac[..., None]


def _hist_chunk(patch: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                cos_t: torch.Tensor, sin_t: torch.Tensor,
                radius: torch.Tensor, ori: torch.Tensor, hw: tuple,
                cfg: SIFTConfig) -> torch.Tensor:
    """Raw histograms of one chunk: (B, pn, pn) patches ->
    (B, d+2, d+2, n+2)."""
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    rd = cfg.descr_patch_radius
    h, w = hw
    b = patch.shape[0]

    off = torch.arange(-rd, rd + 1, dtype=torch.int32, device=patch.device)
    ii_i = off[None, :, None]
    jj_i = off[None, None, :]
    ii = ii_i.to(torch.float32)
    jj = jj_i.to(torch.float32)
    cos_t = cos_t[:, None, None]
    sin_t = sin_t[:, None, None]
    radius = radius[:, None, None]

    dx = patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]
    dy = patch[:, :-2, 1:-1] - patch[:, 2:, 1:-1]

    c_rot = jj * cos_t - ii * sin_t
    r_rot = jj * sin_t + ii * cos_t
    rbin = r_rot + (d / 2 - 0.5)
    cbin = c_rot + (d / 2 - 0.5)
    rr = r0[:, None, None] + ii_i
    cc = c0[:, None, None] + jj_i
    m = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
         & (rr > 0) & (rr < h - 1) & (cc > 0) & (cc < w - 1)
         & (ii_i.abs() <= radius) & (jj_i.abs() <= radius))

    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    mag_g = torch.sqrt(dx * dx + dy * dy)
    theta = fast_atan2_deg(dy, dx)
    obin = (theta - ori[:, None, None]) * (n / 360.0)
    mag = torch.where(m, mag_g * wgt, 0.0).reshape(b, -1)

    rbin = rbin.reshape(b, -1)
    cbin = cbin.reshape(b, -1)
    obin = obin.reshape(b, -1)
    r0i = torch.floor(rbin)
    c0i = torch.floor(cbin)
    o0i = torch.floor(obin)
    fr = rbin - r0i
    fc = cbin - c0i
    fo = obin - o0i
    r0i = r0i.to(torch.int32)
    c0i = c0i.to(torch.int32)
    o0i = o0i.to(torch.int32)
    o0i = torch.where(o0i < 0, o0i + n, o0i)
    o0i = torch.where(o0i >= n, o0i - n, o0i)

    # trilinear soft one-hots: (B, P, d+2), (B, P, d+2), (B, P, n+2)
    rw = _soft_onehot(r0i, fr, d + 2, 1)
    cw = _soft_onehot(c0i, fc, d + 2, 1)
    ow = _soft_onehot(o0i, fo, n + 2, 0) * mag[..., None]
    rc = (rw[..., :, None] * cw[..., None, :]).reshape(
        b, -1, (d + 2) * (d + 2))
    return torch.bmm(rc.transpose(1, 2), ow).reshape(b, d + 2, d + 2, n + 2)


def descriptor_hist_plain(padded: torch.Tensor, layer: torch.Tensor,
                          r: torch.Tensor, c: torch.Tensor,
                          cos_t: torch.Tensor, sin_t: torch.Tensor,
                          radius: torch.Tensor, ori: torch.Tensor,
                          valid: torch.Tensor, cfg: SIFTConfig,
                          chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch K3-desc, `chunk` keypoints at a time.

    padded: (L, Hp, Wp), the octave's layers padded by
    descr_patch_radius + 1; layer: (N,) index into it; r, c: (N,)
    octave pixel; cos_t, sin_t, radius (int32), ori: (N,) from
    descriptor.descriptor_params; valid: (N,) bool. Returns
    (N, d+2, d+2, n+2), zero where valid is false.
    """
    _check_args(padded, layer, r, c, cos_t, sin_t, radius, ori, valid, cfg)
    rd = cfg.descr_patch_radius
    pn = 2 * rd + 3
    hw = tuple(s - 2 * (rd + 1) for s in padded.shape[1:])
    parts = []
    for s in range(0, layer.shape[0], chunk):
        e = s + chunk
        patch = gather_patches_plain(padded, layer[s:e], r[s:e], c[s:e], pn)
        parts.append(_hist_chunk(patch, r[s:e], c[s:e], cos_t[s:e],
                                 sin_t[s:e], radius[s:e], ori[s:e], hw, cfg))
    hist = torch.cat(parts)
    return torch.where(valid[:, None, None, None], hist, 0.0)


def descriptor_hist(padded: torch.Tensor, layer: torch.Tensor,
                    r: torch.Tensor, c: torch.Tensor, cos_t: torch.Tensor,
                    sin_t: torch.Tensor, radius: torch.Tensor,
                    ori: torch.Tensor, valid: torch.Tensor,
                    cfg: SIFTConfig, chunk: int = 64) -> torch.Tensor:
    """K3-desc: (N, d+2, d+2, n+2) raw descriptor histograms (arguments
    as descriptor_hist_plain). CPU tensors take the plain version, in
    chunks of `chunk`; CUDA tensors launch the kernel once, one block
    per keypoint."""
    _check_args(padded, layer, r, c, cos_t, sin_t, radius, ori, valid, cfg)
    if padded.device.type == "cpu":
        return descriptor_hist_plain(padded, layer, r, c, cos_t, sin_t,
                                     radius, ori, valid, cfg, chunk)
    if padded.device.type != "cuda":
        raise ValueError(f"descriptor_hist: unsupported device "
                         f"{padded.device}")
    d, n = cfg.descr_width, cfg.descr_hist_bins
    if (d, n) != (_KERNEL_WIDTH, _KERNEL_BINS):
        raise ValueError(f"the kernel bins into {_KERNEL_WIDTH}x"
                         f"{_KERNEL_WIDTH}x{_KERNEL_BINS}, not {d}x{d}x{n}")
    dev = padded.device
    padded = padded.contiguous()
    layer, r, c, radius = (v.to(device=dev, dtype=torch.int32).contiguous()
                           for v in (layer, r, c, radius))
    cos_t, sin_t, ori = (v.to(device=dev, dtype=torch.float32).contiguous()
                         for v in (cos_t, sin_t, ori))
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    nlay, hp, wp = padded.shape
    k = layer.shape[0]
    out = torch.empty((k, d + 2, d + 2, n + 2), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _build.library().sift_descr_hist(
            padded.data_ptr(), layer.data_ptr(), r.data_ptr(), c.data_ptr(),
            cos_t.data_ptr(), sin_t.data_ptr(), radius.data_ptr(),
            ori.data_ptr(), valid.data_ptr(), out.data_ptr(), k, nlay, hp,
            wp, cfg.descr_patch_radius,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_descr_hist")
    descriptor_hist.launches += 1
    return out


descriptor_hist.launches = 0
