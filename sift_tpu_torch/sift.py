"""SIFT detect + describe (reference C9, SIFT_NCL).

Twin of SIFT_NCL (src/sift.cpp:59-91) and of sift_tpu/sift.py.
Keypoints live in fixed-capacity masked batches (per-octave candidate
caps detect_caps, output caps out_caps); the reference's growing
std::vectors become stable top-k compactions, so tied slots fill in
jax.lax.top_k's lowest-index-first order and no stage waits on the
host for a count.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.ops import pyramid as pyr
from sift_tpu_torch.ops import extrema as ext
from sift_tpu_torch.ops import refine as ref
from sift_tpu_torch.ops import orientation as ori
from sift_tpu_torch.ops import descriptor as desc_mod
from sift_tpu_torch.ops.extrema import stable_top_k


def detect_octave(gauss: torch.Tensor, dog: torch.Tensor, octave: int,
                  cap: int, cfg: SIFTConfig = DEFAULT_CONFIG,
                  out_cap: int = 0) -> Keypoints:
    """Detect, refine and orient keypoints on one octave.

    `cap` bounds extremum candidates; the result is compacted to
    `out_cap` slots (default: cap) ranked by (valid, response).
    """
    out_cap = out_cap or cap
    layer0, r0, c0, valid0 = ext.top_candidates(dog, cap, cfg)
    rf = ref.refine_candidates(dog, layer0, r0, c0, valid0, cfg)

    # mid-compaction: refinement rejects most candidates, so orientation
    # and descriptors run on out_cap slots (sift_tpu/sift.py:62-68)
    if out_cap < cap:
        mscore = torch.where(rf.valid, rf.contr.abs() + 10.0, -1.0)
        _, midx = stable_top_k(mscore, out_cap)
        rf = ref.Refined(*(a[midx] for a in rf))

    nl = cfg.n_octave_layers
    lay_f = rf.layer.to(torch.float32)
    scl_octv = cfg.sigma * torch.exp2((lay_f + rf.xi) / nl)
    size = scl_octv * (1 << octave) * 2.0           # src/sift.cpp:384
    angles, ok = ori.orientation_peaks(gauss, rf.layer, rf.r, rf.c,
                                       scl_octv, rf.valid, cfg)

    k = cfg.max_ori_peaks
    scale = float(1 << octave)

    def tile(a):
        return a.repeat_interleave(k)

    kp = Keypoints(
        x=tile((rf.c.to(torch.float32) + rf.xc) * scale),
        y=tile((rf.r.to(torch.float32) + rf.xr) * scale),
        size=tile(size),
        angle=angles.reshape(-1),
        response=tile(rf.contr.abs()),
        octave=torch.full((rf.layer.shape[0] * k,), octave,
                          dtype=torch.int32, device=dog.device),
        layer=tile(rf.layer),
        r=tile(rf.r),
        c=tile(rf.c),
        valid=ok.reshape(-1),
    )
    # compact (slots*k) -> out_cap slots (valid first, then response)
    score = torch.where(kp.valid, kp.response + 10.0, -1.0)
    _, idx = stable_top_k(score, out_cap)
    return kp.gather(idx)


def _octave_usable(shape, cfg: SIFTConfig) -> bool:
    """An octave participates only if the refinement/NMS windows fit; a
    too-small octave yields an empty batch, keeping capacities static."""
    return min(shape) >= max(2 * cfg.img_border + 3, 8)


def detect(img: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG
           ) -> Tuple[Keypoints, List[torch.Tensor]]:
    """Pyramid + extrema + refine + orientation on an (H, W) image.
    Returns (keypoints over all octaves, Gaussian octave stacks)."""
    octs = pyr.build_gaussian_pyramid(img, cfg)
    dogs = pyr.build_dog_pyramid(octs)
    parts = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            parts.append(detect_octave(octs[o], dogs[o], o,
                                       cfg.detect_caps[o], cfg,
                                       cfg.out_caps[o]))
        else:
            parts.append(Keypoints.zeros(cfg.out_caps[o], img.device))
    return Keypoints.concatenate(parts), octs


def candidate_saturation(octs: List[torch.Tensor],
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(n_octaves,) bool: octave o's NMS survivors exceed detect_caps[o]
    (candidates dropped before refinement; counted on the dense mask)."""
    dogs = pyr.build_dog_pyramid(octs)
    flags = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            m = ext.extrema_mask(dogs[o], cfg)
            flags.append(m.sum() > cfg.detect_caps[o])
        else:
            flags.append(torch.zeros((), dtype=torch.bool,
                                     device=octs[o].device))
    return torch.stack(flags)


def octave_saturation(kp: Keypoints, cfg: SIFTConfig = DEFAULT_CONFIG
                      ) -> torch.Tensor:
    """(n_octaves,) bool: octave o's output batch is (near-)full, so the
    out_caps[o] compactions may have dropped valid keypoints. Near-full
    (within max(n/16, 4)) because orientation can invalidate a few slots
    after the mid-compaction truncated (sift_tpu/sift.py:156-176)."""
    flags = []
    start = 0
    for o in range(cfg.n_octaves):
        n = cfg.out_caps[o]
        slack = max(n // 16, 4)
        flags.append(kp.valid[start:start + n].sum() >= n - slack)
        start += n
    return torch.stack(flags)


def detect_and_compute(img: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG
                       ) -> Tuple[Keypoints, torch.Tensor]:
    """Twin of SIFT_NCL (src/sift.cpp:59-91): keypoints + (N, 128)
    descriptors, computed per octave and concatenated; invalid slots
    hold zero descriptors."""
    octs = pyr.build_gaussian_pyramid(img, cfg)
    dogs = pyr.build_dog_pyramid(octs)
    kp_parts = []
    d_parts = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            kp = detect_octave(octs[o], dogs[o], o, cfg.detect_caps[o], cfg,
                               cfg.out_caps[o])
            d = desc_mod.descriptors_octave(octs[o], kp, cfg)
        else:
            kp = Keypoints.zeros(cfg.out_caps[o], img.device)
            d = torch.zeros((cfg.out_caps[o], cfg.descr_size),
                            dtype=torch.float32, device=img.device)
        kp_parts.append(kp)
        d_parts.append(d)
    return Keypoints.concatenate(kp_parts), torch.cat(d_parts)
