"""SIFT detect + describe (reference C9, SIFT_NCL).

Twin of SIFT_NCL (src/sift.cpp:59-91) and of sift_tpu/sift.py.
Keypoints live in fixed-capacity masked batches (per-octave candidate
caps detect_caps, output caps out_caps); the reference's growing
std::vectors become stable top-k compactions, so tied slots fill in
jax.lax.top_k's lowest-index-first order and no stage waits on the
host for a count. Each stage runs in a span of utils.profiling named
after it (sift.pyramid, and per octave, with an `octave` attribute,
sift.scan, sift.refine, sift.orient, sift.compact and sift.descr),
inside the span of detect_and_compute or detect_and_compute_batch.
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
from sift_tpu_torch.utils.profiling import span


def detect_octave(gauss: torch.Tensor, dog: torch.Tensor, octave: int,
                  cap: int, cfg: SIFTConfig = DEFAULT_CONFIG,
                  out_cap: int = 0) -> Keypoints:
    """Detect, refine and orient keypoints on one octave.

    `cap` bounds extremum candidates; the result is compacted to
    `out_cap` slots (default: cap) ranked by (valid, response).
    """
    out_cap = out_cap or cap
    with span("sift.scan", octave=octave):
        layer0, r0, c0, valid0 = ext.top_candidates(dog, cap, cfg)
    return _octave_tail(gauss, dog, layer0, r0, c0, valid0, octave, cfg,
                        out_cap)


def _octave_tail(gauss: torch.Tensor, dog: torch.Tensor,
                 layer0: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                 valid0: torch.Tensor, octave: int, cfg: SIFTConfig,
                 out_cap: int, row_bounds=None) -> Keypoints:
    """Refine + orient + compact one octave, given the candidate scan's
    output: one frame's (S, H, W) / (D, H, W) stacks with (cap,)
    candidates, or B frames' (B, S, H, W) / (B, D, H, W) stacks with
    (B, cap) candidates, every stage once for all frames (sift_tpu
    vmaps this tail, sift_tpu/sift.py:236-250). Split out of
    detect_octave so the batched path can run the scan for all frames at
    once (sift_tpu/sift.py:49-99). row_bounds: local rows of the true
    image when the stack is a row band of it (parallel/spatial.py)."""
    with span("sift.refine", octave=octave):
        rf = ref.refine_candidates(dog, layer0, r0, c0, valid0, cfg,
                                   row_bounds=row_bounds)
        cap = layer0.shape[-1]
        # mid-compaction: refinement rejects most candidates, so
        # orientation and descriptors run on out_cap slots
        # (sift_tpu/sift.py:62-68)
        if out_cap < cap:
            mscore = torch.where(rf.valid, rf.contr.abs() + 10.0, -1.0)
            _, midx = stable_top_k(mscore, out_cap)
            rf = ref.Refined(*(a.gather(-1, midx) for a in rf))

    with span("sift.orient", octave=octave):
        nl = cfg.n_octave_layers
        lay_f = rf.layer.to(torch.float32)
        scl_octv = cfg.sigma * torch.exp2((lay_f + rf.xi) / nl)
        angles, ok = ori.orientation_peaks(gauss, rf.layer, rf.r, rf.c,
                                           scl_octv, rf.valid, cfg,
                                           row_bounds=row_bounds)

    with span("sift.compact", octave=octave):
        size = scl_octv * (1 << octave) * 2.0       # src/sift.cpp:384
        k = cfg.max_ori_peaks
        scale = float(1 << octave)

        def tile(a):
            return a.repeat_interleave(k, dim=-1)

        kp = Keypoints(
            x=tile((rf.c.to(torch.float32) + rf.xc) * scale),
            y=tile((rf.r.to(torch.float32) + rf.xr) * scale),
            size=tile(size),
            angle=angles.flatten(-2),
            response=tile(rf.contr.abs()),
            octave=torch.full(ok.flatten(-2).shape, octave,
                              dtype=torch.int32, device=dog.device),
            layer=tile(rf.layer),
            r=tile(rf.r),
            c=tile(rf.c),
            valid=ok.flatten(-2),
        )
        # compact (slots*k) -> out_cap slots (valid first, then response)
        score = torch.where(kp.valid, kp.response + 10.0, -1.0)
        _, idx = stable_top_k(score, out_cap)
        return kp.gather(idx)


def _octave_usable(shape, cfg: SIFTConfig) -> bool:
    """An octave participates only if the refinement/NMS windows fit; a
    too-small octave yields an empty batch, keeping capacities static."""
    return min(shape) >= max(2 * cfg.img_border + 3, 8)


def _empty_octave(out_cap: int, cfg: SIFTConfig, device, frames: tuple = ()
                  ) -> Tuple[Keypoints, torch.Tensor]:
    """A too-small octave's out_cap slots: invalid keypoints and zero
    descriptors, for one frame or with leading `frames` axes."""
    return Keypoints.zeros(out_cap, device, frames), torch.zeros(
        (*frames, out_cap, cfg.descr_size), dtype=torch.float32,
        device=device)


def detect(img: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG
           ) -> Tuple[Keypoints, List[torch.Tensor]]:
    """Pyramid + extrema + refine + orientation on an (H, W) image.
    Returns (keypoints over all octaves, Gaussian octave stacks)."""
    with span("sift.pyramid"):
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
    after the mid-compaction truncated (sift_tpu/sift.py:156-176). Takes
    one frame's (N,) keypoints: kp.frame(b) of a batch."""
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
    with span("sift.detect_and_compute"):
        with span("sift.pyramid"):
            octs = pyr.build_gaussian_pyramid(img, cfg)
            dogs = pyr.build_dog_pyramid(octs)
        kp_parts = []
        d_parts = []
        for o in range(cfg.n_octaves):
            if _octave_usable(octs[o].shape[1:], cfg):
                kp = detect_octave(octs[o], dogs[o], o, cfg.detect_caps[o],
                                   cfg, cfg.out_caps[o])
                with span("sift.descr", octave=o):
                    d = desc_mod.descriptors_octave(octs[o], kp, cfg)
            else:
                kp, d = _empty_octave(cfg.out_caps[o], cfg, img.device)
            kp_parts.append(kp)
            d_parts.append(d)
        return Keypoints.concatenate(kp_parts), torch.cat(d_parts)


def detect_and_compute_batch(imgs: torch.Tensor,
                             cfg: SIFTConfig = DEFAULT_CONFIG
                             ) -> Tuple[Keypoints, torch.Tensor]:
    """Single-card throughput mode: B frames in one call.

    (B, H, W) -> (Keypoints with (B, N) fields, (B, N, 128)
    descriptors); row b equals detect_and_compute(imgs[b]). Every stage
    of an octave runs once for all B frames: the pyramid and the
    candidate scan (K1-batch, the compact scan and the select), then
    _octave_tail and descriptors_octave over (B, ...) tensors, as
    sift_tpu's vmap over the tail (K3-ori and K3-desc: one launch per
    octave over the B frames' stacked planes). Use kp.frame(b) for a
    per-frame view.
    """
    nb = imgs.shape[0]
    with span("sift.detect_and_compute_batch"):
        with span("sift.pyramid"):
            octs = pyr.build_gaussian_pyramid_batch(imgs, cfg)
            dogs = pyr.build_dog_pyramid_batch(octs)
        kp_parts: List[Keypoints] = []
        d_parts: List[torch.Tensor] = []
        for o in range(cfg.n_octaves):
            out_cap = cfg.out_caps[o]
            if _octave_usable(octs[o].shape[2:], cfg):
                with span("sift.scan", octave=o):
                    cands = ext.top_candidates_batch(dogs[o],
                                                     cfg.detect_caps[o], cfg)
                kp = _octave_tail(octs[o], dogs[o], *cands, o, cfg, out_cap)
                with span("sift.descr", octave=o):
                    d = desc_mod.descriptors_octave(octs[o], kp, cfg)
            else:
                kp, d = _empty_octave(out_cap, cfg, imgs.device, (nb,))
            kp_parts.append(kp)
            d_parts.append(d)
        return Keypoints.concatenate(kp_parts), torch.cat(d_parts, dim=1)
