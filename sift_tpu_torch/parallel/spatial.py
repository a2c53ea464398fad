"""Spatial tiling: ONE large frame split by rows over the ranks (twin of
sift_tpu/parallel/spatial.py).

Each rank owns a horizontal band of rows. The front end's stencils are
short (blur radius <= 11, orientation radius <= ~17, descriptor radius
<= ~41 in octave pixels), so one halo exchange per octave gives exact
results. Per octave o < tiled_octaves:

  1. every rank zeroes the GLOBAL quirk rows and column (the reference's
     Gaussian_Blur zero-pads the last row and column of each octave
     base, src/sift.cpp:116) and the rows outside the true image,
     before every blur (`_zero_beyond`);
  2. two ppermutes exchange `halo` boundary rows with each neighbour;
     edge ranks receive ppermute's zero fill, the zero padding the
     whole-frame convolution sees at the image's edges;
  3. the per-octave pipeline runs on the haloed band: K1 with
     apply_quirk=False, the DoG, K2's compact scan with the candidate
     box of the band's core rows inside the global border, the select,
     then refine, K3-ori and K3-desc with `row_bounds`, the local rows
     of the true image's edges, so the global border behaves as on one
     device;
  4. keypoint rows move to global coordinates; the core of Gaussian
     layer nL is decimated into the next octave's band.

Deep octaves (o >= tiled_octaves) are small, so the bands are
all_gathered into the whole octave base and the remaining octaves run
replicated through the ordinary single-frame path. Tiled octaves carry
per-rank caps (cfg.detect_caps / out_caps per band): a tiled detect can
return up to n x the single-device capacity of those octaves, so
compare with detect_and_compute as sets of valid keypoints.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from sift_tpu_torch import sift
from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops import conv
from sift_tpu_torch.ops import descriptor as desc_mod
from sift_tpu_torch.ops import extrema as ext
from sift_tpu_torch.ops.image import downsample_nearest_2x
from sift_tpu_torch.parallel.frames import gather_keypoints
from sift_tpu_torch.parallel.mesh import Mesh, all_gather, axis_index, \
    axis_size, ppermute
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.utils.profiling import span


def _true_sizes(n: int, n_octaves: int) -> List[int]:
    """An image side through the octaves (each halves, rounding down)."""
    return [n >> o for o in range(n_octaves)]


def _zero_beyond(x: torch.Tensor, gr0: int, h_true: int, w_true: int
                 ) -> torch.Tensor:
    """Copy of a band (first global row gr0) with the rows outside the
    global image (above row 0, at or past the quirk row h_true - 1) and
    the global last column zeroed: the zero padding and last-row/column
    quirk of the whole-frame blur, in global rows. Rows above 0 matter
    between chained blurs: the first blur leaks image content into an
    edge rank's out-of-image halo rows."""
    rows = gr0 + torch.arange(x.shape[0], device=x.device)
    keep = ((rows >= 0) & (rows < h_true - 1))[:, None] & (
        torch.arange(x.shape[1], device=x.device) < w_true - 1)[None, :]
    return torch.where(keep, x, 0.0)


def _exchange_halo(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """(Hb, W) -> (Hb + 2 halo, W): the neighbours' boundary rows above
    and below; edge ranks get zeros."""
    n = axis_size(mesh)
    down = [(i, i + 1) for i in range(n - 1)]     # my bottom -> next's top
    up = [(i, i - 1) for i in range(1, n)]        # my top -> previous' bottom
    top = ppermute(x[-halo:], mesh, down)
    bot = ppermute(x[:halo], mesh, up)
    return torch.cat([top, x, bot])


def candidate_box(hb: int, halo: int, gr0: int, h_true: int, w_true: int,
                  band_hw, cfg: SIFTConfig) -> Tuple[int, int, int, int]:
    """The compact scan's box on a haloed band (local rows; gr0 the
    band's first global row without the halo): its core rows [halo,
    halo + hb), inside the global border rows and inside the band's own
    border box (sift_tpu/parallel/spatial.py:139-151); columns
    img_border .. w_true - img_border. An empty box keeps r_hi = r_lo."""
    hp, wp = band_hw
    b = cfg.img_border
    gr0p = gr0 - halo                       # global row of local row 0
    r_lo = max(halo, b - gr0p, b)
    r_hi = min(halo + hb, h_true - b - gr0p, hp - b)
    r_lo = min(r_lo, hp - b)
    return r_lo, max(r_hi, r_lo), b, max(min(wp - b, w_true - b), b)


def _tiled_octave(band: torch.Tensor, octave: int, gr0: int, h_true: int,
                  w_true: int, halo: int, first: bool, cfg: SIFTConfig,
                  mesh: Mesh):
    """One tiled octave. band: this rank's (Hb, W) octave base without
    halo, gr0 its first global row. Returns (keypoints, descriptors, the
    next octave's band)."""
    sig = cfg.scale_sigmas()
    nl = cfg.n_octave_layers
    hb = band.shape[0]

    padded = _exchange_halo(band, halo, mesh)       # (hb + 2 halo, W)
    gr0p = gr0 - halo                               # global row of padded[0]
    if first:
        # createInitialImage: the stored base is the RAW initial blur;
        # the quirk applies to each blur's input copy only
        base_p = conv.gaussian_blur_multi(
            _zero_beyond(padded, gr0p, h_true, w_true),
            (cfg.init_blur_sigma,), apply_quirk=False)[0]
    else:
        base_p = padded
    layers = conv.gaussian_blur_multi(
        _zero_beyond(base_p, gr0p, h_true, w_true), sig[1:],
        apply_quirk=False)
    gauss = torch.cat([base_p[None], layers])
    dog = gauss[1:] - gauss[:-1]

    box = candidate_box(hb, halo, gr0, h_true, w_true, dog.shape[1:], cfg)
    with span("sift.scan", octave=octave):
        cands = ext.top_candidates(dog, cfg.detect_caps[octave], cfg,
                                   box=box)
    row_bounds = (halo - gr0, h_true - gr0 + halo)  # local rows of the image
    kp = sift._octave_tail(gauss, dog, *cands, octave, cfg,
                           cfg.out_caps[octave], row_bounds=row_bounds)
    with span("sift.descr", octave=octave):
        desc = desc_mod.descriptors_octave(gauss, kp, cfg,
                                           row_bounds=row_bounds)
    kp = dataclasses.replace(kp, y=kp.y + float(gr0p * (1 << octave)),
                             r=kp.r + gr0p)
    # next octave base: INTER_NEAREST decimation of the core of layer nL
    # (src/sift.cpp:252-254)
    return kp, desc, downsample_nearest_2x(gauss[nl][halo:halo + hb])


def _tail_octaves(base: torch.Tensor, start_octave: int, cfg: SIFTConfig):
    """The octaves from start_octave on, from the whole (replicated)
    octave base, by the single-frame path."""
    sig = cfg.scale_sigmas()
    nl = cfg.n_octave_layers
    kp_parts, d_parts = [], []
    for o in range(start_octave, cfg.n_octaves):
        if o > start_octave:
            base = downsample_nearest_2x(base)
        gauss = torch.cat([base[None],
                           conv.gaussian_blur_multi(base, sig[1:])])
        dog = gauss[1:] - gauss[:-1]
        if sift._octave_usable(gauss.shape[1:], cfg):
            kp = sift.detect_octave(gauss, dog, o, cfg.detect_caps[o], cfg,
                                    cfg.out_caps[o])
            with span("sift.descr", octave=o):
                d = desc_mod.descriptors_octave(gauss, kp, cfg)
        else:
            kp, d = sift._empty_octave(cfg.out_caps[o], cfg, base.device)
        kp_parts.append(kp)
        d_parts.append(d)
        base = gauss[nl]
    return kp_parts, d_parts


def detect_and_compute_tiled(img, mesh: Mesh,
                             cfg: SIFTConfig = DEFAULT_CONFIG,
                             tiled_octaves: int = 2, halo: int = 64
                             ) -> Tuple[Keypoints, torch.Tensor]:
    """Detect + describe ONE (H, W) frame (the same on every rank) split
    by rows over the mesh's first axis; every rank returns the whole
    result: the tiled octaves' keypoints of rank 0, rank 1, ..., then
    the deep octaves'. The same valid keypoints and descriptors as
    sift.detect_and_compute while no octave saturates; `halo` must cover
    the in-octave stencils (blur radius + descriptor radius)."""
    n = axis_size(mesh)
    img = torch.as_tensor(img, dtype=torch.float32, device=mesh.device)
    h, w = img.shape
    ht = _true_sizes(h, cfg.n_octaves + 1)
    wt = _true_sizes(w, cfg.n_octaves + 1)
    t = tiled_octaves
    if not 1 <= t <= cfg.n_octaves:
        raise ValueError(f"tiled_octaves must be 1..{cfg.n_octaves}, got {t}")
    # pad rows so every band halves cleanly through the tiled octaves;
    # padded rows are zeroed again before every blur
    unit = n * (1 << t)
    hp = -(-h // unit) * unit
    hb = hp // n
    if hb // (1 << (t - 1)) < halo:
        raise ValueError(
            f"bands of {hb} rows are too thin for {t} tiled octaves "
            f"with halo {halo}; reduce tiled_octaves or mesh size")
    rank = axis_index(mesh)
    cur = F.pad(img, (0, 0, 0, hp - h))[rank * hb:(rank + 1) * hb]
    kp_parts, d_parts = [], []
    for o in range(t):
        kp, d, cur = _tiled_octave(cur, o, rank * (hb >> o), ht[o], wt[o],
                                   halo, o == 0, cfg, mesh)
        kp_parts.append(kp)
        d_parts.append(d)
    full = all_gather(cur, mesh)[:ht[t], :wt[t]]
    tail_kp, tail_d = (_tail_octaves(full, t, cfg) if t < cfg.n_octaves
                       else ([], []))
    tiled_kp = gather_keypoints(Keypoints.concatenate(kp_parts), mesh)
    tiled_d = all_gather(torch.cat(d_parts), mesh)
    return (Keypoints.concatenate([tiled_kp, *tail_kp]),
            torch.cat([tiled_d, *tail_d]))
