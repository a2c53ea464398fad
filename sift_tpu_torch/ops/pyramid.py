"""Gaussian + DoG scale-space pyramids (reference C6/C7).

Twin of buildGaussianPyramid / buildDoGPyramid (src/sift.cpp:229-283)
and of sift_tpu/ops/pyramid.py: each octave is one (n_scales, H_o, W_o)
tensor whose non-base layers come from one multi-sigma blur of the
octave base. The next base is layer n_octave_layers of the previous
octave, 2x nearest-neighbour decimated (src/sift.cpp:252-254); there is
no initial upsampling (src/sift.cpp:219-227).
"""

from __future__ import annotations

from typing import List

import torch

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.conv import gaussian_blur_multi
from sift_tpu_torch.ops.image import downsample_nearest_2x


def build_gaussian_pyramid(img: torch.Tensor,
                           cfg: SIFTConfig = DEFAULT_CONFIG
                           ) -> List[torch.Tensor]:
    """(H, W) -> n_octaves tensors of shape (n_scales, H_o, W_o)."""
    sig = cfg.scale_sigmas()
    base = gaussian_blur_multi(img.to(torch.float32),
                               (cfg.init_blur_sigma,))[0]
    octaves: List[torch.Tensor] = []
    for o in range(cfg.n_octaves):
        if o > 0:
            base = downsample_nearest_2x(octaves[o - 1][cfg.n_octave_layers])
        layers = gaussian_blur_multi(base, sig[1:])          # (S-1, H, W)
        octaves.append(torch.cat([base[None], layers], dim=0))
    return octaves


def build_dog_pyramid(octaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """dog[i] = gauss[i+1] - gauss[i] per octave (src/sift.cpp:271-281):
    n_octaves tensors of shape (n_scales - 1, H_o, W_o)."""
    return [oct[1:] - oct[:-1] for oct in octaves]
