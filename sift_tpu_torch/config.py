"""SIFT parameter block and pipeline sizing configuration.

Mirror of sift_tpu/config.py (the reference's file-static parameter
block, src/sift.cpp:3-47, plus the static capacity knobs). Kept as a
copy rather than an import: importing sift_tpu pulls in JAX.

The port carries one formulation per stage, so the JAX package's
implementation-choice fields (ori_hist_impl, ori/descr_gather_impl,
descr_layout, frames_per_chip_mode) are absent. descr_rc_bf16 is
carried: it changes the descriptors, not only their layout. Its default
differs from sift_tpu's: the port's DEFAULT_CONFIG computes exact
float32 descriptors, and from_jax_config keeps whatever the JAX config
says (True in sift_tpu's DEFAULT_CONFIG).

Reference quirks reproduced (they affect match parity):
  * n_octave_layers = 2 (src/sift.cpp:4)
  * no initial 2x upsampling (src/sift.cpp:219-227)
  * extrema threshold is the literal 8 on the 0..255 scale
    (src/sift.cpp:551,564)
  * Gaussian kernels truncated at radius floor(3*sigma) and NOT
    renormalized (src/sift.cpp:95-108)
  * blur treats the last row/col as out-of-bounds zeros
    (src/sift.cpp:116)
  * descriptors end sqrt(L1-normalized) (src/sift.cpp:711-721), hence
    L1 matching with ratio 0.86 (src/main.cpp:25,38)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

# sift_tpu.config.SIFTConfig fields that choose between implementations
# of one stage; the port has a single implementation of each
_JAX_ONLY_FIELDS = ("ori_hist_impl", "ori_gather_impl", "descr_gather_impl",
                    "descr_layout", "frames_per_chip_mode")


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    # --- algorithm constants (reference src/sift.cpp:3-47) ---
    n_octaves: int = 5
    n_octave_layers: int = 2
    sigma: float = 1.6
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    init_sigma_assumed: float = 0.2
    descr_width: int = 4
    descr_hist_bins: int = 8
    img_border: int = 5
    max_interp_steps: int = 5
    ori_hist_bins: int = 36
    ori_sig_fctr: float = 1.5
    ori_radius_fctr: float = 4.5
    ori_peak_ratio: float = 0.8
    descr_scl_fctr: float = 3.0
    descr_mag_thr: float = 0.2
    int_descr_fctr: float = 512.0
    nms_threshold: float = 8.0

    # --- static capacities (see sift_tpu/config.py for the sizing) ---
    # extremum candidates surfaced per octave before refinement
    detect_caps: Tuple[int, ...] = (4096, 2048, 512, 256, 128)
    # keypoint/descriptor slots per octave after orientation expansion
    out_caps: Tuple[int, ...] = (1024, 256, 128, 64, 64)
    max_ori_peaks: int = 4
    max_keypoints: int = 4096
    match_ratio: float = 0.86
    # sift_tpu's bf16 descriptor arm (sift_tpu/ops/descriptor.py:139-165):
    # each sample's row x column trilinear weight and its
    # magnitude-weighted orientation weight are rounded to bfloat16
    # (round to nearest even) before their product, which is then summed
    # in float32; ~1e-2 L1 from the exact arm. False (the port's default)
    # keeps every weight in float32.
    descr_rc_bf16: bool = False

    @property
    def n_scales(self) -> int:
        return self.n_octave_layers + 3

    @property
    def n_dog(self) -> int:
        return self.n_scales - 1

    @property
    def descr_size(self) -> int:
        return self.descr_width * self.descr_width * self.descr_hist_bins

    @property
    def init_blur_sigma(self) -> float:
        # createInitialImage sigma = sqrt(Sigma^2 + 0.2^2) (sift.cpp:237)
        return math.sqrt(self.sigma * self.sigma
                         + self.init_sigma_assumed * self.init_sigma_assumed)

    def scale_sigmas(self) -> Tuple[float, ...]:
        """Per-scale blur sigmas applied to the octave base image:
        sig[i] = sqrt((k^i sigma)^2 - sigma^2), k = 2^(1/nOctaveLayers)
        (sift.cpp:240-245); every layer is blurred from the base."""
        k = 2.0 ** (1.0 / self.n_octave_layers)
        sigs = [self.sigma]
        for i in range(1, self.n_scales):
            total = (k ** i) * self.sigma
            sigs.append(math.sqrt(total * total - self.sigma * self.sigma))
        return tuple(sigs)

    @property
    def max_scl_octv(self) -> float:
        """Upper bound on sigma * 2^((layer+xi)/nOctaveLayers)."""
        return self.sigma * 2.0 ** (
            (self.n_octave_layers + 0.5) / self.n_octave_layers)

    @property
    def ori_patch_radius(self) -> int:
        """Static radius covering the largest orientation window
        (cvRound(SIFT_ORI_RADIUS * scl_octv), sift.cpp:521)."""
        return int(math.ceil(self.ori_radius_fctr * self.max_scl_octv))

    @property
    def descr_patch_radius(self) -> int:
        """Static radius covering the largest descriptor window
        (sift.cpp:587-588)."""
        hw = self.descr_scl_fctr * self.max_scl_octv
        return int(math.ceil(hw * math.sqrt(2.0) * (self.descr_width + 1)
                             * 0.5))


DEFAULT_CONFIG = SIFTConfig()


def from_jax_config(d: Dict[str, Any]) -> SIFTConfig:
    """Port config from dataclasses.asdict(sift_tpu.config.SIFTConfig).

    Drops the JAX package's implementation-choice fields and carries the
    rest, descr_rc_bf16 included.
    """
    kw = {k: v for k, v in d.items() if k not in _JAX_ONLY_FIELDS}
    for k in ("detect_caps", "out_caps"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return SIFTConfig(**kw)
