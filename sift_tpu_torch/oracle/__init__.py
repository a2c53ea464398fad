"""CPU oracle: a faithful NumPy twin of the reference SIFT math.

The port's own copy of sift_tpu/oracle/ (it imports nothing of
sift_tpu). NumPy on the host only: used by tests, chip_smoke.py's
phase 8 and tools/torch_oracle_repeatability.py, never by the card path.
"""

from sift_tpu_torch.oracle.cpu_sift import (
    gaussian_kernel_2d,
    gaussian_blur,
    build_gaussian_pyramid,
    build_dog_pyramid,
    find_scale_space_extrema,
    calc_descriptors,
    sift_ncl,
    match_l1_ratio,
)

__all__ = [
    "gaussian_kernel_2d",
    "gaussian_blur",
    "build_gaussian_pyramid",
    "build_dog_pyramid",
    "find_scale_space_extrema",
    "calc_descriptors",
    "sift_ncl",
    "match_l1_ratio",
]
