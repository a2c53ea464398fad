"""sift_tpu_torch -- PyTorch/CUDA port of sift_tpu's main path.

gray frame -> Gaussian/DoG pyramid -> 3x3x3 extrema -> subpixel refine
-> orientation -> 128-d descriptors -> top-2 L1 match -> RANSAC
homography -> object corners. sift_tpu (JAX) is the reference it is
held against. The four kernels of the path are CUDA C++ for sm_90a
(csrc/), built with nvcc at first use; every kernel wrapper runs its
plain PyTorch version for CPU tensors.
"""

__version__ = "0.1.0"

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.types import Keypoints

__all__ = ["SIFTConfig", "DEFAULT_CONFIG", "Keypoints", "__version__"]
