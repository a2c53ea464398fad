"""Static-capacity helper (twin of sift_tpu/utils/caps.py).

Dynamic counts are padded to a power-of-two capacity ladder, so that a
caller with static shapes sees one shape per ladder step (logarithmic in
problem size), not one per distinct count.
"""

from __future__ import annotations

import numpy as np


def pow2_cap(n: int, lo: int = 16) -> int:
    """Smallest power of two >= max(n, 2), floored at `lo`."""
    return max(1 << int(np.ceil(np.log2(max(n, 2)))), lo)
