"""Numeric primitives matching the reference's math library.

fastAtan2's polynomial is reproduced exactly (orientation and
descriptor bin assignments depend on it); cvRound is round-half-even,
which torch.round also is.
"""

from __future__ import annotations

import math

import torch

# cv::hal::fastAtan2 polynomial coefficients, in degrees
_P1 = 0.9997878412794807 * (180.0 / math.pi)
_P3 = -0.3258083974640975 * (180.0 / math.pi)
_P5 = 0.1555786518463281 * (180.0 / math.pi)
_P7 = -0.04432655554792128 * (180.0 / math.pi)
_DBL_EPS = 2.220446049250313e-16


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV fastAtan2 twin: polynomial atan2 in degrees [0, 360)."""
    ax, ay = x.abs(), y.abs()
    swap = ax < ay
    c = torch.where(swap, ax / (ay + _DBL_EPS), ay / (ax + _DBL_EPS))
    c2 = c * c
    a = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(swap, 90.0 - a, a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def cv_round(x: torch.Tensor) -> torch.Tensor:
    """cvRound twin: round half to even, as int32."""
    return torch.round(x).to(torch.int32)
