"""The least time a kernel's launch could take on the card: the larger
of its bytes at the HBM rate and its operations at the float32 rate
that applies, from the published peaks in peaks.json. Each input byte
is counted read once and each output byte written once.

A frozen copy, made at commit e1604af, of chip_smoke.bound_ms.
"""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def bound_s(n_bytes: float, n_ops: float, rate: str = "f32_ops_per_s"
            ) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_ops / PEAKS[rate])
