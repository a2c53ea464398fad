"""Structured logging and counters (twin of sift_tpu/utils/logger.py).

Leveled logging through Python logging under the `sift_tpu_torch`
logger, plus process-local counters and gauges that stages bump (for
example the CLI's out_cap_saturated/<image>/octave<o>) and a one-call
snapshot for reports.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Dict

_LOG = logging.getLogger("sift_tpu_torch")


def get_logger(name: str = "") -> logging.Logger:
    return _LOG.getChild(name) if name else _LOG


def configure(level: str = "INFO") -> None:
    """Basic console configuration; safe to call repeatedly."""
    if not _LOG.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        _LOG.addHandler(h)
    _LOG.setLevel(getattr(logging, level.upper(), logging.INFO))


class Counters:
    """Thread-safe named counters/gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = collections.defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counts[name] = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


COUNTERS = Counters()
