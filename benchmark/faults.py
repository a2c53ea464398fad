"""Faults planted in the program's timed path, each of which has to
make `correct` come out false: the CPU tests plant them at a small
size (benchmark/tests/test_bench_correct.py), and calibrate.py at a
cell's own size on the card, for the reading that sets a limit's upper
end. Planting one wraps one function of the port for the length of a
`with` block; the port's files are not touched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch


def _stale(fn):
    """fn that returns its previous call's answer from the second on."""
    last = {}

    def wrapped(*a, **k):
        out = fn(*a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return wrapped


def _half_batch(fn):
    def wrapped(imgs, *a, **k):
        half = imgs.shape[0] // 2
        kp, d = fn(imgs[:half], *a, **k)
        pad = imgs.shape[0] - half

        def grow(x):
            return torch.cat([x, torch.zeros((pad, *x.shape[1:]),
                                             dtype=x.dtype,
                                             device=x.device)])
        kp = type(kp)(**{f.name: grow(getattr(kp, f.name))
                         for f in dataclasses.fields(kp)})
        return kp, grow(d)
    return wrapped


def _altered_batch(fn):
    def wrapped(imgs, *a, **k):
        kp, d = fn(imgs, *a, **k)
        d = d.clone()
        d[-1] = d[-1] * 1.01
        return kp, d
    return wrapped


def _altered_object(fn):
    def wrapped(*a, **k):
        det = fn(*a, **k)
        return det._replace(scene_desc=det.scene_desc * 1.01)
    return wrapped


def _last_valid(valid: torch.Tensor) -> torch.Tensor:
    """valid with its last True slot on the last axis cleared, per row."""
    n = valid.shape[-1]
    last = n - 1 - valid.flip(-1).int().argmax(-1, keepdim=True)
    drop = torch.zeros_like(valid).scatter_(-1, last, True) & valid
    return valid & ~drop


def _drop_keypoint(fn):
    """One valid keypoint of each frame left out."""
    def wrapped(*a, **k):
        kp, d = fn(*a, **k)
        return dataclasses.replace(kp, valid=_last_valid(kp.valid)), d
    return wrapped


def _drop_match(fn):
    """One ratio-test match of each pair left out."""
    def wrapped(*a, **k):
        m = fn(*a, **k)
        return m._replace(good=_last_valid(m.good))
    return wrapped


def _no_refit(fn):
    """RANSAC's best hypothesis without the refit on its inliers."""
    def wrapped(*a, **k):
        return fn(*a, **{**k, "refine": False})
    return wrapped


# name: (cells it applies to, module of the port, function, wrapper)
FAULTS = {
    "stale": (("video_b8_1080p",), "sift_tpu_torch.sift",
              "detect_and_compute_batch", _stale),
    "half_batch": (("video_b8_1080p",), "sift_tpu_torch.sift",
                   "detect_and_compute_batch", _half_batch),
    "altered_batch": (("video_b8_1080p",), "sift_tpu_torch.sift",
                      "detect_and_compute_batch", _altered_batch),
    "stale_object": (("object_1080p",), "sift_tpu_torch.pipeline",
                     "detect_object", _stale),
    "altered_object": (("object_1080p",), "sift_tpu_torch.pipeline",
                       "detect_object", _altered_object),
    "drop_keypoint_batch": (("video_b8_1080p",), "sift_tpu_torch.sift",
                            "detect_and_compute_batch", _drop_keypoint),
    "drop_keypoint": (("object_1080p",), "sift_tpu_torch.sift",
                      "detect_and_compute", _drop_keypoint),
    "drop_match": (("video_b8_1080p", "object_1080p"),
                   "sift_tpu_torch.ops.match", "match_ratio", _drop_match),
    "no_refit": (("object_1080p",), "sift_tpu_torch.pipeline",
                 "find_homography_ransac", _no_refit),
}


@contextlib.contextmanager
def planted(name: str):
    """The port with fault `name` planted, inside the block."""
    _, modname, attr, wrap = FAULTS[name]
    mod = importlib.import_module(modname)
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
