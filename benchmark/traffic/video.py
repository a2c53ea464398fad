"""Traffic kind `video`: offline feature extraction over a video, one
client in a closed loop.

A request is one batch step of the port's throughput path:
`sift.detect_and_compute_batch` on `batch` consecutive frames, then one
`ops.match.match_ratio` over the batch - 1 consecutive pairs (one K4
launch), as chip_smoke.phase_batch runs it. The frames are a pan across
one seeded wide scene, `step_px` columns apart; a pool of `pool`
batches of consecutive frames is made in set-up, moved to the device
and cycled. A request counts `batch` frames.

Parameters (the workload file's `params`): batch, step_px, pool,
warmup_requests, profile_requests, check_batches (pool batches the
reference recomputes, drawn from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import recipes
from benchmark.reference import compare, sift_plain


class Video:
    def __init__(self, cfg: dict, params: dict, seed: int,
                 device: torch.device):
        from sift_tpu_torch.config import from_jax_config
        self.p = params
        # program_sift: settings of the program's config only (the
        # control's lower-precision arm); the reference keeps the file's
        self.cfg = from_jax_config({**cfg["sift"],
                                    **params.get("program_sift", {})})
        self.ref_cfg = sift_plain.ref_config(cfg["sift"])
        self.hw = tuple(params.get("frame_hw", cfg["frame_hw"]))
        nb, pool = params["batch"], params["pool"]
        obj_hw = tuple(params.get("object_hw", cfg["object_hw"]))
        frames = recipes.pan_frames(self.hw, obj_hw,
                                    nb * pool, params["step_px"], seed)
        self.pool = torch.from_numpy(frames).to(device).reshape(
            pool, nb, *self.hw)
        self.kept = {}
        self.pool_size = self.pool.shape[0]

    def step(self, i: int, span) -> int:
        from sift_tpu_torch import sift
        from sift_tpu_torch.ops import match as match_mod
        k = i % self.pool.shape[0]
        with span("detect"):
            kp, d = sift.detect_and_compute_batch(self.pool[k], self.cfg)
        with span("match"):
            m = match_mod.match_ratio(d[1:], d[:-1], q_valid=kp.valid[1:],
                                      t_valid=kp.valid[:-1],
                                      ratio=self.cfg.match_ratio)
        self.kept[k] = (kp, d, m)
        return self.p["batch"]

    def warmup(self, span) -> None:
        for i in range(self.p["warmup_requests"]):
            self.step(i, span)
        self.kept.clear()

    def shapes(self) -> dict:
        """What one request runs: one batch of frames, its pairs matched."""
        return {"images": [[self.p["batch"], *self.hw]],
                "match_pairs": self.p["batch"] - 1}

    def check(self, seed: int):
        """Numbers of `correct` over `check_batches` kept batches drawn
        from the seed: each frame's feature gap and each pair's match
        gap against the reference's (the worst), and the keypoints and
        matches that only one side has (their sum; a match of a query
        whose ratio test is undecided is a note, compare.match_gap)."""
        rng = np.random.default_rng([seed, 1])
        pool = self.pool.shape[0]
        picks = sorted(rng.choice(pool, min(self.p["check_batches"], pool),
                                  replace=False).tolist())
        gaps, mgaps, notes = [], [], []
        lone_kp, lone_m = 0, 0
        for k in picks:
            if k not in self.kept:
                raise RuntimeError(f"no answer kept for batch {k}")
            kp, d, m = self.kept[k]
            rk, rd = sift_plain.detect_and_compute(self.pool[k], self.ref_cfg)
            pairing = []
            for b in range(kp.valid.shape[0]):
                g, counts, pr = compare.frame_gap(kp, d, rk, rd, b, b)
                gaps.append(g)
                lone_kp += counts["unpaired"]
                pairing.append(pr)
                notes.append(f"batch {k} frame {b}: feat_gap {g!r} {counts}")
            for b in range(1, kp.valid.shape[0]):
                ti, good, d1 = sift_plain.match_ratio(
                    rd[b], rd[b - 1], rk.valid[b], rk.valid[b - 1],
                    self.ref_cfg.match_ratio)
                ref = (good, ti, d1)
                prog = (m.good[b - 1], m.train_idx[b - 1], m.distance[b - 1])
                g, counts = compare.match_gap(
                    prog, ref, rd[b], pairing[b], pairing[b - 1],
                    ratio=self.ref_cfg.match_ratio, ref_train_desc=rd[b - 1])
                mgaps.append(g)
                lone_m += counts["one_sided"]
                notes.append(f"batch {k} pair {b}: match_gap {g!r} {counts}")
            del rk, rd
        return {"feat_gap": compare.worst(gaps),
                "match_gap": compare.worst(mgaps),
                "kp_unpaired": float(lone_kp),
                "match_one_sided": float(lone_m)}, notes


def make(cfg: dict, params: dict, seed: int, device: torch.device) -> Video:
    return Video(cfg, params, seed, device)
