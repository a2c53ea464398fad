"""Traffic kind `mapping`: monocular keyframe mapping of a closed loop,
one client in a closed loop.

A request is one `sfm.mapping.run_mapping(frames, k)` with the
configuration's back-end settings (run_mapping's defaults): detect and
describe frame by frame, match each frame with the next `pair_window`,
reconstruct with windowed BA, close the loop, correct the trajectory on
the pose graph and run the final BA. The frames are one closed loop of
the box-corner scene (inputs/mapping_scene.py), its sensor noise drawn
from the seed, rendered in set-up and held on the host as float32
frames; every request maps the same sequence again. A request counts
its frames.

Parameters: n_frames and frame_hw (default the configuration's),
pool (1: the sequence), warmup_requests, profile_requests,
check_sequences (1), check_frames (consecutive frames whose front end
the reference recomputes, their start drawn from the seed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.inputs import mapping_scene
from benchmark.reference import compare_map, sift_plain


class Mapping:
    def __init__(self, cfg: dict, params: dict, seed: int,
                 device: torch.device):
        from sift_tpu_torch.config import from_jax_config
        from sift_tpu_torch.sfm import mapping as prog
        # the check feeds the reference the program's own front end: a
        # program that does not hand it back cannot run this cell
        if "front_end" not in {f.name for f in
                               dataclasses.fields(prog.MappingResult)}:
            raise RuntimeError("run_mapping hands back no front end: the "
                               "mapping cell's check cannot run")
        self.p = params
        self.cfg = from_jax_config(cfg["sift"])
        self.ref_cfg = sift_plain.ref_config(cfg["sift"])
        self.back = dict(cfg["back_end"])
        self.device = device
        self.hw = tuple(params.get("frame_hw", cfg["frame_hw"]))
        self.n_frames = int(params.get("n_frames", cfg["n_frames"]))
        rng = np.random.default_rng([seed, 0])
        textures = mapping_scene.mapping_textures()
        seqs = [mapping_scene.render_corner_sequence(
            textures, n_frames=self.n_frames, size=self.hw, seed=int(s))
            for s in rng.integers(0, 2 ** 31, params["pool"]).tolist()]
        self.frames = [f for f, _, _ in seqs]
        self.k = [k for _, k, _ in seqs]
        self.truth = [gt for _, _, gt in seqs]
        focal = cfg["focal_over_width"] * self.hw[1]
        if any(abs(k[0, 0] - focal) > 1e-9 for k in self.k):
            raise ValueError("the scene's focal length is not the "
                             "configuration's")
        self.kept = {}
        self.pool_size = len(self.frames)

    def step(self, i: int, span) -> int:
        from sift_tpu_torch.sfm.mapping import run_mapping
        k = i % self.pool_size
        with span("map"):
            res = run_mapping(self.frames[k], self.k[k], self.cfg,
                              device=self.device, **self.back)
        self.kept[k] = res
        return self.n_frames

    def warmup(self, span) -> None:
        for i in range(self.p["warmup_requests"]):
            self.step(i, span)
        self.kept.clear()

    def shapes(self) -> dict:
        """What one request runs: its frames, its matched pairs, and the
        padded shapes of its bundle adjustments (`ba`: obs, points,
        cams, iters, cg_iters) and pose graphs (`posegraph`: poses,
        edges, iters), read from the spans of the first request the
        program traced (the profiled one); none where the program
        records no such span."""
        w = self.back["pair_window"]
        n = self.n_frames
        out = {"images": [[1, *self.hw]] * n,
               "match_pairs": sum(min(w, n - 1 - i) for i in range(n)),
               "ba": [], "posegraph": []}
        try:
            from sift_tpu_torch.utils import profiling
            recs = profiling.spans()
        except (ImportError, AttributeError):
            return out
        roots = [s for s in recs if s.name == "mapping.run"]
        if not roots:
            return out
        first = min(roots, key=lambda s: s.start_ns).id
        for s in sorted(recs, key=lambda s: s.start_ns):
            if s.trace != first:
                continue
            if s.name == "sfm.ba":
                out["ba"].append(dict(s.attrs))
            elif s.name == "sfm.posegraph":
                out["posegraph"].append(dict(s.attrs))
        return out

    def check(self, seed: int):
        """Numbers of `correct` over `check_sequences` kept requests
        (reference/compare_map.py): the front end of `check_frames`
        consecutive frames, drawn from the seed, against the plain SIFT
        (feature and match gaps, keypoints and matches of one side); the
        back end against the frozen back end fed the program's own
        front end (frames registered, closures and points that differ,
        the camera, rotation, point and RMSE gaps); and the final
        trajectory's ATE against the scene's ground truth."""
        rng = np.random.default_rng([seed, 1])
        picks = sorted(rng.choice(self.pool_size, min(
            self.p["check_sequences"], self.pool_size),
            replace=False).tolist())
        rows, notes = [], []
        for k in picks:
            if k not in self.kept:
                raise RuntimeError(f"no answer kept for sequence {k}")
            res = self.kept[k]
            n_check = min(self.p["check_frames"], self.n_frames)
            start = int(rng.integers(0, self.n_frames - n_check + 1))
            frames = torch.as_tensor(
                self.frames[k][start:start + n_check], device=self.device)
            front, fnotes = compare_map.front_end_numbers(
                res.front_end, frames, start, self.ref_cfg,
                self.back["pair_window"])
            back, bnotes = compare_map.back_end_numbers(
                res, self.k[k], self.truth[k], self.back, self.device)
            rows.append({**front, **back})
            notes += [f"sequence {k}: {n}" for n in fnotes + bnotes]
        return compare_map.worst_of(rows), notes


def make(cfg: dict, params: dict, seed: int, device: torch.device
         ) -> Mapping:
    return Mapping(cfg, params, seed, device)
