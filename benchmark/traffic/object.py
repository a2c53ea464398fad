"""Traffic kind `object`: the reference demo, finding a known object in
a frame, one client in a closed loop.

A request is one `pipeline.detect_object(scene, object)`: SIFT on both
images, the ratio-test match, the RANSAC homography and the projected
corners. Each (scene, object) pair pastes a seeded object texture into
a seeded scene through a seeded pose (inputs.recipes.object_scene); a
pool of `pool` pairs is made in set-up, moved to the device and cycled.
A request counts one object.

Parameters: pool, warmup_requests, profile_requests, check_pairs (pool
pairs the reference recomputes, drawn from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import recipes
from benchmark.reference import compare, homography_plain, sift_plain


class ObjectDemo:
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
        self.obj_hw = tuple(params.get("object_hw", cfg["object_hw"]))
        rng = np.random.default_rng([seed, 0])
        seeds = rng.integers(0, 2 ** 63, params["pool"]).tolist()
        made = [recipes.object_scene(self.hw, self.obj_hw, s) for s in seeds]
        self.scenes = [torch.from_numpy(m[0]).to(device) for m in made]
        self.objects = [torch.from_numpy(m[1]).to(device) for m in made]
        self.truth = [m[3] for m in made]
        self.kept = {}
        self.pool_size = len(self.scenes)

    def step(self, i: int, span) -> int:
        from sift_tpu_torch import pipeline
        k = i % len(self.scenes)
        with span("detect_object"):
            det = pipeline.detect_object(self.scenes[k], self.objects[k],
                                         self.cfg)
        self.kept[k] = det
        return 1

    def warmup(self, span) -> None:
        for i in range(self.p["warmup_requests"]):
            self.step(i, span)
        self.kept.clear()

    def shapes(self) -> dict:
        """What one request runs: the scene, the object, one pair."""
        return {"images": [[1, *self.hw], [1, *self.obj_hw]],
                "match_pairs": 1}

    def check(self, seed: int):
        """Numbers of `correct` over `check_pairs` kept requests drawn
        from the seed, against the reference's own detection: the
        feature gap of scene and object, the match gap and the RANSAC
        inliers' gap (the worst); the keypoints, matches and inliers
        that only one side has, and the requests whose `found` differs
        (their sums; those of a query whose ratio test is undecided are
        a note, compare.match_gap); the widest distance between the two
        sides' projected corners. The corners' distance from the truth is a
        note."""
        rng = np.random.default_rng([seed, 1])
        pool = len(self.scenes)
        picks = sorted(rng.choice(pool, min(self.p["check_pairs"], pool),
                                  replace=False).tolist())
        gaps, mgaps, igaps, cgaps, notes = [], [], [], [], []
        lone = {"kp": 0, "match": 0, "inlier": 0, "found": 0}
        for k in picks:
            if k not in self.kept:
                raise RuntimeError(f"no answer kept for pair {k}")
            det = self.kept[k]
            ref = detect_object_plain(self.scenes[k], self.objects[k],
                                      self.ref_cfg)
            g_s, c_s, pr_s = compare.frame_gap(det.scene_kp, det.scene_desc,
                                               ref["scene_kp"],
                                               ref["scene_desc"], None, 0)
            g_o, c_o, pr_o = compare.frame_gap(det.object_kp,
                                               det.object_desc,
                                               ref["object_kp"],
                                               ref["object_desc"], None, 0)
            m = det.matches
            share, n = compare.match_gap(
                (m.good, m.train_idx, m.distance),
                (ref["good"], ref["train_idx"], ref["d1"]),
                ref["object_desc"][0], pr_o, pr_s,
                ratio=self.ref_cfg.match_ratio,
                ref_train_desc=ref["scene_desc"][0])
            inl, n_inl = compare.match_gap(
                (det.inliers, m.train_idx, m.distance),
                (ref["inliers"], ref["train_idx"], ref["d1"]),
                ref["object_desc"][0], pr_o, pr_s,
                undecided=[u[0] for u in n["undecided"]])
            cg = compare.corner_gap(det.corners, ref["corners"])
            truth = torch.as_tensor(self.truth[k], device=det.corners.device)
            gaps += [g_s, g_o]
            mgaps.append(share)
            igaps.append(inl)
            cgaps.append(cg)
            lone["kp"] += c_s["unpaired"] + c_o["unpaired"]
            lone["match"] += n["one_sided"]
            lone["inlier"] += n_inl["one_sided"]
            lone["found"] += int(bool(det.found) != bool(ref["found"]))
            notes.append(
                f"pair {k}: feat_gap scene {g_s!r} {c_s} object {g_o!r} "
                f"{c_o}; match_gap {share!r} {n}; inlier_gap {inl!r} "
                f"{n_inl}; corner_gap {cg!r} px; "
                f"from the truth: program "
                f"{compare.corner_gap(det.corners, truth)!r} px, reference "
                f"{compare.corner_gap(ref['corners'], truth)!r} px; found "
                f"{bool(det.found)} / {bool(ref['found'])}")
        return {"feat_gap": compare.worst(gaps),
                "match_gap": compare.worst(mgaps),
                "inlier_gap": compare.worst(igaps),
                "corner_gap_px": compare.worst(cgaps),
                "kp_unpaired": float(lone["kp"]),
                "match_one_sided": float(lone["match"]),
                "inlier_one_sided": float(lone["inlier"]),
                "found_differs": float(lone["found"])}, notes


def detect_object_plain(scene: torch.Tensor, obj: torch.Tensor,
                        cfg: sift_plain.RefConfig) -> dict:
    """The demo (src/main.cpp:10-72) on the reference: SIFT of both
    images, object -> scene ratio-test matches, RANSAC (seed 0, as the
    port's default) and the projected corners."""
    skp, sd = sift_plain.detect_and_compute(scene[None], cfg)
    okp, od = sift_plain.detect_and_compute(obj[None], cfg)
    tidx, good, d1 = sift_plain.match_ratio(od[0], sd[0], okp.valid[0],
                                            skp.valid[0], cfg.match_ratio)
    t = tidx.long()
    src = torch.stack([okp.x[0], okp.y[0]], dim=1)
    dst = torch.stack([skp.x[0][t], skp.y[0][t]], dim=1)
    hres = homography_plain.find_homography_ransac(src, dst, valid=good)
    h, w = obj.shape
    corners = torch.tensor([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]],
                           dtype=torch.float32, device=obj.device)
    return {"scene_kp": skp, "scene_desc": sd, "object_kp": okp,
            "object_desc": od, "train_idx": tidx, "good": good, "d1": d1,
            "inliers": hres.inliers, "found": hres.ok,
            "corners": homography_plain.perspective_transform(corners,
                                                              hres.H)}


def make(cfg: dict, params: dict, seed: int, device: torch.device
         ) -> ObjectDemo:
    return ObjectDemo(cfg, params, seed, device)
