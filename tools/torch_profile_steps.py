#!/usr/bin/env python3
"""Time and profile the PyTorch port's 1080p pair and batch steps on one
CUDA card, for one or more checkouts of the repository, in turns.

    python3 tools/torch_profile_steps.py [TREE ...] [--rounds 2]
                                         [--out build/profile_steps.json]

Each TREE is a directory holding sift_tpu_torch/ and chip_smoke.py (the
default is this checkout). Every tree runs in its own process, in the
order A B B A for each round, so trees on one card are compared in
turns. A process builds its tree's kernels, makes chip_smoke.py's
synthetic 1080p scene, warms up, then measures on synchronised wall
clocks:
  - bench.py's pair step (two detect_and_compute, one match_ratio),
    median of 10, and its frames/s;
  - the batch step (detect_and_compute_batch on chip_smoke.py's 8
    frames, 7 matches), median of 5, and its frames/s;
  - detect_and_compute on the scene and, within it, the octave-0
    descriptor stage (descriptors_octave), medians of 10;
and, under torch.profiler, one pair step and one batch step: device
busy time (the union of the device events' intervals), device events
(kernel launches, copies and fills) and the largest device ops, each
per frame. Each process prints one JSON line; the summary and all
lines go to --out. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _wall_ms(fn, runs: int) -> list:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profile(fn, frames: int) -> dict:
    """Device busy ms, device events and the top device ops, per frame,
    of one call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ops = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), reverse=True)[:8]
    return {"device_busy_ms_per_frame": busy_us / 1e3 / frames,
            "device_events_per_frame": len(spans) / frames,
            "top_device_ops_ms_per_frame": [
                [k, t / 1e3 / frames, n / frames] for t, k, n in ops]}


def worker(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as cs
    from sift_tpu_torch import _build, sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import descriptor as desc_mod
    from sift_tpu_torch.ops import match as match_mod
    from sift_tpu_torch.ops import pyramid

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    scene_np, _, _ = cs.full_size_inputs()
    scene = torch.from_numpy(scene_np).cuda()
    f1 = torch.roll(scene, 37, dims=1)
    frames = cs.batch_frames(scene)
    nb = frames.shape[0]

    def pair_step():
        kp0, d0 = sift.detect_and_compute(scene, cfg)
        kp1, d1 = sift.detect_and_compute(f1, cfg)
        return match_mod.match_ratio(d1, d0, q_valid=kp1.valid,
                                     t_valid=kp0.valid, ratio=cfg.match_ratio)

    def batch_step():
        kp, d = sift.detect_and_compute_batch(frames, cfg)
        return [match_mod.match_ratio(d[b], d[b - 1], q_valid=kp.valid[b],
                                      t_valid=kp.valid[b - 1],
                                      ratio=cfg.match_ratio)
                for b in range(1, nb)]

    octs = pyramid.build_gaussian_pyramid(scene, cfg)
    dogs = pyramid.build_dog_pyramid(octs)
    kp0 = sift.detect_octave(octs[0], dogs[0], 0, cfg.detect_caps[0], cfg,
                             cfg.out_caps[0])

    pair = _wall_ms(pair_step, 10)
    batch = _wall_ms(batch_step, 5)
    dac = _wall_ms(lambda: sift.detect_and_compute(scene, cfg), 10)
    desc0 = _wall_ms(lambda: desc_mod.descriptors_octave(octs[0], kp0, cfg),
                     10)
    return {
        "tree": str(tree),
        "pair_step_ms": pair,
        "pair_fps": 2000.0 / statistics.median(pair),
        "batch_step_ms": batch,
        "batch_fps": nb * 1000.0 / statistics.median(batch),
        "detect_and_compute_ms": statistics.median(dac),
        "octave0_descriptors_ms": statistics.median(desc0),
        "pair_profile": _profile(pair_step, 2),
        "batch_profile": _profile(batch_step, nb),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_steps.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(pathlib.Path(args.worker).resolve())))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_profile_steps: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps({k: run[k] for k in (
            "tree", "pair_fps", "batch_fps", "detect_and_compute_ms",
            "octave0_descriptors_ms")}), flush=True)
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {
            k: [r[k] for r in mine]
            for k in ("pair_fps", "batch_fps", "detect_and_compute_ms",
                      "octave0_descriptors_ms")}
        for step in ("pair_profile", "batch_profile"):
            summary[tree][step] = [
                {k: r[step][k] for k in ("device_busy_ms_per_frame",
                                         "device_events_per_frame")}
                for r in mine]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "summary": summary,
                               "runs": runs}, indent=1))
    print(json.dumps({"card": card, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
