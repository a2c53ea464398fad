#!/usr/bin/env python3
"""Time the port's K1, K1-batch, K2, K2-batch, K3-ori, K3-desc and K4
kernels, its candidate selection, its refinement and the BA's segment
sums, as their wrappers launch them, in one or more checkouts of the
repository, in turns, with one timing method for all of them.

    python3 tools/torch_kernel_times.py [TREE ...] [--rounds 2]
                                        [--out build/kernel_times.json]

Each TREE is a directory holding sift_tpu_torch/ (the default is this
checkout). Every tree runs in its own process, in the order A B B A for
each round (tools/torch_profile_steps.py's driver), and imports its own
kernels and wrappers; the inputs and the timing come from this
checkout's chip_smoke.py, so a tree whose chip_smoke.py timed another
way is still timed the same way here. Each process times:
  - K1 at every launch of one 1080p detect_object (the scene's and the
    640x480 object's base blur and five octaves), K1-batch at every
    launch of the B = 8 batch step, and K4 at 1536 x 1536;
  - the dense K2 (extrema_scores) at the scene's octave 0 and K2-batch
    (extrema_scores_batch) at the batch step's;
  - the candidate selection, ops/extrema.top_candidates at every octave
    of detect_object and top_candidates_batch at every octave of the
    batch step, whatever the tree launches for it (before the compact
    scan: the dense K2, a stable sort of the scores and the decode);
  - the select kernel alone (extrema_cuda.select_candidates) at the same
    15 launches, on the keys and counts of the tree's own compact scan
    (trees that have one), each with the tree's select launch shape
    where it has select_shape and, where it has select_floor, the device
    time of an empty kernel launched with that shape (floor_ms);
  - the BA's segment sums (ops/segsum.segment_sum, csrc/segsum.cu) at
    32,768 observations over 24 cameras (width 36, the normal blocks)
    and over 4,096 points (width 3), with the plan made once; in a tree
    without it, the index_add_ that was its path;
  - K3-ori and K3-desc at every launch of the scene's and the object's
    detect_and_compute (one each per usable octave) and of the batch
    step's detect_and_compute_batch (one each per octave for the 8
    frames), on the arguments those calls hand the wrappers (captured
    from the calls), each also with its plain version's device time
    (plain_ms, 3 runs) and its bound (chip_smoke.hist_bound);
each with
  - device_ms: chip_smoke.median_ms, each of 20 calls queued behind a
    spin kernel, so the events time the device's work only;
  - events_ms: the same without the spin kernel, so a call whose host
    side outlasts its kernels is timed with that host side;
  - host_us: the host's time per call while the card is busy, the
    median over 10 rounds of 50 calls enqueued without a synchronise;
and the sums of each over the launches of one detect_object and of one
batch step. --select-only times the select kernel's rows alone (a
process takes seconds instead of minutes). --gather-only times the bare
K3 gather (ori_gather_cuda.gather_patches) alone at chip_smoke.py
phase 2's three shapes, on the same inputs (1080p octave 0's stacks, p =
39 with N = 1024, p = 85 with N = 64 and N = 1024), each held bit for
bit against gather_patches_plain, with its plain version's device time,
its bound, the device time of an empty kernel of the tree's launch
shape (floor_ms, tools/torch_cuda_variants.py) and, in a tree with
gather_shape, its warps a CTA and a sweep of them at each.
--refine-only times ops/refine.refine_candidates alone at every octave
of detect_object (scene and object) and of the batch step, on the
candidates of the tree's own scan: in a tree with the refine kernel
(csrc/refine.cu) its launch, beside the device time of an empty kernel
of its grid (floor_ms) and its byte bound (chip_smoke
REFINE_BYTES_PER_SLOT a slot); in a tree without it, the plain version
that was its path; and at octave 0 (B = 1 and B = 8) the tree's plain
version (plain_ms, 5 runs). Each process prints one JSON line; the
summary and all lines go to --out. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_profile_steps as steps  # noqa: E402  (the in-turns driver)

METHODS = ("device_ms", "events_ms", "host_us")


def _host_us(fn, calls: int = 50, rounds: int = 10) -> float:
    import torch
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def _times(cs, label, shape, fn) -> dict:
    return {"label": label, "shape": list(shape),
            "device_ms": cs.median_ms(fn),
            "events_ms": cs.median_ms(fn, queued=False),
            "host_us": _host_us(fn)}


def _sums(rows) -> dict:
    return {k: sum(r[k] for r in rows) for k in METHODS + ("floor_ms",)
            if all(k in r for r in rows)}


def hist_launches(fn) -> list:
    """Run fn() and return (name, wrapper arguments) of every K3-ori and
    K3-desc call it makes, in order: the wrappers, as ops/orientation.py
    and ops/descriptor.py call them, are replaced by recorders for the
    call."""
    from sift_tpu_torch.ops import descriptor, orientation
    calls = []
    saved = orientation.orientation_hist, descriptor.descriptor_hist

    def recorder(name, wrapper):
        def record(*args):
            calls.append((name, args))
            return wrapper(*args)
        return record

    orientation.orientation_hist = recorder("K3-ori", saved[0])
    descriptor.descriptor_hist = recorder("K3-desc", saved[1])
    try:
        fn()
    finally:
        orientation.orientation_hist, descriptor.descriptor_hist = saved
    return calls


def hist_rows(cs, calls, where) -> list:
    """Times of each captured K3 call under the tree's own wrapper and
    plain version, with its bound."""
    from sift_tpu_torch.ops.descr_hist_cuda import (descriptor_hist,
                                                    descriptor_hist_plain)
    from sift_tpu_torch.ops.ori_hist_cuda import (orientation_hist,
                                                  orientation_hist_plain)
    fns = {"K3-ori": (orientation_hist, orientation_hist_plain),
           "K3-desc": (descriptor_hist, descriptor_hist_plain)}
    rows, octave = [], {"K3-ori": 0, "K3-desc": 0}
    for name, args in calls:
        fn, plain = fns[name]
        row = _times(cs, f"{where} octave {octave[name]}",
                     tuple(args[1].shape), lambda a=args: fn(*a))
        row["plain_ms"] = cs.median_ms(lambda a=args: plain(*a), runs=3)
        row["bound_ms"], row["bound_by"] = cs.hist_bound(name, args)
        octave[name] += 1
        rows.append((name, row))
    return rows


def select_alone_rows(cs, dogs: dict, cfg) -> dict:
    """The select kernel alone at every octave of detect_object (scene
    and object) and of the batch step: times, counts, launch shape and,
    where the tree has one, its launch floor; with sums per
    detect_object and per batch step."""
    import torch
    from sift_tpu_torch.ops import extrema_cuda as ext
    if not hasattr(ext, "select_candidates"):
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nl = cfg.n_octave_layers
    out = {}
    for where, octaves in dogs.items():
        rows = []
        for o, d in enumerate(octaves):
            d4 = d if d.dim() == 4 else d[None]
            keys, count = ext.extrema_compact(d4, cfg)
            cap, hw = cfg.detect_caps[o], tuple(d4.shape[-2:])
            row = _times(cs, f"{where} octave {o}", d4.shape,
                         lambda k=keys, c=count, cap=cap, hw=hw:
                         ext.select_candidates(k, c, cap, hw))
            row["counts"] = count.tolist()
            row["cap"] = cap
            if hasattr(ext, "select_shape"):
                row["shape"] = list(ext.select_shape(
                    cap, nl * hw[0] * hw[1], d4.shape[0], sms))
            if hasattr(ext, "select_floor"):
                row["floor_ms"] = cs.median_ms(
                    lambda b=d4.shape[0], cap=cap, hw=hw:
                    ext.select_floor(b, cap, nl, hw, d4.device))
            rows.append(row)
        out[where] = rows
    return {"select": out["scene"] + out["object"],
            "select-batch": out["batch"],
            "select_per_detect_object": _sums(out["scene"] + out["object"]),
            "select_per_batch_step": _sums(out["batch"])}


def load_tree(tree: pathlib.Path):
    """Put `tree` first on the path, import this checkout's chip_smoke.py
    (the inputs and the timing that every tree shares) and build the
    tree's kernel library; returns chip_smoke."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("timing_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sift_tpu_torch import _build
    _build.library()
    return cs


def scene_and_object(cs) -> tuple:
    """chip_smoke's 1080p scene and 640x480 object, on the card."""
    import torch
    scene_np, obj_np, _ = cs.full_size_inputs()
    return torch.from_numpy(scene_np).cuda(), torch.from_numpy(obj_np).cuda()


def dog_stacks(cs, img, obj, cfg) -> dict:
    """The DoG octaves of the scene's and the object's detect_object and
    of the batch step on chip_smoke.batch_frames(img), each contiguous."""
    from sift_tpu_torch.ops import pyramid
    dogs = {"scene": pyramid.build_dog_pyramid(
                pyramid.build_gaussian_pyramid(img, cfg)),
            "object": pyramid.build_dog_pyramid(
                pyramid.build_gaussian_pyramid(obj, cfg)),
            "batch": pyramid.build_dog_pyramid_batch(
                pyramid.build_gaussian_pyramid_batch(cs.batch_frames(img),
                                                     cfg))}
    return {k: [d.contiguous() for d in v] for k, v in dogs.items()}


def select_worker(tree: pathlib.Path) -> dict:
    """--select-only: the select kernel's rows alone."""
    cs = load_tree(tree)
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    rows = select_alone_rows(cs, dog_stacks(cs, *scene_and_object(cs), cfg),
                             cfg)
    return {"tree": str(tree), **rows, "main": _select_main(rows)}


def _select_main(rows: dict) -> dict:
    return {"select_per_detect_object": rows["select_per_detect_object"],
            "select_per_batch_step": rows["select_per_batch_step"],
            **{f"select {r['label']}": r
               for r in rows["select"] + rows["select-batch"]}}


# --gather-only's sweep of launch shapes: warps a CTA
GATHER_SWEEP = (1, 2, 4, 8, 16, 32)


def gather_launches(cs) -> list:
    """chip_smoke.py phase 2's three K3 launches, drawn in its order, on
    the scene's octave 0: [(label, (padded, layer, row, col, p))]."""
    import numpy as np
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import pyramid
    gauss = pyramid.build_gaussian_pyramid(scene_and_object(cs)[0], cfg)[0]
    return cs.gather_cases(gauss, cfg, np.random.default_rng(0))


def gather_floor_ms(cs, k3, floor_lib, args) -> tuple:
    """(device time of an empty kernel of the tree's K3 grid for these
    arguments, the grid's warps a CTA or None): the launch floor. A tree
    without gather_grid launches one 128-thread block a keypoint (commit
    e823213 and before)."""
    import torch_cuda_variants as variants
    padded, n, p = args[0], args[1].shape[0], args[4]
    warps, ctas, threads = None, 1, 128
    if hasattr(k3, "gather_grid"):
        warps = k3.launch_warps(n, p, padded.device)
        ctas, threads = k3.gather_grid(p, warps)
    return cs.median_ms(lambda: variants.launch_empty(
        floor_lib, (n, ctas), threads)), warps


def gather_worker(tree: pathlib.Path) -> dict:
    """--gather-only: the bare K3 gather at phase 2's three shapes."""
    cs = load_tree(tree)
    import torch
    import torch_cuda_variants as variants
    from sift_tpu_torch import _build
    from sift_tpu_torch.ops import ori_gather_cuda as k3
    floor_lib = variants.floor_library(ROOT / "build" / "gather_floor",
                                       _build)
    rows = {}
    for label, args in gather_launches(cs):
        padded = args[0]
        if not torch.equal(k3.gather_patches(*args),
                           k3.gather_patches_plain(*args)):
            raise SystemExit(f"K3 {label} differs from its plain version")
        row = _times(cs, label, padded.shape,
                     lambda a=args: k3.gather_patches(*a))
        row["plain_ms"] = cs.median_ms(lambda a=args:
                                       k3.gather_patches_plain(*a))
        row["bound_ms"], row["bound_by"] = cs.gather_bound(*args)
        row["floor_ms"], row["warps"] = gather_floor_ms(cs, k3, floor_lib,
                                                        args)
        if hasattr(k3, "gather_shape"):
            chosen, row["sweep"] = k3.launch_warps, {}
            try:
                for warps in GATHER_SWEEP:
                    k3.launch_warps = lambda *a, w=warps: w
                    row["sweep"][warps] = cs.median_ms(
                        lambda a=args: k3.gather_patches(*a))
            finally:
                k3.launch_warps = chosen
        rows[row["label"]] = row
    return {"tree": str(tree), "main": rows,
            "device_ms": {k: r["device_ms"] for k, r in rows.items()}}


def refine_worker(tree: pathlib.Path) -> dict:
    """--refine-only: refine_candidates at every octave of detect_object
    and of the batch step, with sums per detect_object and per batch
    step."""
    cs = load_tree(tree)
    import torch_cuda_variants as variants
    from sift_tpu_torch import _build
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import refine as ref
    floor_lib = variants.floor_library(ROOT / "build" / "refine_floor",
                                       _build)
    threads = getattr(ref, "KERNEL_THREADS", None)
    plain = getattr(ref, "refine_candidates_plain", ref.refine_candidates)
    out = {}
    for where, octaves in dog_stacks(cs, *scene_and_object(cs), cfg).items():
        rows = []
        for o, d in enumerate(octaves):
            scan = ext.top_candidates_batch if d.dim() == 4 else \
                ext.top_candidates
            cands = scan(d, cfg.detect_caps[o], cfg)
            slots = cands[0].numel()
            row = _times(cs, f"{where} octave {o}", d.shape,
                         lambda d=d, c=cands: ref.refine_candidates(d, *c,
                                                                    cfg))
            row["slots"] = slots
            row["bound_ms"], row["bound_by"] = cs.bound_ms(
                cs.REFINE_BYTES_PER_SLOT * slots, 0.0)
            if threads is not None:
                row["floor_ms"] = cs.median_ms(
                    lambda s=slots: variants.launch_empty(
                        floor_lib, (-(-s // threads), 1), threads))
            if o == 0:
                row["plain_ms"] = cs.median_ms(
                    lambda d=d, c=cands: plain(d, *c, cfg), runs=5)
            rows.append(row)
        out[where] = rows
    main = {f"refine {r['label']}": r for rows in out.values() for r in rows}
    main["refine_per_detect_object"] = _sums(out["scene"] + out["object"])
    main["refine_per_batch_step"] = _sums(out["batch"])
    return {"tree": str(tree), "main": main}


def segsum_rows(cs) -> dict:
    """The BA's segment sums at 32,768 observations over 24 cameras
    (width 36) and over 4,096 points (width 3): the tree's fixed-order
    segment_sum where it has ops/segsum.py, else index_add_."""
    import numpy as np
    import torch
    try:
        from sift_tpu_torch.ops import segsum
    except ImportError:
        segsum = None
    rng = np.random.default_rng(18)
    dev = torch.device("cuda")
    o, rows = 32768, {}
    for label, s, w in (("cams W=36", 24, 36), ("points W=3", 4096, 3)):
        idx = torch.as_tensor(rng.integers(0, s, o), device=dev)
        x = torch.randn(o, w, device=dev)
        out = torch.zeros(s, w, device=dev)
        if segsum is None:
            def fn(out=out, idx=idx, x=x):
                return out.index_add_(0, idx, x)
        else:
            def fn(out=out, plan=segsum.make_plan(idx, s), x=x):
                return segsum.segment_sum(out, plan, x)
        rows[f"segsum {label}"] = _times(cs, f"O={o} S={s} W={w}", (o, w),
                                         fn)
    return rows


def worker(tree: pathlib.Path) -> dict:
    cs = load_tree(tree)
    import numpy as np
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import pyramid
    from sift_tpu_torch.ops.conv_cuda import blur_vh, blur_vh_batch
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, obj = scene_and_object(cs)

    def blur_rows(wrapper, launches, where):
        return [_times(cs, f"{where} {label}", x.shape,
                       lambda x=x, k=kmat: wrapper(x, k))
                for label, x, kmat in launches]

    k1 = (blur_rows(blur_vh, cs.blur_launches(
              img, pyramid.build_gaussian_pyramid(img, cfg), False, cfg),
              "scene")
          + blur_rows(blur_vh, cs.blur_launches(
              obj, pyramid.build_gaussian_pyramid(obj, cfg), False, cfg),
              "object"))
    frames = cs.batch_frames(img)
    k1b = blur_rows(blur_vh_batch, cs.blur_launches(
        frames, pyramid.build_gaussian_pyramid_batch(frames, cfg), True,
        cfg), "batch")
    n = sum(cfg.out_caps)
    q, tm = cs.knn_inputs(np.random.default_rng(0), n, n, img.device)
    k4 = _times(cs, f"{n}x{n}", (n, n), lambda: knn2_l1_cuda(q, tm))

    # the candidate scan and selection at every octave
    dogs = dog_stacks(cs, img, obj, cfg)

    def select_rows(where, route):
        return [_times(cs, f"{where} octave {o}", d.shape,
                       lambda d=d, cap=cfg.detect_caps[o]: route(d, cap, cfg))
                for o, d in enumerate(dogs[where])]

    sel = (select_rows("scene", ext.top_candidates)
           + select_rows("object", ext.top_candidates))
    selb = select_rows("batch", ext.top_candidates_batch)
    alone = select_alone_rows(cs, dogs, cfg)
    k3 = (hist_rows(cs, hist_launches(
              lambda: sift.detect_and_compute(img, cfg)), "scene")
          + hist_rows(cs, hist_launches(
              lambda: sift.detect_and_compute(obj, cfg)), "object"))
    k3b = hist_rows(cs, hist_launches(
        lambda: sift.detect_and_compute_batch(frames, cfg)), "batch")
    k3_out = {}
    for name in ("K3-ori", "K3-desc"):
        mine = [r for n_, r in k3 if n_ == name]
        mine_b = [r for n_, r in k3b if n_ == name]
        k3_out[name] = mine
        k3_out[f"{name} batch"] = mine_b
        k3_out[f"{name}_per_detect_object"] = _sums(mine)
        k3_out[f"{name}_per_batch_step"] = _sums(mine_b)
    d0, db0 = dogs["scene"][0], dogs["batch"][0]
    k2 = _times(cs, "scene octave 0", d0.shape,
                lambda: ext.extrema_scores(d0, cfg))
    k2b = _times(cs, "batch octave 0", db0.shape,
                 lambda: ext.extrema_scores_batch(db0, cfg))
    sums = segsum_rows(cs)
    return {"tree": str(tree), "K1": k1, "K1-batch": k1b, "K4": k4,
            "K2": k2, "K2-batch": k2b, "selection": sel,
            "selection-batch": selb,
            "K1_per_detect_object": _sums(k1),
            "K1-batch_per_batch_step": _sums(k1b),
            "selection_per_detect_object": _sums(sel),
            "selection_per_batch_step": _sums(selb), **k3_out, **alone,
            "main": {**(_select_main(alone) if alone else {}),
                     "K1": k1[1], "K1-batch": k1b[1], "K4": k4, "K2": k2,
                     "K2-batch": k2b, **sums,
                     "selection_per_detect_object": _sums(sel),
                     "selection_per_batch_step": _sums(selb),
                     "K3-ori": k3_out["K3-ori"][0],
                     "K3-desc": k3_out["K3-desc"][0],
                     "K3-ori batch": k3_out["K3-ori batch"][0],
                     "K3-desc batch": k3_out["K3-desc batch"][0],
                     **{k: v for k, v in k3_out.items() if "_per_" in k}}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_times.json"))
    ap.add_argument("--select-only", action="store_true",
                    help="time the select kernel's rows alone")
    ap.add_argument("--gather-only", action="store_true",
                    help="time the bare K3 gather alone")
    ap.add_argument("--refine-only", action="store_true",
                    help="time refine_candidates alone")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        work = (gather_worker if args.gather_only else
                select_worker if args.select_only else
                refine_worker if args.refine_only else worker)
        print(json.dumps(work(pathlib.Path(args.worker).resolve())))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    card = steps.card_name()
    print(card)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    mode = (("--gather-only",) if args.gather_only else
            ("--select-only",) if args.select_only else
            ("--refine-only",) if args.refine_only else ())
    runs = steps.run_in_turns(
        __file__, trees, args.rounds,
        ("tree", "device_ms") if args.gather_only else
        ("tree", "select_per_detect_object", "select_per_batch_step")
        if args.select_only else ("tree", "main") if args.refine_only else
        ("tree", "main", "K1_per_detect_object", "K1-batch_per_batch_step"),
        mode)
    if runs is None:
        return 1
    keys = () if mode else (
        "K1", "K1-batch", "K4", "K2", "K2-batch",
        "selection_per_detect_object", "selection_per_batch_step",
        "K3-ori", "K3-desc", "K3-ori batch", "K3-desc batch",
        "K3-ori_per_detect_object", "K3-desc_per_detect_object",
        "K3-ori_per_batch_step", "K3-desc_per_batch_step")
    keys += tuple(dict.fromkeys(k for r in runs for k in r["main"]
                                if k.startswith(("select", "p=", "refine",
                                                 "segsum"))))
    summary = {tree: {k: {m: [r["main"][k][m] for r in runs
                              if r["tree"] == tree
                              and m in r["main"].get(k, {})]
                          for m in METHODS + ("floor_ms", "plain_ms")}
                      for k in keys}
               for tree in trees}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "summary": summary,
                               "runs": runs}, indent=1))
    print(json.dumps({"card": card, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
