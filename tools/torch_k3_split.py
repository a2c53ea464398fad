#!/usr/bin/env python3
"""Split K3-ori's and K3-desc's device time into the window load, the
load plus the per-sample arithmetic, and the whole kernel, in one or
more checkouts of the repository, in turns.

    python3 tools/torch_k3_split.py [TREE ...] [--rounds 1]
                                    [--out build/k3_split.json]

Each TREE is a directory holding sift_tpu_torch/ (the default is this
checkout). Every tree runs in its own process, in the order A B B A for
each round (tools/torch_profile_steps.py's in-turns runner). A process
copies the tree's csrc/ori_hist.cu, csrc/descr_hist.cu and
csrc/hist_common.cuh into build/k3_split/<tree>/<variant>/, edits the
copies, compiles them into a library of their own and loads it in place
of the tree's kernel library under the tree's own wrappers
(tools/torch_cuda_variants.py). The variants:
  - "load": the sample loop runs no iteration; the window is loaded (and,
    where the kernel takes its integer scale from it, reduced) and the
    histogram written;
  - "arith": every sample's arithmetic runs, K3-desc's 8 corner weights
    included, and the histogram update is replaced by an empty asm
    statement that takes the values the update would have added, so the
    compiler keeps them;
  - "whole": the sources as they are;
  - "warp": K3-ori with one warp per CTA (K3-desc as it is).
The package's sources are not touched; the edits are the rules below,
one list per kernel and variant, a pattern for the warp-vote design
(commit 51ae1e5 and before) and one for the integer-histogram design;
the first that occurs in the file must occur exactly once.

Each variant is timed (chip_smoke.median_ms: device time, 20 runs each
queued behind a spin kernel) at four launches, on the arguments
detect_and_compute and detect_and_compute_batch hand the wrappers on
chip_smoke.py's 1080p scene (tools/torch_kernel_times.hist_launches):
octave 0 of the scene (1,024 slots), the first 64 of those slots,
octave 0 of the batch step (8 x 1,024), and the 640x480 object's last
octave (64 slots of a 30 x 40 octave, the smallest launch of
detect_object). Where the tree's wrappers take a
cluster size (`cluster_size` in ops/ori_hist_cuda.py and
ops/descr_hist_cuda.py), the whole kernels are also timed at every
cluster size 1..8 at those launches. With each library the process
prints ptxas's registers and shared memory per kernel, and the opcodes
of the whole kernels' shared-memory atomics (cuobjdump -sass). Each
process prints one JSON line; the summary and all lines go to --out.
Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_cuda_variants as variants  # noqa: E402  (edited builds)
import torch_kernel_times as times  # noqa: E402  (set-up, hist_launches)
import torch_profile_steps as steps  # noqa: E402  (runs trees in turns)

SOURCES = ("ori_hist.cu", "descr_hist.cu", "hist_common.cuh")
ENTRIES = ("sift_ori_hist", "sift_descr_hist")
_DESC_SINK = ("{ float v_[8]; corner_weights<kBf16>(fr, fc, fo, mag, v_); "
              "asm volatile(\"\" :: \"f\"(v_[0]), \"f\"(v_[1]), "
              "\"f\"(v_[2]), \"f\"(v_[3]), \"f\"(v_[4]), \"f\"(v_[5]), "
              "\"f\"(v_[6]), \"f\"(v_[7]), \"r\"(key)); }")
# (file, variant) -> [(pattern, replacement)] (torch_cuda_variants.edit:
# the first pattern of the list that occurs in the file is replaced, and
# it must occur once)
RULES = {
    ("ori_hist.cu", "load"): [(r"b < nsamp;", "b < 0;"),
                              (r"s < nband;", "s < 0;")],
    ("descr_hist.cu", "load"): [(r"b < nsamp;", "b < 0;"),
                                (r"s < nband;", "s < 0;")],
    ("ori_hist.cu", "arith"): [
        (re.escape("warp_add(hist, key, v, lane);"),
         'asm volatile("" :: "f"(v), "r"(key));'),
        (re.escape("hist_add(hist, bin, v, scale);"),
         'asm volatile("" :: "f"(v), "r"(bin), "f"(scale));')],
    ("descr_hist.cu", "arith"): [
        (re.escape("warp_add_trilinear<kBf16>(hist, key, fr, fc, fo, mag, "
                   "lane);"), _DESC_SINK),
        (re.escape("add_corners<kBf16>(hist, key, fr, fc, fo, mag, scale);"),
         _DESC_SINK)],
    ("ori_hist.cu", "warp"): [(r"constexpr int kWarps = 4;",
                               "constexpr int kWarps = 1;"),
                              (r"constexpr int kThreads = 128;",
                               "constexpr int kThreads = 32;")],
}
VARIANTS = ("load", "arith", "whole", "warp")


def ptxas_summary(report: str) -> list:
    """[(kernel, registers, static shared bytes)] from ptxas -v output
    (0 where ptxas prints no shared memory)."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0)))
            name = None
    return rows


def shared_atomics(objs) -> dict:
    """{object: opcode: count} of the atomics in the objects."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for obj in objs:
        sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                              text=True).stdout
        for op in re.findall(r"\b((?:ATOMS|ATOM|REDS?)\.[A-Z0-9.]+)", sass):
            key = f"{obj.stem}: {op}"
            out[key] = out.get(key, 0) + 1
    return out


def worker(tree: pathlib.Path) -> dict:
    cs = times.load_tree(tree)
    import torch
    from sift_tpu_torch import _build, sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import descr_hist_cuda, ori_hist_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, obj = times.scene_and_object(cs)
    scene = times.hist_launches(lambda: sift.detect_and_compute(img, cfg))
    small_octave = times.hist_launches(
        lambda: sift.detect_and_compute(obj, cfg))
    batch = times.hist_launches(
        lambda: sift.detect_and_compute_batch(cs.batch_frames(img), cfg))

    def first(calls, name):
        return next(a for n, a in calls if n == name)

    def last(calls, name):
        return [a for n, a in calls if n == name][-1]

    def small(args):
        return tuple(a[:cs.SMALL_SLOTS] if torch.is_tensor(a)
                     and a.dim() == 1 and a.shape[0] == args[1].shape[0]
                     else a for a in args)

    launches = {}
    for name, fn in (("K3-ori", ori_hist_cuda.orientation_hist),
                     ("K3-desc", descr_hist_cuda.descriptor_hist)):
        one = first(scene, name)
        launches[name] = {"1080p octave 0": (fn, one),
                          f"{cs.SMALL_SLOTS} of octave 0": (fn, small(one)),
                          "batch octave 0": (fn, first(batch, name)),
                          "object octave 4": (fn, last(small_octave, name))}

    def time_all():
        return {name: {label: cs.median_ms(lambda f=f, a=a: f(*a))
                       for label, (f, a) in rows.items()}
                for name, rows in launches.items()}

    tag = re.sub(r"[^A-Za-z0-9]+", "_", str(tree.resolve()))[-60:]
    result = {"tree": str(tree), "variants": {}}
    for variant in VARIANTS:
        rules = {name: RULES[(name, variant)] for name in SOURCES
                 if (name, variant) in RULES}
        lib_path, objs, report = variants.build_variant(
            tree, SOURCES, rules, ROOT / "build" / "k3_split" / tag / variant,
            _build)
        with variants.in_place_of_library(
                _build, variants.load(lib_path, _build, ENTRIES)):
            row = {"ptxas": ptxas_summary(report),
                   "ptxas_lines": [ln for ln in report.splitlines()
                                   if "ptxas" in ln],
                   "ms": time_all()}
            if variant == "whole":
                row["shared_atomics"] = shared_atomics(objs)
                mods = [m for m in (ori_hist_cuda, descr_hist_cuda)
                        if hasattr(m, "cluster_size")]
                if mods:
                    chosen = mods[0].cluster_size
                    row["cluster_sweep"] = {}
                    for size in range(1, 9):
                        for m in mods:
                            m.cluster_size = lambda *a, s=size: s
                        row["cluster_sweep"][size] = time_all()
                    for m in mods:
                        m.cluster_size = chosen
        result["variants"][variant] = row
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "build" / "k3_split.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(pathlib.Path(args.worker).resolve())))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_k3_split: CUDA is not available", file=sys.stderr)
        return 1
    card = steps.card_name()
    print(card)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    runs = steps.run_in_turns(__file__, trees, args.rounds, ("tree",
                                                             "variants"))
    if runs is None:
        return 1
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
