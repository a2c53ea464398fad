#!/usr/bin/env python3
"""Split K2's select kernel's device time into the launch, the count read,
the selection of the kept keys, their ordering and the slot writes, in
one or more checkouts of the repository, in turns.

    python3 tools/torch_select_split.py [TREE ...] [--rounds 1]
                                        [--out build/select_split.json]

Each TREE is a directory holding sift_tpu_torch/ (the default is this
checkout). Every tree runs in its own process, in the order A B B A for
each round (tools/torch_profile_steps.py's in-turns runner). A process
copies the tree's csrc/extrema.cu into build/select_split/<tree>/
<variant>/, edits the copy, compiles it into a library of its own beside
an empty kernel and loads it in place of the tree's kernel library under
the tree's own select_candidates (tools/torch_cuda_variants.py). The
variants:
  - "launch": the kernel reads its frame's count and returns;
  - "keep": the count, the radix select where the design runs one and
    the kept keys gathered (the one-block design: the radix select where
    n > cap and its keep pass into shared memory; the rank design: every
    CTA's staging, and past `stage` its radix select and packing), then a
    return: no sort, no slot;
  - "sort": everything but the slot writes (write_slot's stores become
    an empty asm statement that takes the index), so the sort or the
    ranks and the gap bitmap run;
  - "whole": the source as it is;
  - for the rank design also "128 threads" (kSelThreads 128).
"floor" is the empty kernel launched with the tree's select launch shape
(the one-block design: B blocks of its thread count and shared memory;
the rank design: select_shape's grid, kSelThreads threads and its
shared memory). The package's sources are not touched; the edits are the
rules below, a pattern for the rank design and one for the one-block
bitonic design (commit 822348d and before); the first that occurs in the
file must occur exactly once.

Each variant is timed (chip_smoke.median_ms: device time, 20 runs each
queued behind a spin kernel) at the 15 select launches of the main path:
the five octaves of the 1080p scene's and the 640x480 object's
detect_and_compute, and of the B = 8 batch step (chip_smoke.py's
inputs), on the keys and counts the tree's own compact scan gives there.
Where the tree has select_shape, the whole kernel is also timed at CTA
counts of 1 to 256 a frame. Each process prints one JSON line; the
summary and all lines go to --out. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_cuda_variants as variants  # noqa: E402  (edited builds)
import torch_kernel_times as times  # noqa: E402  (set-up, inputs)
import torch_profile_steps as steps  # noqa: E402  (runs trees in turns)

ENTRY = "sift_extrema_select"
_WRITE_SLOT = (
    "  const unsigned rem = i % hw;\n"
    "  layer[slot] = (int)(i / hw) + 1;\n"
    "  row[slot] = (int)(rem / W);\n"
    "  col[slot] = (int)(rem % W);\n"
    "  valid[slot] = ok;\n")
# variant -> [(pattern, replacement)] for extrema.cu
# (torch_cuda_variants.edit: the first pattern of the list that occurs
# is replaced, and it must occur once)
RULES = {
    "launch": [
        (re.escape("  const int n = count[frame];\n"),
         "  const int n = count[frame];\n  if (n >= 0) return;\n"),
        (re.escape("  const int n = count[b];\n"),
         "  const int n = count[b];\n  if (n >= 0) return;\n")],
    "keep": [
        (re.escape("  // the gap and padding slots first"),
         '  asm volatile("" :: "r"((int)general));\n'
         "  return;\n  // the gap and padding slots first"),
        (re.escape("  const int m = s_m;  // min(n, cap)\n"),
         "  if (s_m < 0) layer[0] = 0;\n  return;\n"
         "  const int m = s_m;  // min(n, cap)\n")],
    "sort": [(re.escape(_WRITE_SLOT),
              '  asm volatile("" :: "r"(i), "l"(slot), "r"((int)ok));\n')],
    "128 threads": [(re.escape("constexpr int kSelThreads = 256;"),
                     "constexpr int kSelThreads = 128;")],
}
VARIANTS = ("launch", "keep", "sort", "whole")
# variants of the rank design alone (a tree without the pattern skips
# them): CTAs of 128 threads
DESIGN_VARIANTS = ("128 threads",)
CTA_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def select_ptxas(report: str) -> list:
    """ptxas's lines for the select kernels."""
    lines, keep = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            keep = "select" in line
        if keep and "ptxas" in line:
            lines.append(line.strip())
    return lines


def launch_shape(ext, tree: pathlib.Path, frames: int, cap: int,
                 total: int, sms: int) -> tuple:
    """((grid x, grid y), threads, dynamic shared bytes) of the tree's
    select launch."""
    slots = min(cap, total)
    if hasattr(ext, "select_shape"):
        src = (tree / "sift_tpu_torch" / "csrc" / "extrema.cu").read_text()
        threads = int(re.search(r"constexpr int kSelThreads = (\d+);",
                                src).group(1))
        ctas, stage = ext.select_shape(cap, total, frames, sms)
        smem = 8 * stage + 8 * -(-slots // 32)
        return (ctas, frames), threads, smem
    n2 = 1 << max(slots - 1, 0).bit_length()
    return (frames, 1), min(max(n2 // 2, 64), 1024), 8 * n2


def worker(tree: pathlib.Path) -> dict:
    cs = times.load_tree(tree)
    import torch
    from sift_tpu_torch import _build
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import extrema_cuda as ext

    dogs = times.dog_stacks(cs, *times.scene_and_object(cs), cfg)
    launches = []
    for where, octaves in dogs.items():
        for o, d in enumerate(octaves):
            d4 = (d if d.dim() == 4 else d[None]).contiguous()
            keys, count = ext.extrema_compact(d4, cfg)
            launches.append((f"{where} octave {o}", keys, count,
                             cfg.detect_caps[o], tuple(d4.shape[-2:])))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nl = cfg.n_octave_layers

    def time_all(lib):
        out = {}
        for label, keys, count, cap, hw in launches:
            out[label] = cs.median_ms(
                lambda k=keys, c=count, cap=cap, hw=hw:
                ext.select_candidates(k, c, cap, hw))
        return out

    def floors(lib):
        out = {}
        for label, keys, count, cap, hw in launches:
            grid, threads, smem = launch_shape(
                ext, tree, keys.shape[0], cap, nl * hw[0] * hw[1], sms)
            out[label] = {"ms": cs.median_ms(
                lambda g=grid, t=threads, m=smem:
                variants.launch_empty(lib, g, t, m)),
                "grid": list(grid), "threads": threads, "smem": smem}
        return out

    tag = re.sub(r"[^A-Za-z0-9]+", "_", str(tree.resolve()))[-60:]
    result = {"tree": str(tree),
              "counts": {label: count.tolist()
                         for label, _, count, _, _ in launches},
              "variants": {}}
    src = (tree / "sift_tpu_torch" / "csrc" / "extrema.cu").read_text()
    for variant in VARIANTS + tuple(
            v for v in DESIGN_VARIANTS
            if any(re.search(p, src) for p, _ in RULES[v])):
        rules = {"extrema.cu": RULES[variant]} if variant in RULES else {}
        lib_path, _, report = variants.build_variant(
            tree, ("extrema.cu",), rules,
            ROOT / "build" / "select_split" / tag / variant, _build)
        with variants.in_place_of_library(
                _build, variants.load(lib_path, _build, (ENTRY,))) as lib:
            row = {"ptxas": select_ptxas(report), "ms": time_all(lib)}
            if variant == "whole":
                row["floor"] = floors(lib)
                if hasattr(ext, "select_shape"):
                    chosen = ext.select_shape
                    row["cta_sweep"] = {}
                    try:
                        for ctas in CTA_SWEEP:
                            ext.select_shape = (
                                lambda *a, c=ctas: (c, chosen(*a)[1]))
                            row["cta_sweep"][ctas] = time_all(lib)
                    finally:
                        ext.select_shape = chosen
        result["variants"][variant] = row
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "select_split.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(pathlib.Path(args.worker).resolve())))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_select_split: CUDA is not available", file=sys.stderr)
        return 1
    card = steps.card_name()
    print(card)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    runs = steps.run_in_turns(__file__, trees, args.rounds, ("tree",
                                                             "counts"))
    if runs is None:
        return 1
    summary = {tree: {v: {label: sorted(r["variants"][v]["ms"][label]
                                        for r in runs if r["tree"] == tree)
                          for label in runs[0]["variants"]["whole"]["ms"]}
                      for v in VARIANTS + DESIGN_VARIANTS
                      if v in [r for r in runs if r["tree"] == tree][0][
                          "variants"]}
               for tree in trees}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "summary": summary,
                               "runs": runs}, indent=1))
    print(json.dumps({"card": card, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
