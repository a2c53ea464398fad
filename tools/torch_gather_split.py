#!/usr/bin/env python3
"""Split the bare K3 gather's device time into its loads and its stores,
and set it beside a plain device copy of the same bytes, in one or more
checkouts of the repository, in turns.

    python3 tools/torch_gather_split.py [TREE ...] [--rounds 1]
                                        [--out build/gather_split.json]

Each TREE is a directory holding sift_tpu_torch/ whose csrc/gather.cu
is the (keypoint, row block) design (the one with
ori_gather_cuda.gather_shape); every tree runs in its own process, in
the order A B B A for each round (tools/torch_profile_steps.py's
in-turns runner). A process copies the tree's csrc/gather.cu into
build/gather_split/<tree>/<variant>/, edits the copy, compiles it into
a library of its own and loads it in place of the tree's kernel library
under the tree's own gather_patches (tools/torch_cuda_variants.py). The
variants:
  - "load": the loads, each value compared with a NaN bit pattern the
    inputs never hold in place of its store (so the load stays);
  - "store": the stores, of the row index in place of the loaded value
    (the loads and the starts' reads go with it);
  - "store wb": the streaming stores (__stcs) become plain stores;
  - "load cg": the read-only loads (__ldg) become L2-only loads (__ldcg);
  - "whole": the source as it is.
Each is timed (chip_smoke.median_ms: device time, 20 runs each queued
behind a spin kernel) at chip_smoke.py phase 2's three shapes, on its
inputs (1080p octave 0's stacks; p = 39 with N = 1024, p = 85 with N =
64 and N = 1024), and "whole" is held bit for bit against
gather_patches_plain there. Beside them, at each shape: the tree's
launch floor (an empty kernel of its grid); "copy", one torch.Tensor.copy_ of an (N,
p, p) float32 tensor into another, and "zero", one zero_ of it: the
card's own contiguous copy and fill of the bytes K3 moves; and the
tree's whole kernel on other inputs of the shape: "same start" (every
window at one start, so every read after the first hits a cache), "N/2"
(the first half of the windows) and "2N" (the windows and as many more,
shifted). Each process prints one JSON line; the summary and all lines
go to --out. Needs one card and nvcc.
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
import torch_kernel_times as times  # noqa: E402  (set-up, inputs, floor)
import torch_profile_steps as steps  # noqa: E402  (runs trees in turns)

ENTRY = "sift_gather_patches"
_LOAD = re.escape("__ldg(win + (size_t)(i0 + k) * Wp + g + 32 * q)")
_STORE = re.escape("__stcs(dst + (size_t)(i0 + k) * p + g + 32 * q, "
                   "v[k][q]);")
# variant -> [(pattern, replacement)] for gather.cu (torch_cuda_variants.
# edit: the pattern must occur once)
RULES = {
    "load": [(_STORE, "if (__float_as_uint(v[k][q]) == 0xffffffffu) "
                      "dst[0] = 0.f;")],
    "store": [(_LOAD, "(float)(i0 + k)")],
    "store wb": [(_STORE, "dst[(size_t)(i0 + k) * p + g + 32 * q] = "
                          "v[k][q];")],
    "load cg": [(_LOAD, "__ldcg(win + (size_t)(i0 + k) * Wp + g + 32 * q)")],
}
VARIANTS = ("load", "store", "store wb", "load cg", "whole")


def registers(report: str) -> list:
    """ptxas's register counts, one a compiled kernel."""
    return [int(m) for m in re.findall(r"Used (\d+) registers", report)]


def worker(tree: pathlib.Path) -> dict:
    cs = times.load_tree(tree)
    import torch
    from sift_tpu_torch import _build
    from sift_tpu_torch.ops import ori_gather_cuda as k3

    shapes = times.gather_launches(cs)

    def time_all():
        return {label: cs.median_ms(lambda a=args: k3.gather_patches(*a))
                for label, args in shapes}

    tag = re.sub(r"[^A-Za-z0-9]+", "_", str(tree.resolve()))[-60:]
    out = ROOT / "build" / "gather_split" / tag
    floor_lib = variants.floor_library(out / "floor", _build)
    result = {"tree": str(tree), "variants": {}, "floor": {}, "copy": {},
              "zero": {}, "inputs": {}}
    for label, (padded, lay, r, c, p) in shapes:
        n = lay.shape[0]
        result["floor"][label] = times.gather_floor_ms(
            cs, k3, floor_lib, (padded, lay, r, c, p))[0]
        a = torch.randn((n, p, p), device="cuda")
        b = torch.empty_like(a)
        result["copy"][label] = cs.median_ms(lambda a=a, b=b: b.copy_(a))
        result["zero"][label] = cs.median_ms(lambda b=b: b.zero_())
        other = {"same start": (lay * 0, r * 0 + 500, c * 0 + 900),
                 "N/2": (lay[:n // 2], r[:n // 2], c[:n // 2]),
                 "2N": tuple(torch.cat([v, v.flip(0) + d])
                             for v, d in ((lay, 0), (r, 7), (c, 5)))}
        result["inputs"][label] = {
            k: cs.median_ms(lambda s=starts: k3.gather_patches(padded, *s, p))
            for k, starts in other.items()}
    for variant in VARIANTS:
        rules = {"gather.cu": RULES[variant]} if variant in RULES else {}
        lib_path, _, report = variants.build_variant(
            tree, ("gather.cu",), rules, out / variant, _build)
        with variants.in_place_of_library(
                _build, variants.load(lib_path, _build, (ENTRY,))):
            if variant == "whole":
                for label, args in shapes:
                    if not torch.equal(k3.gather_patches(*args),
                                       k3.gather_patches_plain(*args)):
                        raise SystemExit(f"K3 {label} differs from its "
                                         f"plain version")
            result["variants"][variant] = {"registers": registers(report),
                                           "ms": time_all()}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "gather_split.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(pathlib.Path(args.worker).resolve())))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_gather_split: CUDA is not available", file=sys.stderr)
        return 1
    card = steps.card_name()
    print(card)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    runs = steps.run_in_turns(__file__, trees, args.rounds,
                              ("tree", "floor", "copy", "zero", "inputs"))
    if runs is None:
        return 1
    summary = {tree: {v: {label: sorted(r["variants"][v]["ms"][label]
                                        for r in runs if r["tree"] == tree)
                          for label in runs[0]["floor"]}
                      for v in VARIANTS}
               for tree in trees}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "summary": summary,
                               "runs": runs}, indent=1))
    print(json.dumps({"card": card, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
