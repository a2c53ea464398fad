"""Command-line entry point (reference C1, src/main.cpp:10-76).

Usage mirrors the reference (`./sift <scene> <object>`) and
`python -m sift_tpu.cli`:

    python -m sift_tpu_torch.cli <scene> <object> [--out matches.png]
        [--ratio 0.86] [--no-resize] [--timing] [--diagnose-caps]
        [--device cuda]

The visualization is written to a file with --out. Prints match and
homography stats and, with --timing, per-stage wall times. The default
device is CUDA, which must be present; a CPU run, on the plain PyTorch
version of every kernel, has to be asked for with --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import sys
import time

import numpy as np
import torch

from sift_tpu_torch import io as sio
from sift_tpu_torch import sift as _sift
from sift_tpu_torch.config import DEFAULT_CONFIG
from sift_tpu_torch.ops import pyramid as _pyr
from sift_tpu_torch.pipeline import detect_object

_LOG = logging.getLogger("sift_tpu_torch.cli")


def _draw(scene_path: str, obj_path: str, det, out_path: str) -> None:
    """drawMatches + green box twin (src/main.cpp:42,65-68)."""
    import cv2
    scene = cv2.resize(cv2.imread(scene_path), (960, 960))
    obj = cv2.imread(obj_path)
    good = det.matches.good.cpu().numpy()
    tidx = det.matches.train_idx.cpu().numpy()
    ox, oy = det.object_kp.x.cpu().numpy(), det.object_kp.y.cpu().numpy()
    sx, sy = det.scene_kp.x.cpu().numpy(), det.scene_kp.y.cpu().numpy()
    h_o, w_o = obj.shape[:2]
    canvas = np.zeros((max(960, h_o), 960 + w_o, 3), np.uint8)
    canvas[:h_o, :w_o] = obj
    canvas[:960, w_o:] = scene
    for q in np.where(good)[0]:
        p0 = (int(ox[q]), int(oy[q]))
        p1 = (int(sx[tidx[q]]) + w_o, int(sy[tidx[q]]))
        cv2.line(canvas, p0, p1, (0, 0, 255), 1)
    if bool(det.found):
        c = det.corners.cpu().numpy().astype(int)
        for i in range(4):
            p0 = (c[i][0] + w_o, c[i][1])
            p1 = (c[(i + 1) % 4][0] + w_o, c[(i + 1) % 4][1])
            cv2.line(canvas, p0, p1, (0, 255, 0), 4)
    cv2.imwrite(out_path, canvas)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sift_tpu_torch",
        description="SIFT object detection, PyTorch/CUDA port")
    ap.add_argument("scene")
    ap.add_argument("object")
    ap.add_argument("--out", default=None,
                    help="write match visualization to this file")
    ap.add_argument("--ratio", type=float, default=DEFAULT_CONFIG.match_ratio)
    ap.add_argument("--no-resize", action="store_true",
                    help="skip the 960x960 scene resize (src/main.cpp:83)")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--diagnose-caps", action="store_true",
                    help="also count dense NMS survivors against "
                         "detect_caps (rebuilds the pyramid once per "
                         "image -- diagnostic, not free)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu for a CPU run")

    times: dict = {}

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0

    with stage("ingest"):
        scene = torch.from_numpy(
            sio.read_image(args.scene, resized=not args.no_resize)).to(device)
        obj = torch.from_numpy(sio.read_image(args.object)).to(device)

    cfg = dataclasses.replace(DEFAULT_CONFIG, match_ratio=args.ratio)
    with stage("pipeline(first run)"):
        det = detect_object(scene, obj, cfg=cfg)
    with stage("pipeline(steady)"):
        det = detect_object(scene, obj, cfg=cfg)

    # a (near-)full octave batch means out_caps may have truncated (the
    # reference emits unboundedly, src/sift.cpp:538)
    for name, kp, img in (("scene", det.scene_kp, scene),
                          ("object", det.object_kp, obj)):
        sat = _sift.octave_saturation(kp, cfg).cpu().numpy()
        for o in np.where(sat)[0]:
            _LOG.warning(
                "octave %d of %s hit out_caps[%d]=%d: weakest keypoints "
                "may be truncated; raise SIFTConfig.out_caps",
                o, name, o, cfg.out_caps[o])
        # candidate-level truncation happens before refinement and is
        # invisible in the output batch; opt-in, since it rebuilds the
        # pyramid once per image
        if not args.diagnose_caps:
            continue
        csat = _sift.candidate_saturation(
            _pyr.build_gaussian_pyramid(img, cfg), cfg).cpu().numpy()
        for o in np.where(csat)[0]:
            _LOG.warning(
                "octave %d of %s exceeded detect_caps[%d]=%d NMS "
                "survivors: weakest candidates dropped pre-refinement; "
                "raise SIFTConfig.detect_caps",
                o, name, o, cfg.detect_caps[o])

    found = bool(det.found)
    print(f"scene keypoints:  {int(det.scene_kp.count())}")
    print(f"object keypoints: {int(det.object_kp.count())}")
    print(f"good matches:     {int(det.matches.good.sum())}")
    print(f"RANSAC inliers:   {int(det.n_inliers)}")
    print(f"object found:     {found}")
    if found:
        c = det.corners.cpu().numpy()
        print("corners in scene: "
              + ", ".join(f"({x:.1f},{y:.1f})" for x, y in c))
    if args.timing:
        print("\n".join(f"{k:>24s}: {v * 1e3:9.3f} ms"
                        for k, v in times.items()))
    if args.out:
        _draw(args.scene, args.object, det, args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
