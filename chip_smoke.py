#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sift_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the four kernels from
sift_tpu_torch/csrc, then runs, one line per phase:

  0. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off, so the plain versions are full-float32 references;
  1. build of the kernel library (seconds);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with the CPU tests' tolerances, and both timed
     (median over 20 runs, CUDA events);
  3. the whole path on a 480x640 synthetic pair, CPU (plain versions)
     against the card (kernels);
  4. the main path at 1920x1080: a 640x480 textured object warped into
     a synthetic scene by a known homography must be found, with its
     corners within 2 px, and every kernel must have launched; then the
     steady-state time per detect_object and the frames/s of bench.py's
     1080p pair step (two detect+describe, one match).

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Any
failure exits non-zero before it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

SCENE_HW = (1080, 1920)
OBJECT_HW = (480, 640)
PAIR_HW = (480, 640)
TIMING_RUNS = 20


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- inputs

def texture(h: int, w: int, seed: int, n_blobs: int, amp=(50.0, 120.0),
            block: int = 8, block_amp: float = 60.0) -> np.ndarray:
    """Synthetic gray image (float64, unclipped): a smooth field, Gaussian
    blobs of both polarities and scales, blocky texture and noise (the
    recipe of tests/conftest.py:small_image)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    for k in range(n_blobs):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        s = rng.uniform(1.2, 7.0)
        a = rng.uniform(*amp) * (1 if k % 2 == 0 else -1)
        r = int(4 * s) + 1
        y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
        x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
        img[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s * s))
    blocks = rng.uniform(-block_amp, block_amp,
                         (-(-h // block), -(-w // block)))
    img += np.kron(blocks, np.ones((block, block)))[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return img


def to_gray(img: np.ndarray) -> np.ndarray:
    """8-bit gray as the reference ingests it, as float32 0..255."""
    return np.clip(np.rint(img), 0, 255).astype(np.float32)


def object_homography(obj_hw, scene_hw) -> np.ndarray:
    """Object -> scene: 10 deg rotation, 0.8 scale, mild perspective,
    centred right of the scene's middle."""
    oh, ow = obj_hw
    sh, sw = scene_hw
    t0 = np.array([[1, 0, -ow / 2], [0, 1, -oh / 2], [0, 0, 1]], np.float64)
    a = math.radians(10.0)
    rs = 0.8 * np.array([[math.cos(a), -math.sin(a), 0],
                         [math.sin(a), math.cos(a), 0], [0, 0, 1 / 0.8]])
    persp = np.array([[1, 0, 0], [0, 1, 0], [1.5e-4, -1e-4, 1]], np.float64)
    t1 = np.array([[1, 0, sw * 0.58], [0, 1, sh * 0.5], [0, 0, 1]],
                  np.float64)
    h = t1 @ persp @ rs @ t0
    return h / h[2, 2]


def warp_into(scene: np.ndarray, obj: np.ndarray, h: np.ndarray) -> None:
    """Paste obj into scene through h (object -> scene), bilinear, in
    place, over the object's footprint."""
    oh, ow = obj.shape
    corners = project(np.array([[0, 0], [ow, 0], [ow, oh], [0, oh]],
                               np.float64), h)
    x0, y0 = np.floor(corners.min(0)).astype(int)
    x1, y1 = np.ceil(corners.max(0)).astype(int)
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    src = project(np.stack([xx.ravel(), yy.ravel()], 1), np.linalg.inv(h))
    sx, sy = src[:, 0], src[:, 1]
    inside = (sx >= 0) & (sx <= ow - 1) & (sy >= 0) & (sy <= oh - 1)
    sx, sy = sx[inside], sy[inside]
    ix, iy = np.minimum(sx.astype(int), ow - 2), np.minimum(sy.astype(int),
                                                            oh - 2)
    fx, fy = sx - ix, sy - iy
    val = (obj[iy, ix] * (1 - fx) * (1 - fy) + obj[iy, ix + 1] * fx * (1 - fy)
           + obj[iy + 1, ix] * (1 - fx) * fy + obj[iy + 1, ix + 1] * fx * fy)
    scene[yy.ravel()[inside].astype(int), xx.ravel()[inside].astype(int)] = val


def project(pts: np.ndarray, h: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ h.T
    return p[:, :2] / p[:, 2:3]


def full_size_inputs():
    """(scene, object, true corners) at 1920x1080 / 640x480."""
    obj = to_gray(texture(*OBJECT_HW, seed=7, n_blobs=400, block_amp=40.0))
    scene = texture(*SCENE_HW, seed=8, n_blobs=800, amp=(30.0, 90.0),
                    block=24, block_amp=20.0)
    h = object_homography(OBJECT_HW, SCENE_HW)
    warp_into(scene, obj.astype(np.float64), h)
    oh, ow = OBJECT_HW
    true = project(np.array([[0, 0], [ow, 0], [ow, oh], [0, oh]],
                            np.float64), h)
    return to_gray(scene), obj, true


def pair_inputs():
    """480x640 scene and a 320x400 crop of it (corners known)."""
    scene = to_gray(texture(*PAIR_HW, seed=3, n_blobs=350, block_amp=40.0))
    return scene, scene[80:400, 120:520].copy()


# ------------------------------------------------------------ comparison

def compare_detections(a, b, ratio: float) -> dict:
    """The tests/test_torch_pipeline.py comparison of two ObjectDetection
    results; returns its numbers, raises SmokeFailure on a miss."""
    from sift_tpu_torch.ops import match as tmatch
    out = {}
    for which in ("scene_kp", "object_kp"):
        ka, kb = (_kps(getattr(d, which)) for d in (a, b))
        na, nb = len(ka["x"]), len(kb["x"])
        check(na > 20, f"{which}: only {na} keypoints")
        check(abs(na - nb) <= 0.01 * na, f"{which}: counts {na} vs {nb}")
        other = {}
        for i in range(nb):
            other.setdefault(_key(kb, i), []).append((kb["x"][i], kb["y"][i]))
        hit = sum(any(abs(x - ka["x"][i]) < 1e-3 and abs(y - ka["y"][i]) < 1e-3
                      for x, y in other.get(_key(ka, i), ()))
                  for i in range(na))
        check(hit >= 0.99 * na, f"{which}: {hit}/{na} keypoints agree")
        out[which] = (na, nb, hit)
    rows = []
    for d in (a, b):
        d2 = tmatch.knn2_l1(d.object_desc, d.scene_desc, d.scene_kp.valid).d2
        rows.append(_good_rows(d, d2.cpu().numpy(), ratio))
    for mine, other in ((rows[0], rows[1]), (rows[1], rows[0])):
        for q, t, border in mine:
            found = any(_same(q, q2) and _same(t, t2) for q2, t2, _ in other)
            check(found or border, f"good match {q}->{t} only on one side")
    out["good"] = (len(rows[0]), len(rows[1]))
    check(bool(a.found) == bool(b.found), "found differs")
    err = float(np.abs(a.corners.cpu().numpy()
                       - b.corners.cpu().numpy()).max())
    check(err < 0.05, f"corners differ by {err} px")
    out["corner_diff_px"] = err
    return out


def _kps(kp):
    a = {f: getattr(kp, f).cpu().numpy()
         for f in ("octave", "layer", "r", "c", "x", "y", "angle", "valid")}
    return {f: v[a["valid"]] for f, v in a.items()}


def _key(k, i):
    return (k["octave"][i], k["layer"][i], k["r"][i], k["c"][i])


def _good_rows(det, d2, ratio):
    good = det.matches.good.cpu().numpy()
    tidx = det.matches.train_idx.cpu().numpy()
    d1 = det.matches.distance.cpu().numpy()
    border = np.abs(d1 - ratio * d2) < 1e-4
    q = {f: getattr(det.object_kp, f).cpu().numpy()
         for f in ("octave", "layer", "r", "c", "angle")}
    t = {f: getattr(det.scene_kp, f).cpu().numpy()
         for f in ("octave", "layer", "r", "c", "angle")}

    def ident(kp, i):
        return _key(kp, i) + (float(kp["angle"][i]),)

    return [(ident(q, i), ident(t, tidx[i]), bool(border[i]))
            for i in np.where(good)[0]]


def _same(a, b):
    da = abs(a[4] - b[4]) % 360.0
    return a[:4] == b[:4] and min(da, 360.0 - da) < 1e-2


# ----------------------------------------------------------------- phases

def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of fn() over `runs` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(scene_np: np.ndarray) -> list:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import conv, pyramid
    from sift_tpu_torch.ops.conv_cuda import blur_vh, blur_vh_plain
    from sift_tpu_torch.ops.extrema_cuda import (extrema_scores,
                                                 extrema_scores_plain)
    from sift_tpu_torch.ops.ori_gather_cuda import (gather_patches,
                                                    gather_patches_plain)
    from sift_tpu_torch.ops.match import mask_train
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda, knn2_l1_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(scene_np).to(dev)
    report = []

    def record(name, src, replaces, err, ms, plain_ms):
        report.append({"name": name, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": 0,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # K1 at 1080p, S=1 (base) and S=4 (octave 0)
    x = conv.zero_last_row_col(img)
    k1 = []
    for sig in ((cfg.init_blur_sigma,), cfg.scale_sigmas()[1:]):
        kmat, _ = conv.stack_kernels(sig)
        got, want = blur_vh(x, kmat), blur_vh_plain(x, kmat)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
              f"K1 S={len(sig)} disagrees with its plain version")
        err = float((got - want).abs().max())
        ms = median_ms(lambda: blur_vh(x, kmat))
        pms = median_ms(lambda: blur_vh_plain(x, kmat))
        k1.append((len(sig), err, ms, pms))
        print(f"phase 2 K1 blur 1080x1920 S={len(sig)}: max_abs_err={err!r} "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    record("K1 separable Gaussian blur", "sift_tpu_torch/csrc/blur.cu",
           "sift_tpu/ops/conv_pallas.py:92", max(e for _, e, _, _ in k1),
           k1[1][2], k1[1][3])

    # K2 on the (4, 1080, 1920) DoG of the synthetic frame
    octs = pyramid.build_gaussian_pyramid(img, cfg)
    dog = pyramid.build_dog_pyramid(octs)[0].contiguous()
    got, want = extrema_scores(dog, cfg), extrema_scores_plain(dog, cfg)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K2 is not bit-identical to its plain version")
    err = float((got - want).abs().max())
    ms = median_ms(lambda: extrema_scores(dog, cfg))
    pms = median_ms(lambda: extrema_scores_plain(dog, cfg))
    print(f"phase 2 K2 extrema {tuple(dog.shape)}: candidates="
          f"{int((got > 0).sum())} max_abs_err={err!r} kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms")
    record("K2 DoG extrema scores", "sift_tpu_torch/csrc/extrema.cu",
           "sift_tpu/ops/extrema_pallas.py:90", err, ms, pms)

    # K3: p=39 with N=1024 (orientation), p=85 with N=64 and N=1024
    k3 = []
    h, w = octs[0].shape[1:]
    for rad, n in ((cfg.ori_patch_radius, 1024), (cfg.descr_patch_radius, 64),
                   (cfg.descr_patch_radius, 1024)):
        p = 2 * rad + 3
        padded = torch.nn.functional.pad(octs[0][1:3], (rad + 1,) * 4)
        lay = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
        r = torch.from_numpy(rng.integers(-3, h + 3, n).astype(np.int32)).to(dev)
        c = torch.from_numpy(rng.integers(-3, w + 3, n).astype(np.int32)).to(dev)
        got = gather_patches(padded, lay, r, c, p)
        want = gather_patches_plain(padded, lay, r, c, p)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K3 p={p} N={n} is not bit-identical")
        ms = median_ms(lambda: gather_patches(padded, lay, r, c, p))
        pms = median_ms(lambda: gather_patches_plain(padded, lay, r, c, p))
        k3.append((p, n, ms, pms))
        print(f"phase 2 K3 gather p={p} N={n}: max_abs_err=0.0 kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms")
    record("K3 keypoint patch gather", "sift_tpu_torch/csrc/gather.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", 0.0, k3[1][2], k3[1][3])

    # K4 at 1536 x 1536 with sentinel rows and tied duplicates
    n = m = sum(cfg.out_caps)
    q = torch.from_numpy((rng.random((n, 128)) * 0.3).astype(np.float32))
    t = torch.from_numpy((rng.random((m, 128)) * 0.3).astype(np.float32))
    t[100:140] = t[0:40]
    q[0:40] = t[0:40]
    valid = torch.from_numpy(rng.random(m) > 0.2)
    q, t, valid = q.to(dev), t.to(dev), valid.to(dev)
    tm = mask_train(t, valid)
    gi, g1, g2 = knn2_l1_cuda(q, tm)
    wi, w1, w2 = knn2_l1_plain(q, tm)
    torch.cuda.synchronize()
    clear = (w2 - w1) > 1e-4
    check(torch.equal(gi[clear], wi[clear]), "K4 best index disagrees")
    check(torch.allclose(g1, w1, rtol=1e-6) and torch.allclose(g2, w2,
                                                               rtol=1e-6),
          "K4 distances disagree")
    err = float(torch.maximum((g1 - w1).abs().max(), (g2 - w2).abs().max()))
    ms = median_ms(lambda: knn2_l1_cuda(q, tm))
    pms = median_ms(lambda: knn2_l1_plain(q, tm))
    print(f"phase 2 K4 top-2 L1 {n}x{m}: idx equal on {int(clear.sum())}/{n} "
          f"clear rows, max_abs_err={err!r} kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms")
    record("K4 top-2 L1 matcher", "sift_tpu_torch/csrc/knn2.cu",
           "sift_tpu/ops/match_pallas.py:83", err, ms, pms)
    return report


def phase_cpu_vs_card():
    """Phase 3: the whole path, plain versions on the CPU vs kernels."""
    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.pipeline import detect_object
    scene, obj = pair_inputs()
    t0 = time.perf_counter()
    on_cpu = detect_object(torch.from_numpy(scene), torch.from_numpy(obj), cfg)
    t_cpu = time.perf_counter() - t0
    on_card = detect_object(torch.from_numpy(scene).cuda(),
                            torch.from_numpy(obj).cuda(), cfg)
    torch.cuda.synchronize()
    res = compare_detections(on_cpu, on_card, cfg.match_ratio)
    check(bool(on_card.found), "480x640 pair: object not found")
    print(f"phase 3 cpu-vs-card 480x640 pair: keypoints (cpu, card, agree) "
          f"scene={res['scene_kp']} object={res['object_kp']} "
          f"good={res['good']} corner_diff_px={res['corner_diff_px']!r} "
          f"(cpu run {t_cpu:.1f} s)")


def phase_main_path(scene_np, obj_np, true_corners, report) -> None:
    """Phase 4: the main path at full size, with launch counts."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import match as match_mod
    from sift_tpu_torch.ops.conv_cuda import blur_vh
    from sift_tpu_torch.ops.extrema_cuda import extrema_scores
    from sift_tpu_torch.ops.ori_gather_cuda import gather_patches
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda
    from sift_tpu_torch.pipeline import detect_object

    wrappers = (blur_vh, extrema_scores, gather_patches, knn2_l1_cuda)
    scene = torch.from_numpy(scene_np).cuda()
    obj = torch.from_numpy(obj_np).cuda()
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    det = detect_object(scene, obj, cfg)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in wrappers]
    for entry, nl in zip(report, counts):
        entry["launches"] = nl
    check(all(nl > 0 for nl in counts),
          f"a kernel did not launch on the main path: {counts}")
    corners = det.corners.cpu().numpy()
    cerr = float(np.abs(corners - true_corners).max())
    n_s, n_o = int(det.scene_kp.count()), int(det.object_kp.count())
    n_good, n_inl = int(det.matches.good.sum()), int(det.n_inliers)
    sat = [sift.octave_saturation(k, cfg).cpu().numpy().astype(int).tolist()
           for k in (det.scene_kp, det.object_kp)]
    print(f"phase 4 main path 1080x1920 scene / 480x640 object: launches "
          f"K1..K4={counts} scene_kp={n_s} object_kp={n_o} good={n_good} "
          f"inliers={n_inl} found={bool(det.found)} "
          f"corner_err_px={cerr!r} out_cap_saturated(scene, object)={sat}")
    check(bool(det.found), "object not found at 1080p")
    check(cerr < 2.0, f"corners {cerr} px from the truth")

    ms = _median_wall_ms(lambda: detect_object(scene, obj, cfg))
    f1 = torch.roll(scene, 37, dims=1)

    def pair_step():
        kp0, d0 = sift.detect_and_compute(scene, cfg)
        kp1, d1 = sift.detect_and_compute(f1, cfg)
        return match_mod.match_ratio(d1, d0, q_valid=kp1.valid,
                                     t_valid=kp0.valid, ratio=cfg.match_ratio)

    pair_ms = _median_wall_ms(pair_step)
    print(f"phase 4 timing: detect_object {ms:.3f} ms (median of 10), "
          f"1080p pair step {pair_ms:.3f} ms = "
          f"{2000.0 / pair_ms:.3f} frames/s")


def _median_wall_ms(fn, runs: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 0 env: python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} devices "
          f"{torch.cuda.device_count()}")
    print(card)

    from sift_tpu_torch import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(lib.parents[3])}")

    scene, obj, true = full_size_inputs()
    report = phase_kernels(scene)
    phase_cpu_vs_card()
    phase_main_path(scene, obj, true, report)

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
