#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sift_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from
sift_tpu_torch/csrc, then runs, one line per phase:

  0. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off, so the plain versions are full-float32 references;
  1. build of the kernel library (seconds);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with the CPU tests' tolerances, and both timed
     (median over 20 runs, CUDA events) beside the least time the card
     could take (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s,
     the larger) and, for K1 and K1-batch, one cuDNN convolution that
     computes the same blur (no single PyTorch call computes the other
     kernels' functions); K1-batch and K2-batch at B = 8 1080p frames, each frame
     also equal to the single-frame kernel; K3-ori and K3-desc on octave
     0 of the 1080p scene with its real keypoints plus slots whose
     windows start outside the image, within rtol 1e-5 and
     atol 1e-5 * max|hist| per row of their plain versions on valid rows
     (the sums only run in another order), and bit-identical across two
     launches;
  3. the whole path on a 480x640 synthetic pair, CPU (plain versions)
     against the card (kernels);
  4. the main path at 1920x1080: a 640x480 textured object warped into
     a synthetic scene by a known homography must be found, with its
     corners within 2 px; K1, K2 and K4 must have launched, K3-ori and
     K3-desc once per usable octave of each frame, and the bare gather
     K3 not at all; then the steady-state time per detect_object and the
     frames/s of bench.py's 1080p pair step (two detect+describe, one
     match);
  5. the throughput path at 1080p, B = 8 (frame i is the scene rolled by
     17 i columns): bench.py's batch step, detect_and_compute_batch plus
     7 consecutive-frame matches, must launch K1-batch, K2-batch, K4,
     and K3-ori and K3-desc once per usable octave of each frame, and
     not the single-frame K1 and K2; every row of the batch must equal
     detect_and_compute on its frame; then its frames/s and peak device
     memory.

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
BATCH = 8
ROLL_STEP = 17       # columns between consecutive frames (bench.py:493)
TIMING_RUNS = 20
EXTRA_SLOTS = 64     # phase-2 K3-ori/K3-desc slots starting outside the image
KERNELS = ("K1", "K1-batch", "K2", "K2-batch", "K3", "K3-ori", "K3-desc",
           "K4")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# float32 operations per binned sample, counted in csrc/ori_hist.cu and
# csrc/descr_hist.cu (expf, sqrtf and a division counted as one each)
ORI_OPS_PER_SAMPLE = 26
DESC_OPS_PER_SAMPLE = 70


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


def batch_frames(scene):
    """(BATCH, H, W): frame i is the scene rolled by ROLL_STEP * i
    columns."""
    import torch
    return torch.stack([torch.roll(scene, ROLL_STEP * i, dims=1)
                        for i in range(BATCH)])


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes at the HBM rate and the float32 operations at the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blur_bound(x_shape, kmat) -> tuple:
    """K1 (and K1-batch): read the frames, write S planes each; two
    passes of one multiply and one add per nonzero tap and output."""
    pix = float(np.prod(x_shape))
    s = kmat.shape[0]
    return bound_ms(4 * pix * (1 + s),
                    2 * pix * 2 * float(np.count_nonzero(kmat)))


def blur_library(x, kmat):
    """One PyTorch call computing K1's function: a cuDNN convolution of
    each frame with the S outer-product 2-D taps, zero padded; the
    yardstick library_ms (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    taps = np.einsum("si,sj->sij", kmat, kmat).astype(np.float32)
    weight = torch.from_numpy(taps)[:, None].to(x.device)
    frames = x.reshape(-1, 1, *x.shape[-2:])
    return lambda: F.conv2d(frames, weight,
                            padding=kmat.shape[1] // 2).reshape(
        *x.shape[:-2], len(kmat), *x.shape[-2:])


def window_bound(shape, p: int, rad: int, layer, r, c, radius, keep,
                 n_in: int, n_out: int, ops_per_sample: int) -> tuple:
    """K3-ori / K3-desc: the stack pixels the kept keypoints' windows
    reach (each read once), n_in bytes of keypoint arguments, n_out bytes
    of histograms; ops_per_sample for every sample of each box."""
    nlay, hp, wp = shape
    touched = np.zeros(shape, bool)
    boxes = np.minimum(radius, rad)
    keep = keep & (boxes >= 0)
    lay = np.clip(layer, 0, nlay - 1)
    rs = np.clip(r, 0, hp - p) + rad - boxes
    cs = np.clip(c, 0, wp - p) + rad - boxes
    for k in np.nonzero(keep)[0]:
        span = 2 * boxes[k] + 3
        touched[lay[k], rs[k]:rs[k] + span, cs[k]:cs[k] + span] = True
    samples = float(((2 * boxes[keep] + 1) ** 2).sum())
    return bound_ms(4.0 * touched.sum() + n_in + n_out,
                    ops_per_sample * samples)


def phase_kernels(scene_np: np.ndarray) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import conv, pyramid
    from sift_tpu_torch.ops.conv_cuda import (blur_vh, blur_vh_batch,
                                              blur_vh_batch_plain,
                                              blur_vh_plain)
    from sift_tpu_torch.ops.extrema_cuda import (extrema_scores,
                                                 extrema_scores_batch,
                                                 extrema_scores_batch_plain,
                                                 extrema_scores_plain)
    from sift_tpu_torch.ops.ori_gather_cuda import (gather_patches,
                                                    gather_patches_plain)
    from sift_tpu_torch.ops.match import mask_train
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda, knn2_l1_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(scene_np).to(dev)
    frames = batch_frames(img)
    report = {}

    def record(key, name, src, replaces, err, ms, plain_ms, bound,
               library_ms=None):
        report[key] = {"name": name, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": 0,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": library_ms}

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
        lib = blur_library(x, kmat)
        lerr = float((lib() - want).abs().max())
        ms = median_ms(lambda: blur_vh(x, kmat))
        pms = median_ms(lambda: blur_vh_plain(x, kmat))
        lms = median_ms(lib)
        bnd = blur_bound(x.shape, kmat)
        k1.append((len(sig), err, ms, pms, bnd, lms))
        print(f"phase 2 K1 blur 1080x1920 S={len(sig)}: max_abs_err={err!r} "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), library conv2d {lms:.4f} ms "
              f"(max diff from plain {lerr!r})")
    record("K1", "K1 separable Gaussian blur", "sift_tpu_torch/csrc/blur.cu",
           "sift_tpu/ops/conv_pallas.py:92", max(e[1] for e in k1),
           *k1[1][2:])

    # K1-batch on 8 frames at 1080p, S=1 and S=4; each frame must also be
    # the single-frame K1 on it, bit for bit
    xb = conv.zero_last_row_col(frames)
    k1b = []
    for sig in ((cfg.init_blur_sigma,), cfg.scale_sigmas()[1:]):
        kmat, _ = conv.stack_kernels(sig)
        got, want = blur_vh_batch(xb, kmat), blur_vh_batch_plain(xb, kmat)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
              f"K1-batch S={len(sig)} disagrees with its plain version")
        check(all(torch.equal(got[b], blur_vh(xb[b], kmat))
                  for b in range(BATCH)),
              f"K1-batch S={len(sig)}: a frame differs from K1 on it")
        err = float((got - want).abs().max())
        lib = blur_library(xb, kmat)
        lerr = float((lib() - want).abs().max())
        del got, want
        ms = median_ms(lambda: blur_vh_batch(xb, kmat))
        pms = median_ms(lambda: blur_vh_batch_plain(xb, kmat))
        lms = median_ms(lib)
        bnd = blur_bound(xb.shape, kmat)
        k1b.append((len(sig), err, ms, pms, bnd, lms))
        print(f"phase 2 K1-batch blur {tuple(xb.shape)} S={len(sig)}: "
              f"max_abs_err={err!r} (each frame equals K1) kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), library conv2d {lms:.4f} ms (max diff from "
              f"plain {lerr!r})")
    record("K1-batch", "K1-batch separable Gaussian blur, B frames",
           "sift_tpu_torch/csrc/blur.cu", "sift_tpu/ops/conv_pallas.py:173",
           max(e[1] for e in k1b), *k1b[1][2:])

    # K2 on the (4, 1080, 1920) DoG of the synthetic frame: read the DoG,
    # write nL score planes; a threshold test and 26 neighbour tests per
    # score
    octs = pyramid.build_gaussian_pyramid(img, cfg)
    dogs = pyramid.build_dog_pyramid(octs)
    dog = dogs[0].contiguous()
    nl = cfg.n_octave_layers
    got, want = extrema_scores(dog, cfg), extrema_scores_plain(dog, cfg)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K2 is not bit-identical to its plain version")
    err = float((got - want).abs().max())
    ms = median_ms(lambda: extrema_scores(dog, cfg))
    pms = median_ms(lambda: extrema_scores_plain(dog, cfg))
    plane = dog.shape[1] * dog.shape[2]
    bnd = bound_ms(4.0 * plane * (dog.shape[0] + nl), 27.0 * nl * plane)
    print(f"phase 2 K2 extrema {tuple(dog.shape)}: candidates="
          f"{int((got > 0).sum())} max_abs_err={err!r} kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K2", "K2 DoG extrema scores", "sift_tpu_torch/csrc/extrema.cu",
           "sift_tpu/ops/extrema_pallas.py:90", err, ms, pms, bnd)

    # K2-batch on the (8, 4, 1080, 1920) DoG of the eight frames
    dogb = pyramid.build_dog_pyramid_batch(
        pyramid.build_gaussian_pyramid_batch(frames, cfg))[0].contiguous()
    got = extrema_scores_batch(dogb, cfg)
    want = extrema_scores_batch_plain(dogb, cfg)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          "K2-batch is not bit-identical to its plain version")
    check(all(torch.equal(got[b], extrema_scores(dogb[b], cfg))
              for b in range(BATCH)), "K2-batch: a frame differs from K2")
    err = float((got - want).abs().max())
    ncand = [int((got[b] > 0).sum()) for b in range(BATCH)]
    del got, want
    ms = median_ms(lambda: extrema_scores_batch(dogb, cfg))
    pms = median_ms(lambda: extrema_scores_batch_plain(dogb, cfg))
    bnd = bound_ms(4.0 * BATCH * plane * (dogb.shape[1] + nl),
                   27.0 * BATCH * nl * plane)
    print(f"phase 2 K2-batch extrema {tuple(dogb.shape)}: candidates per "
          f"frame={ncand} max_abs_err={err!r} (each frame equals K2) kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    record("K2-batch", "K2-batch DoG extrema scores, B frames",
           "sift_tpu_torch/csrc/extrema.cu",
           "sift_tpu/ops/extrema_pallas.py:167", err, ms, pms, bnd)
    del dogb, xb

    # K3: p=39 with N=1024 (orientation), p=85 with N=64 and N=1024; a
    # copy: each window read once and written once
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
        bnd = bound_ms(2.0 * 4 * n * p * p + 12 * n, 0.0)
        k3.append((p, n, ms, pms, bnd))
        print(f"phase 2 K3 gather p={p} N={n}: max_abs_err=0.0 kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
    record("K3", "K3 keypoint patch gather", "sift_tpu_torch/csrc/gather.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", 0.0, k3[1][2], k3[1][3],
           k3[1][4])

    # K3-ori and K3-desc on octave 0 of the scene
    kp = sift.detect_octave(octs[0], dogs[0], 0, cfg.detect_caps[0], cfg,
                            cfg.out_caps[0])
    phase_fused_hist(octs[0], kp, rng, record)

    # K4 at 1536 x 1536 with sentinel rows and tied duplicates; one
    # subtraction and one absolute add per pair and dimension
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
    bnd = bound_ms(4.0 * (n + m) * 128 + 12 * n, 2.0 * n * m * 128)
    print(f"phase 2 K4 top-2 L1 {n}x{m}: idx equal on {int(clear.sum())}/{n} "
          f"clear rows, max_abs_err={err!r} kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K4", "K4 top-2 L1 matcher", "sift_tpu_torch/csrc/knn2.cu",
           "sift_tpu/ops/match_pallas.py:83", err, ms, pms, bnd)
    return report


def phase_fused_hist(gauss, kp, rng, record) -> None:
    """Phase 2, K3-ori and K3-desc: the octave-0 stack of the scene with
    its real keypoints (N = out_caps[0] slots) plus EXTRA_SLOTS valid
    slots whose windows start outside the image (the starts clamp)."""
    import torch
    import torch.nn.functional as F
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops.descriptor import descriptor_params
    from sift_tpu_torch.ops.descr_hist_cuda import (descriptor_hist,
                                                    descriptor_hist_plain)
    from sift_tpu_torch.ops.orientation import orientation_params
    from sift_tpu_torch.ops.ori_hist_cuda import (orientation_hist,
                                                  orientation_hist_plain)

    dev = gauss.device
    nl = cfg.n_octave_layers
    h, w = gauss.shape[1:]
    n_real = kp.capacity
    real = torch.nonzero(kp.valid).flatten().cpu().numpy()
    check(len(real) > 100, f"only {len(real)} valid octave-0 keypoints")
    pick = torch.from_numpy(rng.choice(real, EXTRA_SLOTS)).to(dev)
    e = EXTRA_SLOTS
    above = rng.random(e) < 0.5
    xr = np.where(above, rng.integers(-60, 0, e), rng.integers(h, h + 60, e))

    def slots(a, extra):
        return torch.cat([a, torch.as_tensor(extra, dtype=a.dtype,
                                             device=dev)])

    layer = slots(kp.layer, rng.integers(0, nl + 2, e))   # stack index -1..nl
    r = slots(kp.r, xr)
    c = slots(kp.c, rng.integers(-60, w + 60, e))
    size = slots(kp.size, kp.size[pick])
    angle = slots(kp.angle, kp.angle[pick])
    valid = slots(kp.valid, np.ones(e, bool))

    def compare(name, got, want, rows):
        g = got[rows].reshape(int(rows.sum()), -1)
        x = want[rows].reshape(g.shape)
        atol = 1e-5 * x.abs().amax(dim=1, keepdim=True)
        check(bool(((g - x).abs() <= 1e-5 * x.abs() + atol).all()),
              f"{name} disagrees with its plain version")
        return float((g - x).abs().max())

    def host(*ts):
        return [t.cpu().numpy() for t in ts]

    # K3-ori on every slot, as the main path runs it (octave 0: the
    # octave scale is half the size)
    rp = cfg.ori_patch_radius
    po = F.pad(gauss[1:1 + nl], (rp + 1,) * 4)
    radius, expf_scale = orientation_params(size * 0.5, cfg)
    args = (po, layer - 1, r, c, radius, expf_scale, cfg)
    got = orientation_hist(*args)
    again = orientation_hist(*args)
    want = orientation_hist_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "K3-ori: two launches differ")
    err = compare("K3-ori", got, want, valid)
    real_args = tuple(a[:n_real] if torch.is_tensor(a) and a.dim() == 1
                      else a for a in args)
    ms = median_ms(lambda: orientation_hist(*real_args))
    pms = median_ms(lambda: orientation_hist_plain(*real_args))
    lay, rr, cc, rad = host(layer[:n_real] - 1, r[:n_real], c[:n_real],
                            radius[:n_real])
    bnd = window_bound(tuple(po.shape), 2 * rp + 3, rp, lay, rr, cc, rad,
                       np.ones(n_real, bool), 20 * n_real, 4 * 36 * n_real,
                       ORI_OPS_PER_SAMPLE)
    print(f"phase 2 K3-ori orientation histograms p={2 * rp + 3} "
          f"N={n_real}+{e} (valid {int(valid.sum())}): max_abs_err={err!r} "
          f"(two launches bit-identical) kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms at N={n_real}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K3-ori", "K3-ori fused window gather + orientation histogram",
           "sift_tpu_torch/csrc/ori_hist.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", err, ms, pms, bnd)

    # K3-desc
    rd = cfg.descr_patch_radius
    pd = F.pad(gauss[1:1 + nl], (rd + 1,) * 4)
    prm = descriptor_params(size, angle, torch.ones(1, device=dev), (h, w),
                            cfg)
    args = (pd, layer - 1, r, c, prm.cos_t, prm.sin_t, prm.radius, prm.ori,
            valid, cfg)
    got = descriptor_hist(*args)
    again = descriptor_hist(*args)
    want = descriptor_hist_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "K3-desc: two launches differ")
    check(bool((got[~valid] == 0).all() and (want[~valid] == 0).all()),
          "K3-desc: a slot with valid false is not zero")
    err = compare("K3-desc", got, want, valid)
    real_args = tuple(a[:n_real] if torch.is_tensor(a) and a.dim() == 1
                      else a for a in args)
    ms = median_ms(lambda: descriptor_hist(*real_args))
    pms = median_ms(lambda: descriptor_hist_plain(*real_args))
    lay, rr, cc, rad, keep = host(layer[:n_real] - 1, r[:n_real], c[:n_real],
                                  prm.radius[:n_real], valid[:n_real])
    bnd = window_bound(tuple(pd.shape), 2 * rd + 3, rd, lay, rr, cc, rad,
                       keep, 29 * n_real, 4 * 360 * n_real,
                       DESC_OPS_PER_SAMPLE)
    print(f"phase 2 K3-desc descriptor histograms p={2 * rd + 3} "
          f"N={n_real}+{e} (valid {int(valid.sum())}): max_abs_err={err!r} "
          f"(two launches bit-identical) kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms at N={n_real}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K3-desc", "K3-desc fused window gather + descriptor histogram",
           "sift_tpu_torch/csrc/descr_hist.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", err, ms, pms, bnd)


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


def wrappers() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from sift_tpu_torch.ops.conv_cuda import blur_vh, blur_vh_batch
    from sift_tpu_torch.ops.extrema_cuda import (extrema_scores,
                                                 extrema_scores_batch)
    from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist
    from sift_tpu_torch.ops.ori_gather_cuda import gather_patches
    from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda
    return {"K1": blur_vh, "K1-batch": blur_vh_batch, "K2": extrema_scores,
            "K2-batch": extrema_scores_batch, "K3": gather_patches,
            "K3-ori": orientation_hist, "K3-desc": descriptor_hist,
            "K4": knn2_l1_cuda}


def usable_octaves(hw) -> int:
    """How many octaves of an (H, W) frame detect_and_compute runs:
    K3-ori and K3-desc launch once for each."""
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    h, w = hw
    return sum(sift._octave_usable((h >> o, w >> o), cfg)
               for o in range(cfg.n_octaves))


def counted(fn):
    """Run fn() with every launch count set to 0 just before it; return
    (its result, the counts read just after it)."""
    import torch
    torch.cuda.synchronize()
    for w in wrappers().values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers().items()}


def phase_main_path(scene_np, obj_np, true_corners, report) -> float:
    """Phase 4: the main path at full size, with launch counts; returns
    the pair step's frames/s."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import match as match_mod
    from sift_tpu_torch.pipeline import detect_object

    scene = torch.from_numpy(scene_np).cuda()
    obj = torch.from_numpy(obj_np).cuda()
    det, launches = counted(lambda: detect_object(scene, obj, cfg))
    path = ("K1", "K2", "K3-ori", "K3-desc", "K4")
    counts = [launches[k] for k in path]
    for k in path + ("K3",):
        report[k]["launches"] = launches[k]
    check(all(nl > 0 for nl in counts),
          f"a kernel did not launch on the main path: {counts}")
    per_frame = usable_octaves(scene_np.shape) + usable_octaves(obj_np.shape)
    check(launches["K3-ori"] == per_frame and launches["K3-desc"] == per_frame,
          f"K3-ori/K3-desc launched {launches['K3-ori']}/"
          f"{launches['K3-desc']} times, not once per usable octave "
          f"({per_frame})")
    check(launches["K3"] == 0,
          f"the bare gather K3 launched {launches['K3']} times")
    corners = det.corners.cpu().numpy()
    cerr = float(np.abs(corners - true_corners).max())
    n_s, n_o = int(det.scene_kp.count()), int(det.object_kp.count())
    n_good, n_inl = int(det.matches.good.sum()), int(det.n_inliers)
    sat = [sift.octave_saturation(k, cfg).cpu().numpy().astype(int).tolist()
           for k in (det.scene_kp, det.object_kp)]
    print(f"phase 4 main path 1080x1920 scene / 480x640 object: launches "
          f"{dict(zip(path, counts))} gather K3={launches['K3']} "
          f"scene_kp={n_s} object_kp={n_o} good={n_good} "
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
    return 2000.0 / pair_ms


def phase_batch(scene_np, report, pair_fps: float) -> None:
    """Phase 5: the throughput path, detect_and_compute_batch on BATCH
    1080p frames and the BATCH - 1 consecutive-frame matches (bench.py's
    batch step, bench.py:511-519), with launch counts; each row against
    detect_and_compute on its frame; frames/s and peak memory."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import match as match_mod

    frames = batch_frames(torch.from_numpy(scene_np).cuda())

    def batch_step():
        kp, d = sift.detect_and_compute_batch(frames, cfg)
        ms = [match_mod.match_ratio(d[b], d[b - 1], q_valid=kp.valid[b],
                                    t_valid=kp.valid[b - 1],
                                    ratio=cfg.match_ratio)
              for b in range(1, BATCH)]
        return kp, d, ms

    (kp, d, ms), launches = counted(batch_step)
    for k in ("K1-batch", "K2-batch"):
        report[k]["launches"] = launches[k]
    check(all(launches[k] > 0 for k in ("K1-batch", "K2-batch", "K3-ori",
                                        "K3-desc", "K4")),
          f"a kernel of the batch path did not launch: {launches}")
    check(launches["K1"] == 0 and launches["K2"] == 0 and launches["K3"] == 0,
          f"the batch path launched a single-frame kernel: {launches}")
    per_step = BATCH * usable_octaves(scene_np.shape)
    check(launches["K3-ori"] == per_step and launches["K3-desc"] == per_step,
          f"batch step: K3-ori/K3-desc launched {launches['K3-ori']}/"
          f"{launches['K3-desc']} times, not {per_step}")
    n = sum(cfg.out_caps)
    check(tuple(kp.x.shape) == (BATCH, n)
          and tuple(d.shape) == (BATCH, n, cfg.descr_size),
          f"batch shapes {tuple(kp.x.shape)} {tuple(d.shape)}")
    check(bool(torch.isfinite(d).all()) and all(
        bool(torch.isfinite(getattr(kp, f)).all())
        for f in ("x", "y", "size", "angle", "response")),
        "non-finite batch output")
    n_good = [int(m.good.sum()) for m in ms]
    check(min(n_good) > 20, f"too few consecutive-frame matches: {n_good}")

    # every row equals detect_and_compute on its frame: valid and integer
    # fields exactly, float fields within 1e-4 and descriptors within 1e-3
    # (tests/test_batch.py's bounds)
    fmax = dmax = 0.0
    counts = []
    for b in range(BATCH):
        k1, d1 = sift.detect_and_compute(frames[b], cfg)
        kb = kp.frame(b)
        check(torch.equal(kb.valid, k1.valid), f"frame {b}: valid differs")
        for f in ("octave", "layer", "r", "c"):
            check(torch.equal(getattr(kb, f), getattr(k1, f)),
                  f"frame {b}: {f} differs")
        v = k1.valid
        for f in ("x", "y", "size", "angle", "response"):
            fmax = max(fmax, float((getattr(kb, f)[v] - getattr(k1, f)[v])
                                   .abs().max()))
        dmax = max(dmax, float((d[b][v] - d1[v]).abs().max()))
        counts.append(int(k1.count()))
    check(fmax <= 1e-4 and dmax <= 1e-3,
          f"batch rows differ from single frames: fields {fmax}, "
          f"descriptors {dmax}")
    print(f"phase 5 batch path {tuple(frames.shape)}: launches "
          f"{ {k: launches[k] for k in KERNELS} } keypoints per "
          f"frame={counts} good matches={n_good} "
          f"rows vs single frames: max field diff={fmax!r} max descriptor "
          f"diff={dmax!r}")
    del kp, d, ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_wall_ms(batch_step)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5 timing: batch step (detect_and_compute_batch B={BATCH} "
          f"+ {BATCH - 1} matches) {step_ms:.3f} ms (median of 10) = "
          f"{BATCH * 1000.0 / step_ms:.3f} frames/s, pair step "
          f"{pair_fps:.3f} frames/s; peak device memory "
          f"{peak / 2**30:.3f} GiB")


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
    pair_fps = phase_main_path(scene, obj, true, report)
    phase_batch(scene, report, pair_fps)

    print(json.dumps({"kernels": [report[k] for k in KERNELS]}))
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
