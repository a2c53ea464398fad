#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sift_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from
sift_tpu_torch/csrc, then runs, one line per phase:

  0. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off, so the plain versions are full-float32 references;
  1. build of the kernel library (seconds);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, and both timed (median device time over 20
     runs, CUDA events, each run queued behind a spin kernel that hides
     the host's launch overhead) beside the least time the card could
     take (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, the
     larger; K4's and K3-ori's and K3-desc's operations, which have no
     FMA form, at the 33.5 T/s issue rate) and, for K1 and K1-batch, one
     cuDNN
     convolution that computes the same blur (no single PyTorch call
     computes the other kernels' functions); K1, K1-batch, K2, K2-batch,
     K3 and K4 bit for bit (torch.equal), K1 at every shape
     detect_object launches it and K1-batch at every shape of the B = 8
     batch step, with their sums per detect_object and per batch step;
     K1-batch and K2-batch at B = 8 1080p frames, each frame also equal
     to the single-frame kernel; K1 and K1-batch also at widths that are
     not a multiple of 4 and on an input 4 bytes off a 16-byte boundary;
     K4 with tied duplicate rows in different train splits, and also on
     rows 4 bytes off, at ragged N and M, M = 1 and M = 0; K4 over the
     batch step's 7 pairs in one launch, (7, 1536, 128) x (7, 1536, 128),
     against its batched plain version, the single launch on each pair
     and a second launch, bit for bit, timed beside 7 single launches;
     K3 at p = 39, N = 1024 and p = 85, N = 64 and 1024, each time
     beside its launch floor (an empty kernel of its launch shape), and
     on edge cases: p = 1, p = Wp, p = 129, N = 1, N = 0, N = 8192, the
     1958-wide stack, a source 4 bytes off a 16-byte boundary, starts
     past every edge of the stack;
     K3-ori and K3-desc on octave
     0 of the 1080p scene with its real keypoints plus slots whose
     windows start outside the image, within rtol 1e-5 and
     atol 1e-5 * max|hist| per row of their plain versions on valid rows
     (the plain versions sum floats in another order, the kernels
     integers), and bit-identical across two launches; the first 64 of
     those slots in a launch of their own (each keypoint split across a
     cluster of CTAs) at the same bounds, bit-identical across two
     launches and bit for bit the same keypoints' rows of the larger
     launch, and timed; K3-ori and K3-desc also over the batch step's 8
     frames in
     one launch each (8 x 2 stacked planes of 1080 + pad x 1920 + pad,
     each frame's real keypoints plus slots starting outside the image
     and invalid slots at stack layer -1, which in frames >= 1 must
     clamp inside their own frame), against their plain versions at the
     same bounds and, frame by frame, equal to the single-frame launch,
     and frame 0's first 64 slots alone bit for bit their rows of the
     batched launch and of frame 0's single-frame launch; K3-desc again
     under sift_tpu's default bf16 arm (descr_rc_bf16) on the same slots,
     one frame and B = 8, at the same bounds, timed beside the f32 arm;
     K3-ori and K3-desc (both arms) on a 0/255 checkerboard of 2x2
     squares at the largest radius, where every sample adds the largest
     magnitude, at N = 64 and N = 1024 against their plain versions at
     the same bounds, the 64 rows bit for bit the larger launch's;
     K2's compact scan and the select kernel, as
     top_candidates and top_candidates_batch launch them, under
     torch.equal against top_candidates_plain (the stable sort of the
     dense scores) on all four outputs at every octave of detect_object
     and of the batch step (each row also the single-frame call), on a
     plateau with far more candidates than the cap, at cap = n - 1, n,
     n + 1, width 1917, an input 4 bytes off and a 48x24 octave whose
     gap slots pass the border rows; each of the two kernels against its
     own plain version; all route calls again with torch.sort removed
     and torch.cuda.set_sync_debug_mode("error"); both kernels timed at
     every octave, with sums per detect_object and per batch step; the
     refine kernel against refine_candidates_plain, bit for bit in all
     eight fields of every slot (floats by their bits), at every usable
     octave of detect_object and of the B = 8 batch step on the
     benchmark's seeded inputs (benchmark/inputs/recipes.py), each batch
     frame also equal to the single-frame launch, two launches equal, on
     a row band viewed out of octave 0 (not contiguous) and on the
     planted cubes of tests/test_torch_refine_kernel.py, timed at every
     octave beside its launch floor and byte bound (the plain version at
     octave 0, B = 1 and B = 8);
  3. the whole path on a 480x640 synthetic pair, CPU (plain versions)
     against the card (kernels);
  4. the main path at 1920x1080: a 640x480 textured object warped into
     a synthetic scene by a known homography must be found, with its
     corners within 2 px; K1 and K4 must have launched, the compact scan,
     the select kernel, refine, K3-ori and K3-desc once per usable
     octave of each frame, and the dense K2 and the bare gather K3 not
     at all; the same path under the bf16 descriptor arm: keypoints equal, 99 % of
     the descriptor rows within 2e-2 L1 of the f32 run's and every row
     within 5e-2, corners within 2 px; then the steady-state time per detect_object and the
     frames/s of bench.py's 1080p pair step (two detect+describe, one
     match);
  5. the throughput path at 1080p, B = 8 (frame i is the scene rolled by
     17 i columns): bench.py's batch step, detect_and_compute_batch plus
     the 7 consecutive-frame matches in one batched match_ratio, must
     launch K1-batch, K4 once, the compact scan, the select kernel,
     refine, K3-ori and K3-desc once per usable octave for all 8 frames,
     and not
     the single-frame K1, the dense K2 or K2-batch; every row of the
     batch must equal detect_and_compute on its frame, and each pair's
     matches match_ratio on that pair (train_idx, good, distance bit for
     bit); then its frames/s and peak device memory;
  6. the mapping path (sfm.mapping.run_mapping: detect + describe per
     frame, sequential K4 matches, incremental SfM, loop closures, pose
     graph, closure-aware BA, export), rendered by the port's cv2-free
     renderer from four synthetic 480x640 textures (fixed seeds):
     6a at eval_mapping's gated configuration, 16 frames of 240x320 on
     the card, must meet the four mapping gates of sift_tpu_torch.eval
     (registered >= 0.9 F, >= 1 closure, ate_final <= 0.07, reproj_rmse
     <= 4e-3) and write both export files, with the compact scan, the
     select, refine, K3-ori and K3-desc launched once per usable octave
     of each frame, K4 once per sequential pair (42) and K1-batch, the dense
     K2/K2-batch and the bare gather K3 never; 6b runs tests/
     test_mapping.py's 10 frames of 200x268 on the CPU (plain versions)
     and on the card with one shared RANSAC sampler (a seeded CPU
     torch.Generator): equal registered frames and closure pairs,
     ate_final and reproj_rmse within 10 % relative; 6c runs the CLI's
     frame size, 24 frames of 480x640, on the card (>= 90 % registered,
     a closure), then prints the wall time of one call after a
     warm-up by stage (front end, reconstruct, loop closure + pose
     graph, final BA) and the device busy time, device events and
     largest device kernels of one call (torch.profiler); 6d runs 6c's
     sequence cold, warm and eagerly: the CUDA graphs of the RANSACs'
     stretches and of BA's LM iterations give the eager map bit for bit;
  7. the multi-device layer (sift_tpu_torch.parallel), each entry with
     its launch counts and its median wall time of 3 calls after a
     warm-up: 7a world 1 on NCCL in this process -- the B = 8 1080p
     frames (equal to detect_and_compute_batch), both sharded matchers
     on the 7 consecutive pairs (equal to match_ratio), observation- and
     point-sharded BA on SCALING.json's 64 cameras / 4096 points / 65,536
     observations, 3 LM x 10 CG (RMSE falls; RMSE, cameras and points
     within BA_RMSE_RTOL / BA_CAM_ATOL / BA_PT_ATOL of bundle_adjust's),
     the tiled detector on one 2160x3840 frame
     (tiled_octaves 2, halo 64; the keypoint set equals
     detect_and_compute's, no octave saturated), the partitioned pose
     graph (cost falls) and mesh_health_check; 7b world 2 on the same
     card, two processes on gloo with every collective staged through
     the host (NCCL refuses two ranks on one card; a bare "cuda" maps
     both ranks to card 0), each result equal to 7a's (BA within the
     same bounds); 7c supervise_ba: 2 gloo ranks crash after a
     checkpoint, 1 NCCL rank resumes and finishes with a lower RMSE.
     Phase 2 also holds, at the 4K split's band shape at world 2
     (1080 + 2 x 64 rows x 3840, both bands), the boxed compact scan and
     select under torch.equal, refine with the band's row_bounds bit for
     bit, and the row-windowed K3-ori and K3-desc at rtol 1e-5 against
     their plain versions.
  8. the port on the card against the NumPy oracle of the reference
     algorithm on the host (sift_tpu_torch/oracle/cpu_sift.py), under
     tests/test_detect.py's gates (oracle keypoints recalled >= 0.97 by
     position within 0.1 px, size within 1 % and angle within 1 degree;
     precision >= 0.97; descriptor L1 of the matched rows, median < 0.05
     and 90th percentile < 0.2) and tests/test_match.py's (match recall
     >= 0.9, both endpoints within 0.5 px): 8a tests/conftest.py's
     small_image (160x200, copied here) at DEFAULT_CONFIG; 8b its 480x640
     tiling with out_caps raised to ORACLE_OUT_CAPS, no octave saturated
     (K3-ori and K3-desc at N = 4096 in octave 0); 8c match_ratio of a
     288x384 crop of 8b's frame against the frame, against the oracle's
     match_l1_ratio. Each launches K1 once for the base blur and once
     per octave, the compact scan, the select, refine, K3-ori and
     K3-desc once
     per usable octave, K4 once in 8c, and nothing else; each line
     prints the oracle's host seconds and the card's milliseconds.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Any
failure exits non-zero before it.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SCENE_HW = (1080, 1920)
OBJECT_HW = (480, 640)
PAIR_HW = (480, 640)
BATCH = 8
ROLL_STEP = 17       # columns between consecutive frames (bench.py:493)
TIMING_RUNS = 20
EXTRA_SLOTS = 64     # phase-2 K3-ori/K3-desc slots starting outside the image
SMALL_SLOTS = 64     # phase-2 K3-ori/K3-desc small launch (octave 4's cap)
TRAP_SLOTS = 16      # phase-2 batched K3: invalid slots a frame at layer -1
KERNELS = ("K1", "K1-batch", "K2", "K2-batch", "K2-compact", "K2-select",
           "K3", "K3-ori", "K3-desc", "K4", "refine", "segsum")
# phase 2's refine check: the seed of the benchmark's recipes
# (benchmark/inputs/recipes.py) for its 1080p scene, 640x480 object and
# B = 8 pan
REFINE_SEED = 2_718_281_828
# csrc/refine.cu's bytes a slot: its candidate (3 int32 and a bool) in,
# the eight Refined fields (3 int32, 4 float32 and a bool) out, and the
# 19 DoG values of one cube
REFINE_BYTES_PER_SLOT = 13 + 29 + 19 * 4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# The 67 TFLOP/s count an FMA as two operations. An operation with no
# FMA form (K4's subtraction, and its add of an absolute value) issues
# at half that: 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 instructions/s.
F32_ISSUE_PER_S = 33.5e12
# torch.cuda._sleep spins for a count of clock cycles; at most 1.98 GHz
# on the H100, so a count of seconds x 2e9 spins at least that long
SPIN_CYCLES_PER_S = 2.0e9
# float32 operations of the histogram function a sample needs, counted
# in csrc/ori_hist.cu and csrc/descr_hist.cu (hist_bound), each
# multiply, add, subtract, compare, floor and absolute value one; each
# special function one, its special-function-unit op (expf: ex2, sqrtf:
# rsqrt, the division in fastAtan2: rcp; 3 a binned sample), its fix-up
# instructions not counted. The kernels' own work (the integer scale,
# its conversions, the adds) is not the function's and is left out.
# K3-desc's every box sample: its rotated offsets (4 multiplies, 2
# adds), the bin shifts (2) and the 4 bin tests; a binned sample: the
# gradient (2), the weight (4 and ex2), the magnitude (3 and rsqrt),
# fastAtan2 (17 and rcp), the orientation bin (2), mag (1), 3 floors, 3
# fractions and the corner weights (17: 1 - fr, 1 - fc, the 2
# orientation weights (3), the 4 distinct row x column products and the
# 8 corner products). K3-ori's binned sample: the gradient (2), the
# weight (1 and ex2), the magnitude (3 and rsqrt), fastAtan2 (17 and
# rcp), wgt * mag and the bin (1); its box tests are integer.
ORI_OPS_PER_SAMPLE = 28
DESC_BOX_OPS_PER_SAMPLE = 12
DESC_OPS_PER_SAMPLE = 55
# the bf16 arm rounds 6 more values a sample: the 4 row x column weights
# and the 2 orientation weights (csrc/descr_hist.cu corner_weights)
DESC_BF16_OPS_PER_SAMPLE = DESC_OPS_PER_SAMPLE + 6
# phase 6, the mapping path: (frames, (H, W)) of eval_mapping's gated
# configuration, of tests/test_mapping.py's sequence and of the CLI's
# default frame size; the plane textures' size
MAP_GATED = (16, (240, 320))
MAP_SMALL = (10, (200, 268))
MAP_CLI = (24, (480, 640))
MAP_TEXTURE_HW = (480, 640)
# ate_final and reproj_rmse, CPU run against card run, relative
MAP_CPU_CARD_RTOL = 0.10
# phase 4: descriptor rows under the bf16 arm against the f32 arm's, L1
# (sift_tpu/config.py:97-103: ~1e-2): 99 % of the valid rows within
# BF16_DESC_L1 and every row within BF16_DESC_L1_MAX. The arm tips
# uchar quantization counts (src/sift.cpp:709-713), so a few rows of a
# 1080p frame pass 2e-2 in sift_tpu as in the port
# (tools/torch_bf16_parity.py)
BF16_DESC_L1 = 2e-2
BF16_DESC_L1_MAX = 5e-2


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

def median_ms(fn, runs: int = TIMING_RUNS, queued: bool = True) -> float:
    """Median time of fn() over `runs` calls (CUDA events). With queued,
    each call is queued behind a spin kernel that outlasts twice its
    host-side enqueue, so the events time the device's work back to back
    and not the host's launch overhead; without it, the events start on
    an idle card, so a call whose host side outlasts its kernels is timed
    with that host side (tools/torch_kernel_times.py reports both)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((2.0 * host_s + 1e-3) * SPIN_CYCLES_PER_S)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
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


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes at the HBM rate and the float32 operations at ops_per_s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


def hist_args(name, args) -> dict:
    """The fields of one K3-ori or K3-desc call's wrapper arguments
    (orientation_hist: padded, layer, r, c, radius, expf_scale, cfg,
    row_bounds; descriptor_hist: padded, layer, r, c, cos_t, sin_t,
    radius, ori, valid, cfg, chunk, row_bounds), the keypoint fields
    flattened over the frames."""
    import torch
    from sift_tpu_torch.ops.ori_hist_cuda import frame_stack, row_window
    ori = name == "K3-ori"
    cfg = args[6] if ori else args[9]
    rows = args[7 if ori else 11] if len(args) > (7 if ori else 11) else None
    rad = cfg.ori_patch_radius if ori else cfg.descr_patch_radius
    stack, frames, _ = frame_stack(args[0])
    flat = [a.reshape(-1) for a in args[1:4]]
    radius = (args[4] if ori else args[6]).reshape(-1)
    keep = (torch.ones_like(radius, dtype=torch.bool) if ori
            else args[8].reshape(-1))
    out = dict(cfg=cfg, rad=rad, stack=stack, frames=frames, layer=flat[0],
               r=flat[1], c=flat[2], radius=radius,
               keep=keep & (radius >= 0),
               window=row_window(rows, stack.shape[1] - 2 * (rad + 1)),
               w=stack.shape[2] - 2 * (rad + 1))
    if not ori:
        out.update(cos_t=args[4].reshape(-1), sin_t=args[5].reshape(-1))
    return out


def hist_samples(name, a: dict, chunk: int = 256) -> tuple:
    """(box samples, binned samples) of one K3-ori or K3-desc call: every
    sample of the kept keypoints' (2R + 1)^2 boxes, and those the plain
    versions' masks keep (inside the image and the row window; K3-desc
    also inside the rotated descriptor square)."""
    import torch
    rad, (row_lo, row_hi), w = a["rad"], a["window"], a["w"]
    off = torch.arange(-rad, rad + 1, device=a["r"].device)
    ii, jj = off[None, :, None], off[None, None, :]
    fi, fj = ii.to(torch.float32), jj.to(torch.float32)
    d = a["cfg"].descr_width
    rr = torch.clamp(a["radius"], max=rad)
    box = binned = 0
    for s in range(0, rr.shape[0], chunk):
        sl = slice(s, s + chunk)
        keep = a["keep"][sl][:, None, None]
        R = rr[sl][:, None, None]
        yy, xx = a["r"][sl][:, None, None] + ii, a["c"][sl][:, None, None] + jj
        inbox = keep & (ii.abs() <= R) & (jj.abs() <= R)
        m = (inbox & (yy > row_lo) & (yy < row_hi - 1) & (xx > 0)
             & (xx < w - 1))
        if name == "K3-desc":
            ct = a["cos_t"][sl][:, None, None]
            st = a["sin_t"][sl][:, None, None]
            rbin = (fj * st + fi * ct) + (d / 2 - 0.5)
            cbin = (fj * ct - fi * st) + (d / 2 - 0.5)
            m &= (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
        box += int(inbox.sum())
        binned += int(m.sum())
    return box, binned


def hist_bound(name, args) -> tuple:
    """K3-ori / K3-desc, one call (its wrapper arguments): the stack
    pixels the kept keypoints' windows reach, each read once, the
    keypoint arguments read once and the histograms written once, at the
    HBM rate; or the float32 operations of every box sample and of every
    binned sample (hist_samples), which have no FMA form in the kernels,
    at the issue rate F32_ISSUE_PER_S; the larger."""
    a = hist_args(name, args)
    stack = a["stack"]
    nlay, hp, wp = stack.shape
    rad = a["rad"]
    p = 2 * rad + 3
    layer, r, c, radius, keep = (a[k].cpu().numpy() for k in
                                 ("layer", "r", "c", "radius", "keep"))
    touched = np.zeros(stack.shape, bool)
    boxes = np.minimum(radius, rad)
    lpf, kpf = nlay // a["frames"], len(layer) // a["frames"]
    lay = np.clip(layer, 0, lpf - 1) + np.arange(len(layer)) // kpf * lpf
    rs = np.clip(r, 0, hp - p) + rad - boxes
    cs = np.clip(c, 0, wp - p) + rad - boxes
    for k in np.nonzero(keep)[0]:
        span = 2 * boxes[k] + 3
        touched[lay[k], rs[k]:rs[k] + span, cs[k]:cs[k] + span] = True
    box, binned = hist_samples(name, a)
    n = len(layer)
    if name == "K3-ori":
        n_io, ops = n * (20 + 4 * 36), binned * ORI_OPS_PER_SAMPLE
    else:
        per = (DESC_BF16_OPS_PER_SAMPLE if a["cfg"].descr_rc_bf16
               else DESC_OPS_PER_SAMPLE)
        n_io = n * (29 + 4 * 360)
        ops = box * DESC_BOX_OPS_PER_SAMPLE + binned * per
    return bound_ms(4.0 * touched.sum() + n_io, float(ops), F32_ISSUE_PER_S)


def blur_launches(img, octs, batched: bool, cfg) -> list:
    """(label, input, taps) of each K1 (or K1-batch) launch of one
    pyramid: the S=1 base blur of the frame(s), then the S=4 blur of
    each octave's base, with the last-row/col quirk applied as
    ops/conv.py applies it."""
    from sift_tpu_torch.ops import conv
    kbase, _ = conv.stack_kernels((cfg.init_blur_sigma,))
    koct, _ = conv.stack_kernels(cfg.scale_sigmas()[1:])
    out = [("base S=1", conv.zero_last_row_col(img), kbase)]
    for o, oct_ in enumerate(octs):
        base = oct_[:, 0] if batched else oct_[0]
        out.append((f"octave {o} S=4", conv.zero_last_row_col(base), koct))
    return out


def offset_copy(x):
    """A copy of x whose data starts 4 bytes past a 16-byte boundary
    (a fresh allocation is aligned), so the kernels' 16-byte copies may
    not run on it."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    check(y.data_ptr() % 16 == 4, "offset_copy: not 4 bytes off")
    return y


def phase_blur_edges(cfg) -> None:
    """K1 and K1-batch where rows are not staged in 16-byte pieces:
    widths that are not a multiple of 4 (octave 1 of a 1366x768 frame is
    384x683), and an input 4 bytes off a 16-byte boundary; at S=1 and
    S=4, large (all scales per block) and small (scales split over the
    grid); bit for bit against the plain versions, each K1-batch frame
    also against K1 on it."""
    import torch
    from sift_tpu_torch.ops import conv
    from sift_tpu_torch.ops.conv_cuda import (blur_vh, blur_vh_batch,
                                              blur_vh_batch_plain,
                                              blur_vh_plain)
    rng = np.random.default_rng(5)
    taps = [conv.stack_kernels((cfg.init_blur_sigma,))[0],
            conv.stack_kernels(cfg.scale_sigmas()[1:])[0]]
    done = []
    for shape, misaligned in (((1, 1079, 1917), False), ((2, 384, 683), False),
                              ((3, 67, 121), False), ((2, 1080, 1920), True)):
        x = conv.zero_last_row_col(torch.from_numpy(
            (rng.random(shape) * 255).astype(np.float32)).cuda())
        if misaligned:
            x = offset_copy(x)
        for kmat in taps:
            got = blur_vh_batch(x, kmat)
            check(torch.equal(got, blur_vh_batch_plain(x, kmat)),
                  f"K1-batch {shape} S={len(kmat)} (misaligned {misaligned}) "
                  f"is not bit-identical to its plain version")
            for b in range(shape[0]):
                one = blur_vh(x[b], kmat)
                check(torch.equal(one, blur_vh_plain(x[b], kmat))
                      and torch.equal(got[b], one),
                      f"K1 {shape[1:]} S={len(kmat)} (misaligned "
                      f"{misaligned}): not bit-identical to its plain "
                      f"version or to K1-batch's frame {b}")
        done.append(f"{shape}{' 4 bytes off' if misaligned else ''}")
    torch.cuda.synchronize()
    print(f"phase 2 K1/K1-batch edge cases at S=1 and S=4: {', '.join(done)}"
          f": bit-identical to the plain versions, each frame equals K1")


def knn_inputs(rng, n: int, m: int, dev):
    """K4's phase-2 query and (masked) train rows: random rows, 20 %
    masked, with tied duplicates within a split (rows j and j + 100) and
    across splits (rows j and j + M/2), and queries 0..79 equal to train
    rows 0..79."""
    import torch
    from sift_tpu_torch.ops.match import mask_train
    q = torch.from_numpy((rng.random((n, 128)) * 0.3).astype(np.float32))
    t = torch.from_numpy((rng.random((m, 128)) * 0.3).astype(np.float32))
    t[100:140] = t[0:40]
    t[m // 2 + 40:m // 2 + 80] = t[40:80]
    q[0:80] = t[0:80]
    valid = torch.from_numpy(rng.random(m) > 0.2)
    for rows in (slice(0, 80), slice(100, 140),
                 slice(m // 2 + 40, m // 2 + 80)):
        valid[rows] = True
    return q.to(dev), mask_train(t.to(dev), valid.to(dev))


def phase_knn_edges(q, tm) -> str:
    """K4 on cuts of its phase-2 inputs that the 1536 x 1536 check does
    not reach: rows 4 bytes off a 16-byte boundary (the wrapper copies
    them), ragged N and M, M = 1 and M = 0; idx, d1 and d2 bit for bit
    against the plain version. Returns what was checked."""
    import torch
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda, knn2_l1_plain
    cases = [("4 bytes off", offset_copy(q), offset_copy(tm), q, tm)]
    for n, m in ((100, 777), (64, 1), (64, 0)):
        cases.append((f"{n}x{m}", q[:n], tm[:m], q[:n], tm[:m]))
    for label, qk, tk, qp, tp in cases:
        got, want = knn2_l1_cuda(qk, tk), knn2_l1_plain(qp, tp)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K4 {label} is not bit-identical to its plain version")
    torch.cuda.synchronize()
    return ", ".join(c[0] for c in cases)


def phase_blur(name, wrapper, plain, launches, per, single=None) -> list:
    """K1 or K1-batch at each of `launches` (see blur_launches): bit for
    bit against the plain version (and, for K1-batch, each frame
    against the single-frame `single`), timed; the cuDNN yardstick at
    the 1080p shapes. Returns [(label, shape, err, ms, plain_ms, bound,
    library_ms)] and prints the sums over the launches of one `per`."""
    import torch
    rows = []
    for label, x, kmat in launches:
        got, want = wrapper(x, kmat), plain(x, kmat)
        torch.cuda.synchronize()
        shape = tuple(x.shape)
        check(torch.equal(got, want),
              f"{name} {label} {shape} is not bit-identical to its plain "
              f"version")
        if single is not None:
            check(all(torch.equal(got[b], single(x[b], kmat))
                      for b in range(x.shape[0])),
                  f"{name} {label} {shape}: a frame differs from K1 on it")
        err = float((got - want).abs().max())
        del got
        ms = median_ms(lambda: wrapper(x, kmat))
        pms = median_ms(lambda: plain(x, kmat))
        bnd = blur_bound(x.shape, kmat)
        lms, lib_note = None, ""
        if x.shape[-2:] == SCENE_HW and label in ("base S=1",
                                                  "octave 0 S=4"):
            lib = blur_library(x, kmat)
            lerr = float((lib() - want).abs().max())
            lms = median_ms(lib)
            lib_note = (f", library conv2d {lms:.4f} ms (max diff from "
                        f"plain {lerr!r})")
        del want
        rows.append((label, shape, err, ms, pms, bnd, lms))
        print(f"phase 2 {name} blur {label} {shape}: max_abs_err={err!r} "
              f"(bit-identical{', each frame equals K1' if single else ''}"
              f") kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}){lib_note}")
    print_sums(f"{name} per {per}", rows)
    return rows


def print_sums(what, rows) -> None:
    """The kernel, plain and bound ms of phase_blur's rows, summed."""
    print(f"phase 2 {what} ({len(rows)} launches): kernel "
          f"{sum(r[3] for r in rows):.4f} ms, plain "
          f"{sum(r[4] for r in rows):.4f} ms, bound "
          f"{sum(r[5][0] for r in rows):.4f} ms")


def phase_kernels(scene_np: np.ndarray, obj_np: np.ndarray,
                  img4k_np: np.ndarray) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes
    (and at the 4K split's band shape, phase_band_kernels)."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import pyramid
    from sift_tpu_torch.ops.conv_cuda import (blur_vh, blur_vh_batch,
                                              blur_vh_batch_plain,
                                              blur_vh_plain)
    from sift_tpu_torch.ops.extrema_cuda import (extrema_scores,
                                                 extrema_scores_batch,
                                                 extrema_scores_batch_plain,
                                                 extrema_scores_plain)
    from sift_tpu_torch.ops.match_cuda import (knn2_l1_cuda, knn2_l1_plain,
                                               launch_plan)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(scene_np).to(dev)
    img_obj = torch.from_numpy(obj_np).to(dev)
    frames = batch_frames(img)
    octs = pyramid.build_gaussian_pyramid(img, cfg)
    octsb = pyramid.build_gaussian_pyramid_batch(frames, cfg)
    report = {}

    def record(key, name, src, replaces, err, ms, plain_ms, bound,
               library_ms=None):
        report[key] = {"name": name, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": 0,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": library_ms}

    def main_row(rows):
        """ms, plain ms, bound and library ms at the 1080p octave 0"""
        row = next(r for r in rows
                   if r[0] == "octave 0 S=4" and r[1][-2:] == SCENE_HW)
        return row[3:]

    # K1 at each launch of detect_object: the 1080p scene's and the
    # 480x640 object's base blur and five octaves; the JSON row is the
    # 1080p octave 0 (S=4)
    k1 = (phase_blur("K1", blur_vh, blur_vh_plain,
                     blur_launches(img, octs, False, cfg), "scene")
          + phase_blur("K1", blur_vh, blur_vh_plain,
                       blur_launches(img_obj, pyramid.build_gaussian_pyramid(
                           img_obj, cfg), False, cfg), "object"))
    print_sums("K1 per detect_object", k1)
    record("K1", "K1 separable Gaussian blur", "sift_tpu_torch/csrc/blur.cu",
           "sift_tpu/ops/conv_pallas.py:92", max(r[2] for r in k1),
           *main_row(k1))

    # K1-batch at each launch of the B = 8 batch step; each frame must
    # also be the single-frame K1 on it, bit for bit
    k1b = phase_blur("K1-batch", blur_vh_batch, blur_vh_batch_plain,
                     blur_launches(frames, octsb, True, cfg), "batch step",
                     single=blur_vh)
    record("K1-batch", "K1-batch separable Gaussian blur, B frames",
           "sift_tpu_torch/csrc/blur.cu", "sift_tpu/ops/conv_pallas.py:173",
           max(r[2] for r in k1b), *main_row(k1b))
    phase_blur_edges(cfg)

    # K2 on the (4, 1080, 1920) DoG of the synthetic frame: read the DoG,
    # write nL score planes; a threshold test and 26 neighbour tests per
    # score
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
    dogsb = pyramid.build_dog_pyramid_batch(octsb)
    dogb = dogsb[0].contiguous()
    octb0 = octsb[0]
    del octsb
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
    del dogb
    phase_select(dogs, pyramid.build_dog_pyramid(
        pyramid.build_gaussian_pyramid(img_obj, cfg)), dogsb, record)
    dogb0 = dogsb[0]
    del dogsb
    phase_refine(record)

    phase_gather(octs[0], cfg, rng, record)

    # K3-ori and K3-desc on octave 0 of the scene
    kp = sift.detect_octave(octs[0], dogs[0], 0, cfg.detect_caps[0], cfg,
                            cfg.out_caps[0])
    phase_fused_hist(octs[0], kp, rng, record, report)
    # and over the B = 8 frames of the batch step, one launch each
    kpb = sift._octave_tail(octb0, dogb0, *ext.top_candidates_batch(
        dogb0, cfg.detect_caps[0], cfg), 0, cfg, cfg.out_caps[0])
    phase_fused_hist_batch(octb0, kpb, rng, report)
    del octb0, dogb0, kpb
    phase_hist_extreme(report, dev)
    phase_hist_nonfinite(report, dev)
    phase_band_kernels(img4k_np)

    # K4 at 1536 x 1536 with sentinel rows and tied duplicates, within a
    # split and across splits; one subtraction and one absolute add per
    # pair and dimension, which have no FMA form, at the instruction
    # issue rate
    n = m = sum(cfg.out_caps)
    q, tm = knn_inputs(rng, n, m, dev)
    gi, g1, g2 = knn2_l1_cuda(q, tm)
    wi, w1, w2 = knn2_l1_plain(q, tm)
    torch.cuda.synchronize()
    check(torch.equal(gi, wi) and torch.equal(g1, w1) and torch.equal(g2, w2),
          "K4 is not bit-identical to its plain version")
    check(torch.equal(gi[0:80].cpu(), torch.arange(80, dtype=torch.int32))
          and bool((g2[0:80] == 0).all()),
          "K4: a tied duplicate did not resolve to the lowest row")
    err = float(torch.maximum((g1 - w1).abs().max(), (g2 - w2).abs().max()))
    edges = phase_knn_edges(q, tm)
    p, span = launch_plan(n, m, 1, q.device)
    ms = median_ms(lambda: knn2_l1_cuda(q, tm))
    pms = median_ms(lambda: knn2_l1_plain(q, tm))
    bnd = bound_ms(4.0 * (n + m) * 128 + 12 * n, 2.0 * n * m * 128,
                   F32_ISSUE_PER_S)
    print(f"phase 2 K4 top-2 L1 {n}x{m}: {p} train splits of {span} rows, "
          f"idx, d1 and d2 bit-identical on all {n} rows (80 with a tied "
          f"duplicate, 40 across splits) and at {edges}, "
          f"max_abs_err={err!r} kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    record("K4", "K4 top-2 L1 matcher", "sift_tpu_torch/csrc/knn2.cu",
           "sift_tpu/ops/match_pallas.py:83", err, ms, pms, bnd)
    phase_knn_pairs(rng, n, m, dev, report["K4"])
    return report


def gather_starts(rng, n: int, nlay: int, hp: int, wp: int, p: int, dev):
    """(N,) int32 layer, row and column starts of K3 windows, drawn
    across the stack and past every edge: the first four slots start at
    layer -1 and L, before row and column 0 and past Hp - p and Wp - p."""
    import torch
    lay = rng.integers(-1, nlay + 1, n)
    r = rng.integers(-5, hp - p + 6, n)
    c = rng.integers(-5, wp - p + 6, n)
    edges = [(-1, -7, -9), (nlay, hp, wp), (0, hp - p + 1, -1),
             (nlay - 1, -1, wp - p + 1)]
    for k, e in enumerate(edges[:n]):
        lay[k], r[k], c[k] = e
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (lay, r, c))


def phase_gather_edges(stacks: dict, dev) -> str:
    """Phase 2, K3 against gather_patches_plain under torch.equal where
    its launch shape or addressing is at an edge: p = 1, p = Wp, p = 129
    (above the Pallas kernel's cap of 128), N = 1, N = 0, N = 8192, the
    1958-wide stack, a source 4 bytes off a 16-byte boundary, every
    window set with starts past every edge (gather_starts)."""
    import torch
    from sift_tpu_torch.ops.ori_gather_cuda import (gather_patches,
                                                    gather_patches_plain,
                                                    launch_warps)
    rng = np.random.default_rng(13)
    narrow = torch.from_numpy(
        rng.standard_normal((3, 70, 61)).astype(np.float32)).to(dev)
    cases = [("p=1", narrow, 1, 300), ("p=Wp=61", narrow, 61, 50),
             ("p=129", stacks[85], 129, 300), ("N=1", stacks[85], 85, 1),
             ("N=0", stacks[85], 85, 0), ("N=8192", stacks[85], 85, 8192),
             ("Wp=1958", stacks[39], 39, 2048),
             ("4 bytes off", offset_copy(stacks[39]), 39, 1024)]
    done = []
    for label, src, p, n in cases:
        starts = gather_starts(rng, n, *src.shape, p, dev)
        got = gather_patches(src, *starts, p)
        want = gather_patches_plain(src, *starts, p)
        torch.cuda.synchronize()
        check(got.shape == (n, p, p) and torch.equal(got, want),
              f"K3 {label} ({tuple(src.shape)}, p={p}, N={n}) is not "
              f"bit-identical to gather_patches_plain")
        warps = launch_warps(n, p, src.device) if n else None
        done.append(f"{label} {tuple(src.shape)} N={n} warps {warps}")
        del got, want
    return "; ".join(done)


def gather_cases(gauss, cfg, rng) -> list:
    """K3's three phase-2 launches on octave 0's (S, H, W) stack `gauss`:
    (label, (padded, layer, row, col, p)) for p = 39 with N = 1024 (the
    orientation stage's octave), p = 85 with N = 64 (the descriptor
    stage's chunk) and N = 1024; starts drawn from rng, a few outside the
    image."""
    import torch
    dev = gauss.device
    h, w = gauss.shape[1:]
    cases = []
    for rad, n in ((cfg.ori_patch_radius, 1024), (cfg.descr_patch_radius, 64),
                   (cfg.descr_patch_radius, 1024)):
        p = 2 * rad + 3
        padded = torch.nn.functional.pad(gauss[1:3], (rad + 1,) * 4)
        lay, r, c = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in
                     (rng.integers(0, 3, n), rng.integers(-3, h + 3, n),
                      rng.integers(-3, w + 3, n)))
        cases.append((f"p={p} N={n}", (padded, lay, r, c, p)))
    return cases


def gather_bound(padded, layer, row, col, p: int) -> tuple:
    """K3, a copy: each window written once, each element of the stack
    that the clamped windows cover read once (their union, counted on
    the card: windows overlap, and at p = 85, N = 1024 they hold more
    elements than the stack), and the 12 bytes of each window's
    starts."""
    import torch
    nlay, hp, wp = padded.shape
    n = layer.shape[0]
    off = torch.arange(p, device=padded.device)
    covered = torch.zeros(padded.shape, dtype=torch.bool,
                          device=padded.device)
    covered[layer.long().clamp(0, nlay - 1)[:, None, None],
            (row.long().clamp(0, hp - p)[:, None] + off)[:, :, None],
            (col.long().clamp(0, wp - p)[:, None] + off)[:, None, :]] = True
    return bound_ms(4.0 * (n * p * p + int(covered.sum())) + 12 * n, 0.0)


def phase_gather(gauss, cfg, rng, record) -> None:
    """Phase 2, K3 at gather_cases' three shapes (p = 85, N = 64 is the
    JSON row), bit for bit against gather_patches_plain, then on
    phase_gather_edges' cases; each time beside its launch floor (an
    empty kernel of its grid, tools/torch_cuda_variants.py) and its
    bound."""
    import torch
    from sift_tpu_torch import _build
    from sift_tpu_torch.ops.ori_gather_cuda import (gather_grid,
                                                    gather_patches,
                                                    gather_patches_plain,
                                                    launch_warps)
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_cuda_variants as variants
    floor_lib = variants.floor_library(ROOT / "build" / "smoke_floor",
                                       _build)
    dev = gauss.device
    stacks, rows = {}, []
    for label, args in gather_cases(gauss, cfg, rng):
        padded, n, p = args[0], args[1].shape[0], args[4]
        stacks[p] = padded
        got = gather_patches(*args)
        want = gather_patches_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K3 {label} is not bit-identical")
        del got, want
        ms = median_ms(lambda: gather_patches(*args))
        pms = median_ms(lambda: gather_patches_plain(*args))
        ctas, threads = gather_grid(p, launch_warps(n, p, dev))
        floor = median_ms(lambda: variants.launch_empty(
            floor_lib, (n, ctas), threads))
        bnd = gather_bound(*args)
        rows.append((ms, pms, bnd))
        print(f"phase 2 K3 gather {label} {tuple(padded.shape)}: "
              f"max_abs_err=0.0 kernel {ms:.4f} ms (launch floor "
              f"{floor:.4f}; {n} x {ctas} CTAs of {threads} threads), "
              f"plain {pms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.0%} of it")
    edges = phase_gather_edges(stacks, dev)
    print(f"phase 2 K3 gather edges, each bit-identical to "
          f"gather_patches_plain: {edges}")
    record("K3", "K3 keypoint patch gather", "sift_tpu_torch/csrc/gather.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", 0.0, *rows[1])


def phase_knn_pairs(rng, n: int, m: int, dev, row: dict) -> None:
    """Phase 2, K4 over the batch step's BATCH - 1 pairs in one launch,
    (G, N, 128) x (G, M, 128) at G = 7 and N = M = 1536, on knn_inputs
    drawn for each pair (20 % of the train rows masked, tied
    duplicates): idx, d1 and d2 bit for bit against the batched plain
    version and, pair by pair, against the single launch on that pair;
    two launches bit-identical. Timed beside G single launches; bound
    G times the single pair's. Adds a "pairs" entry to K4's row."""
    import torch
    from sift_tpu_torch.ops.match_cuda import (knn2_l1_cuda, knn2_l1_plain,
                                               launch_plan)
    g = BATCH - 1
    pairs = [knn_inputs(rng, n, m, dev) for _ in range(g)]
    q = torch.stack([a for a, _ in pairs])
    tm = torch.stack([b for _, b in pairs])
    got, again = knn2_l1_cuda(q, tm), knn2_l1_cuda(q, tm)
    want = knn2_l1_plain(q, tm)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"K4 over {g} pairs is not bit-identical to its plain version")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4 over {g} pairs: two launches differ")
    for k in range(g):
        one = knn2_l1_cuda(q[k], tm[k])
        check(all(torch.equal(a[k], b) for a, b in zip(got, one)),
              f"K4 over {g} pairs: pair {k} differs from the single launch "
              f"on it")
    err = float(torch.maximum((got[1] - want[1]).abs().max(),
                              (got[2] - want[2]).abs().max()))
    p, span = launch_plan(n, m, g, dev)
    ms = median_ms(lambda: knn2_l1_cuda(q, tm))
    singles_ms = median_ms(lambda: [knn2_l1_cuda(q[k], tm[k])
                                    for k in range(g)])
    pms = median_ms(lambda: knn2_l1_plain(q, tm), runs=3)
    bnd = bound_ms(g * (4.0 * (n + m) * 128 + 12 * n),
                   g * 2.0 * n * m * 128, F32_ISSUE_PER_S)
    print(f"phase 2 K4 top-2 L1 over {g} pairs {tuple(q.shape)} x "
          f"{tuple(tm.shape)} in one launch: {p} train splits of {span} "
          f"rows, idx, d1 and d2 bit-identical to the plain version, to "
          f"the single launch on each pair and across two launches, "
          f"max_abs_err={err!r} kernel {ms:.4f} ms, {g} single launches "
          f"{singles_ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    row["pairs"] = {"pairs": g, "max_abs_err": err, "ms": ms,
                    "single_launches_ms": singles_ms, "plain_ms": pms,
                    "bound_ms": float(bnd[0]), "bound_by": bnd[1]}


def compact_bound(shape, n: int, nl: int) -> tuple:
    """K2's compact scan on (B, D, H, W): read the nl + 2 planes it
    scans, write n keys and B counts; 27 comparisons per scanned pixel."""
    b, _, h, w = shape
    plane = float(h * w)
    return bound_ms(4.0 * b * (nl + 2) * plane + 8.0 * n + 4.0 * b,
                    27.0 * b * nl * plane)


def select_bound(frames: int, n: int, cap: int) -> tuple:
    """The select kernel: read n keys and the counts, write 13 bytes a
    slot (three int32 and a bool); it moves keys and does no float
    arithmetic."""
    return bound_ms(8.0 * n + 4.0 * frames + 13.0 * frames * cap, 0.0)


def synthetic_keys(rng, counts, total: int, tied: bool = False):
    """(B, total) int64 key lists and their (B,) counts, as the compact
    scan leaves them: frame b's counts[b] candidates at distinct flat
    indices, random scores (or one score for all: keys that differ only
    in their index bits), in a shuffled order, then zeros."""
    keys = np.zeros((len(counts), total), np.int64)
    for b, n in enumerate(counts):
        idx = rng.choice(total, n, replace=False).astype(np.uint64)
        score = (np.full(n, 20.0) if tied else rng.uniform(1.0, 50.0, n)
                 ).astype(np.float32)
        bits = score.view(np.uint32).astype(np.uint64)
        keys[b, :n] = ((bits << np.uint64(32))
                       | (np.uint64(0xFFFFFFFF) - idx)).astype(np.int64)
    return keys, np.array(counts, np.int32)


def select_edge_counts(cap: int, ctas: int, stage: int, threads: int):
    """Counts where the rank select's partition changes at a launch
    shape: none, one, a slice of one, 32 and `threads` keys a CTA and
    their neighbours, cap and its neighbours, stage and one more (the
    first list whose kept keys the CTAs pack)."""
    counts = {0, 1, ctas - 1, ctas, ctas + 1, cap - 1, cap, cap + 1, stage,
              stage + 1}
    for per in (32, threads):
        counts |= {ctas * per - 1, ctas * per, ctas * per + 1}
    return sorted(c for c in counts if c >= 0)


def refined_equal(got, want) -> bool:
    """Every field of every slot of two Refined results equal, floats by
    their bits."""
    import torch
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               if g.dtype == torch.float32 else torch.equal(g, w)
               for g, w in zip(got, want))


def refined_err(got, want) -> float:
    """The largest difference between two Refined results' fields (NaN
    where both are NaN counts as none)."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        d = d[~(g.double().isnan() & w.double().isnan())]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def refine_launches(cfg) -> list:
    """Every refine launch of detect_object on the benchmark's seeded
    1080p scene and 640x480 object, and of the B = 8 batch step on its
    seeded pan (benchmark/inputs/recipes.py, REFINE_SEED): [(label, DoG
    stack, candidates)] from the card's scan, one entry per usable
    octave."""
    import torch
    from benchmark.inputs import recipes
    from sift_tpu_torch import sift
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import pyramid
    scene, obj, _, _ = recipes.object_scene(SCENE_HW, OBJECT_HW, REFINE_SEED)
    pan = recipes.pan_frames(SCENE_HW, OBJECT_HW, BATCH, ROLL_STEP,
                             REFINE_SEED)
    out = []
    for name, img in (("scene", scene), ("object", obj)):
        octs = pyramid.build_gaussian_pyramid(torch.from_numpy(img).cuda(),
                                              cfg)
        for o, d in enumerate(pyramid.build_dog_pyramid(octs)):
            if sift._octave_usable(octs[o].shape[1:], cfg):
                out.append((f"{name} octave {o}", d,
                            ext.top_candidates(d, cfg.detect_caps[o], cfg)))
    octs = pyramid.build_gaussian_pyramid_batch(torch.from_numpy(pan).cuda(),
                                                cfg)
    for o, d in enumerate(pyramid.build_dog_pyramid_batch(octs)):
        if sift._octave_usable(octs[o].shape[2:], cfg):
            out.append((f"batch octave {o}", d,
                        ext.top_candidates_batch(d, cfg.detect_caps[o], cfg)))
    return out


def phase_refine(record) -> None:
    """Phase 2, the refine kernel (csrc/refine.cu) against
    refine_candidates_plain on the card, bit for bit in all eight fields
    of every slot: at every usable octave of detect_object (the
    benchmark's seeded 1080p scene and 640x480 object) and of the B = 8
    batch step (its seeded pan; each frame also the single-frame launch
    on it), on a stack that is not contiguous (a row band viewed out of
    octave 0, with row_bounds past it) and on the planted cubes of
    tests/test_torch_refine_kernel.py; two launches bit-identical. Timed
    at octave 0, B = 1 and B = 8, beside its launch floor (an empty
    kernel of its grid), its byte bound and the plain version, with the
    sums per detect_object and per batch step."""
    import torch
    from sift_tpu_torch import _build
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import refine as ref
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_cuda_variants as variants
    floor_lib = variants.floor_library(ROOT / "build" / "smoke_floor",
                                       _build)

    rows = {}
    for label, dog, cands in refine_launches(cfg):
        got = ref.refine_candidates(dog, *cands, cfg)
        again = ref.refine_candidates(dog, *cands, cfg)
        want = ref.refine_candidates_plain(dog, *cands, cfg)
        torch.cuda.synchronize()
        check(refined_equal(got, want), f"refine {label}: the kernel differs "
              f"from refine_candidates_plain (max {refined_err(got, want)})")
        check(refined_equal(got, again), f"refine {label}: two launches "
              f"differ")
        if dog.dim() == 4:
            check(all(refined_equal(
                tuple(a[b] for a in got),
                ref.refine_candidates(dog[b], *(a[b] for a in cands), cfg))
                for b in range(dog.shape[0])),
                f"refine {label}: a frame differs from its single-frame "
                f"launch")
        slots = cands[0].numel()
        ms = median_ms(lambda: ref.refine_candidates(dog, *cands, cfg))
        floor = median_ms(lambda: variants.launch_empty(
            floor_lib, (-(-slots // ref.KERNEL_THREADS), 1),
            ref.KERNEL_THREADS))
        bnd = bound_ms(REFINE_BYTES_PER_SLOT * slots, 0.0)
        pms = (median_ms(lambda: ref.refine_candidates_plain(dog, *cands,
                                                             cfg))
               if label.endswith("octave 0") else None)
        rows[label] = (ms, floor, bnd, pms)
        each = (" (each frame its single-frame launch)" if dog.dim() == 4
                else "")
        print(f"phase 2 refine {label} {tuple(dog.shape)} slots={slots}: "
              f"valid {int(cands[3].sum())} -> {int(want.valid.sum())}, all "
              f"eight fields bit for bit refine_candidates_plain{each}"
              f"; kernel {ms:.4f} ms (launch floor {floor:.4f}), bound "
              f"{bnd[0]:.5f} ms ({bnd[1]})"
              + (f", plain {pms:.4f} ms" if pms is not None else ""))
    for what, prefix in (("detect_object", ("scene", "object")),
                         ("batch step", ("batch",))):
        sel = [v for k, v in rows.items() if k.startswith(prefix)]
        print(f"phase 2 refine per {what} ({len(sel)} launches): kernel "
              f"{sum(v[0] for v in sel):.4f} ms, launch floors "
              f"{sum(v[1] for v in sel):.4f} ms, bound "
              f"{sum(v[2][0] for v in sel):.5f} ms")
    phase_refine_edges(cfg)
    ms, floor, bnd, pms = rows["scene octave 0"]
    record("refine", "refine: Newton steps, contrast and edge tests",
           "sift_tpu_torch/csrc/refine.cu",
           "none (sift_tpu/ops/refine.py is plain XLA)", 0.0, ms, pms, bnd)
    report_b8 = rows["batch octave 0"]
    print(f"phase 2 refine at octave 0: B = 1 kernel {ms:.4f} ms (floor "
          f"{floor:.4f}, bound {bnd[0]:.5f}, plain {pms:.4f}); B = 8 kernel "
          f"{report_b8[0]:.4f} ms (floor {report_b8[1]:.4f}, bound "
          f"{report_b8[2][0]:.5f}, plain {report_b8[3]:.4f})")


def phase_refine_edges(cfg) -> None:
    """Phase 2, the refine kernel on what the frames do not reach: a
    stack that is not contiguous (a row band viewed out of the scene's
    octave 0, the wrapper's copy), with row_bounds past the band, and
    the planted cubes of tests/test_torch_refine_kernel.py (an invalid
    slot at (1, 0, 0), a flat cube, cubes that diverge by size and by a
    NaN, one that steps out of the border box, one across a layer, one
    still moving after the last step), each alone and as frame 1 of a
    batch; bit for bit refine_candidates_plain on the card."""
    import importlib.util

    import torch
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import pyramid
    from sift_tpu_torch.ops import refine as ref
    from benchmark.inputs import recipes
    scene, _, _, _ = recipes.object_scene(SCENE_HW, OBJECT_HW, REFINE_SEED)
    dog = pyramid.build_dog_pyramid(pyramid.build_gaussian_pyramid(
        torch.from_numpy(scene).cuda(), cfg))[0]
    top, bot = dog.shape[1] // 4, dog.shape[1] - dog.shape[1] // 4
    band = dog[:, top:bot, :]
    check(not band.is_contiguous(), "the band view is contiguous")
    lay, r, c, v = ext.top_candidates(dog, cfg.detect_caps[0], cfg)
    keep = v & (r >= top + 5) & (r < bot - 5)
    args = (lay[keep], r[keep] - top, c[keep], v[keep])
    # the true image's rows reach 3 past the band: every move stays
    # inside the band (the plain version's gather raises past the field)
    rows = (-3, bot - top + 3)
    got = ref.refine_candidates(band, *args, cfg, row_bounds=rows)
    want = ref.refine_candidates_plain(band, *args, cfg, row_bounds=rows)
    torch.cuda.synchronize()
    check(refined_equal(got, want), "refine on a band view differs from "
          "refine_candidates_plain")
    n_band = (int(args[3].sum()), int(want.valid.sum()))

    # the test module imports its thread fixture from tests/_torch_threads.py
    sys.path.insert(0, str(ROOT / "tests"))
    spec = importlib.util.spec_from_file_location(
        "refine_planted", ROOT / "tests" / "test_torch_refine_kernel.py")
    planted = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(planted)
    done = []
    for name, (make, (l0, r0, c0), expect) in sorted(planted.PLANTED.items()):
        stack = make().cuda()
        cand = [torch.tensor(x, dtype=torch.int32, device="cuda")
                for x in ([l0, 1, l0], [r0, 0, r0], [c0, 0, c0])]
        valid = torch.tensor([True, False, False], device="cuda")
        got = ref.refine_candidates(stack, *cand, valid, cfg)
        want = ref.refine_candidates_plain(stack, *cand, valid, cfg)
        both = torch.stack([torch.zeros_like(stack), stack])
        bc = [torch.stack([a, a]) for a in cand]
        bv = torch.stack([torch.zeros_like(valid), valid])
        got_b = ref.refine_candidates(both, *bc, bv, cfg)
        want_b = ref.refine_candidates_plain(both, *bc, bv, cfg)
        torch.cuda.synchronize()
        check(refined_equal(got, want) and refined_equal(got_b, want_b)
              and refined_equal(tuple(a[1] for a in got_b), got),
              f"refine planted {name}: the kernel differs from "
              f"refine_candidates_plain")
        moved = (int(got.layer[0]), int(got.r[0]),
                 int(got.c[0])) != (l0, r0, c0)
        check(bool(got.valid[0]) == expect["valid"]
              and moved == expect["moved"] and not bool(got.valid[1:].any()),
              f"refine planted {name}: valid {got.valid.tolist()}, moved "
              f"{moved}; expected {expect}")
        done.append(name)
    print(f"phase 2 refine edges, each bit for bit refine_candidates_plain: "
          f"a {tuple(band.shape)} band viewed out of octave 0 (not "
          f"contiguous) with row_bounds {rows}: valid {n_band[0]} -> "
          f"{n_band[1]}; planted "
          f"cubes alone and as frame 1 of a batch: {', '.join(done)}")


def phase_select(dogs, dogs_obj, dogsb, record) -> None:
    """Phase 2, the fused selection: K2's compact scan and the select
    kernel, as top_candidates / top_candidates_batch launch them, against
    top_candidates_plain (the dense scores' stable sort) under
    torch.equal on all four outputs, at every octave of detect_object
    (1080p scene and 640x480 object) and of the B = 8 batch step (each
    row also equal to the single-frame call), and on edge cases; each
    kernel against its own plain version; the route once more with
    torch.sort removed and host synchronisation an error; then both
    kernels timed at every octave, with sums per detect_object and per
    batch step, each select time beside the launch floor of its launch
    shape (an empty kernel, extrema_cuda.select_floor). The JSON rows'
    max_abs_err is the largest difference from the plain versions at the
    1080p octave 0: over the sorted key lists and counts (compact scan)
    and over layer, r, c and valid (select)."""
    import dataclasses
    import re

    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops import extrema_cuda
    from sift_tpu_torch.ops.extrema_cuda import (extrema_compact,
                                                 extrema_compact_plain,
                                                 extrema_scores,
                                                 extrema_scores_plain,
                                                 select_candidates,
                                                 select_candidates_plain,
                                                 select_floor)
    nl = cfg.n_octave_layers

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    def max_err(got, want) -> int:
        return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                   for a, b in zip(got, want))

    errs = {}

    def check_route(label, dog, cap, cfg=cfg) -> list:
        """The fused route on dog ((D, H, W) or (B, D, H, W)) against the
        plain route, and each kernel against its plain version; returns
        the candidates per frame and keeps each kernel's largest
        difference in errs[label]."""
        batched = dog.dim() == 4
        d4 = dog if batched else dog[None]
        hw = tuple(dog.shape[-2:])
        if batched:
            got = ext.top_candidates_batch(dog, cap, cfg)
            want = ext.top_candidates_batch_plain(dog, cap, cfg)
            check(all(same((a[b] for a in got),
                           ext.top_candidates(dog[b], cap, cfg))
                      for b in range(dog.shape[0])),
                  f"fused selection {label}: a row differs from the "
                  f"single-frame call")
        else:
            got = ext.top_candidates(dog, cap, cfg)
            want = ext.top_candidates_plain(dog, cap, cfg)
        check(same(got, want), f"fused selection {label} differs from "
              f"top_candidates_plain")
        keys, count = extrema_compact(d4, cfg)
        pkeys, pcount = extrema_compact_plain(d4, cfg)
        check(torch.equal(count, pcount), f"compact scan {label}: counts "
              f"{count.tolist()} vs plain {pcount.tolist()}")
        err_c = max_err((count,), (pcount,))
        for b, n in enumerate(pcount.tolist()):
            gk = torch.sort(keys[b, :n]).values
            wk = torch.sort(pkeys[b, :n]).values
            check(torch.equal(gk, wk), f"compact scan {label}: frame {b}'s "
                  f"keys differ from the plain version's")
            err_c = max(err_c, max_err((gk,), (wk,)))
        gs = select_candidates(keys, count, cap, hw)
        ws = select_candidates_plain(keys, count, cap, hw)
        check(same(gs, ws), f"select {label} differs from its plain version")
        errs[label] = (err_c, max_err(gs, ws))
        return pcount.tolist()

    # every octave of the main path; the JSON rows are the 1080p octave 0
    launches = ([(f"scene octave {o}", d.contiguous(), cfg.detect_caps[o])
                 for o, d in enumerate(dogs)]
                + [(f"object octave {o}", d.contiguous(), cfg.detect_caps[o])
                   for o, d in enumerate(dogs_obj)])
    batch = [(f"batch octave {o}", d.contiguous(), cfg.detect_caps[o])
             for o, d in enumerate(dogsb)]
    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, dog, cap in launches + batch:
        counts = check_route(label, dog, cap)
        d4 = dog if dog.dim() == 4 else dog[None]
        keys, count = extrema_compact(d4, cfg)
        hw = tuple(dog.shape[-2:])
        ms_c = median_ms(lambda: extrema_compact(d4, cfg))
        ms_s = median_ms(lambda: select_candidates(keys, count, cap, hw))
        floor = median_ms(lambda: select_floor(d4.shape[0], cap, nl, hw,
                                               d4.device))
        bc = compact_bound(d4.shape, sum(counts), nl)
        bs = select_bound(d4.shape[0], sum(counts), cap)
        rows[label] = (d4, keys, count, cap, counts, ms_c, ms_s, bc, bs,
                       floor)
        shape = extrema_cuda.select_shape(cap, nl * hw[0] * hw[1],
                                          d4.shape[0], sms)
        print(f"phase 2 K2 fused selection {label} {tuple(dog.shape)} "
              f"cap={cap}: candidates={counts} equal to "
              f"top_candidates_plain{' (each row the single frame)' if dog.dim() == 4 else ''}; "
              f"compact scan {ms_c:.4f} ms (bound {bc[0]:.4f}, {bc[1]}), "
              f"select {ms_s:.4f} ms ({shape[0]} CTAs a frame; bound "
              f"{bs[0]:.5f}, {bs[1]}; launch floor {floor:.4f})")
    for what, labels in (("detect_object", [x[0] for x in launches]),
                         ("batch step", [x[0] for x in batch])):
        sel = [rows[k] for k in labels]
        print(f"phase 2 K2 fused selection per {what} ({len(sel)} octaves): "
              f"compact scan {sum(r[5] for r in sel):.4f} ms, select "
              f"{sum(r[6] for r in sel):.4f} ms (launch floors "
              f"{sum(r[9] for r in sel):.4f}), together "
              f"{sum(r[5] + r[6] for r in sel):.4f} ms; bound "
              f"{sum(r[7][0] + r[8][0] for r in sel):.4f} ms")

    # edge cases: a plateau (n >> cap), n = cap and its neighbours, a
    # width that is not a multiple of 4, an input 4 bytes off, and a
    # small octave whose gap slots reach past the first border rows
    d0 = dogs[0].contiguous()
    plateau = torch.zeros_like(d0)
    plateau[:, 100:400, 200:1000] = 20.0
    n_pl = check_route("plateau", plateau, cfg.detect_caps[0])
    check_route("plateau in a batch", torch.stack([plateau, d0]),
                cfg.detect_caps[0])
    d1 = dogs[1].contiguous()
    n1 = int(extrema_compact_plain(d1[None], cfg)[1][0])
    for cap in (n1 - 1, n1, n1 + 1):
        check_route(f"cap {cap} at n {n1}", d1, cap)
    check_route("width 1917", d0[:, :1079, :1917].contiguous(), 4096)
    check_route("4 bytes off", offset_copy(d0), 4096)
    small = dogs[2][:, :48, :24].clone()
    small[1, 10, 10] = small.abs().max() + 50.0   # a peak at index 250
    n_sm = check_route("48x24", small, 512)[0]
    lay, r, c, _ = ext.top_candidates_plain(small, 512, cfg)
    first = int(((lay[:n_sm] - 1) * 48 * 24 + r[:n_sm] * 24 + c[:n_sm]).min())
    check(0 < n_sm and 512 - n_sm > cfg.img_border * 24
          and first < 512 - n_sm,
          f"the 48x24 case does not reach the general gap path "
          f"(n {n_sm}, lowest candidate index {first})")
    # caps whose slots pass the shared-memory sort (the device-memory
    # scratch): the plateau's n >> 20000, and 65536 slots on the 1080p
    # octave 2 (nL*H*W = 259200), most of them gaps
    check_route("plateau cap 20000", plateau, 20000)
    check_route("octave 2 cap 65536", dogs[2].contiguous(), 65536)
    # nL = 8: two scan launches (layers 1..6, then 7..8) appending to one
    # list; the dense K2 the same way
    deep_cfg = dataclasses.replace(cfg, n_octave_layers=8)
    deep = torch.cat([d0, d0.flip(-1), d0.flip(-2)])[:10].contiguous()
    n_deep = check_route("nL 8", deep, 4096, deep_cfg)[0]
    check(torch.equal(extrema_scores(deep, deep_cfg),
                      extrema_scores_plain(deep, deep_cfg)),
          "K2 at nL 8 is not bit-identical to its plain version")

    # B = 8 with one frame empty and frames over and under their cap
    mixed = dogsb[2].contiguous().clone()
    mixed[3].zero_()
    n_mixed = check_route("batch octave 2, frame 3 empty, cap 615", mixed,
                          615)
    check(n_mixed[3] == 0 and min(n_mixed[:3] + n_mixed[4:]) < 615 <
          max(n_mixed), f"the mixed batch has counts {n_mixed}")

    def check_lists(label, keys_np, counts_np, cap, hw):
        """The select on synthetic key lists against its plain version
        under torch.equal, and each row against the single-frame call."""
        keys = torch.from_numpy(keys_np).to(d0.device)
        count = torch.from_numpy(counts_np).to(d0.device)
        got = select_candidates(keys, count, cap, hw)
        check(same(got, select_candidates_plain(keys, count, cap, hw)),
              f"select on {label} differs from its plain version")
        if keys.shape[0] > 1:
            for b in range(keys.shape[0]):
                one = select_candidates(keys[b:b + 1], count[b:b + 1], cap,
                                        hw)
                check(same((a[b:b + 1] for a in got), one),
                      f"select on {label}: row {b} differs from the "
                      f"single-frame call")

    # n at the launch shape's edges: slices of 1, 32 and kSelThreads keys
    # a CTA and one more or less, cap +- 1, stage and stage + 1 (the
    # kept keys packed), at the 1080p octave 0's shape for one frame and
    # for the batch step's 8; and a tied list past stage
    src = (pathlib.Path(extrema_cuda.__file__).resolve().parent.parent
           / "csrc" / "extrema.cu").read_text()
    threads = int(re.search(r"constexpr int kSelThreads = (\d+);",
                            src).group(1))
    hw0 = tuple(d0.shape[-2:])
    total0 = nl * hw0[0] * hw0[1]
    cap0 = cfg.detect_caps[0]
    rng = np.random.default_rng(12)
    shape1 = extrema_cuda.select_shape(cap0, total0, 1, sms)
    edges = select_edge_counts(cap0, *shape1, threads)
    for n in edges:
        check_lists(f"{n} keys", *synthetic_keys(rng, [n], total0), cap0,
                    hw0)
    shape8 = extrema_cuda.select_shape(cap0, total0, BATCH, sms)
    edges8 = select_edge_counts(cap0, *shape8, threads)
    for k in range(0, len(edges8), BATCH):
        part = (edges8[k:k + BATCH] + [1103] * BATCH)[:BATCH]
        check_lists(f"a batch of {part} keys",
                    *synthetic_keys(rng, part, total0), cap0, hw0)
    check_lists("a tied list past stage",
                *synthetic_keys(rng, [shape1[1] + 999], total0, tied=True),
                cap0, hw0)
    print(f"phase 2 K2 select at the launch shape's edges (cap {cap0}, "
          f"{shape1[0]} CTAs a frame staging {shape1[1]} keys; the batch "
          f"step's {shape8[0]}): n in {edges} one frame, {edges8} in "
          f"batches of {BATCH} (each row the single frame), a tied list "
          f"of {shape1[1] + 999}; B = 8 with frame 3 empty and counts "
          f"{n_mixed} at cap 615: all equal to select_candidates_plain")

    # the route once more: no torch.sort, no host synchronisation
    torch.cuda.synchronize()
    real_sort = torch.sort

    def no_sort(*args, **kwargs):
        raise SmokeFailure("the fused selection called torch.sort")

    torch.sort = no_sort
    torch.cuda.set_sync_debug_mode("error")
    try:
        for label, dog, cap in launches + batch + [
                ("plateau cap 20000", plateau, 20000)]:
            (ext.top_candidates_batch if dog.dim() == 4
             else ext.top_candidates)(dog, cap, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.sort = real_sort
    torch.cuda.synchronize()
    print(f"phase 2 K2 fused selection edge cases: plateau (candidates "
          f"{n_pl[0]} > cap {cfg.detect_caps[0]}, also in a batch), cap "
          f"n-1, n, n+1 at n={n1}, width 1917, 4 bytes off, 48x24 with "
          f"cap 512 (n={n_sm}, general gap path), caps 20000 (plateau) and "
          f"65536 (octave 2) sorting in device memory, nL 8 in two scan "
          f"launches (n={n_deep}; dense K2 too): all equal to "
          f"top_candidates_plain; every route call again, and the plateau "
          f"at cap 20000, with torch.sort removed and sync debug mode "
          f"'error': no sort, no host sync")

    # JSON rows: the 1080p scene's octave 0
    d4, keys, count, cap, counts, ms_c, ms_s, bc, bs, _ = rows[
        "scene octave 0"]
    err_c, err_s = errs["scene octave 0"]
    record("K2-compact", "K2 compact extremum scan (candidate keys)",
           "sift_tpu_torch/csrc/extrema.cu",
           "sift_tpu/ops/extrema_pallas.py:90", float(err_c), ms_c,
           median_ms(lambda: extrema_compact_plain(d4, cfg)), bc)
    hw = tuple(d4.shape[-2:])
    record("K2-select", "K2 top-cap candidate selection",
           "sift_tpu_torch/csrc/extrema.cu", "sift_tpu/ops/extrema.py:214",
           float(err_s), ms_s,
           median_ms(lambda: select_candidates_plain(keys, count, cap, hw)),
           bs)


def hist_err(name, got, want, rows) -> float:
    """Fails unless got is within rtol 1e-5 and atol 1e-5 * max|row| of
    want on the rows selected by the bool mask `rows` (the plain versions
    sum floats in another order; the kernels sum integers); returns the
    largest absolute difference there."""
    g = got[rows].reshape(int(rows.sum()), -1)
    x = want[rows].reshape(g.shape)
    atol = 1e-5 * x.abs().amax(dim=1, keepdim=True)
    check(bool(((g - x).abs() <= 1e-5 * x.abs() + atol).all()),
          f"{name} disagrees with its plain version")
    return float((g - x).abs().max())


def phase_small_hist(name, fn, plain, args, full, rows, where) -> dict:
    """Phase 2: the first SMALL_SLOTS slots of a one-frame K3-ori or
    K3-desc call (args) in a launch of their own, where the wrapper
    splits each keypoint across a cluster of CTAs: against the plain
    version, two launches bit-identical, and bit for bit the same
    keypoints' rows of each larger launch in `full` ({label: rows});
    timed. rows: the slots the plain version bins."""
    import torch
    from sift_tpu_torch.ops.ori_hist_cuda import cluster_size
    k = SMALL_SLOTS
    small = tuple(a[:k] if torch.is_tensor(a) and a.dim() == 1 else a
                  for a in args)
    check(bool(rows[:k].all()), f"{name}: the first {k} slots are not valid")
    got, again = fn(*small), fn(*small)
    want = plain(*small)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name} at N={k}: two launches differ")
    for label, rows_full in full.items():
        check(torch.equal(got, rows_full[:k]),
              f"{name} at N={k} differs from the same keypoints' rows of "
              f"{label}")
    err = hist_err(f"{name} at N={k}", got, want, rows[:k])
    ms = median_ms(lambda: fn(*small))
    pms = median_ms(lambda: plain(*small))
    bnd = hist_bound(name.split()[0], small)
    size = cluster_size(k, args[0].device)
    print(f"phase 2 {name} small launch ({where}, N={k}, {size} CTAs a "
          f"keypoint): max_abs_err={err!r} (two launches bit-identical, "
          f"bit for bit the rows of {' and '.join(full)}) kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    return {"keypoints": k, "cluster": size, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": float(bnd[0]), "bound_by": bnd[1]}


def checkerboard_args(name, cfg, n: int, dev, seed: int = 5) -> tuple:
    """Wrapper arguments of a K3-ori or K3-desc call on a 0/255
    checkerboard of 2 x 2 squares, so that every central difference of
    the window is +-255 and every sample adds the largest magnitude, at
    the largest radius (radius = the patch radius, the descriptor's
    rotated square filling the box) for n keypoints in the interior."""
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    nl = cfg.n_octave_layers
    ori = name == "K3-ori"
    rad = cfg.ori_patch_radius if ori else cfg.descr_patch_radius
    h = w = 4 * rad + 64
    yy, xx = np.mgrid[0:h, 0:w]
    board = np.where((yy // 2 + xx // 2) % 2 == 0, 255.0, 0.0)
    stack = torch.from_numpy(np.repeat(board[None], nl, 0).astype(
        np.float32)).to(dev)
    padded = F.pad(stack, (rad + 1,) * 4)

    def ints(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(
            np.int32)).to(dev)

    layer, r, c = ints(0, nl), ints(rad + 2, h - rad - 2), ints(rad + 2,
                                                                 w - rad - 2)
    radius = torch.full((n,), rad, dtype=torch.int32, device=dev)
    if ori:
        sigma = cfg.ori_sig_fctr * rad / cfg.ori_radius_fctr
        expf = torch.full((n,), -1.0 / (2.0 * sigma * sigma), device=dev)
        return padded, layer, r, c, radius, expf, cfg
    d = cfg.descr_width
    hist_width = rad / (math.sqrt(2.0) * (d + 1) * 0.5)
    theta = torch.from_numpy(rng.uniform(0.0, 360.0, n).astype(
        np.float32)).to(dev)
    rad_t = theta * (math.pi / 180.0)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    return (padded, layer, r, c, torch.cos(rad_t) / hist_width,
            torch.sin(rad_t) / hist_width, radius, theta, valid, cfg)


def phase_hist_extreme(report, dev) -> None:
    """Phase 2, K3-ori and K3-desc (both arms) on checkerboard_args at
    the largest radius, where an overflow of the kernels' integer scale
    would show: against the plain versions (hist_err), at N = SMALL_SLOTS
    (a cluster of CTAs a keypoint) and at N = out_caps[0] (one CTA),
    whose first SMALL_SLOTS rows must equal the small launch's."""
    import dataclasses

    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops.descr_hist_cuda import (descriptor_hist,
                                                    descriptor_hist_plain)
    from sift_tpu_torch.ops.ori_hist_cuda import (orientation_hist,
                                                  orientation_hist_plain)
    bcfg = dataclasses.replace(cfg, descr_rc_bf16=True)
    n = cfg.out_caps[0]
    parts = []
    for name, fn, plain, c in (
            ("K3-ori", orientation_hist, orientation_hist_plain, cfg),
            ("K3-desc", descriptor_hist, descriptor_hist_plain, cfg),
            ("K3-desc (bf16 arm)", descriptor_hist, descriptor_hist_plain,
             bcfg)):
        args = checkerboard_args(name.split()[0], c, n, dev)
        args = args[:-1] + (c,)
        small = tuple(a[:SMALL_SLOTS] if torch.is_tensor(a) and a.dim() == 1
                      else a for a in args)
        got, got_s = fn(*args), fn(*small)
        want, want_s = plain(*args), plain(*small)
        torch.cuda.synchronize()
        rows = torch.ones(n, dtype=torch.bool, device=dev)
        err = max(hist_err(f"{name} on the checkerboard", got, want, rows),
                  hist_err(f"{name} on the checkerboard at N={SMALL_SLOTS}",
                           got_s, want_s, rows[:SMALL_SLOTS]))
        check(torch.equal(got[:SMALL_SLOTS], got_s),
              f"{name} on the checkerboard: the N={SMALL_SLOTS} launch "
              f"differs from the N={n} launch's rows")
        peak = float(want.abs().max())
        report[name.split()[0]]["extreme" + (
            "_bf16" if "bf16" in name else "")] = {
            "keypoints": n, "max_abs_err": err, "largest_bin": peak}
        parts.append(f"{name} max_abs_err={err!r} (largest bin {peak!r})")
    print(f"phase 2 K3 extreme window (0/255 checkerboard of 2x2 squares, "
          f"largest radius, N={n} and N={SMALL_SLOTS}, equal rows): "
          + "; ".join(parts))


def nonfinite_args(name, cfg, dev) -> tuple:
    """checkerboard_args for 2 keypoints, with an infinity in the padded
    stack that only a sample keypoint 0 does not bin reads (its box's
    leftmost column, left of the image: keypoint 0 at column 1), and a NaN
    at keypoint 1's own pixel, which 4 of its binned samples read."""
    args = checkerboard_args(name, cfg, 2, dev)
    ori = name == "K3-ori"
    rad = cfg.ori_patch_radius if ori else cfg.descr_patch_radius
    padded, layer, r, c = (a.clone() for a in args[:4])
    # keypoint 0 at column 1, keypoint 1 at the right, clear of its window
    c[0], c[1] = 1, padded.shape[-1] - 2 * (rad + 1) - rad - 3
    # the box sample (R, 0) of a full-radius box reads window (R + 1, 0),
    # which is padded (row + rad + 1, col + rad - R) = (row + rad + 1, 1)
    lay, kr = (int(v) for v in (layer[0], r[0]))
    padded[lay, kr + rad + 1, 1] = float("inf")
    lay, kr, kc = (int(v) for v in (layer[1], r[1], c[1]))
    padded[lay, kr + rad + 1, kc + rad + 1] = float("nan")
    return (padded, layer, r, c) + args[4:]


def phase_hist_nonfinite(report, dev) -> None:
    """Phase 2, K3-ori and K3-desc on nonfinite_args, one CTA a keypoint
    and clusters of 8 (the cluster size patched in the wrappers): row 0,
    whose infinity no binned sample reads, is finite and within hist_err
    of the plain version; row 1, whose NaN 4 binned samples read, is all
    NaN, and the plain version's row 1 is not finite; both launches give
    the same bits."""
    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import descr_hist_cuda, ori_hist_cuda
    chosen = ori_hist_cuda.cluster_size
    parts = []
    for name, fn, plain in (
            ("K3-ori", ori_hist_cuda.orientation_hist,
             ori_hist_cuda.orientation_hist_plain),
            ("K3-desc", descr_hist_cuda.descriptor_hist,
             descr_hist_cuda.descriptor_hist_plain)):
        args = nonfinite_args(name, cfg, dev)
        got = {}
        try:
            for size in (1, 8):
                for m in (ori_hist_cuda, descr_hist_cuda):
                    m.cluster_size = lambda *a, s=size: s
                got[size] = fn(*args).reshape(2, -1)
        finally:
            for m in (ori_hist_cuda, descr_hist_cuda):
                m.cluster_size = chosen
        want = plain(*args).reshape(2, -1)
        torch.cuda.synchronize()
        check(torch.equal(got[1].view(torch.int32), got[8].view(torch.int32)),
              f"{name} with a non-finite window: clusters of 1 and 8 CTAs "
              f"differ")
        row0 = torch.tensor([True, False], device=dev)
        check(bool(torch.isfinite(got[1][0]).all()),
              f"{name}: an infinity that no binned sample reads reached "
              f"the row")
        check(bool(torch.isfinite(want[0]).all()),
              f"{name} (plain): an infinity that no binned sample reads "
              f"reached the row")
        err = hist_err(f"{name} beside an infinity it does not bin",
                       got[1], want, row0)
        check(bool(torch.isnan(got[1][1]).all()),
              f"{name}: a NaN in binned samples did not make the row NaN")
        check(not bool(torch.isfinite(want[1]).all()),
              f"{name} (plain): a NaN in binned samples left the row "
              f"finite")
        report[name]["nonfinite"] = {"max_abs_err": err}
        parts.append(f"{name} max_abs_err={err!r}")
    print("phase 2 K3 non-finite windows (an infinity only an unbinned "
          "sample reads: finite rows; a NaN binned samples read: NaN "
          "rows; 1 and 8 CTAs a keypoint equal): " + "; ".join(parts))


def phase_fused_hist(gauss, kp, rng, record, report) -> None:
    """Phase 2, K3-ori and K3-desc: the octave-0 stack of the scene with
    its real keypoints (N = out_caps[0] slots) plus EXTRA_SLOTS valid
    slots whose windows start outside the image (the starts clamp);
    K3-desc under both arms of descr_rc_bf16."""
    import dataclasses

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
    err = hist_err("K3-ori", got, want, valid)
    real_args = tuple(a[:n_real] if torch.is_tensor(a) and a.dim() == 1
                      else a for a in args)
    ms = median_ms(lambda: orientation_hist(*real_args))
    pms = median_ms(lambda: orientation_hist_plain(*real_args))
    bnd = hist_bound("K3-ori", real_args)
    print(f"phase 2 K3-ori orientation histograms p={2 * rp + 3} "
          f"N={n_real}+{e} (valid {int(valid.sum())}): max_abs_err={err!r} "
          f"(two launches bit-identical) kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms at N={n_real}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K3-ori", "K3-ori fused window gather + orientation histogram",
           "sift_tpu_torch/csrc/ori_hist.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", err, ms, pms, bnd)
    report["K3-ori"]["small"] = phase_small_hist(
        "K3-ori", orientation_hist, orientation_hist_plain, real_args,
        {f"the N={n_real}+{e} launch": got}, valid, "1080p octave 0")

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
    err = hist_err("K3-desc", got, want, valid)
    real_args = tuple(a[:n_real] if torch.is_tensor(a) and a.dim() == 1
                      else a for a in args)
    ms = median_ms(lambda: descriptor_hist(*real_args))
    pms = median_ms(lambda: descriptor_hist_plain(*real_args))
    bnd = hist_bound("K3-desc", real_args)
    print(f"phase 2 K3-desc descriptor histograms p={2 * rd + 3} "
          f"N={n_real}+{e} (valid {int(valid.sum())}): max_abs_err={err!r} "
          f"(two launches bit-identical) kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms at N={n_real}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    record("K3-desc", "K3-desc fused window gather + descriptor histogram",
           "sift_tpu_torch/csrc/descr_hist.cu",
           "sift_tpu/ops/ori_gather_pallas.py:109", err, ms, pms, bnd)
    report["K3-desc"]["small"] = phase_small_hist(
        "K3-desc", descriptor_hist, descriptor_hist_plain, real_args,
        {f"the N={n_real}+{e} launch": got}, valid, "1080p octave 0")

    # K3-desc under sift_tpu's default bf16 arm, on the same slots
    bcfg = dataclasses.replace(cfg, descr_rc_bf16=True)
    bargs = args[:-1] + (bcfg,)
    got_b, again_b = descriptor_hist(*bargs), descriptor_hist(*bargs)
    want_b = descriptor_hist_plain(*bargs)
    torch.cuda.synchronize()
    check(torch.equal(got_b, again_b), "K3-desc (bf16 arm): two launches "
                                       "differ")
    check(bool((got_b[~valid] == 0).all()),
          "K3-desc (bf16 arm): a slot with valid false is not zero")
    check(not torch.equal(got_b, got), "K3-desc: the bf16 arm gives the "
                                       "f32 arm's bits")
    err_b = hist_err("K3-desc (bf16 arm)", got_b, want_b, valid)
    real_b = real_args[:-1] + (bcfg,)
    ms_b = median_ms(lambda: descriptor_hist(*real_b))
    pms_b = median_ms(lambda: descriptor_hist_plain(*real_b))
    bnd_b = hist_bound("K3-desc", real_b)
    print(f"phase 2 K3-desc bf16 arm p={2 * rd + 3} N={n_real}+{e}: "
          f"max_abs_err={err_b!r} (two launches bit-identical) kernel "
          f"{ms_b:.4f} ms (f32 arm {ms:.4f} ms), plain {pms_b:.4f} ms at "
          f"N={n_real}, bound {bnd_b[0]:.4f} ms ({bnd_b[1]})")
    report["K3-desc"]["bf16"] = {
        "keypoints": n_real, "max_abs_err": err_b, "ms": ms_b,
        "plain_ms": pms_b, "bound_ms": float(bnd_b[0]),
        "bound_by": bnd_b[1]}
    report["K3-desc"]["small_bf16"] = phase_small_hist(
        "K3-desc (bf16 arm)", descriptor_hist, descriptor_hist_plain,
        real_b, {f"the N={n_real}+{e} launch": got_b}, valid,
        "1080p octave 0")


def phase_fused_hist_batch(gauss, kp, rng, report) -> None:
    """Phase 2, K3-ori and K3-desc over the batch step's B frames at
    octave 0, one launch each on the (B * nl, Hp, Wp) stack, as
    detect_and_compute_batch launches them: per frame its real keypoints
    (out_caps[0] slots), EXTRA_SLOTS valid slots starting outside the
    image at stack layers -1..nl, and TRAP_SLOTS invalid slots at stack
    layer -1, which in frames b >= 1 must read frame b's first plane and
    not frame b - 1's last. Each against its plain version on every row
    K3-ori bins (all) and K3-desc bins (valid) within rtol 1e-5 and
    atol 1e-5 * max|hist| per row; each frame also equal to the
    single-frame launch on that frame alone, bit for bit; timed on the
    B x out_caps[0] real slots; K3-desc under both arms of
    descr_rc_bf16. Adds a "batch" entry to each row (and "batch_bf16" to
    K3-desc's)."""
    import dataclasses

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
    nb = gauss.shape[0]
    nl = cfg.n_octave_layers
    h, w = gauss.shape[-2:]
    n_real = kp.capacity
    e, t = EXTRA_SLOTS, TRAP_SLOTS
    check(all(int(kp.valid[b].sum()) > 100 for b in range(nb)),
          f"too few valid octave-0 keypoints per frame: "
          f"{kp.valid.sum(dim=1).tolist()}")

    def per_frame(draw, dtype):
        return torch.as_tensor(np.stack([draw() for _ in range(nb)]),
                               dtype=dtype, device=dev)

    def slots(a, extra, trap):
        return torch.cat([a, extra.to(a.dtype), trap.to(a.dtype)], dim=1)

    real = [torch.nonzero(kp.valid[b]).flatten().cpu().numpy()
            for b in range(nb)]
    pick = torch.as_tensor(np.stack([rng.choice(v, e) for v in real]),
                           device=dev)
    pick_t = torch.as_tensor(np.stack([rng.choice(v, t) for v in real]),
                             device=dev)
    above = rng.random((nb, e)) < 0.5
    xr = torch.as_tensor(np.where(above, rng.integers(-60, 0, (nb, e)),
                                  rng.integers(h, h + 60, (nb, e))),
                         device=dev)
    zeros_t = torch.zeros((nb, t), dtype=torch.int32, device=dev)
    layer = slots(kp.layer, per_frame(lambda: rng.integers(0, nl + 2, e),
                                      torch.int32), zeros_t)
    r = slots(kp.r, xr, kp.r.gather(1, pick_t))
    c = slots(kp.c, per_frame(lambda: rng.integers(-60, w + 60, e),
                              torch.int32), kp.c.gather(1, pick_t))
    size = slots(kp.size, kp.size.gather(1, pick), kp.size.gather(1, pick_t))
    angle = slots(kp.angle, kp.angle.gather(1, pick),
                  kp.angle.gather(1, pick_t))
    valid = slots(kp.valid, torch.ones((nb, e), dtype=torch.bool,
                                       device=dev),
                  torch.zeros((nb, t), dtype=torch.bool, device=dev))

    def run(name, fn, plain, args, rows, key="batch"):
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} at B={nb}: two launches "
                                       f"differ")
        frames = [tuple(a[b] if torch.is_tensor(a) else a for a in args)
                  for b in range(nb)]
        ones = [fn(*f) for f in frames]
        for b in range(nb):
            check(torch.equal(got[b], ones[b]),
                  f"{name} at B={nb}: frame {b} differs from the "
                  f"single-frame launch on it")
        err = hist_err(f"{name} at B={nb}", got, want, rows)
        real = tuple(a[:, :n_real] if torch.is_tensor(a) and a.dim() == 2
                     else a for a in args)
        ms = median_ms(lambda: fn(*real))
        pms = median_ms(lambda: plain(*real), runs=3)
        stack = args[0]
        bnd = hist_bound(name, real)
        print(f"phase 2 {name} ({key}) over B={nb} frames "
              f"{tuple(stack.shape)} "
              f"N={nb}x({n_real}+{e}+{t}) (valid {int(valid.sum())}, "
              f"{t} invalid slots a frame at stack layer -1): "
              f"max_abs_err={err!r} (two launches bit-identical, each "
              f"frame equal to its single-frame launch) kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms at N={nb}x{n_real}, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")
        report[name][key] = {
            "frames": nb, "keypoints": nb * n_real, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": float(bnd[0]),
            "bound_by": bnd[1]}
        # frame 0's first SMALL_SLOTS slots alone: bit for bit their rows
        # of the batched launch and of frame 0's single-frame launch
        report[name][f"{key}_small"] = phase_small_hist(
            f"{name} ({key})", fn, plain, frames[0],
            {f"the B={nb} launch": got[0],
             f"frame 0's N={rows.shape[1]} launch": ones[0]}, rows[0],
            "batch step frame 0")

    rp = cfg.ori_patch_radius
    po = F.pad(gauss[:, 1:1 + nl], (rp + 1,) * 4)
    radius, expf_scale = orientation_params(size * 0.5, cfg)
    run("K3-ori", orientation_hist, orientation_hist_plain,
        (po, layer - 1, r, c, radius, expf_scale, cfg),
        torch.ones_like(valid))
    rd = cfg.descr_patch_radius
    pd = F.pad(gauss[:, 1:1 + nl], (rd + 1,) * 4)
    prm = descriptor_params(size, angle, torch.ones(1, device=dev), (h, w),
                            cfg)
    dargs = (pd, layer - 1, r, c, prm.cos_t, prm.sin_t, prm.radius, prm.ori,
             valid, cfg)
    got = descriptor_hist(*dargs)
    check(bool((got[~valid] == 0).all()),
          f"K3-desc at B={nb}: a slot with valid false is not zero")
    run("K3-desc", descriptor_hist, descriptor_hist_plain, dargs, valid)
    bargs = dargs[:-1] + (dataclasses.replace(cfg, descr_rc_bf16=True),)
    run("K3-desc", descriptor_hist, descriptor_hist_plain, bargs, valid,
        key="batch_bf16")


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
    from sift_tpu_torch.ops.extrema_cuda import (extrema_compact,
                                                 extrema_scores,
                                                 extrema_scores_batch,
                                                 select_candidates)
    from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist
    from sift_tpu_torch.ops.ori_gather_cuda import gather_patches
    from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist
    from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda
    from sift_tpu_torch.ops.refine import refine_candidates
    from sift_tpu_torch.ops.segsum import segment_sum
    return {"K1": blur_vh, "K1-batch": blur_vh_batch, "K2": extrema_scores,
            "K2-batch": extrema_scores_batch, "K2-compact": extrema_compact,
            "K2-select": select_candidates, "K3": gather_patches,
            "K3-ori": orientation_hist, "K3-desc": descriptor_hist,
            "K4": knn2_l1_cuda, "refine": refine_candidates,
            "segsum": segment_sum}


def usable_octaves(hw) -> int:
    """How many octaves of an (H, W) frame detect_and_compute runs:
    refine, K3-ori and K3-desc launch once for each."""
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
    path = ("K1", "K2-compact", "K2-select", "refine", "K3-ori", "K3-desc",
            "K4")
    counts = [launches[k] for k in path]
    for k in path + ("K2", "K3"):
        report[k]["launches"] = launches[k]
    check(all(nl > 0 for nl in counts),
          f"a kernel did not launch on the main path: {counts}")
    per_frame = usable_octaves(scene_np.shape) + usable_octaves(obj_np.shape)
    once = ("K2-compact", "K2-select", "refine", "K3-ori", "K3-desc")
    check(all(launches[k] == per_frame for k in once),
          f"{once} launched { [launches[k] for k in once] } times, not "
          f"once per usable octave ({per_frame})")
    check(launches["K3"] == 0 and launches["K2"] == 0,
          f"the bare gather K3 / the dense K2 launched {launches['K3']} / "
          f"{launches['K2']} times")
    corners = det.corners.cpu().numpy()
    cerr = float(np.abs(corners - true_corners).max())
    n_s, n_o = int(det.scene_kp.count()), int(det.object_kp.count())
    n_good, n_inl = int(det.matches.good.sum()), int(det.n_inliers)
    sat = [sift.octave_saturation(k, cfg).cpu().numpy().astype(int).tolist()
           for k in (det.scene_kp, det.object_kp)]
    print(f"phase 4 main path 1080x1920 scene / 480x640 object: launches "
          f"{dict(zip(path, counts))} gather K3={launches['K3']} dense "
          f"K2={launches['K2']} "
          f"scene_kp={n_s} object_kp={n_o} good={n_good} "
          f"inliers={n_inl} found={bool(det.found)} "
          f"corner_err_px={cerr!r} out_cap_saturated(scene, object)={sat}")
    check(bool(det.found), "object not found at 1080p")
    check(cerr < 2.0, f"corners {cerr} px from the truth")
    phase_main_path_bf16(scene, obj, det, true_corners)

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


def phase_main_path_bf16(scene, obj, det, true_corners) -> None:
    """Phase 4 under sift_tpu's default descriptor arm (descr_rc_bf16):
    the keypoints equal the f32 run's, 99 % of the descriptor rows move
    by at most BF16_DESC_L1 from it and every row by at most
    BF16_DESC_L1_MAX, and the object is still found within 2 px."""
    import dataclasses

    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.pipeline import detect_object

    bcfg = dataclasses.replace(cfg, descr_rc_bf16=True)
    det_b, launches = counted(lambda: detect_object(scene, obj, bcfg))
    check(launches["K3-desc"] > 0, "the bf16 arm did not launch K3-desc")
    l1s = []
    for which in ("scene", "object"):
        kp, kp_b = getattr(det, f"{which}_kp"), getattr(det_b, f"{which}_kp")
        for f in ("x", "y", "size", "angle", "response", "octave", "layer",
                  "r", "c", "valid"):
            check(torch.equal(getattr(kp, f), getattr(kp_b, f)),
                  f"bf16 arm: {which} keypoint field {f} differs from the "
                  f"f32 run's")
        d, d_b = getattr(det, f"{which}_desc"), getattr(det_b, f"{which}_desc")
        l1 = (d - d_b).abs().sum(dim=1)
        check(bool((l1[kp.valid] > 0).any()),
              f"bf16 arm: {which} descriptors equal the f32 arm's")
        check(bool((l1[~kp.valid] == 0).all()),
              f"bf16 arm: an invalid {which} row is not zero")
        l1s.append(l1[kp.valid].cpu().numpy())
    l1 = np.concatenate(l1s)
    worst, p99 = float(l1.max()), float(np.percentile(l1, 99))
    check(p99 <= BF16_DESC_L1 and worst <= BF16_DESC_L1_MAX,
          f"bf16 arm: descriptor rows moved {p99} L1 (99th percentile) and "
          f"{worst} (max) from the f32 run's")
    cerr = float(np.abs(det_b.corners.cpu().numpy() - true_corners).max())
    print(f"phase 4 main path, bf16 descriptor arm: keypoints equal the "
          f"f32 run's; descriptor rows against it, L1: max {worst!r}, "
          f"99th percentile {p99!r}, median {float(np.median(l1))!r}, "
          f"{int((l1 > BF16_DESC_L1).sum())} of {len(l1)} rows above "
          f"{BF16_DESC_L1}; "
          f"good={int(det_b.matches.good.sum())} "
          f"inliers={int(det_b.n_inliers)} found={bool(det_b.found)} "
          f"corner_err_px={cerr!r}")
    check(bool(det_b.found), "bf16 arm: object not found at 1080p")
    check(cerr < 2.0, f"bf16 arm: corners {cerr} px from the truth")


def phase_batch(scene_np, report, pair_fps: float) -> None:
    """Phase 5: the throughput path, detect_and_compute_batch on BATCH
    1080p frames and the BATCH - 1 consecutive-frame matches in one
    batched match_ratio (bench.py's batch step, bench.py:511-519, whose
    vmap puts the pairs on one K4 launch), with launch counts; each row
    against detect_and_compute on its frame, each pair against
    match_ratio on it; frames/s and peak memory."""
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import match as match_mod

    frames = batch_frames(torch.from_numpy(scene_np).cuda())

    def batch_step():
        kp, d = sift.detect_and_compute_batch(frames, cfg)
        ms = match_mod.match_ratio(d[1:], d[:-1], q_valid=kp.valid[1:],
                                   t_valid=kp.valid[:-1],
                                   ratio=cfg.match_ratio)
        return kp, d, ms

    (kp, d, ms), launches = counted(batch_step)
    check(launches["K4"] == 1, f"batch step: K4 launched {launches['K4']} "
                               f"times for its {BATCH - 1} pairs, not once")
    for k in ("K1-batch", "K2-batch"):
        report[k]["launches"] = launches[k]
    check(all(launches[k] > 0 for k in ("K1-batch", "K2-compact",
                                        "K2-select", "refine", "K3-ori",
                                        "K3-desc", "K4")),
          f"a kernel of the batch path did not launch: {launches}")
    check(all(launches[k] == 0 for k in ("K1", "K2", "K2-batch", "K3")),
          f"the batch path launched a single-frame kernel or the dense "
          f"K2: {launches}")
    octaves = usable_octaves(scene_np.shape)
    check(launches["K2-compact"] == octaves
          and launches["K2-select"] == octaves,
          f"batch step: the compact scan / select launched "
          f"{launches['K2-compact']}/{launches['K2-select']} times, not "
          f"once per octave ({octaves})")
    check(launches["K3-ori"] == octaves and launches["K3-desc"] == octaves
          and launches["refine"] == octaves,
          f"batch step: refine/K3-ori/K3-desc launched "
          f"{launches['refine']}/{launches['K3-ori']}/"
          f"{launches['K3-desc']} times, not once per octave for all "
          f"{BATCH} frames ({octaves})")
    n = sum(cfg.out_caps)
    check(tuple(kp.x.shape) == (BATCH, n)
          and tuple(d.shape) == (BATCH, n, cfg.descr_size),
          f"batch shapes {tuple(kp.x.shape)} {tuple(d.shape)}")
    check(bool(torch.isfinite(d).all()) and all(
        bool(torch.isfinite(getattr(kp, f)).all())
        for f in ("x", "y", "size", "angle", "response")),
        "non-finite batch output")
    n_good = ms.good.sum(dim=1).tolist()
    check(min(n_good) > 20, f"too few consecutive-frame matches: {n_good}")
    for b in range(1, BATCH):
        want = match_mod.match_ratio(d[b], d[b - 1], q_valid=kp.valid[b],
                                     t_valid=kp.valid[b - 1],
                                     ratio=cfg.match_ratio)
        check(all(torch.equal(x[b - 1], y) for x, y in zip(ms, want)),
              f"batch step: pair {b} of the batched match differs from "
              f"match_ratio on it")

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
          f"diff={dmax!r}; the {BATCH - 1} matches in one K4 launch, each "
          f"pair's Matches equal to match_ratio on it")
    del kp, d, ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_wall_ms(batch_step)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5 timing: batch step (detect_and_compute_batch B={BATCH} "
          f"+ {BATCH - 1} matches in one K4 launch) {step_ms:.3f} ms "
          f"(median of 10) = "
          f"{BATCH * 1000.0 / step_ms:.3f} frames/s, pair step "
          f"{pair_fps:.3f} frames/s; peak device memory "
          f"{peak / 2**30:.3f} GiB")


def mapping_textures() -> list:
    """Phase 6's four plane textures (the renderer's `_TEXTURES`
    slots): 480x640 synthetic gray images from fixed seeds."""
    return [to_gray(texture(*MAP_TEXTURE_HW, seed=100 + i, n_blobs=300))
            for i in range(4)]


def sequential_pairs(n_frames: int, window: int) -> int:
    """Frame pairs run_mapping matches with K4: each frame against the
    next `window` frames."""
    return sum(min(window, n_frames - 1 - i) for i in range(n_frames))


def cpu_sampler(kind, valid, n_samples, k, seed):
    """RANSAC draws from a seeded CPU torch.Generator, moved to the
    call's device: a CPU and a CUDA run draw the same samples (the two
    devices' generators give different streams)."""
    import torch
    from sift_tpu_torch.geometry.homography import gumbel_top_k
    gen = torch.Generator().manual_seed(seed)
    return gumbel_top_k(valid.cpu(), n_samples, k, gen).to(valid.device)


def mapping_gates(stats: dict, ate: dict) -> list:
    """The failed `mapping_*` gates of sift_tpu_torch.eval.GATES."""
    from sift_tpu_torch.eval import GATES
    failed = []
    if stats["n_registered"] < (GATES["mapping_min_registered_frac"]
                                * stats["n_frames"]):
        failed.append("registered")
    if stats["n_closures"] < GATES["mapping_min_closures"]:
        failed.append("closures")
    if ate["ate_final"] > GATES["mapping_max_ate"]:
        failed.append("ate_final")
    if stats["reproj_rmse"] > GATES["mapping_max_reproj"]:
        failed.append("reproj_rmse")
    return failed


def _stats_line(stats: dict, ate: dict) -> str:
    keys = ("n_registered", "n_points", "n_seq_pairs", "n_closures",
            "n_closure_edges", "n_closure_obs", "reproj_rmse")
    return (" ".join(f"{k}={stats[k]!r}" for k in keys) + " "
            + " ".join(f"{k}={v!r}" for k, v in ate.items()))


def phase_mapping_gated(textures) -> None:
    """Phase 6a: run_mapping on CUDA at eval_mapping's configuration (16
    frames of 240x320, sift_tpu/eval.py:248-249), default arguments,
    exporting to a temporary directory; the four mapping gates, both
    export files, and the launches of every kernel: segsum once per
    segment sum that the call's sfm.ba and sfm.posegraph spans make
    (with the sums of BA's graph replays, segsum_replays)."""
    import os
    import tempfile
    from sift_tpu_torch.sfm.mapping import (mapping_ate,
                                            render_corner_sequence,
                                            run_mapping)
    n_frames, hw = MAP_GATED
    from sift_tpu_torch.utils import profiling
    frames, k, gt = render_corner_sequence(n_frames=n_frames, size=hw,
                                           textures=textures)
    t0 = time.perf_counter()
    profiling.clear()
    with tempfile.TemporaryDirectory() as td, profiling.tracing(), \
            segsum_replays() as tally:
        res, launches = counted(lambda: run_mapping(
            frames, k, export_prefix=os.path.join(td, "map")))
        exported = [os.path.exists(p) for p in res.stats["export"].values()]
    wall = time.perf_counter() - t0
    check_segsum_launches("6a", launches, profiling.spans(), tally)
    ate = mapping_ate(res, gt)
    print(f"phase 6a mapping {n_frames}x{hw[0]}x{hw[1]} on the card: "
          f"{_stats_line(res.stats, ate)} exported={exported} "
          f"launches { {k: launches[k] for k in KERNELS} } "
          f"(first run {wall:.1f} s)")
    failed = mapping_gates(res.stats, ate)
    check(not failed, f"mapping gates failed: {failed}")
    check(len(exported) == 2 and all(exported), "export files missing")
    per_octave = n_frames * usable_octaves(hw)
    once = ("K2-compact", "K2-select", "refine", "K3-ori", "K3-desc")
    check(all(launches[k] == per_octave for k in once),
          f"{once} launched { [launches[k] for k in once] } times, not "
          f"once per usable octave of each frame ({per_octave})")
    pairs = sequential_pairs(n_frames, 3)
    check(launches["K4"] == pairs,
          f"K4 launched {launches['K4']} times, not once per sequential "
          f"pair ({pairs})")
    check(launches["K1"] > 0, "K1 did not launch")
    check(all(launches[k] == 0 for k in ("K1-batch", "K2", "K2-batch",
                                         "K3")),
          f"the mapping path launched a batch kernel, the dense K2 or the "
          f"bare gather K3: {launches}")


def segsum_sums(recs) -> int:
    """The segment sums that the traced spans `recs` make: 6 + 2
    cg_iters an LM iteration of each `sfm.ba` (sfm/ba.py: five for the
    normal equations and the right-hand sides, two a CG iteration, one
    for the back-substitution) and 6 a Gauss-Newton iteration of each
    `sfm.posegraph` (sfm/posegraph.py)."""
    return (sum((6 + 2 * r.attrs["cg_iters"]) * r.attrs["iters"]
                for r in recs if r.name == "sfm.ba")
            + sum(6 * r.attrs["iters"] for r in recs
                  if r.name == "sfm.posegraph"))


class _Tally:
    """What segsum_replays counted: the segment sums that graph replays
    launched (`replayed`), and those of them that each capture's
    checking replay launched (`checks`)."""

    def __init__(self):
        self.replayed = self.checks = 0


@contextlib.contextmanager
def segsum_replays():
    """Inside it, the segsum wrapper's `launches` also counts the sums
    that CUDA-graph replays of graphs.CACHE launch: the wrapper counts
    its Python calls, and a replay makes none. A capture calls the
    wrapper without launching anything; those calls are taken off the
    count and kept as the graph's sums, which every replay of the graph
    adds back. The cache replays each capture once to check it (those
    sums are not the call's own: `checks`). The cache is cleared on
    entry, so that every graph replayed inside was captured inside; the
    graphs it captures go on counting after it, which `counted` zeroes.
    Yields the _Tally."""
    from unittest import mock
    from sift_tpu_torch.geometry import graphs
    from sift_tpu_torch.ops.segsum import segment_sum
    cache = graphs.CACHE
    capture = cache._capture
    tally = _Tally()

    def counting_capture(fn, args, pools):
        before = segment_sum.launches
        try:
            replay, outs = capture(fn, args, pools)
        finally:
            sums = segment_sum.launches - before
            segment_sum.launches = before
        tally.checks += sums

        def counting_replay():
            replay()
            segment_sum.launches += sums
            tally.replayed += sums
        return counting_replay, outs

    cache.clear()
    with mock.patch.object(cache, "_capture", counting_capture):
        yield tally


def check_segsum_launches(phase: str, launches: dict, recs,
                          tally: _Tally) -> int:
    """Every segment sum of a run_mapping call launched csrc/segsum.cu
    once: its launches, counted inside segsum_replays and less the
    capture checks' (`tally`, zeroed before the call), equal
    segsum_sums of the call's spans."""
    want = segsum_sums(recs)
    n_ba = sum(r.name == "sfm.ba" for r in recs)
    n_pg = sum(r.name == "sfm.posegraph" for r in recs)
    got = launches["segsum"] - tally.checks
    print(f"phase {phase} segsum launches {launches['segsum']} over {n_ba} "
          f"sfm.ba and {n_pg} sfm.posegraph spans, which make {want} "
          f"segment sums; {tally.replayed} of the launches by graph "
          f"replays, {tally.checks} of those by the capture checks")
    check(n_ba > 0 and n_pg > 0, f"phase {phase}: run_mapping recorded "
          f"{n_ba} sfm.ba and {n_pg} sfm.posegraph spans")
    check(got == want, f"phase {phase}: segsum launched {got} times "
          f"(without the capture checks), not once per segment sum ({want})")
    return want


def phase_mapping_cpu_vs_card(textures) -> None:
    """Phase 6b: the same run_mapping on tests/test_mapping.py's sequence
    (10 frames of 200x268, seed 3; pair window 2, min gap 4, one closure
    candidate), plain versions on the CPU against the card, both drawing
    RANSAC samples from cpu_sampler. Registered frames and closure pairs
    must be equal; ATE and RMSE within MAP_CPU_CARD_RTOL, relative."""
    from sift_tpu_torch.sfm.mapping import (mapping_ate,
                                            render_corner_sequence,
                                            run_mapping)
    n_frames, hw = MAP_SMALL
    frames, k, gt = render_corner_sequence(n_frames=n_frames, size=hw,
                                           seed=3, textures=textures)
    kw = dict(pair_window=2, min_gap=4, closure_candidates=1,
              sampler=cpu_sampler)
    t0 = time.perf_counter()
    on_cpu = run_mapping(frames, k, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    on_card = run_mapping(frames, k, **kw)
    out = {}
    for name, res in (("cpu", on_cpu), ("card", on_card)):
        ate = mapping_ate(res, gt)
        out[name] = (ate["ate_final"], res.reproj_rmse)
        print(f"phase 6b mapping {n_frames}x{hw[0]}x{hw[1]} on the {name}: "
              f"{_stats_line(res.stats, ate)}")
    check(np.array_equal(on_cpu.registered, on_card.registered),
          "registered frames differ")
    pairs = [[(c.i, c.j) for c in r.closures] for r in (on_cpu, on_card)]
    check(pairs[0] == pairs[1], f"closure pairs differ: {pairs}")
    rel = [abs(a - b) / abs(a) for a, b in zip(out["cpu"], out["card"])]
    print(f"phase 6b cpu-vs-card: registered equal, closure pairs equal "
          f"({len(pairs[0])}), relative difference ate_final={rel[0]!r} "
          f"reproj_rmse={rel[1]!r} (cpu run {t_cpu:.1f} s)")
    check(max(rel) <= MAP_CPU_CARD_RTOL,
          f"ate_final / reproj_rmse differ by {rel} (> {MAP_CPU_CARD_RTOL})")


def _profile_busy(fn) -> tuple:
    """(device busy ms -- the union of the device events' intervals --,
    device events, the 8 largest device kernels as (name, ms, calls)) of
    one call of fn under torch.profiler, tracing the card only. The raw
    trace events are read directly: building the profiler's EventList
    of a call with ~10^6 events takes minutes."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = sorted((e.start_ns(), e.end_ns()) for e in events)
    busy_ns, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    per_name = collections.defaultdict(lambda: [0, 0])
    for e in events:
        agg = per_name[e.name()[:60]]
        agg[0] += e.duration_ns()
        agg[1] += 1
    ops = sorted(((t, k, n) for k, (t, n) in per_name.items()),
                 reverse=True)[:8]
    return busy_ns / 1e6, len(spans), [(k, t / 1e6, n) for t, k, n in ops]


def phase_mapping_cli_size(textures, report) -> None:
    """Phase 6c: run_mapping on CUDA at the CLI's frame size, the
    renderer's default 24 frames of 480x640 (sift_tpu/sfm/mapping.py:424);
    at least 90 % registered and one closure; the wall time of one call
    after a warm-up (one, not a median of several: it keeps the whole
    script, phase 7 included, near 400 s on a slow host), by stage: the
    host ms of run_mapping's four spans (utils.profiling; each stage
    ends by reading its results on the host), with segsum launched once
    per segment sum of the call's spans (segsum_replays: the warm call's
    BA iterations replay graphs) and the call's map bit for bit
    the first's; phase 2's segsum rows at the call's shapes; then the
    device busy time and device events of one call (torch.profiler)."""
    from sift_tpu_torch.sfm.mapping import (mapping_ate,
                                            render_corner_sequence,
                                            run_mapping)
    import torch
    from sift_tpu_torch.utils import profiling
    n_frames, hw = MAP_CLI
    frames, k, gt = render_corner_sequence(n_frames=n_frames, size=hw,
                                           textures=textures)
    with segsum_replays() as tally:
        res = run_mapping(frames, k)
        ate = mapping_ate(res, gt)
        print(f"phase 6c mapping {n_frames}x{hw[0]}x{hw[1]} on the card: "
              f"{_stats_line(res.stats, ate)}")
        check(res.stats["n_registered"] >= 0.9 * n_frames,
              f"{res.stats['n_registered']} of {n_frames} frames registered")
        check(res.stats["n_closures"] >= 1, "no loop closure")
        tally.replayed = tally.checks = 0
        profiling.clear()
        with profiling.tracing():
            t0 = time.perf_counter()
            again, launches = counted(lambda: run_mapping(frames, k))
            wall_ms = (time.perf_counter() - t0) * 1e3
    stages = {n: v["total_ms"] for n, v in profiling.summary().items()
              if n.startswith("mapping.")}
    print(f"phase 6c timing (one call after a warm-up): run_mapping "
          f"{wall_ms:.1f} ms; "
          + ", ".join(f"{s} {v:.1f} ms" for s, v in stages.items()))
    same = same_map(res, again)
    print(f"phase 6c repeatability, the second call against the first, bit "
          f"for bit: {same}")
    check(all(same.values()), f"run_mapping gave another map: {same}")
    recs = profiling.spans()
    check_segsum_launches("6c", launches, recs, tally)
    phase_segsum([s.attrs for s in recs if s.name == "sfm.ba"],
                 [s.attrs for s in recs if s.name == "sfm.posegraph"],
                 report, launches["segsum"])
    busy, events, ops = _profile_busy(lambda: run_mapping(frames, k))
    print(f"phase 6c profile of one run_mapping: device busy {busy:.1f} ms "
          f"({100.0 * (1.0 - busy / wall_ms):.1f} % idle over the timed "
          f"call), {events} device events; largest device kernels (ms, "
          f"calls): " + "; ".join(f"{n} {t:.1f} {c}" for n, t, c in ops))


def ransac_problem(n_pad: int, seed: int, dev):
    """A two-view problem padded to n_pad (3/4 valid, a fifth of those
    outliers, 1e-3 noise): normalized points p0, p1, the valid mask and
    the world points x seen as p0 (PnP's input)."""
    import torch
    rng = np.random.default_rng(seed)
    n = 3 * n_pad // 4
    x = rng.uniform([-1, -1, 4], [1, 1, 8], (n, 3))
    c, s = np.cos(0.1), np.sin(0.1)
    x1 = x @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T + [0.5, 0.05, 0.1]
    p0, p1 = x[:, :2] / x[:, 2:], x1[:, :2] / x1[:, 2:]
    p1 = p1 + rng.normal(0, 1e-3, p1.shape)
    out = rng.random(n) < 0.2
    p1[out] = rng.uniform(-0.3, 0.3, (int(out.sum()), 2))

    def pad(a):
        return torch.tensor(np.pad(a, ((0, n_pad - n), (0, 0))),
                            dtype=torch.float32, device=dev)
    valid = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    valid[:n] = True
    return pad(p0), pad(p1), valid, pad(x)


class _AtenCount:
    """Counts the non-view ATen calls dispatched inside its block."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    outer.n += 1
                return func(*args, **(kwargs or {}))
        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def phase_ransac_graphs(textures) -> None:
    """Phase 6d: the CUDA graphs (geometry/graphs.py) of the geometry
    layer's stretches and of BA's LM iterations against the eager path,
    bit for bit. run_mapping of phase 6c's 24 frames of 480x640 with the
    cache cleared (a cold request: its spans' share of RANSAC calls that
    replayed every stretch and of BAs that replayed every iteration),
    again (warm: every call replays), and eagerly (the cache bypassed):
    equal maps, no key refused, no miss in the warm call. Then
    bundle_adjust at the warm call's largest table, a hit against its
    eager run bit for bit, with ATen calls and host ms of one call
    eagerly and on a hit. Then, at every padded N of those calls,
    find_essential_ransac and pnp_ransac on one problem (a miss: each
    stretch captured) and another (a hit), each against its eager run:
    E, R, t, inliers, n_inliers and ok equal bit for bit, the cache's
    counts as expected; ATen calls and host ms of one call eagerly and
    on a hit at the largest N."""
    import collections
    from unittest import mock
    import torch
    from sift_tpu_torch.geometry import graphs
    from sift_tpu_torch.geometry.epipolar import find_essential_ransac
    from sift_tpu_torch.geometry.pnp import pnp_ransac
    from sift_tpu_torch.sfm import ba, incremental, mapping
    from sift_tpu_torch.sfm.mapping import render_corner_sequence, run_mapping
    from sift_tpu_torch.utils import profiling
    cache = graphs.CACHE
    eager = mock.patch.object(cache, "_on_card", lambda ts: False)
    names = ("geometry.essential", "geometry.pnp")
    kinds = {"RANSAC": names, "BA": ("sfm.ba",)}
    ba_calls = {}

    def recording_ba(prob, **kw):
        ba_calls[(prob.cam_idx.shape[0], prob.points.shape[0])] = (prob, kw)
        return ba.bundle_adjust(prob, **kw)

    @contextlib.contextmanager
    def recording():
        """The BA calls of run_mapping's two callers, by table shape."""
        with mock.patch.object(incremental, "bundle_adjust", recording_ba), \
                mock.patch.object(mapping, "bundle_adjust", recording_ba):
            yield
    n_frames, hw = MAP_CLI
    frames, k, _ = render_corner_sequence(n_frames=n_frames, size=hw,
                                          textures=textures)

    def traced_map():
        profiling.clear()
        with profiling.tracing():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_mapping(frames, k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        recs = [s for s in profiling.spans()
                if s.name in names + kinds["BA"]]
        stages = {n: round(v["total_ms"], 1)
                  for n, v in profiling.summary().items()
                  if n.startswith("mapping.") or n in names + kinds["BA"]}
        return res, recs, wall, stages

    cache.clear()
    reserved = torch.cuda.memory_reserved()
    runs = {}
    for label in ("cold", "warm", "eager"):
        before = (cache.hits, cache.misses, cache.refused)
        with (eager if label == "eager" else recording() if label == "warm"
              else contextlib.nullcontext()):
            runs[label] = traced_map()
        res, recs, wall, stages = runs[label]
        shares = []
        for kind, span_names in kinds.items():
            calls = [s for s in recs if s.name in span_names]
            hit = sum(bool(s.attrs["graph_hit"]) for s in calls)
            shares.append(f"{kind} calls {len(calls)}, replayed every "
                          f"{'stretch' if kind == 'RANSAC' else 'iteration'}"
                          f" {hit} ({100.0 * hit / max(len(calls), 1):.1f} %)")
        print(f"phase 6d run_mapping {label}: {wall:.2f} s; "
              + "; ".join(shares) + f"; cache hits {cache.hits - before[0]} "
              f"misses {cache.misses - before[1]} refused "
              f"{cache.refused - before[2]}; host ms {stages}")
        if label == "cold":
            pool_mb = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    check(cache.refused == 0, f"the cache refused {cache.refused} keys: "
          f"{[k for k in cache.keys() if cache._graphs[k] is None]}")
    warm = runs["warm"][1]
    check(all(any(s.name in n for s in warm) for n in kinds.values())
          and all(s.attrs["graph_hit"] for s in warm),
          "the warm run_mapping did not replay every RANSAC stretch and "
          "every BA iteration")
    check(len(cache.keys()) == cache.misses,
          f"{cache.misses} misses for {len(cache.keys())} keys")
    for label in ("cold", "warm"):
        same = same_map(runs[label][0], runs["eager"][0])
        print(f"phase 6d {label} map against the eager map, bit for bit: "
              f"{same}")
        check(all(same.values()), f"the {label} map differs from the "
              f"eager map: {same}")
    sizes = {n: sorted({s.attrs["n"] for s in runs["cold"][1]
                        if s.name == n}) for n in names}
    ba_keys = sorted((k[1][3][0][0], k[1][1][0][0], k[1][0][0][0])
                     for k in cache.keys() if k[0] == "ba.lm_iter")
    print(f"phase 6d keys {len(cache.keys())}: "
          f"{dict(collections.Counter(k[0] for k in cache.keys()))} "
          f"(device memory reserved {pool_mb:+.1f} MiB over the cold run); "
          f"padded N by solver {sizes}; BA (obs, points, cams) {ba_keys}")

    (o, p), (prob, kw) = max(ba_calls.items())
    with eager:
        want = ba.bundle_adjust(prob, **kw)
    h, m = cache.hits, cache.misses
    got = ba.bundle_adjust(prob, **kw)
    check((cache.hits - h, cache.misses - m) == (kw["iters"], 0),
          f"bundle_adjust at O = {o}, P = {p}: hits {cache.hits - h} and "
          f"misses {cache.misses - m}, not {kw['iters']} and 0")
    check(graphs.same_bits((got.cameras, got.points),
                           (want.cameras, want.points)),
          f"bundle_adjust at O = {o}, P = {p}: a hit differs from eager")
    for label in ("eager", "hit"):
        with eager if label == "eager" else contextlib.nullcontext():
            with _AtenCount() as c:
                ba.bundle_adjust(prob, **kw)
            host, wall = _host_and_wall_ms(
                lambda: ba.bundle_adjust(prob, **kw), runs=5)
        print(f"phase 6d bundle_adjust at O = {o}, P = {p}, {kw['iters']} "
              f"iterations, {label}: {c.n} ATen calls, host {host:.2f} ms "
              f"to return, {wall:.2f} ms a call")

    fields = ("E", "R", "t", "inliers", "n_inliers", "ok")
    solvers = {"geometry.essential": (
        lambda q: find_essential_ransac(q[0], q[1], valid=q[2],
                                        threshold=2e-3), 2),
        "geometry.pnp": (lambda q: pnp_ransac(q[3], q[0], valid=q[2]), 1)}
    for name, (call, stretches) in solvers.items():
        for n_pad in sizes[name]:
            cache.clear()
            for seed, (dh, dm) in ((n_pad, (0, stretches)),
                                   (n_pad + 1, (stretches, 0))):
                q = ransac_problem(n_pad, seed, "cuda")
                with eager:
                    want = call(q)
                h, m = cache.hits, cache.misses
                got = call(q)
                bad = [f for f in fields if hasattr(want, f)
                       and not graphs.same_bits(getattr(got, f),
                                                getattr(want, f))]
                check(not bad, f"{name} at N = {n_pad}: {bad} differ from "
                      f"the eager call's")
                check((cache.hits - h, cache.misses - m) == (dh, dm),
                      f"{name} at N = {n_pad}: hits {cache.hits - h} and "
                      f"misses {cache.misses - m}, not {dh} and {dm}")
            check(cache.refused == 0, f"{name} at N = {n_pad}: refused")
        print(f"phase 6d {name}: bit for bit the eager call at N = "
              f"{sizes[name]}, a miss then a hit each")
        n_pad = max(sizes[name])
        q = ransac_problem(n_pad, 7, "cuda")
        call(q)
        for label in ("eager", "hit"):
            ctx = eager if label == "eager" else contextlib.nullcontext()
            with ctx:
                with _AtenCount() as c:
                    call(q)
                ms = _median_wall_ms(lambda: call(q), runs=5)
            print(f"phase 6d {name} at N = {n_pad}, {label}: {c.n} ATen "
                  f"calls, {ms:.2f} ms a call")

    # a stretch that reads a value back cannot be captured: the cache
    # refuses its key, runs it eagerly, and still captures the next key
    probe = graphs.GraphCache()
    x = torch.arange(1.0, 5.0, device="cuda")
    stretches = (("reads back", lambda t: t * float(t.sum())),
                 ("stays on the card", lambda t: t * t.sum()))
    for name, fn in stretches * 2:
        got = probe.run(name, fn, (x,))
        check(graphs.same_bits(got, fn(x)), f"the stretch that {name}")
    torch.cuda.synchronize()
    check((probe.refused, probe.misses, probe.hits) == (1, 2, 1),
          f"the probe cache: refused {probe.refused}, misses "
          f"{probe.misses}, hits {probe.hits}, not 1, 2 and 1")
    print("phase 6d a stretch that syncs: refused and run eagerly; the "
          "next key captured and replayed")


def same_map(a, b) -> dict:
    """Whether two MappingResults hold the same bits: the cameras after
    the pose graph and after the final BA, the points, the registered
    frames and points, and the closures (pairs and matches)."""
    def bits(x):
        x = np.ascontiguousarray(x)
        return x.view(np.uint8) if x.dtype.kind == "f" else x

    out = {f: bool(np.array_equal(bits(getattr(a, f)), bits(getattr(b, f))))
           for f in ("cameras_pg", "cameras_final", "points_final",
                     "registered", "has_point")}
    out["closures"] = (
        [(c.i, c.j) for c in a.closures] == [(c.i, c.j) for c in b.closures]
        and all(np.array_equal(x.matches, y.matches)
                for x, y in zip(a.closures, b.closures)))
    return out


def segsum_cases(ba_shapes, pg_shapes) -> list:
    """(label, S segments, index (O,), width) of the segment sums of
    phase 6c's largest and smallest bundle adjustments (camera sums at
    widths 36 and 6, point sums at 9 and 3; indices drawn uniformly, as
    observations spread over cameras and points) and of its pose graph
    (the flat normal matrix at width 1, the right-hand side at 6)."""
    rng = np.random.default_rng(18)
    out = []
    picked = sorted({(a["obs"], a["points"], a["cams"]) for a in ba_shapes})
    for o, p, c in sorted({picked[0], picked[-1]}):
        cam = rng.integers(0, c, o)
        pt = rng.integers(0, p, o)
        for w in (36, 6):
            out.append((f"BA O={o} cams C={c} W={w}", c, cam, w))
        for w in (9, 3):
            out.append((f"BA O={o} points P={p} W={w}", p, pt, w))
    for g in pg_shapes[:1]:
        v, e = g["poses"], g["edges"]
        blocks = rng.integers(0, v * v, e)
        flat = (blocks[:, None] * 36 + np.arange(36)[None]).reshape(-1)
        out.append((f"pose graph V={v} E={e} flat W=1", 36 * v * v, flat,
                    1))
        out.append((f"pose graph V={v} E={e} rhs W=6", v,
                    rng.integers(0, v, e), 6))
    return out


def segsum_args(rng, s: int, idx: np.ndarray, w: int, dev):
    """(out (S, W) non-zero, plan, x (O, W)) on dev: values over eight
    decades, so that the order of the adds shows in the bits."""
    import torch
    from sift_tpu_torch.ops import segsum
    o = len(idx)
    x = (rng.standard_normal((o, w))
         * 10.0 ** rng.uniform(-4, 4, (o, 1))).astype(np.float32)
    out = (rng.standard_normal((s, w)) * 100).astype(np.float32)
    index = torch.as_tensor(idx, device=dev)
    return (torch.as_tensor(out, device=dev), segsum.make_plan(index, s),
            torch.as_tensor(x, device=dev))


def segsum_launch(o: int, s: int, w: int) -> tuple:
    """(grid, threads) of csrc/segsum.cu's launch for O rows, S segments
    and width W (its kShortRows, kCols and kThreads)."""
    if o <= 32 * s:
        return ((s * w + 127) // 128, 1), 128
    return (s, (w + 63) // 64), 128


def phase_segsum(ba_shapes, pg_shapes, report, launches: int) -> None:
    """Phase 2's check of the fixed-order segment sum, at the shapes of
    phase 6c's bundle adjustments and pose graph (their spans'
    attributes): bit for bit the CPU's index_add_, where the card's
    index_add_ is not; the kernel's time beside its launch floor (an
    empty kernel of its grid), the card's index_add_ and its bound;
    then the edge cases. The JSON row (report["segsum"]) is the largest
    BA's camera sum at width 36, with the plain version's time that of
    the card's index_add_ and the launches of phase 6c's timed call."""
    import torch
    from sift_tpu_torch import _build
    from sift_tpu_torch.ops import segsum
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_cuda_variants as variants
    floor_lib = variants.floor_library(ROOT / "build" / "smoke_floor",
                                       _build)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    check(ba_shapes and pg_shapes, "phase 6c recorded no sfm.ba or "
          "sfm.posegraph span")
    n_atomic_same = 0
    rows = {}
    cases = segsum_cases(ba_shapes, pg_shapes)
    for label, s, idx, w in cases:
        out, plan, x = segsum_args(rng, s, idx, w, dev)
        want = out.cpu().index_add_(0, plan.index.cpu(), x.cpu())
        got = segsum.segment_sum(out.clone(), plan, x).cpu()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"segsum {label} is not the CPU's index_add_ bit for bit")
        atomic = out.clone().index_add_(0, plan.index, x).cpu()
        n_atomic_same += int(torch.equal(atomic.view(torch.int32),
                                         want.view(torch.int32)))
        ms = median_ms(lambda: segsum.segment_sum(out, plan, x))
        ams = median_ms(lambda: out.index_add_(0, plan.index, x))
        pms = median_ms(lambda: segsum.make_plan(plan.index, s))
        grid, threads = segsum_launch(len(idx), s, w)
        floor = median_ms(lambda: variants.launch_empty(floor_lib, grid,
                                                        threads))
        o = len(idx)
        bnd = bound_ms(4.0 * (o * w + o + 2.0 * s * w), o * w,
                       F32_ISSUE_PER_S)
        rows[label] = (ms, ams, bnd)
        print(f"phase 2 segsum {label}: bit for bit the CPU's index_add_; "
              f"kernel {ms:.4f} ms (launch floor {floor:.4f}; grid {grid} "
              f"of {threads}), the card's index_add_ {ams:.4f} ms, plan "
              f"{pms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
    # segsum_cases lists the largest BA last
    main = [l for l in rows if " cams " in l and l.endswith(" W=36")][-1]
    ms, ams, bnd = rows[main]
    report["segsum"] = {
        "name": "segsum: fixed-order segment sum", "route": "cuda",
        "source": "sift_tpu_torch/csrc/segsum.cu",
        "replaces": "none (sift_tpu/sfm/ba.py sums with segment_sum)",
        "launches": launches, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": ams, "bound_ms": bnd[0], "bound_by": bnd[1],
        "library_ms": None}
    print(f"phase 2 segsum: the card's index_add_ equal to the CPU's in "
          f"{n_atomic_same} of {len(cases)} cases")
    edges = []
    for label, s, idx, w, strided in (
            ("empty segments", 50, rng.integers(0, 10, 3000) * 5, 6, False),
            ("one segment holds every row", 24, np.full(30000, 7), 36,
             False),
            ("a chunk past 64 columns", 40, rng.integers(0, 40, 3000), 70,
             False),
            ("non-contiguous x", 7, rng.integers(0, 7, 500), 36, True),
            ("no rows", 5, np.zeros(0, np.int64), 3, False)):
        out, plan, x = segsum_args(rng, s, idx, w, dev)
        if strided:
            x = x.reshape(-1, 6, 6).transpose(1, 2)
            out = out.reshape(-1, 6, 6)
        want = out.cpu().index_add_(0, plan.index.cpu(), x.cpu())
        got = segsum.segment_sum(out.clone(), plan, x).cpu()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"segsum {label} is not the CPU's index_add_ bit for bit")
        edges.append(label)
    print(f"phase 2 segsum edges, each bit for bit the CPU's index_add_: "
          f"{'; '.join(edges)}")


# ------------------------------------------------------ phase 7: multi-device

# the 4K frame of the spatial split (bench.py:449-450 sizes bands for a
# 2160x3840 frame with halo 64) and its caps: 4x the 1080p scene's area
# and blobs, caps that no octave of it fills (checked on every run)
FRAME_4K_HW = (2160, 3840)
SPATIAL_HALO = 64
SPATIAL_TILED_OCTAVES = 2
CAPS_4K = dict(detect_caps=(16384, 8192, 4096, 1024, 512),
               out_caps=(8192, 4096, 4096, 512, 256))
# SCALING.json's BA problem (bench_scaling.py:104-124, seed 0)
BA_SHAPE = dict(c=64, p=4096, o=65536)
BA_ITERS, BA_CG_ITERS = 3, 10
# BA at world 2 against world 1, and world 1 against single-device
# bundle_adjust: psum regroups the segment sums (and the card's
# index_add_ adds in no fixed order), so float32 rounding moves the runs
# apart. Bounds about 20x the spread of world 1 and 2 gloo runs on the
# CPU (RMSE 1.7e-7 relative, cameras 5.3e-7, points 1.2e-5 absolute),
# where BA itself moves cameras by 2.7e-2 and points by 0.44
BA_RMSE_RTOL = 1e-5
BA_CAM_ATOL = 1e-5
BA_PT_ATOL = 2e-4
# the partitioned pose graph: posegraph_dist.loop_graph, selftest's loop
# trajectory, with 4 poses a rank at world 2 (32 poses), 24 rounds of 6
# inner iterations
GRAPH_POSES = 32
TIMED_CALLS = 3
ELASTIC_ITERS, ELASTIC_CHUNK = 6, 2


def frame_4k() -> np.ndarray:
    """The 2160x3840 synthetic frame (the 1080p scene's recipe at 4x the
    area and blob count)."""
    return to_gray(texture(*FRAME_4K_HW, seed=9, n_blobs=3200,
                           amp=(30.0, 90.0), block=24, block_amp=20.0))


def ba_problem_arrays(c: int, p: int, o: int, seed: int = 0) -> dict:
    """bench_scaling.py's BA problem (the draws of its _make_problem in
    their order) as numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, p), rng.uniform(-3, 3, p),
                    rng.uniform(6, 14, p)], 1).astype(np.float32)
    cams = np.zeros((c, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, c)
    cam_idx = rng.integers(0, c, o).astype(np.int32)
    pt_idx = rng.integers(0, p, o).astype(np.int32)
    xc = pts[pt_idx] + cams[cam_idx][:, 3:]
    uv = (xc[:, :2] / xc[:, 2:3]
          + rng.normal(0, 1e-3, (o, 2))).astype(np.float32)
    fixed = np.zeros(c, bool)
    fixed[0] = True
    cams0 = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32) \
        * ~fixed[:, None]
    return dict(cameras=cams0, points=pts, cam_idx=cam_idx, pt_idx=pt_idx,
                uv=uv, mask=np.ones(o, bool), fixed_cams=fixed)


def cfg_4k():
    import dataclasses
    from sift_tpu_torch.config import DEFAULT_CONFIG
    return dataclasses.replace(DEFAULT_CONFIG, **CAPS_4K)


def band_stack(img, gr0: int, hb: int, halo: int, cfg):
    """Octave 0 of the haloed band whose core starts at global row gr0,
    as parallel/spatial.py builds it from the exchanged halo (rows
    outside the image zero): (gauss, dog, box, row window)."""
    import torch
    from sift_tpu_torch.ops import conv
    from sift_tpu_torch.parallel import spatial
    h, w = img.shape
    gr0p = gr0 - halo
    padded = torch.zeros((hb + 2 * halo, w), device=img.device)
    lo, hi = max(gr0p, 0), min(gr0 + hb + halo, h)
    padded[lo - gr0p:hi - gr0p] = img[lo:hi]
    base = conv.gaussian_blur_multi(spatial._zero_beyond(padded, gr0p, h, w),
                                    (cfg.init_blur_sigma,),
                                    apply_quirk=False)[0]
    layers = conv.gaussian_blur_multi(spatial._zero_beyond(base, gr0p, h, w),
                                      cfg.scale_sigmas()[1:],
                                      apply_quirk=False)
    gauss = torch.cat([base[None], layers])
    dog = (gauss[1:] - gauss[:-1]).contiguous()
    box = spatial.candidate_box(hb, halo, gr0, h, w, dog.shape[1:], cfg)
    return gauss, dog, box, (halo - gr0, h - gr0 + halo)


def phase_band_kernels(img4k_np) -> None:
    """Phase 2, the spatial path's kernel parameters at the band shape of
    the 4K split at world 2 (1080 + 2*64 rows x 3840, octave 0): for
    each of the two bands, the boxed compact scan and the select against
    their plain versions under torch.equal (route and kernels), refine
    with the band's row_bounds bit for bit its plain version, and
    K3-ori and K3-desc with the band's row window against theirs at rtol
    1e-5 / atol 1e-5 * max|hist| per valid row; each kernel also timed at
    rank 0's band."""
    import torch
    import torch.nn.functional as F
    from sift_tpu_torch import sift
    from sift_tpu_torch.ops import extrema as ext
    from sift_tpu_torch.ops.descriptor import descriptor_params
    from sift_tpu_torch.ops.descr_hist_cuda import (descriptor_hist,
                                                    descriptor_hist_plain)
    from sift_tpu_torch.ops.extrema_cuda import (extrema_compact,
                                                 extrema_compact_plain)
    from sift_tpu_torch.ops.orientation import orientation_params
    from sift_tpu_torch.ops.ori_hist_cuda import (orientation_hist,
                                                  orientation_hist_plain)
    from sift_tpu_torch.ops import refine as ref
    cfg = cfg_4k()
    img = torch.from_numpy(img4k_np).cuda()
    hb = FRAME_4K_HW[0] // 2
    nl = cfg.n_octave_layers
    lines = []
    for rank in range(2):
        gauss, dog, box, rows = band_stack(img, rank * hb, hb, SPATIAL_HALO,
                                           cfg)
        cap = cfg.detect_caps[0]
        got = ext.top_candidates(dog, cap, cfg, box=box)
        want = ext.top_candidates_plain(dog, cap, cfg, box)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"band {rank}: the boxed route differs from its plain version")
        keys, count = extrema_compact(dog[None], cfg, box)
        pkeys, pcount = extrema_compact_plain(dog[None], cfg, box)
        n = int(pcount[0])
        check(torch.equal(count, pcount) and torch.equal(
            torch.sort(keys[0, :n]).values, torch.sort(pkeys[0, :n]).values),
            f"band {rank}: the boxed compact scan differs from its plain "
            f"version")
        rf = ref.refine_candidates(dog, *got, cfg, row_bounds=rows)
        rf_plain = ref.refine_candidates_plain(dog, *got, cfg,
                                               row_bounds=rows)
        torch.cuda.synchronize()
        check(refined_equal(rf, rf_plain), f"band {rank}: refine with rows "
              f"{rows} differs from refine_candidates_plain")
        kp = sift._octave_tail(gauss, dog, *got, 0, cfg, cfg.out_caps[0],
                               row_bounds=rows)
        rp, rd = cfg.ori_patch_radius, cfg.descr_patch_radius
        po = F.pad(gauss[1:1 + nl], (rp + 1,) * 4)
        radius, expf = orientation_params(kp.size * 0.5, cfg)
        oargs = (po, kp.layer - 1, kp.r, kp.c, radius, expf, cfg, rows)
        pd = F.pad(gauss[1:1 + nl], (rd + 1,) * 4)
        prm = descriptor_params(kp.size, kp.angle, torch.ones(1, device="cuda"),
                                tuple(gauss.shape[1:]), cfg)
        dargs = (pd, kp.layer - 1, kp.r, kp.c, prm.cos_t, prm.sin_t,
                 prm.radius, prm.ori, kp.valid, cfg, 64, rows)
        errs = []
        for name, fn, plain, args in (
                ("K3-ori", orientation_hist, orientation_hist_plain, oargs),
                ("K3-desc", descriptor_hist, descriptor_hist_plain, dargs)):
            g, x = fn(*args), plain(*args)
            torch.cuda.synchronize()
            v = kp.valid
            g, x = g[v].reshape(int(v.sum()), -1), x[v].reshape(g[v].shape[0],
                                                                 -1)
            atol = 1e-5 * x.abs().amax(dim=1, keepdim=True)
            check(bool(((g - x).abs() <= 1e-5 * x.abs() + atol).all()),
                  f"band {rank}: {name} with rows {rows} disagrees with its "
                  f"plain version")
            errs.append(float((g - x).abs().max()))
        times = ""
        if rank == 0:
            t = [median_ms(lambda: ext.top_candidates(dog, cap, cfg, box=box)),
                 median_ms(lambda: ref.refine_candidates(
                     dog, *got, cfg, row_bounds=rows)),
                 median_ms(lambda: orientation_hist(*oargs)),
                 median_ms(lambda: descriptor_hist(*dargs))]
            times = (f"; boxed scan + select {t[0]:.4f} ms, refine "
                     f"{t[1]:.4f} ms, K3-ori {t[2]:.4f} ms, K3-desc "
                     f"{t[3]:.4f} ms")
        lines.append(f"band {rank} {tuple(dog.shape)} box {box} rows {rows}: "
                     f"candidates {n}, refined {int(rf.valid.sum())} (bit "
                     f"for bit the plain version), valid keypoints "
                     f"{int(kp.valid.sum())}, "
                     f"K3-ori max_abs_err {errs[0]!r}, K3-desc max_abs_err "
                     f"{errs[1]!r}{times}")
    torch.cuda.synchronize()
    print("phase 2 spatial band kernels (4K split at world 2, octave 0; "
          "boxed route, compact scan and refine with the band's rows equal "
          "to their plain versions, K3-ori/K3-desc within rtol 1e-5): "
          + "; ".join(lines))


def multidevice_entries(mesh, scene_np, img4k_np, ba_arrays, graph):
    """Phase 7's entries on this rank's mesh, each called once with the
    launch counts set to 0 just before it, then timed (median wall time
    of TIMED_CALLS calls after a warm-up, each ending in a device
    synchronisation). Returns (results on the CPU, {entry: ms},
    {entry: launches})."""
    import torch
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.parallel import (batched_detect_and_compute,
                                         bundle_adjust_point_sharded,
                                         bundle_adjust_sharded,
                                         detect_and_compute_tiled,
                                         sharded_match_ratio,
                                         sharded_match_ratio_train_sharded)
    from sift_tpu_torch.parallel.dryrun import to_problem
    from sift_tpu_torch.parallel.mesh import _to_host
    from sift_tpu_torch.sfm.posegraph import PoseGraph
    from sift_tpu_torch.sfm.posegraph_dist import \
        optimize_pose_graph_partitioned
    from sift_tpu_torch.utils.health import mesh_health_check
    dev = mesh.device
    frames = batch_frames(torch.from_numpy(scene_np).to(dev))
    img4k = torch.from_numpy(img4k_np).to(dev)
    prob = to_problem(ba_arrays, dev)
    graph = PoseGraph(*(t.to(dev) for t in graph))
    c4k = cfg_4k()
    kp, d = batched_detect_and_compute(frames, mesh, cfg)

    def pairs(matcher):
        return [matcher(d[b], d[b - 1], mesh, q_valid=kp.valid[b],
                        t_valid=kp.valid[b - 1], ratio=cfg.match_ratio)
                for b in range(1, BATCH)]

    entries = {
        "frames": lambda: batched_detect_and_compute(frames, mesh, cfg),
        "match_query": lambda: pairs(sharded_match_ratio),
        "match_train": lambda: pairs(sharded_match_ratio_train_sharded),
        "ba_obs": lambda: bundle_adjust_sharded(
            prob, mesh, iters=BA_ITERS, cg_iters=BA_CG_ITERS),
        "ba_point": lambda: bundle_adjust_point_sharded(
            prob, mesh, iters=BA_ITERS, cg_iters=BA_CG_ITERS),
        "spatial": lambda: detect_and_compute_tiled(
            img4k, mesh, c4k, tiled_octaves=SPATIAL_TILED_OCTAVES,
            halo=SPATIAL_HALO),
        "posegraph": lambda: optimize_pose_graph_partitioned(
            graph, mesh, rounds=24, inner_iters=6),
        "health": lambda: mesh_health_check(mesh),
    }
    results, times, launches = {}, {}, {}
    for name, fn in entries.items():
        results[name], launches[name] = counted(fn)
        results[name] = _to_host(results[name])
        times[name] = _median_wall_ms(fn, TIMED_CALLS)
    return results, times, launches


def _rank_entries(mesh, scene_np, img4k_np, ba_arrays, graph):
    """World 2's rank function (mesh.run_spmd): TF32 off as in the main
    process, then multidevice_entries."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = multidevice_entries(mesh, scene_np, img4k_np, ba_arrays, graph)
    return out + (str(mesh.device),)


def kp_set(kp, d):
    """The valid keypoints as rows (x, y, angle, size) sorted, and their
    descriptors (tests/test_spatial.py's comparison)."""
    v = kp.valid.cpu().numpy()
    xy = np.stack([getattr(kp, f).cpu().numpy()[v]
                   for f in ("x", "y", "angle", "size")], 1)
    order = np.lexsort((xy[:, 2], xy[:, 1], xy[:, 0]))
    return xy[order], d.cpu().numpy()[v][order]


def same_set(a, b) -> bool:
    (xa, da), (xb, db) = a, b
    return (xa.shape == xb.shape and np.abs(xa - xb).max(initial=0) <= 1e-3
            and np.abs(da - db).max(initial=0) <= 1e-3)


def check_launches(label: str, launches: dict) -> None:
    """The kernels each entry must and must not launch."""
    need = {"frames": ("K1-batch", "K2-compact", "K2-select", "refine",
                       "K3-ori", "K3-desc"),
            "match_query": ("K4",), "match_train": ("K4",),
            "spatial": ("K1", "K2-compact", "K2-select", "refine", "K3-ori",
                        "K3-desc")}
    for entry, kernels in need.items():
        got = launches[entry]
        check(all(got[k] > 0 for k in kernels),
              f"{label} {entry}: a kernel of its path did not launch: {got}")
    for entry, got in launches.items():
        check(got["K2"] == 0 and got["K3"] == 0,
              f"{label} {entry}: the dense K2 or the bare K3 launched: {got}")


def nonzero(launches: dict) -> dict:
    """{entry: {kernel: launches}} without the zero counts."""
    return {e: {k: n for k, n in c.items() if n} for e, c in launches.items()}


def check_ba(label: str, got, ref) -> tuple:
    """Two BA results within BA_RMSE_RTOL (RMSE, relative), BA_CAM_ATOL
    (cameras) and BA_PT_ATOL (points); returns the three spreads."""
    from sift_tpu_torch.sfm.ba import reproj_rmse
    r, r1 = float(reproj_rmse(got)), float(reproj_rmse(ref))
    spread = (abs(r - r1) / r1,
              float((got.cameras.cpu() - ref.cameras.cpu()).abs().max()),
              float((got.points.cpu() - ref.points.cpu()).abs().max()))
    check(spread[0] <= BA_RMSE_RTOL and spread[1] <= BA_CAM_ATOL
          and spread[2] <= BA_PT_ATOL,
          f"{label}: RMSE {r} vs {r1}; (RMSE relative, cameras, points) "
          f"spread {spread} past ({BA_RMSE_RTOL}, {BA_CAM_ATOL}, "
          f"{BA_PT_ATOL})")
    return spread


def compare_worlds(label: str, got: dict, ref: dict) -> dict:
    """World 2's results against world 1's: frames and matches equal,
    the tiled keypoint set equal, BA within check_ba's bounds. Returns
    {BA entry: spread}."""
    import torch
    (kp, d), (kp1, d1) = got["frames"], ref["frames"]
    check(all(torch.equal(getattr(kp, f), getattr(kp1, f))
              for f in ("x", "y", "size", "angle", "response", "octave",
                        "layer", "r", "c", "valid"))
          and torch.equal(d, d1), f"{label}: frames differ from world 1's")
    for m in ("match_query", "match_train"):
        check(all(all(torch.equal(a, b) for a, b in zip(x, y))
                  for x, y in zip(got[m], ref[m])),
              f"{label}: {m} differs from world 1's")
    check(same_set(kp_set(*got["spatial"]), kp_set(*ref["spatial"])),
          f"{label}: the tiled keypoint set differs from world 1's")
    out = {m: check_ba(f"{label} {m} vs world 1", got[m], ref[m])
           for m in ("ba_obs", "ba_point")}
    check(got["health"] is True, f"{label}: mesh_health_check failed")
    return out


def phase_multidevice(scene_np, img4k_np) -> dict:
    """Phase 7: the multi-device layer. 7a: world 1 on NCCL, in this
    process; 7b: world 2 on the one card (gloo with CUDA tensors, every
    collective staged through the host), two processes; 7c: elastic BA
    shrinking 2 -> 1. Returns {entry: launches at world 1}."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_tpu_torch.ops import match as match_mod
    from sift_tpu_torch.parallel.dryrun import to_problem
    from sift_tpu_torch.parallel.mesh import (HOST_STAGED, default_mesh,
                                              init_process, run_spmd)
    from sift_tpu_torch.sfm.ba import bundle_adjust, reproj_rmse
    from sift_tpu_torch.sfm.posegraph import pose_graph_cost
    from sift_tpu_torch.sfm.posegraph_dist import loop_graph

    ba_arrays = ba_problem_arrays(**BA_SHAPE)
    graph = loop_graph(GRAPH_POSES)
    args = (scene_np, img4k_np, ba_arrays, graph)
    dev = torch.device("cuda:0")

    # 7a: world 1 on NCCL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        init_process(0, 1, os.path.join(tmp, "store"), "nccl", "cuda:0")
        try:
            res1, ms1, launches1 = multidevice_entries(
                default_mesh(device="cuda:0"), *args)
        finally:
            dist.destroy_process_group()
    check_launches("7a", launches1)
    # against the single-device entry points
    frames = batch_frames(torch.from_numpy(scene_np).to(dev))
    kp, d = sift.detect_and_compute_batch(frames, cfg)
    kp1, d1 = res1["frames"]
    check(all(torch.equal(getattr(kp1, f), getattr(kp, f).cpu())
              for f in ("x", "y", "angle", "valid", "r", "c"))
          and torch.equal(d1, d.cpu()),
          "7a frames differ from detect_and_compute_batch")
    for m in ("match_query", "match_train"):
        for b, got in zip(range(1, BATCH), res1[m]):
            want = match_mod.match_ratio(d[b], d[b - 1], q_valid=kp.valid[b],
                                         t_valid=kp.valid[b - 1],
                                         ratio=cfg.match_ratio)
            check(all(torch.equal(x, y.cpu()) for x, y in zip(got, want)),
                  f"7a {m} pair {b} differs from match_ratio")
    prob = to_problem(ba_arrays, dev)
    rmse0 = float(reproj_rmse(prob))
    single_ba = bundle_adjust(prob, iters=BA_ITERS, cg_iters=BA_CG_ITERS)
    single = float(reproj_rmse(single_ba))
    rmse = {m: float(reproj_rmse(res1[m])) for m in ("ba_obs", "ba_point")}
    check(all(r < rmse0 for r in rmse.values()),
          f"7a BA RMSE {rmse} did not fall from {rmse0}")
    spread1 = {m: check_ba(f"7a {m} vs bundle_adjust", res1[m], single_ba)
               for m in ("ba_obs", "ba_point")}
    c4k = cfg_4k()
    img4k = torch.from_numpy(img4k_np).to(dev)
    kps, ds = sift.detect_and_compute(img4k, c4k)
    sat = sift.octave_saturation(kps, c4k).cpu().numpy()
    from sift_tpu_torch.ops import pyramid
    csat = sift.candidate_saturation(
        pyramid.build_gaussian_pyramid(img4k, c4k), c4k).cpu().numpy()
    per_octave = [int(kps.valid[a:a + n].sum()) for a, n in zip(
        np.cumsum((0,) + c4k.out_caps[:-1]), c4k.out_caps)]
    check(not sat.any() and not csat.any(),
          f"4K single-device run saturates: out caps {sat} (valid per "
          f"octave {per_octave} of {c4k.out_caps}), candidates {csat}")
    tiled_set = kp_set(*res1["spatial"])
    check(same_set(tiled_set, kp_set(kps, ds)),
          f"7a tiled keypoint set ({len(tiled_set[0])}) differs from "
          f"detect_and_compute's ({int(kps.count())})")
    c0, c1 = (float(pose_graph_cost(g)) for g in (graph, res1["posegraph"]))
    check(c1 < 0.02 * c0, f"7a pose graph cost {c1} from {c0}")
    check(res1["health"] is True, "7a mesh_health_check failed")
    print(f"phase 7a world 1 (nccl, cuda:0): frames and both matchers "
          f"equal to detect_and_compute_batch / match_ratio; BA RMSE "
          f"obs {rmse['ba_obs']!r} point {rmse['ba_point']!r} "
          f"(single-device {single!r}, initial {rmse0!r}; (RMSE relative, "
          f"cameras, points) spread from bundle_adjust {spread1}, bounds "
          f"({BA_RMSE_RTOL}, {BA_CAM_ATOL}, {BA_PT_ATOL})); 4K tiled "
          f"keypoints {len(tiled_set[0])} equal to detect_and_compute's as "
          f"a set (valid per octave {per_octave} of out caps "
          f"{c4k.out_caps}, none saturated); pose graph cost {c0!r} -> "
          f"{c1!r}; "
          f"health ok; launches {nonzero(launches1)}; wall ms (median of "
          f"{TIMED_CALLS} after a warm-up) "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms1.items())
          + f" ({time.perf_counter() - t0:.1f} s)")

    # 7b: world 2 on the one card, gloo with CUDA tensors
    t0 = time.perf_counter()
    # a bare "cuda": rank r on card r % 1, both on cuda:0
    out = run_spmd(_rank_entries, 2, args=args, backend="gloo",
                   device="cuda", timeout_s=300)
    spreads, costs = [], []
    for r, (res2, ms2, launches2, rank_dev) in enumerate(out):
        check(rank_dev == "cuda:0", f"7b rank {r} ran on {rank_dev}")
        check_launches(f"7b rank {r}", launches2)
        spreads.append(compare_worlds(f"7b rank {r}", res2, res1))
        costs.append(float(pose_graph_cost(res2["posegraph"])))
        check(costs[-1] < 0.02 * c0,
              f"7b rank {r} pose graph cost {costs[-1]} from {c0}")
    res2, ms2, launches2, _ = out[0]
    print(f"phase 7b world 2 (gloo, both ranks on cuda:0; collectives "
          f"staged through the host: {', '.join(HOST_STAGED)}): each rank's "
          f"frames, matches and tiled keypoints equal world 1's, BA "
          f"(RMSE relative, cameras, points) spread from world 1 by rank "
          f"{spreads} within ({BA_RMSE_RTOL}, {BA_CAM_ATOL}, {BA_PT_ATOL}), "
          f"pose graph cost {c0!r} -> {costs}, health ok; rank 0 launches "
          f"{nonzero(launches2)}; "
          f"rank 0 wall ms (median of {TIMED_CALLS} after a warm-up) "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms2.items())
          + f" ({time.perf_counter() - t0:.1f} s with process start)")

    # 7c: elastic BA, 2 ranks (gloo, one card) crash after a checkpoint,
    # 1 rank (nccl) resumes
    from sift_tpu_torch.parallel.elastic import supervise_ba
    from sift_tpu_torch.sfm import checkpoint as ck
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = ck.save_ba(os.path.join(tmp, "prob"), to_problem(ba_arrays,
                                                                 "cpu"), 0)
        spawned = []
        final, restarts = supervise_ba(
            path, os.path.join(tmp, "ck"), total_iters=ELASTIC_ITERS,
            chunk_iters=ELASTIC_CHUNK, cg_iters=BA_CG_ITERS, n_devices=2,
            backend={2: "gloo", 1: "nccl"}, device="cuda",
            inject_crash_step=ELASTIC_CHUNK, worker_timeout=300,
            on_spawn=spawned.append)
        out_prob, step = ck.load_ba(final)
    codes = [p.returncode for p in spawned]
    r_end = float(reproj_rmse(out_prob))
    check(restarts == 1 and codes == [17, 17, 0] and step == ELASTIC_ITERS
          and r_end < rmse0,
          f"7c elastic: restarts {restarts}, exit codes {codes}, step {step}, "
          f"RMSE {r_end} from {rmse0}")
    print(f"phase 7c elastic BA: 2 ranks (gloo, cuda) crashed after the "
          f"step-{ELASTIC_CHUNK} checkpoint (exit codes {codes[:2]}), 1 rank "
          f"(nccl) resumed and finished at step {step}: restarts {restarts}, "
          f"RMSE {rmse0!r} -> {r_end!r} ({time.perf_counter() - t0:.1f} s)")
    return launches1


# ------------------------------------------------ phase 8: the NumPy oracle

# 8b/8c: out_caps raised until no octave of the 480x640 frames saturates,
# so that the port's keypoint set is uncapped, as the reference's is (the
# default out_caps[0] = 1024 truncates octave 0's 1,299 keypoints)
ORACLE_OUT_CAPS = (4096, 1024, 512, 256, 128)
ORACLE_HW = (480, 640)
# 8c's object: tests/test_match.py's crop of small_image, [24:120,
# 40:168], scaled by 3 onto the 480x640 frame
ORACLE_CROP = (slice(72, 360), slice(120, 504))
# tests/test_detect.py's gates (keypoints matched by position within
# 0.1 px, size within 1 %, angle within 1 degree) and tests/
# test_match.py's (both endpoints of a good match within 0.5 px)
ORACLE_RECALL = 0.97
ORACLE_PRECISION = 0.97
ORACLE_L1_MEDIAN = 0.05
ORACLE_L1_P90 = 0.2
ORACLE_MATCH_RECALL = 0.9


def small_image() -> np.ndarray:
    """tests/conftest.py:small_image, copied: the deterministic 160x200
    synthetic frame with blob and corner structure, float32."""
    from scipy import ndimage
    rng = np.random.default_rng(42)
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    for k in range(60):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        s = rng.uniform(1.2, 7.0)
        a = rng.uniform(50, 120) * (1 if k % 2 == 0 else -1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    blocks = rng.uniform(-60, 60, (h // 8, w // 8))
    img += ndimage.zoom(blocks, 8, order=0)[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def oracle_frame() -> np.ndarray:
    """8b's 480x640 frame: small_image tiled 3 x 4 times, cut to size."""
    h, w = ORACLE_HW
    return np.ascontiguousarray(np.tile(small_image(), (3, 4))[:h, :w])


def _kp_numpy(kp) -> dict:
    return {f: getattr(kp, f).cpu().numpy()
            for f in ("x", "y", "size", "angle", "valid")}


def oracle_hits(kpts_ref, kp, pos_tol=0.1, size_rtol=0.01,
                ang_tol=1.0) -> np.ndarray:
    """tests/test_detect.py's matcher: for each oracle keypoint, the
    first valid port slot within pos_tol px (|dx| + |dy|), its size
    within size_rtol and its angle within ang_tol degrees; -1 where
    there is none."""
    f = _kp_numpy(kp)
    hits = np.full(len(kpts_ref), -1)
    for n, kr in enumerate(kpts_ref):
        d = np.abs(f["x"] - kr["x"]) + np.abs(f["y"] - kr["y"])
        da = np.abs(f["angle"] - kr["angle"])
        da = np.minimum(da, 360 - da)
        ok = (f["valid"] & (d < pos_tol)
              & ~(np.abs(f["size"] - kr["size"]) > size_rtol * kr["size"])
              & ~(da > ang_tol))
        idx = np.flatnonzero(ok)
        if len(idx):
            hits[n] = idx[0]
    return hits


def oracle_gates(kpts_ref, desc_ref, kp, desc) -> dict:
    """tests/test_detect.py's numbers for one frame: recall of the
    oracle's keypoints, precision of the port's valid keypoints (each
    within 0.1 px of an oracle keypoint) and the L1 distance of the
    matched descriptor rows (median, 90th percentile, max)."""
    f = _kp_numpy(kp)
    hits = oracle_hits(kpts_ref, kp)
    rx = np.array([k["x"] for k in kpts_ref])
    ry = np.array([k["y"] for k in kpts_ref])
    px, py = f["x"][f["valid"]], f["y"][f["valid"]]
    near = sum(len(rx) > 0 and np.min(np.abs(rx - x) + np.abs(ry - y)) < 0.1
               for x, y in zip(px, py))
    matched = np.flatnonzero(hits >= 0)
    l1 = np.array([np.abs(desc_ref[i] - desc[hits[i]]).sum()
                   for i in matched])
    return {"oracle": len(kpts_ref), "port": int(f["valid"].sum()),
            "matched": len(matched), "hits": hits,
            "recall": float((hits >= 0).mean()) if len(hits) else 0.0,
            "precision": float(near) / max(len(px), 1),
            "l1": (float(np.median(l1)), float(np.quantile(l1, 0.9)),
                   float(l1.max())) if len(l1) else (math.inf,) * 3}


def check_oracle_gates(label: str, g: dict) -> None:
    check(g["oracle"] > 50, f"phase {label}: the oracle found only "
          f"{g['oracle']} keypoints")
    check(g["matched"] > 30, f"phase {label}: only {g['matched']} keypoints "
          f"matched the oracle's")
    check(g["recall"] >= ORACLE_RECALL,
          f"phase {label}: recall {g['recall']} < {ORACLE_RECALL}")
    check(g["precision"] >= ORACLE_PRECISION,
          f"phase {label}: precision {g['precision']} < {ORACLE_PRECISION}")
    check(g["l1"][0] < ORACLE_L1_MEDIAN and g["l1"][1] < ORACLE_L1_P90,
          f"phase {label}: descriptor L1 (median, p90, max) {g['l1']}")


def oracle_match_recall(ref, ko_ref, ks_ref, kpo, kps, m) -> float:
    """tests/test_match.py's end-to-end recall: the share of the oracle's
    good matches (query the object, train the scene) that the port's
    good matches reproduce, both endpoints within 0.5 px."""
    good = np.flatnonzero(m.good.cpu().numpy())
    ti = m.train_idx.cpu().numpy()[good]
    ox, oy = kpo.x.cpu().numpy()[good], kpo.y.cpu().numpy()[good]
    gx, gy = kps.x.cpu().numpy()[ti], kps.y.cpu().numpy()[ti]
    hits = 0
    for qi, tj, _ in ref:
        qr, tr = ko_ref[qi], ks_ref[tj]
        hits += bool(((np.abs(ox - qr["x"]) < .5) & (np.abs(oy - qr["y"]) < .5)
                      & (np.abs(gx - tr["x"]) < .5)
                      & (np.abs(gy - tr["y"]) < .5)).any())
    return hits / max(len(ref), 1)


def check_frame_launches(label: str, launches: dict, shapes, k4: int,
                         cfg) -> None:
    """detect_and_compute on frames of these shapes (and k4 matches)
    launches K1 once for the base blur and once per octave, the compact
    scan, the select, refine, K3-ori and K3-desc once per usable octave,
    K4 k4 times, and nothing else."""
    n_oct = sum(usable_octaves(hw) for hw in shapes)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"K1": len(shapes) * (1 + cfg.n_octaves), "K2-compact": n_oct,
                 "K2-select": n_oct, "refine": n_oct, "K3-ori": n_oct,
                 "K3-desc": n_oct, "K4": k4})
    check(launches == want, f"phase {label}: launches {launches}, not {want}")


def fired(launches: dict) -> dict:
    """{kernel: launches} without the zero counts."""
    return {k: n for k, n in launches.items() if n}


def _gates_line(g: dict) -> str:
    return (f"oracle_kp={g['oracle']} port_kp={g['port']} "
            f"recall={g['recall']!r} precision={g['precision']!r} "
            f"descriptor L1 (median, p90, max)={g['l1']!r}")


def phase_oracle(card: str) -> None:
    """Phase 8: the port on the card against the NumPy oracle of the
    reference algorithm on the host (sift_tpu_torch/oracle/cpu_sift.py),
    under tests/test_detect.py's and tests/test_match.py's gates: 8a
    small_image (160x200) at DEFAULT_CONFIG, 8b its 480x640 tiling with
    ORACLE_OUT_CAPS and no octave saturated, 8c the ratio-test matches
    of a 288x384 crop of 8b's frame against the frame. Each with its
    launches, the oracle's host seconds and the card's milliseconds
    (median of 10 synchronised calls)."""
    import dataclasses
    import torch
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG
    from sift_tpu_torch.ops.match import match_ratio
    from sift_tpu_torch.oracle import cpu_sift as oracle

    raised = dataclasses.replace(DEFAULT_CONFIG, out_caps=ORACLE_OUT_CAPS)
    scene_np = oracle_frame()
    frames = {}
    for label, img, cfg in (("8a", small_image(), DEFAULT_CONFIG),
                            ("8b", scene_np, raised)):
        t0 = time.perf_counter()
        kpts, desc_ref = oracle.sift_ncl(img, cfg)
        host_s = time.perf_counter() - t0
        x = torch.from_numpy(img).cuda()
        (kp, desc), launches = counted(
            lambda: sift.detect_and_compute(x, cfg))
        card_ms = _median_wall_ms(lambda: sift.detect_and_compute(x, cfg))
        sat = sift.octave_saturation(kp, cfg).cpu().numpy()
        g = oracle_gates(kpts, desc_ref, kp, desc.cpu().numpy())
        per_octave = [sum(k["octave"] == o for k in kpts)
                      for o in range(cfg.n_octaves)]
        print(f"phase {label} oracle {img.shape[0]}x{img.shape[1]} "
              f"out_caps={cfg.out_caps}: {_gates_line(g)} oracle per "
              f"octave {per_octave} octave_saturation "
              f"{sat.astype(int).tolist()} launches {fired(launches)}; "
              f"oracle {host_s:.3f} s on the host, "
              f"detect_and_compute {card_ms:.3f} ms on the card ({card})")
        check_frame_launches(label, launches, [img.shape], 0, cfg)
        check_oracle_gates(label, g)
        check(not sat.any(), f"phase {label}: an octave saturated ({sat}): "
              f"the comparison is capped")
        frames[label] = (kpts, desc_ref, kp, desc)

    # 8c: the object is a crop of 8b's frame, the scene 8b's frame
    ks_ref, ds_ref, kps, ds = frames["8b"]
    obj_np = np.ascontiguousarray(scene_np[ORACLE_CROP])
    t0 = time.perf_counter()
    ko_ref, do_ref = oracle.sift_ncl(obj_np, raised)
    ref = oracle.match_l1_ratio(do_ref, ds_ref, ratio=0.86)
    host_s = time.perf_counter() - t0
    obj = torch.from_numpy(obj_np).cuda()

    def object_and_match():
        kpo, do = sift.detect_and_compute(obj, raised)
        return kpo, match_ratio(do, ds, q_valid=kpo.valid,
                                t_valid=kps.valid, ratio=0.86)

    (kpo, m), launches = counted(object_and_match)
    card_ms = _median_wall_ms(object_and_match)
    sat = sift.octave_saturation(kpo, raised).cpu().numpy()
    recall = oracle_match_recall(ref, ko_ref, ks_ref, kpo, kps, m)
    print(f"phase 8c oracle matches {obj_np.shape[0]}x{obj_np.shape[1]} "
          f"crop -> {scene_np.shape[0]}x{scene_np.shape[1]} frame, ratio "
          f"0.86: oracle good={len(ref)} port good={int(m.good.sum())} "
          f"match recall={recall!r} object oracle_kp={len(ko_ref)} port_kp="
          f"{int(kpo.count())} octave_saturation "
          f"{sat.astype(int).tolist()} launches {fired(launches)}; oracle "
          f"{host_s:.3f} s on the host (object + match), object detect + "
          f"match_ratio {card_ms:.3f} ms on the card ({card})")
    check_frame_launches("8c", launches, [obj_np.shape], 1, raised)
    check(len(ref) >= 10, f"phase 8c: the oracle has only {len(ref)} good "
          f"matches")
    check(not sat.any(), f"phase 8c: an octave of the object saturated "
          f"({sat})")
    check(recall >= ORACLE_MATCH_RECALL,
          f"phase 8c: match recall {recall} < {ORACLE_MATCH_RECALL}")


def _host_and_wall_ms(fn, runs: int) -> tuple:
    """Medians over `runs` calls of fn after one more: (ms until fn
    returns, the host's dispatch; ms until the card has finished)."""
    import torch
    fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


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
    img4k = frame_4k()
    report = phase_kernels(scene, obj, img4k)
    phase_cpu_vs_card()
    pair_fps = phase_main_path(scene, obj, true, report)
    phase_batch(scene, report, pair_fps)
    textures = mapping_textures()
    phase_mapping_gated(textures)
    phase_mapping_cpu_vs_card(textures)
    phase_mapping_cli_size(textures, report)
    phase_ransac_graphs(textures)
    phase_multidevice(scene, img4k)
    phase_oracle(card)

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
