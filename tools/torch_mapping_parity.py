#!/usr/bin/env python3
"""How closely the port's mapping path follows sift_tpu's, on the CPU,
in the numbers its tests hold to tolerances:

    JAX_PLATFORMS=cpu python3 tools/torch_mapping_parity.py \
        [--problems 200] [--out build/mapping_parity.json]

  - the 5-point solver on `--problems` random exact problems (the
    recipe of tests/test_epipolar.py:60-85): the share of problems
    whose true E each package finds within 5e-3 and 1e-3 (up to sign),
    the share of candidates of either package that the other matches
    within 1e-3 and 1e-1, and the share of problems with equal
    candidate counts;
  - bundle adjustment on tests/test_torch_sfm.py's rigs (Huber, and
    Cauchy with 10 % outliers): cameras and points after 4 LM
    iterations of 10 and of 30 CG steps, relative Frobenius distance
    between the packages, and their final costs;
  - the renderer: mean |frame difference| between the packages on the
    tests' textures (chip_smoke.mapping_textures) and the coverage-mask
    pixels that differ from cv2.warpPerspective's;
  - the whole slice, tests/test_torch_mapping.py's configuration: both
    packages' run_mapping on the same 10 rendered frames of 200x268,
    the port with sift_tpu's draws, and the relative difference of ATE
    and RMSE.

Needs JAX, sift_tpu and cv2 (it is a comparison with the reference);
about 6 minutes on 8 CPU cores, most of it sift_tpu's compiles. Prints
one JSON object and writes it to --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def _sign_free(a, b) -> float:
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def five_point(n_problems: int) -> dict:
    import jax
    import torch
    from sift_tpu.geometry import lie as jlie
    from sift_tpu.geometry.fivepoint import essential_candidates_5pt as j5
    from sift_tpu_torch.geometry.fivepoint import essential_candidates_5pt
    rng = np.random.default_rng(11)
    p0s, p1s, es_true = [], [], []
    for _ in range(n_problems):
        r = np.asarray(jlie.so3_exp(rng.normal(0, 0.3, 3)))
        t = rng.normal(0, 1, 3)
        t /= np.linalg.norm(t)
        x = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-2, 2, 5),
                      rng.uniform(4, 10, 5)], 1)
        p0s.append((x[:, :2] / x[:, 2:3]).astype(np.float32))
        x1 = x @ r.T + t
        p1s.append((x1[:, :2] / x1[:, 2:3]).astype(np.float32))
        e = np.asarray(jlie.hat(t)) @ r
        es_true.append(e / np.linalg.norm(e))
    et, ot = essential_candidates_5pt(torch.from_numpy(np.stack(p0s)),
                                      torch.from_numpy(np.stack(p1s)))
    ej, oj = jax.jit(jax.vmap(j5))(np.stack(p0s), np.stack(p1s))
    ej, oj = np.asarray(ej), np.asarray(oj)
    true_err = {"port": [], "sift_tpu": []}
    dists, same = [], 0
    for s, e_true in enumerate(es_true):
        mine = [e for e, o in zip(et[s].numpy(), ot[s].numpy()) if o]
        theirs = [e for e, o in zip(ej[s], oj[s]) if o]
        for name, c in (("port", mine), ("sift_tpu", theirs)):
            true_err[name].append(min([_sign_free(e, e_true) for e in c]
                                      or [np.inf]))
        same += len(mine) == len(theirs)
        if mine and theirs:
            dists += [min(_sign_free(a, b) for b in mine) for a in theirs]
            dists += [min(_sign_free(a, b) for b in theirs) for a in mine]
    dists = np.array(dists)
    out = {"problems": n_problems,
           "equal_counts": same / n_problems,
           "candidates_matched_1e-3": float((dists < 1e-3).mean()),
           "candidates_matched_1e-1": float((dists < 1e-1).mean())}
    for name, errs in true_err.items():
        errs = np.array(errs)
        out[f"{name}_true_E_5e-3"] = float((errs < 5e-3).mean())
        out[f"{name}_true_E_1e-3"] = float((errs < 1e-3).mean())
    return out


def bundle_adjustment() -> dict:
    from test_torch_sfm import (_ba_rig, _jax_problem, _port_problem,
                                _rel_err, jba, tba)
    out = {}
    for loss, outliers in (("huber", 0.0), ("cauchy", 0.1)):
        d = _ba_rig(0, outliers=outliers)
        for cg in (10, 30):
            w = jba.bundle_adjust(_jax_problem(d), iters=4, cg_iters=cg,
                                  loss=loss)
            g = tba.bundle_adjust(_port_problem(d), iters=4, cg_iters=cg,
                                  loss=loss)
            c_w = float(jba._cost(w, 3e-3, loss))
            c_g = float(tba._cost(g, 3e-3, loss))
            out[f"{loss}_cg{cg}"] = {
                "cameras_rel": _rel_err(g.cameras.numpy(),
                                        np.asarray(w.cameras)),
                "points_rel": _rel_err(g.points.numpy(),
                                       np.asarray(w.points)),
                "cost_rel": abs(c_g - c_w) / c_w}
    return out


def _texture_dir(tmp: str) -> str:
    import cv2
    import chip_smoke
    from sift_tpu_torch.sfm import mapping as tmap
    for name, tex in zip(tmap._TEXTURES, chip_smoke.mapping_textures()):
        cv2.imwrite(os.path.join(tmp, name), tex.astype(np.uint8))
    return tmp


def renderer(corpus: str) -> dict:
    import cv2
    from sift_tpu.sfm import mapping as jmap
    from sift_tpu_torch.sfm import mapping as tmap
    want = jmap.render_corner_sequence(data_dir=corpus, n_frames=10,
                                       size=(200, 268), seed=3)[0]
    got = tmap.render_corner_sequence(data_dir=corpus, n_frames=10,
                                      size=(200, 268), seed=3)[0]
    texs = tmap.load_textures(corpus)
    h, w = 200, 268
    k = np.array([[0.9 * w, 0, w / 2.0], [0, 0.9 * w, h / 2.0], [0, 0, 1]])
    mask_diff = 0
    for i in range(24):
        th = 2.0 * np.pi * i / 24
        center = np.array([0.9 * np.sin(th), 0.25 * np.sin(2 * th),
                           0.35 * 0.9 * (1.0 - np.cos(th))])
        r = tmap._look_at(center, np.array([0.6 * np.sin(th), 0.0, 6.0]))
        t = -r @ center
        for (o, u, v), tex in zip(tmap._PLANES, texs):
            th_, tw_ = tex.shape
            m = np.stack([r @ np.asarray(u), r @ np.asarray(v),
                          r @ np.asarray(o) + t], axis=1)
            hom = k @ m @ np.diag([1.0 / (tw_ - 1), 1.0 / (th_ - 1), 1.0])
            ref = cv2.warpPerspective(np.ones_like(tex), hom, (w, h),
                                      flags=cv2.INTER_NEAREST).astype(bool)
            mask_diff += int((tmap._warp_plane(tex, hom, h, w)[1]
                              != ref).sum())
    return {"mean_abs_frame_diff": float(np.abs(got - want).mean()),
            "mask_pixels_differing": mask_diff}


def whole_slice(corpus: str) -> dict:
    from sift_tpu.config import DEFAULT_CONFIG
    from sift_tpu.ops.match_cascade import _projection
    from sift_tpu.sfm import mapping as jmap
    from sift_tpu_torch.config import from_jax_config
    from sift_tpu_torch.sfm import mapping as tmap
    from test_torch_mapping import jax_sampler
    frames, k, gt = jmap.render_corner_sequence(
        data_dir=corpus, n_frames=10, size=(200, 268), seed=3)
    jcfg = dataclasses.replace(DEFAULT_CONFIG, descr_rc_bf16=False)
    kw = dict(pair_window=2, min_gap=7, closure_candidates=1)
    want = jmap.run_mapping(frames, k, cfg=jcfg, **kw)
    got = tmap.run_mapping(frames, k,
                           cfg=from_jax_config(dataclasses.asdict(jcfg)),
                           sampler=jax_sampler,
                           proj=np.asarray(_projection(128, 16, 7)),
                           device="cpu", **kw)
    a_w, a_g = jmap.mapping_ate(want, gt), tmap.mapping_ate(got, gt)
    return {
        "registered_equal": bool((want.registered == got.registered).all()),
        "closures_equal": ([(c.i, c.j) for c in want.closures]
                           == [(c.i, c.j) for c in got.closures]),
        "n_points": [want.stats["n_points"], got.stats["n_points"]],
        "ate_rel": {key: abs(a_g[key] - a_w[key]) / a_w[key] for key in a_w},
        "reproj_rmse_rel": (abs(got.reproj_rmse - want.reproj_rmse)
                            / want.reproj_rmse)}


def main() -> int:
    ap = argparse.ArgumentParser(prog="torch_mapping_parity")
    ap.add_argument("--problems", type=int, default=200)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "mapping_parity.json"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = _texture_dir(tmp)
        report = {"device": "cpu",
                  "five_point": five_point(args.problems),
                  "bundle_adjustment": bundle_adjustment(),
                  "renderer": renderer(corpus),
                  "whole_slice": whole_slice(corpus)}
    text = json.dumps(report, indent=1)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
