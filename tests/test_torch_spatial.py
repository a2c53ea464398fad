"""Spatial tiling (sift_tpu_torch.parallel.spatial) and the flags it
threads through the front end, against sift_tpu on the CPU.

Single-process checks hold each flag against JAX's: the blur without
the last-row/column quirk, refine, orientation and descriptors with
`row_bounds` (inside the array, and reaching past it, which the port
compares and never clamps), and the candidate scan's box against JAX's
masked scores. Then the tiled detector runs on 2 gloo ranks on the dry
run's 128x128 frame (tiled_octaves=1, halo=48). sift_tpu's own tiled
call takes over a minute to compile on this CPU, so its single-device
detect_and_compute is the reference here: sift_tpu's tests assert that
the tiled and single-device results are the same keypoints
(tests/test_spatial.py). A 256x128 frame at tiled_octaves=2 covers the
hand-over between tiled octaves, against the port's single-device run.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import sift as jsift
from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import conv as jconv
from sift_tpu.ops import descriptor as jdesc
from sift_tpu.ops import extrema as jext
from sift_tpu.ops import orientation as jori
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops import refine as jref

import _torch_rank_jobs as jobs
from sift_tpu_torch import sift
from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.ops import conv as tconv
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import extrema as text
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops import refine as tref
from sift_tpu_torch.parallel.mesh import run_spmd
from sift_tpu_torch.parallel.spatial import candidate_box
from sift_tpu_torch.types import Keypoints

from _torch_threads import one_thread  # noqa: F401

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
# the dry run's tiled configuration (__graft_entry__.py:153-154), exact
# f32 descriptors; and sift_tpu's tests/test_spatial.py configuration
J_TILED = JaxConfig(detect_caps=(64, 32, 16, 8, 8), out_caps=(32, 16, 8, 8, 8),
                    max_keypoints=72, descr_rc_bf16=False,
                    ori_gather_impl="dynamic_slice",
                    descr_gather_impl="dynamic_slice")
T_TILED = from_jax_config(dataclasses.asdict(J_TILED))
T_TWO = dataclasses.replace(T_TILED, detect_caps=(256, 128, 64, 32, 16),
                            out_caps=(128, 64, 32, 16, 8), max_keypoints=248)
# (lo, hi) rows of the "true image" inside a 160-row octave: inside the
# array, and reaching past both of its edges
ROW_BOUNDS = [(40, 121), (-12, 175)]
RANK_TIMEOUT_S = 240


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def octave0(small_image):
    """JAX's octave-0 Gaussian stack and DoG of the synthetic image, and
    its candidates."""
    octs = jpyr.build_gaussian_pyramid(jnp.asarray(small_image), JCFG)
    dog = jpyr.build_dog_pyramid(octs)[0]
    cands = jext.top_candidates(dog, JCFG.detect_caps[0], JCFG)
    return octs[0], dog, cands


def test_blur_without_quirk_matches_jax():
    # apply_quirk=False blurs the last row and column as they are:
    # against sift_tpu's conv at the blur's bound (atol 1e-3 on 0..255,
    # tests/test_torch_stages.py); the default still zeroes them first
    img = (np.random.default_rng(2).random((41, 57)) * 255).astype(np.float32)
    sig = TCFG.scale_sigmas()[1:]
    for quirk in (False, True):
        want = np.asarray(jconv.gaussian_blur_multi(jnp.asarray(img), sig,
                                                    apply_quirk=quirk))
        got = tconv.gaussian_blur_multi(_t(img), sig, apply_quirk=quirk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    assert not torch.equal(tconv.gaussian_blur_multi(_t(img), sig),
                           tconv.gaussian_blur_multi(_t(img), sig,
                                                     apply_quirk=False))


@pytest.mark.parametrize("bounds", ROW_BOUNDS)
def test_refine_row_bounds_matches_jax(octave0, bounds):
    # decisions exact, offsets and contrast atol 1e-5 (test_torch_stages'
    # bounds); the bounds reject moves that a whole image would take
    _, dog, cands = octave0
    jr = jref.refine_candidates(dog, *cands, JCFG, row_bounds=bounds)
    tr = tref.refine_candidates(_t(dog), *(_t(a) for a in cands), TCFG,
                                row_bounds=bounds)
    jv = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), jv)
    for f in ("layer", "r", "c"):
        np.testing.assert_array_equal(getattr(tr, f).numpy()[jv],
                                      np.asarray(getattr(jr, f))[jv])
    for f in ("xi", "xr", "xc", "contr"):
        np.testing.assert_allclose(getattr(tr, f).numpy()[jv],
                                   np.asarray(getattr(jr, f))[jv], atol=1e-5)
    whole = tref.refine_candidates(_t(dog), *(_t(a) for a in cands), TCFG)
    if bounds[0] > 0:
        assert int(whole.valid.sum()) > int(tr.valid.sum()) > 5


@pytest.mark.parametrize("bounds", ROW_BOUNDS)
def test_orientation_row_bounds_matches_jax(octave0, bounds):
    # ok flags exact, angles within 1e-2 deg (test_torch_stages' bound);
    # the window changes the histograms of keypoints near its rows
    gauss, dog, cands = octave0
    rf = jref.refine_candidates(dog, *cands, JCFG)
    scl = JCFG.sigma * jnp.exp2((rf.layer.astype(jnp.float32) + rf.xi)
                                / JCFG.n_octave_layers)
    peaks = jax.jit(jori.orientation_peaks,
                    static_argnames=("cfg", "row_bounds", "hist_impl"))
    ja, jok = peaks(gauss, rf.layer, rf.r, rf.c, scl, rf.valid, JCFG,
                    row_bounds=bounds, hist_impl="onehot_t")
    args = (_t(gauss), _t(rf.layer), _t(rf.r), _t(rf.c), _t(scl),
            _t(rf.valid), TCFG)
    ta, tok = tori.orientation_peaks(*args, row_bounds=bounds)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    diff = np.abs(ta.numpy()[jok] - np.asarray(ja)[jok])
    assert np.minimum(diff, 360.0 - diff).max() < 1e-2
    whole, _ = tori.orientation_peaks(*args)
    assert not torch.equal(whole, ta)


@pytest.mark.parametrize("bounds", ROW_BOUNDS)
def test_descriptors_row_bounds_match_jax(octave0, bounds):
    # atol 1e-5 against exact-f32 JAX descriptors (test_torch_stages'
    # bound), zero rows where invalid
    gauss, dog, _ = octave0
    kp = jax.jit(jsift.detect_octave,
                 static_argnames=("octave", "cap", "cfg", "out_cap"))(
        gauss, dog, octave=0, cap=JCFG.detect_caps[0], cfg=JCFG,
        out_cap=JCFG.out_caps[0])
    want = np.asarray(jax.jit(jdesc.descriptors_octave,
                              static_argnames=("cfg", "chunk", "row_bounds"))(
        gauss, kp, JCFG, row_bounds=bounds))
    tkp = Keypoints(**{f.name: _t(getattr(kp, f.name))
                       for f in dataclasses.fields(kp)})
    got = tdesc.descriptors_octave(_t(gauss), tkp, TCFG, row_bounds=bounds)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(got.numpy()[~np.asarray(kp.valid)] == 0)
    assert not torch.equal(got, tdesc.descriptors_octave(_t(gauss), tkp,
                                                         TCFG))


def test_boxed_scan_matches_jax_masked_scores(octave0):
    # the plain scan inside a band's box equals JAX's extremum mask
    # intersected with the same rows and columns
    # (sift_tpu/parallel/spatial.py:139-151), exactly; the box's
    # candidates are the slots of top_candidates with the box
    _, dog, _ = octave0
    hb, halo, gr0, h_true = 80, 20, 40, 160
    box = candidate_box(hb, halo, gr0, h_true, dog.shape[2], dog.shape[1:],
                        TCFG)
    r_lo, r_hi, c_lo, c_hi = box
    rows = jnp.arange(dog.shape[1])
    cols = jnp.arange(dog.shape[2])
    inside = (((rows >= r_lo) & (rows < r_hi))[:, None]
              & ((cols >= c_lo) & (cols < c_hi))[None, :])
    nl = JCFG.n_octave_layers
    want = np.asarray(jnp.where(jext.extrema_mask(dog, JCFG) & inside[None],
                                jnp.abs(dog[1:1 + nl]), -1.0))
    got = torch.where(text.extrema_mask(_t(dog), TCFG, box),
                      _t(dog)[1:1 + nl].abs(), -1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).sum() < (np.asarray(jext.extrema_mask(dog, JCFG))
                                   .sum())
    lay, r, c, v = text.top_candidates(_t(dog), 512, TCFG, box=box)
    ll, rr, cc = np.nonzero(want > 0)
    assert set(zip(lay[v].tolist(), r[v].tolist(), c[v].tolist())) == set(
        zip((ll + 1).tolist(), rr.tolist(), cc.tolist()))
    keys, count = text.extrema_compact(_t(dog)[None], TCFG, box)
    assert int(count[0]) == int((want > 0).sum())


def test_box_must_lie_inside_the_border_box():
    # the kernel's neighbour loads stay inside the frame only inside the
    # border box; every device refuses other boxes, and an empty box
    # scans nothing
    dog = torch.zeros((4, 40, 50))
    b = TCFG.img_border
    for box in ((b - 1, 20, b, 45), (b, 36, b, 45), (b, 20, b, 46)):
        with pytest.raises(ValueError, match="not inside the border box"):
            text.top_candidates(dog, 16, TCFG, box=box)
    _, _, _, v = text.top_candidates(dog + 20.0 * (torch.rand(dog.shape) > .9),
                                     16, TCFG, box=(20, 20, b, 45))
    assert not v.any()
    assert text.check_box(None, TCFG, (40, 50)) == (b, 40 - b, b, 50 - b)


def _valid_set(kp, d):
    v = np.asarray(kp.valid)
    xy = np.stack([np.asarray(kp.x)[v], np.asarray(kp.y)[v],
                   np.asarray(kp.angle)[v], np.asarray(kp.size)[v]], 1)
    order = np.lexsort((xy[:, 2], xy[:, 1], xy[:, 0]))
    return xy[order], np.asarray(d)[v][order]


@pytest.fixture(scope="module")
def tiled():
    """The port's 2 ranks (in the background) and sift_tpu's single
    device on the 128x128 frame; the port's 2 ranks at tiled_octaves=2
    on a 256x128 frame."""
    rng = np.random.default_rng(5)
    img = (rng.random((128, 128)) * 255).astype(np.float32)
    img2 = (rng.random((256, 128)) * 255).astype(np.float32)

    def port():
        return (run_spmd(jobs.spatial_job, 2, args=(img, T_TILED, [(1, 48)]),
                         backend="gloo", device="cpu",
                         timeout_s=RANK_TIMEOUT_S),
                run_spmd(jobs.spatial_job, 2, args=(img2, T_TWO, [(2, 48)]),
                         backend="gloo", device="cpu",
                         timeout_s=RANK_TIMEOUT_S))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(port)
        jkp, jd = jsift.detect_and_compute(jnp.asarray(img), J_TILED)
        want = (jkp, np.asarray(jd))
        one, two = fut.result()
    return img, img2, one, two, want


def test_tiled_matches_jax_single_device(tiled):
    # the valid keypoints as a set: (x, y, angle, size) within 1e-3 and
    # descriptors within 1e-3, sift_tpu's tests/test_spatial.py bounds;
    # every rank returns the whole result; the tiled octave does not
    # saturate (it carries per-rank caps; the deep ones run as on one
    # device)
    img, _, one, _, (jkp, jd) = tiled
    xs, ds = _valid_set(jkp, jd)
    assert len(xs) > 10
    for r in one:
        kp, d = r["tiled"][0]
        xt, dt = _valid_set(kp, d)
        assert len(xt) == len(xs), (len(xt), len(xs))
        np.testing.assert_allclose(xt, xs, rtol=0, atol=1e-3)
        np.testing.assert_allclose(dt, ds, rtol=0, atol=1e-3)
    kp1, _ = sift.detect_and_compute(_t(img), T_TILED)
    assert not sift.octave_saturation(kp1, T_TILED)[0]


def test_tiled_two_octaves_matches_single_device(tiled):
    # tiled_octaves=2: the band halves and the next octave exchanges its
    # own halo; against the port's single-device run with the same
    # bounds
    _, img2, _, two, _ = tiled
    kp1, d1 = sift.detect_and_compute(_t(img2), T_TWO)
    assert not sift.octave_saturation(kp1, T_TWO)[:2].any()
    xs, ds = _valid_set(kp1, d1)
    assert len(xs) > 15
    for r in two:
        xt, dt = _valid_set(*r["tiled"][0])
        assert len(xt) == len(xs), (len(xt), len(xs))
        np.testing.assert_allclose(xt, xs, rtol=0, atol=1e-3)
        np.testing.assert_allclose(dt, ds, rtol=0, atol=1e-3)


def test_tiled_refuses_thin_bands(tiled):
    # a band thinner than its halo after the tiled octaves' halvings is
    # refused with sift_tpu's ValueError
    _, _, one, two, _ = tiled
    for r in one + two:
        assert r["thin"] is not None and "too thin" in r["thin"]


def test_candidate_box_of_the_bands():
    # the two bands of a 128-row frame, halo 48: each scans its own core
    # rows inside the global border, and together they cover the border
    # box's rows exactly once
    b = TCFG.img_border
    rows = []
    for rank in range(2):
        r_lo, r_hi, c_lo, c_hi = candidate_box(64, 48, 64 * rank, 128, 128,
                                               (160, 128), TCFG)
        assert (c_lo, c_hi) == (b, 128 - b)
        rows += [r + 64 * rank - 48 for r in range(r_lo, r_hi)]
    assert rows == list(range(b, 128 - b))
