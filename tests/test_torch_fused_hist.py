"""K3-ori and K3-desc on the CPU: the per-keypoint parameters against
sift_tpu's, the plain versions against an independent float64
scatter-add written as the reference's own loops (calcOrientationHist,
calcSIFTDescriptor; the closest CPU stand-in for the CUDA kernels, which
scatter the same float32 samples), the stages against sift_tpu's with
its Pallas patch gather in interpret mode, and the descriptor chunking.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import descriptor as jdesc
from sift_tpu.ops import orientation as jori
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops.mathutil import cv_round as jax_cv_round
from sift_tpu import sift as jsift

from sift_tpu_torch.config import DEFAULT_CONFIG as TCFG, from_jax_config
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist_plain
from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist_plain
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch import sift as tsift

from _torch_threads import one_thread  # noqa: F401

_FLT_EPS = float(np.float32(1.1920929e-07))
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- per-keypoint parameters

def _jax_descr_params(size, angle, octave, hw, cfg):
    """sift_tpu/ops/descriptor.py:76-83 (inside its per-keypoint `one`),
    vectorised over keypoints."""
    d = cfg.descr_width
    h, w = hw
    diag = int(math.sqrt(float(w) * w + float(h) * h))
    inv_scale = jnp.exp2(-jnp.float32(octave))
    scl = size * inv_scale * 0.5
    ori = 360.0 - angle
    ori = jnp.where(jnp.abs(ori - 360.0) < _FLT_EPS, 0.0, ori)
    hist_width = cfg.descr_scl_fctr * scl
    radius = jax_cv_round(hist_width * math.sqrt(2.0) * (d + 1) * 0.5)
    radius = jnp.minimum(radius, diag)
    cos_t = jnp.cos(ori * (math.pi / 180.0)) / hist_width
    sin_t = jnp.sin(ori * (math.pi / 180.0)) / hist_width
    return ori, radius, cos_t, sin_t


def _jax_ori_params(scl0, cfg):
    """sift_tpu/ops/orientation.py:123-125, vectorised over keypoints."""
    radius = jax_cv_round(cfg.ori_radius_fctr * scl0)
    sigma = cfg.ori_sig_fctr * scl0
    return radius, -1.0 / (2.0 * sigma * sigma)


@pytest.mark.parametrize("stage", ["orientation", "descriptor"])
def test_params_match_jax(stage):
    # radius exact; float parameters atol 1e-5 (test_torch_stages.py's
    # bound: the same float32 arithmetic, the libraries' cos/sin and
    # division rounding may differ)
    rng = np.random.default_rng(17)
    n = 200
    cfg = JaxConfig()
    if stage == "orientation":
        scl = rng.uniform(1.6, 4.0, n).astype(F32)
        want = [np.asarray(a) for a in _jax_ori_params(jnp.asarray(scl), cfg)]
        got = [a.numpy() for a in tori.orientation_params(_t(scl), TCFG)]
    else:
        octave = 1
        size = (rng.uniform(1.6, 8.0, n) * 2 ** octave).astype(F32)
        angle = rng.uniform(0.0, 360.0, n).astype(F32)
        angle[:3] = (0.0, np.nextafter(F32(0), F32(1)), 180.0)
        hw = (540, 960)
        want = [np.asarray(a) for a in _jax_descr_params(
            jnp.asarray(size), jnp.asarray(angle), octave, hw, cfg)]
        prm = tdesc.descriptor_params(
            _t(size), _t(angle), torch.exp2(torch.tensor([-float(octave)])),
            hw, TCFG)
        got = [prm.ori.numpy(), prm.radius.numpy(), prm.cos_t.numpy(),
               prm.sin_t.numpy()]
        assert got[0][0] == 0.0          # 360 - 0 snaps to 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype == np.int32:
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5)


# ------------------------------------- plain versions vs reference loops

_P = [F32(k * (180.0 / math.pi)) for k in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128)]
_EPS = F32(2.220446049250313e-16)


def _fast_atan2(y, x):
    """cv::hal::fastAtan2 on float32 scalars, degrees."""
    ax, ay = abs(x), abs(y)
    if ax >= ay:
        c = ay / (ax + _EPS)
    else:
        c = ax / (ay + _EPS)
    c2 = c * c
    a = (((_P[3] * c2 + _P[2]) * c2 + _P[1]) * c2 + _P[0]) * c
    if ax < ay:
        a = F32(90) - a
    if x < 0:
        a = F32(180) - a
    if y < 0:
        a = F32(360) - a
    return a


def _grad(img, y, x):
    """dx, dy at (y, x) as the reference takes them (src/sift.cpp:415-416,
    613-614)."""
    return img[y, x + 1] - img[y, x - 1], img[y - 1, x] - img[y + 1, x]


def _ref_ori_hist(img, r, c, radius, expf_scale, n):
    """calcOrientationHist (src/sift.cpp:389-438), its samples in float32
    and its scatter-add in float64."""
    h, w = img.shape
    hist = np.zeros(n)
    for i in range(-radius, radius + 1):
        y = r + i
        if y <= 0 or y >= h - 1:
            continue
        for j in range(-radius, radius + 1):
            x = c + j
            if x <= 0 or x >= w - 1:
                continue
            dx, dy = _grad(img, y, x)
            wgt = np.exp(F32(i * i + j * j) * expf_scale)
            mag = np.sqrt(dx * dx + dy * dy)
            b = int(np.rint(F32(n / 360.0) * _fast_atan2(dy, dx)))
            b = b - n if b >= n else (b + n if b < 0 else b)
            hist[b] += float(wgt) * float(mag)
    return hist


def _ref_descr_hist(img, r, c, radius, cos_t, sin_t, ori, d, n):
    """calcSIFTDescriptor's histogram (src/sift.cpp:579-684, before the
    circular fold), its samples in float32 and its trilinear scatter-add
    in float64."""
    h, w = img.shape
    hist = np.zeros((d + 2, d + 2, n + 2))
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            c_rot = F32(j) * cos_t - F32(i) * sin_t
            r_rot = F32(j) * sin_t + F32(i) * cos_t
            rbin = r_rot + F32(d / 2 - 0.5)
            cbin = c_rot + F32(d / 2 - 0.5)
            y, x = r + i, c + j
            if not (-1 < rbin < d and -1 < cbin < d
                    and 0 < y < h - 1 and 0 < x < w - 1):
                continue
            dx, dy = _grad(img, y, x)
            wgt = np.exp((c_rot * c_rot + r_rot * r_rot)
                         * F32(-1.0 / (d * d * 0.5)))
            mag = float(np.sqrt(dx * dx + dy * dy) * wgt)
            obin = (_fast_atan2(dy, dx) - ori) * F32(n / 360.0)
            r0, c0, o0 = (int(np.floor(v)) for v in (rbin, cbin, obin))
            fr, fc, fo = (float(v) - k for v, k in ((rbin, r0), (cbin, c0),
                                                     (obin, o0)))
            o0 = o0 + n if o0 < 0 else (o0 - n if o0 >= n else o0)
            v_r1 = mag * fr
            v_r0 = mag - v_r1
            for dr, vr in ((0, v_r0), (1, v_r1)):
                v_c1 = vr * fc
                for dc, vc in ((0, vr - v_c1), (1, v_c1)):
                    v_o1 = vc * fo
                    hist[r0 + 1 + dr, c0 + 1 + dc, o0] += vc - v_o1
                    hist[r0 + 1 + dr, c0 + 1 + dc, o0 + 1] += v_o1
    return hist


def _keypoints(small_image, n=8):
    """Octave-0 Gaussian stack of small_image and n keypoints on layers
    1..nl: interior ones and two whose windows cross the image border."""
    gauss = tpyr.build_gaussian_pyramid(torch.from_numpy(small_image),
                                        TCFG)[0]
    h, w = gauss.shape[1:]
    rng = np.random.default_rng(23)
    layer = rng.integers(1, TCFG.n_octave_layers + 1, n).astype(np.int32)
    r = rng.integers(20, h - 20, n).astype(np.int32)
    c = rng.integers(20, w - 20, n).astype(np.int32)
    r[:2], c[:2] = (3, h - 5), (w - 2, 6)
    scl = rng.uniform(1.6, 2.6, n).astype(F32)
    angle = rng.uniform(0.0, 360.0, n).astype(F32)
    return gauss, layer, r, c, scl, angle


@pytest.mark.parametrize("stage", ["orientation", "descriptor"])
def test_hist_plain_matches_reference_loops(small_image, stage):
    # rtol 1e-5: both scatter the same float32 samples; the plain version
    # sums them in float32 through a one-hot product, the loops in
    # float64
    gauss, layer, r, c, scl, angle = _keypoints(small_image)
    nl = TCFG.n_octave_layers
    img = gauss.numpy()
    if stage == "orientation":
        rp = TCFG.ori_patch_radius
        padded = F.pad(gauss[1:1 + nl], (rp + 1,) * 4)
        radius, expf = tori.orientation_params(_t(scl), TCFG)
        got = orientation_hist_plain(padded, _t(layer - 1), _t(r), _t(c),
                                     radius, expf, TCFG).numpy()
        want = np.stack([_ref_ori_hist(
            img[layer[k]], r[k], c[k], int(radius[k]), expf[k].numpy(),
            TCFG.ori_hist_bins) for k in range(len(r))])
    else:
        rd = TCFG.descr_patch_radius
        padded = F.pad(gauss[1:1 + nl], (rd + 1,) * 4)
        prm = tdesc.descriptor_params(_t(2 * scl), _t(angle),
                                      torch.ones(1), img.shape[1:], TCFG)
        valid = torch.ones(len(r), dtype=torch.bool)
        got = descriptor_hist_plain(padded, _t(layer - 1), _t(r), _t(c),
                                    prm.cos_t, prm.sin_t, prm.radius,
                                    prm.ori, valid, TCFG).numpy()
        want = np.stack([_ref_descr_hist(
            img[layer[k]], r[k], c[k], int(prm.radius[k]),
            prm.cos_t[k].numpy(), prm.sin_t[k].numpy(), prm.ori[k].numpy(),
            TCFG.descr_width, TCFG.descr_hist_bins) for k in range(len(r))])
    assert got.shape == want.shape
    assert (want > 0).sum(axis=tuple(range(1, want.ndim))).min() > 10
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_descriptor_hist_plain_zeroes_invalid_slots(small_image):
    gauss, layer, r, c, scl, angle = _keypoints(small_image)
    rd = TCFG.descr_patch_radius
    padded = F.pad(gauss[1:1 + TCFG.n_octave_layers], (rd + 1,) * 4)
    prm = tdesc.descriptor_params(_t(2 * scl), _t(angle), torch.ones(1),
                                  gauss.shape[1:], TCFG)
    valid = torch.tensor([True, False] * 4)
    args = (padded, _t(layer - 1), _t(r), _t(c), prm.cos_t, prm.sin_t,
            prm.radius, prm.ori)
    some = descriptor_hist_plain(*args, valid, TCFG)
    every = descriptor_hist_plain(*args, torch.ones(8, dtype=torch.bool),
                                  TCFG)
    assert torch.equal(some[valid], every[valid])
    assert not some[~valid].any() and every[~valid].any()


# ------------------------------------------- stages vs sift_tpu, Pallas

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="pallas",
                 descr_gather_impl="pallas",
                 detect_caps=(256, 128, 64, 32, 32),
                 out_caps=(64, 64, 64, 64, 64))
SCFG = from_jax_config(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def jax_octave0(small_image):
    octs = jpyr.build_gaussian_pyramid(jnp.asarray(small_image), JCFG)
    dogs = jpyr.build_dog_pyramid(octs)
    kp = jax.jit(jsift.detect_octave,
                 static_argnames=("octave", "cap", "cfg", "out_cap"))(
        octs[0], dogs[0], octave=0, cap=JCFG.detect_caps[0], cfg=JCFG,
        out_cap=JCFG.out_caps[0])
    return octs[0], kp


@pytest.mark.parametrize("stage", ["orientation", "descriptor"])
def test_stage_matches_jax_with_pallas_gather(jax_octave0, stage):
    # the stages that now go through K3-ori / K3-desc against sift_tpu's,
    # whose patches come from the Pallas gather K3 replaced (interpret
    # mode): test_torch_stages.py's bounds
    gauss, kp = jax_octave0
    valid = np.asarray(kp.valid)
    assert valid.sum() > 5
    if stage == "orientation":
        scl = (np.asarray(kp.size) * 0.5).astype(F32)   # octave 0
        ja, jok = jori.orientation_peaks(gauss, kp.layer, kp.r, kp.c,
                                         jnp.asarray(scl), kp.valid, JCFG,
                                         hist_impl="onehot_t")
        ta, tok = tori.orientation_peaks(_t(gauss), _t(kp.layer), _t(kp.r),
                                         _t(kp.c), _t(scl), _t(kp.valid),
                                         SCFG)
        jok = np.asarray(jok)
        np.testing.assert_array_equal(tok.numpy(), jok)
        diff = np.abs(ta.numpy()[jok] - np.asarray(ja)[jok])
        assert np.minimum(diff, 360.0 - diff).max() < 1e-2
    else:
        want = np.asarray(jdesc.descriptors_octave(gauss, kp, JCFG))
        tkp = Keypoints(**{f.name: _t(getattr(kp, f.name))
                           for f in dataclasses.fields(kp)})
        got = tdesc.descriptors_octave(_t(gauss), tkp, SCFG)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert np.all(got.numpy()[~valid] == 0)


def test_descriptors_octave_chunking_is_exact(small_image):
    # on the CPU the chunks only bound the one-hot intermediate: one chunk
    # of every slot gives the same bits as chunks of 64
    cfg = dataclasses.replace(TCFG, detect_caps=(256, 128, 64, 32, 32),
                              out_caps=(128, 64, 64, 64, 64))
    octs = tpyr.build_gaussian_pyramid(torch.from_numpy(small_image), cfg)
    dogs = tpyr.build_dog_pyramid(octs)
    kp = tsift.detect_octave(octs[0], dogs[0], 0, cfg.detect_caps[0], cfg,
                             cfg.out_caps[0])
    assert int(kp.valid.sum()) > 5
    chunked = tdesc.descriptors_octave(octs[0], kp, cfg, chunk=64)
    whole = tdesc.descriptors_octave(octs[0], kp, cfg, chunk=kp.capacity)
    assert torch.equal(chunked, whole)
