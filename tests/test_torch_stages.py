"""The port's stages one at a time against sift_tpu's, each fed the same
inputs (the JAX stage's own inputs, passed through NumPy), so that a
mismatch points at one module. The JAX side runs its plain XLA
formulation (dynamic_slice gathers, exact-f32 descriptors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops import extrema as jext
from sift_tpu.ops import refine as jref
from sift_tpu.ops import orientation as jori
from sift_tpu.ops import descriptor as jdesc
from sift_tpu.ops import match as jmatch
from sift_tpu.ops import image as jimage
from sift_tpu import sift as jsift

from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.ops import extrema as text
from sift_tpu_torch.ops import refine as tref
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import match as tmatch
from sift_tpu_torch.ops import image as timage

from _torch_threads import one_thread  # noqa: F401

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
OCTAVES = (0, 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch_kp(kp) -> Keypoints:
    return Keypoints(**{f.name: _t(getattr(kp, f.name))
                        for f in dataclasses.fields(kp)})


def test_image_ops_exact():
    # integer arithmetic and a strided copy: exact
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (37, 51, 3), dtype=np.uint8)
    for j, t in ((jimage.bgr_to_gray_swapped_u8, timage.bgr_to_gray_swapped_u8),
                 (jimage.rgb_to_gray_swapped_u8, timage.rgb_to_gray_swapped_u8)):
        np.testing.assert_array_equal(t(_t(bgr)).numpy(),
                                      np.asarray(j(jnp.asarray(bgr))))
    img = rng.random((37, 51)).astype(np.float32)
    np.testing.assert_array_equal(
        timage.downsample_nearest_2x(_t(img)).numpy(),
        np.asarray(jimage.downsample_nearest_2x(jnp.asarray(img))))


@pytest.fixture(scope="module")
def jax_pyramid(small_image):
    octs = jpyr.build_gaussian_pyramid(jnp.asarray(small_image), JCFG)
    return octs, jpyr.build_dog_pyramid(octs)


@pytest.fixture(scope="module")
def jax_refined(jax_pyramid):
    octs, dogs = jax_pyramid
    out = {}
    for o in OCTAVES:
        cands = jext.top_candidates(dogs[o], JCFG.detect_caps[o], JCFG)
        out[o] = cands, jref.refine_candidates(dogs[o], *cands, JCFG)
    return out


def test_pyramid(small_image, jax_pyramid):
    # the plain blur sums taps in tap order, XLA's convolution in its own
    # order: atol 1e-3 on 0..255 values is the blur's bound
    # (tests/test_conv_pallas.py); DoG layers are differences of them
    octs, dogs = jax_pyramid
    t_octs = tpyr.build_gaussian_pyramid(torch.from_numpy(small_image), TCFG)
    t_dogs = tpyr.build_dog_pyramid(t_octs)
    assert len(t_octs) == len(octs) == TCFG.n_octaves
    for a, b in zip(t_octs + t_dogs, octs + dogs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("o", OCTAVES)
def test_top_candidates(jax_pyramid, o):
    # below the cap the candidate SET is exact (the order may differ:
    # JAX ranks 16-column windows by truncated keys)
    dog = jax_pyramid[1][o]
    cap = JCFG.detect_caps[o]
    jl, jr, jc, jv = (np.asarray(a) for a in jext.top_candidates(dog, cap,
                                                                  JCFG))
    tl, tr, tc, tv = (a.numpy() for a in text.top_candidates(_t(dog), cap,
                                                            TCFG))
    assert 0 < tv.sum() < cap
    assert set(zip(jl[jv], jr[jv], jc[jv])) == set(zip(tl[tv], tr[tv], tc[tv]))
    # slots are ranked by |response|, descending
    resp = np.abs(np.asarray(dog))[tl[tv], tr[tv], tc[tv]]
    assert np.all(np.diff(resp) <= 0)


@pytest.mark.parametrize("o", OCTAVES)
def test_refine(jax_pyramid, jax_refined, o):
    # decisions exact; offsets and contrast atol 1e-5 (the same float32
    # arithmetic in the same order: only the libraries' rounding differs)
    dog = jax_pyramid[1][o]
    cands, jr = jax_refined[o]
    tr = tref.refine_candidates(_t(dog), *(_t(a) for a in cands), TCFG)
    jv = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), jv)
    assert jv.sum() > 5
    for f in ("layer", "r", "c"):
        np.testing.assert_array_equal(getattr(tr, f).numpy()[jv],
                                      np.asarray(getattr(jr, f))[jv])
    for f in ("xi", "xr", "xc", "contr"):
        np.testing.assert_allclose(getattr(tr, f).numpy()[jv],
                                   np.asarray(getattr(jr, f))[jv], atol=1e-5)


@pytest.mark.parametrize("o", OCTAVES)
def test_orientation(jax_pyramid, jax_refined, o):
    # ok flags exact; angles within 1e-2 deg (histogram sums reassociate
    # between XLA's dot and torch.bmm)
    gauss = jax_pyramid[0][o]
    _, rf = jax_refined[o]
    scl = JCFG.sigma * jnp.exp2((rf.layer.astype(jnp.float32) + rf.xi)
                                / JCFG.n_octave_layers)
    peaks = jax.jit(jori.orientation_peaks,
                    static_argnames=("cfg", "row_bounds", "hist_impl"))
    ja, jok = peaks(gauss, rf.layer, rf.r, rf.c, scl, rf.valid, JCFG,
                    hist_impl="onehot_t")
    ta, tok = tori.orientation_peaks(_t(gauss), _t(rf.layer), _t(rf.r),
                                     _t(rf.c), _t(scl), _t(rf.valid), TCFG)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() > 5
    diff = np.abs(ta.numpy()[jok] - np.asarray(ja)[jok])
    diff = np.minimum(diff, 360.0 - diff)
    assert diff.max() < 1e-2


@pytest.mark.parametrize("o", OCTAVES)
def test_descriptors(jax_pyramid, o):
    # atol 1e-5 against the exact-f32 JAX descriptors: values are
    # 0..~0.5 after the sqrt-L1 tail; the histogram sums reassociate
    octs, dogs = jax_pyramid
    kp = jax.jit(jsift.detect_octave,
                 static_argnames=("octave", "cap", "cfg", "out_cap"))(
        octs[o], dogs[o], octave=o, cap=JCFG.detect_caps[o], cfg=JCFG,
        out_cap=JCFG.out_caps[o])
    want = np.asarray(jax.jit(jdesc.descriptors_octave,
                              static_argnames=("cfg", "chunk", "row_bounds"))(
        octs[o], kp, JCFG))
    got = tdesc.descriptors_octave(_t(octs[o]), _to_torch_kp(kp), TCFG)
    valid = np.asarray(kp.valid)
    assert valid.sum() > 5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(got.numpy()[~valid] == 0)


def test_match_ratio():
    # train_idx and distances as K4 gives them; good exact except where
    # d1 is within 1e-4 of ratio * d2 (rounding can flip those)
    rng = np.random.default_rng(3)
    n, m = 96, 130
    q = (rng.random((n, 128)) * 0.3).astype(np.float32)
    t = (rng.random((m, 128)) * 0.3).astype(np.float32)
    t[:60] = q[:60] + rng.normal(0, 0.02, (60, 128)).astype(np.float32)
    qv = rng.random(n) > 0.1
    tv = rng.random(m) > 0.1
    want = jmatch.match_ratio(jnp.asarray(q), jnp.asarray(t),
                              q_valid=jnp.asarray(qv),
                              t_valid=jnp.asarray(tv), impl="xla")
    got = tmatch.match_ratio(_t(q), _t(t), q_valid=_t(qv), t_valid=_t(tv))
    np.testing.assert_array_equal(got.train_idx.numpy(),
                                  np.asarray(want.train_idx))
    np.testing.assert_allclose(got.distance.numpy(),
                               np.asarray(want.distance), rtol=1e-6)
    knn = jmatch.knn2_l1_xla(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv))
    border = np.abs(np.asarray(knn.d1) - 0.86 * np.asarray(knn.d2)) < 1e-4
    g, wg = got.good.numpy(), np.asarray(want.good)
    np.testing.assert_array_equal(g[~border], wg[~border])
    assert 20 < wg.sum() < n
