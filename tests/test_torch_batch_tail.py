"""The batched tail of detect_and_compute_batch, port against sift_tpu:
refine, orientation, the octave tail and descriptors over B frames at
once, against jax.vmap of sift_tpu's own stages and against the port's
single-frame calls; the per-frame layer clamp of K3-ori and K3-desc
(an invalid slot of frame b >= 1 with stack layer -1 must read frame b's
first plane, not frame b - 1's last); and B = 1 of every batched
function against its single-frame call.

The JAX side runs exact-f32 descriptors and dynamic_slice gathers at the
reduced caps of tests/test_torch_batch.py, on three textured frames (the
shared small_image rolled by 17 columns a frame, bench.py's step), which
differ and have candidates in every frame of octaves 0 and 1. Both sides
get the same inputs: the JAX batch pyramid and candidate scan, passed
through NumPy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sift_tpu import sift as jsift
from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import descriptor as jdesc
from sift_tpu.ops import extrema as jext
from sift_tpu.ops import orientation as jori
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops import refine as jref

from sift_tpu_torch import sift
from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops import refine as tref
from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist
from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist
from sift_tpu_torch.types import Keypoints

from _torch_threads import one_thread  # noqa: F401

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
NB = 3
OCTAVES = (0, 1)
KP_FIELDS = ("x", "y", "size", "angle", "response", "octave", "layer", "r",
             "c", "valid")


def _t(a):
    return torch.from_numpy(np.array(a))


def _kp_np(kp) -> dict:
    return {f: np.asarray(getattr(kp, f)) for f in KP_FIELDS}


def _to_torch_kp(kp) -> Keypoints:
    return Keypoints(**{f: _t(v) for f, v in _kp_np(kp).items()})


def _same(got, want) -> None:
    """Equal values, shape and dtype, NaN equal to NaN (an orientation
    slot with no peak divides 0 by 0)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _frames_equal(batched, single_fn):
    """Each frame b of a batched result equals single_fn(b), exactly."""
    for b in range(NB):
        want = single_fn(b)
        got = (tuple(a[b] for a in batched) if isinstance(batched, tuple)
               else batched[b])
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                _same(g, w)
        else:
            _same(got, want)


@pytest.fixture(scope="module")
def octaves(small_image):
    """Per octave in OCTAVES: (gauss, dog, candidates) of the JAX batch
    pyramid and scan, as NumPy."""
    imgs = np.stack([np.roll(small_image, 17 * i, axis=1)
                     for i in range(NB)])
    octs = jpyr.build_gaussian_pyramid_batch(jnp.asarray(imgs), JCFG)
    dogs = jpyr.build_dog_pyramid_batch(octs)
    out = {}
    for o in OCTAVES:
        cands = jext.top_candidates_batch(dogs[o], JCFG.detect_caps[o], JCFG)
        out[o] = (np.array(octs[o]), np.array(dogs[o]),
                  tuple(np.array(a) for a in cands))
    return out


@pytest.fixture(scope="module")
def jax_tail(octaves):
    """Per octave: sift_tpu's vmapped refine, the scale of its keypoints,
    its vmapped octave tail and descriptors (sift_tpu/sift.py:236-250)."""
    out = {}
    for o, (gauss, dog, cands) in octaves.items():
        rf = jax.vmap(lambda d, l, r, c, v: jref.refine_candidates(
            d, l, r, c, v, JCFG))(jnp.asarray(dog),
                                  *(jnp.asarray(a) for a in cands))
        scl = JCFG.sigma * jnp.exp2((rf.layer.astype(jnp.float32) + rf.xi)
                                    / JCFG.n_octave_layers)
        tail = jax.vmap(lambda g, d, l, r, c, v, _o=o: jsift._octave_tail(
            g, d, l, r, c, v, _o, JCFG, JCFG.out_caps[_o]))
        kp = jax.jit(tail)(jnp.asarray(gauss), jnp.asarray(dog),
                           *(jnp.asarray(a) for a in cands))
        desc = jax.jit(jax.vmap(lambda g, k: jdesc.descriptors_octave(
            g, k, JCFG)))(jnp.asarray(gauss), kp)
        out[o] = rf, scl, kp, np.asarray(desc)
    return out


@pytest.mark.parametrize("o", OCTAVES)
def test_batched_refine(octaves, jax_tail, o):
    # against sift_tpu's vmap: decisions exact, offsets and contrast atol
    # 1e-5 (test_torch_stages.py's refine bound: the same float32
    # arithmetic, only the libraries' rounding differs); against the
    # port's per-frame refine: every field exact
    _, dog, cands = octaves[o]
    jr = jax_tail[o][0]
    tr = tref.refine_candidates(_t(dog), *(_t(a) for a in cands), TCFG)
    jv = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), jv)
    assert all(jv[b].sum() > 5 for b in range(NB))
    for f in ("layer", "r", "c"):
        np.testing.assert_array_equal(getattr(tr, f).numpy()[jv],
                                      np.asarray(getattr(jr, f))[jv])
    for f in ("xi", "xr", "xc", "contr"):
        np.testing.assert_allclose(getattr(tr, f).numpy()[jv],
                                   np.asarray(getattr(jr, f))[jv], atol=1e-5)
    _frames_equal(tuple(tr), lambda b: tuple(tref.refine_candidates(
        _t(dog[b]), *(_t(a[b]) for a in cands), TCFG)))


@pytest.mark.parametrize("o", OCTAVES)
def test_batched_orientation_peaks(octaves, jax_tail, o):
    # against sift_tpu's vmap: peak flags exact, angles within 1e-2 deg
    # (test_torch_stages.py's bound: histogram sums reassociate between
    # XLA's dot and torch.bmm); against the port per frame: exact
    gauss = octaves[o][0]
    rf, scl = jax_tail[o][:2]
    ja, jok = jax.jit(jax.vmap(lambda g, l, r, c, s, v: jori.orientation_peaks(
        g, l, r, c, s, v, JCFG, hist_impl="onehot_t")))(
        jnp.asarray(gauss), rf.layer, rf.r, rf.c, scl, rf.valid)
    args = [_t(a) for a in (rf.layer, rf.r, rf.c, scl, rf.valid)]
    ta, tok = tori.orientation_peaks(_t(gauss), *args, TCFG)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert all(jok[b].sum() > 5 for b in range(NB))
    diff = np.abs(ta.numpy()[jok] - np.asarray(ja)[jok])
    assert np.minimum(diff, 360.0 - diff).max() < 1e-2
    _frames_equal((ta, tok), lambda b: tori.orientation_peaks(
        _t(gauss[b]), *(a[b] for a in args), TCFG))


@pytest.mark.parametrize("o", OCTAVES)
def test_batched_octave_tail(octaves, jax_tail, o):
    # against sift_tpu's vmapped _octave_tail, slot by slot: keypoint
    # identity (valid, octave, layer, r, c) exact, x/y within 1e-3 px
    # (test_torch_batch.py's bounds); against the port per frame: exact
    gauss, dog, cands = octaves[o]
    jk = _kp_np(jax_tail[o][2])
    kp = sift._octave_tail(_t(gauss), _t(dog), *(_t(a) for a in cands), o,
                           TCFG, TCFG.out_caps[o])
    assert kp.x.shape == (NB, TCFG.out_caps[o])
    v = jk["valid"]
    np.testing.assert_array_equal(kp.valid.numpy(), v)
    assert all(v[b].sum() > 5 for b in range(NB))
    for f in ("octave", "layer", "r", "c"):
        np.testing.assert_array_equal(getattr(kp, f).numpy()[v], jk[f][v])
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(kp, f).numpy()[v], jk[f][v],
                                   atol=1e-3)
    for b in range(NB):
        one = sift._octave_tail(_t(gauss[b]), _t(dog[b]),
                                *(_t(a[b]) for a in cands), o, TCFG,
                                TCFG.out_caps[o])
        for f in KP_FIELDS:
            _same(getattr(kp.frame(b), f), getattr(one, f))


@pytest.mark.parametrize("o", OCTAVES)
def test_batched_descriptors(octaves, jax_tail, o):
    # sift_tpu's own vmapped keypoints into both: descriptors within atol
    # 1e-3 of sift_tpu's vmap (test_torch_batch.py's bound), invalid rows
    # zero; against the port per frame: exact
    gauss = octaves[o][0]
    kp = _to_torch_kp(jax_tail[o][2])
    want = jax_tail[o][3]
    got = tdesc.descriptors_octave(_t(gauss), kp, TCFG)
    assert got.shape == (NB, TCFG.out_caps[o], TCFG.descr_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    valid = kp.valid.numpy()
    assert all(valid[b].sum() > 5 for b in range(NB))
    assert np.all(got.numpy()[~valid] == 0)
    _frames_equal(got, lambda b: tdesc.descriptors_octave(
        _t(gauss[b]), kp.frame(b), TCFG))


def _trap_inputs(octaves):
    """Octave 0's three frames with two slots per frame, both at stack
    layer -1 (keypoint layer 0) next to a keypoint of frame b; the first
    slot invalid, the second valid (K3-desc skips invalid slots)."""
    gauss = _t(octaves[0][0])
    h, w = gauss.shape[-2:]
    rng = np.random.default_rng(5)
    n = 2
    r = _t(rng.integers(20, h - 20, (NB, n)).astype(np.int32))
    c = _t(rng.integers(20, w - 20, (NB, n)).astype(np.int32))
    kp = Keypoints(
        x=c.float(), y=r.float(),
        size=_t(rng.uniform(3.5, 6.0, (NB, n)).astype(np.float32)),
        angle=_t(rng.uniform(0, 360, (NB, n)).astype(np.float32)),
        response=torch.ones((NB, n)),
        octave=torch.zeros((NB, n), dtype=torch.int32),
        layer=torch.zeros((NB, n), dtype=torch.int32), r=r, c=c,
        valid=torch.tensor([[False, True]] * NB))
    return gauss, kp


def test_clamp_trap_reads_the_slots_own_frame(octaves):
    # frames b >= 1: a slot with stack layer -1 clamps to ITS frame's
    # first plane. Its raw histograms, angles and descriptors equal the
    # single-frame call's on frame b exactly, and the raw histograms
    # differ from those of frame b - 1's last plane, which a clamp over
    # the whole (B*L) stack would read
    gauss, kp = _trap_inputs(octaves)
    nl = TCFG.n_octave_layers
    rp, rd = TCFG.ori_patch_radius, TCFG.descr_patch_radius
    scl = kp.size * 0.5
    radius, expf = tori.orientation_params(scl, TCFG)
    po = F.pad(gauss[:, 1:1 + nl], (rp + 1,) * 4)
    prm = tdesc.descriptor_params(kp.size, kp.angle, torch.ones(1),
                                  tuple(gauss.shape[-2:]), TCFG)
    pd = F.pad(gauss[:, 1:1 + nl], (rd + 1,) * 4)
    lay = kp.layer - 1
    oargs = (lay, kp.r, kp.c, radius, expf)
    dargs = (lay, kp.r, kp.c, prm.cos_t, prm.sin_t, prm.radius, prm.ori,
             kp.valid)
    hist_o = orientation_hist(po, *oargs, TCFG)
    hist_d = descriptor_hist(pd, *dargs, TCFG)
    angles, ok = tori.orientation_peaks(gauss, kp.layer, kp.r, kp.c, scl,
                                        kp.valid, TCFG)
    desc = tdesc.descriptors_octave(gauss, kp, TCFG)
    for b in range(1, NB):
        _same(hist_o[b], orientation_hist(po[b], *(a[b] for a in oargs),
                                          TCFG))
        _same(hist_d[b], descriptor_hist(pd[b], *(a[b] for a in dargs),
                                         TCFG))
        a1, ok1 = tori.orientation_peaks(gauss[b], kp.layer[b], kp.r[b],
                                         kp.c[b], scl[b], kp.valid[b], TCFG)
        _same(angles[b], a1)
        _same(ok[b], ok1)
        _same(desc[b], tdesc.descriptors_octave(gauss[b], kp.frame(b),
                                                TCFG))
        assert desc[b, 1].any()
        # what frame b - 1's last plane gives: not what the slot reads
        prev = [a[b] for a in oargs]
        prev[0] = torch.full_like(prev[0], nl - 1)
        assert not torch.equal(hist_o[b], orientation_hist(po[b - 1], *prev,
                                                           TCFG))
        prev = [a[b] for a in dargs]
        prev[0] = torch.full_like(prev[0], nl - 1)
        assert not torch.equal(hist_d[b, 1], descriptor_hist(
            pd[b - 1], *prev, TCFG)[1])


def _batch_of_one(name, octaves, o=0):
    """(batched call on frame 0 as a batch of one, single-frame call)."""
    gauss, dog, cands = (a[:1] if isinstance(a, np.ndarray) else a
                         for a in octaves[o])
    cands = tuple(_t(a[:1]) for a in cands)
    gauss, dog = _t(gauss), _t(dog)
    kp = sift._octave_tail(gauss, dog, *cands, o, TCFG, TCFG.out_caps[o])
    nl = TCFG.n_octave_layers
    one = lambda x: x[0]  # noqa: E731
    if name == "refine_candidates":
        return (tuple(tref.refine_candidates(dog, *cands, TCFG)),
                tuple(tref.refine_candidates(dog[0], *map(one, cands),
                                             TCFG)))
    if name == "_octave_tail":
        single = sift._octave_tail(gauss[0], dog[0], *map(one, cands), o,
                                   TCFG, TCFG.out_caps[o])
        return (tuple(getattr(kp, f) for f in KP_FIELDS),
                tuple(getattr(single, f) for f in KP_FIELDS))
    scl = kp.size * 0.5
    if name == "orientation_peaks":
        args = (kp.layer, kp.r, kp.c, scl, kp.valid)
        return (tori.orientation_peaks(gauss, *args, TCFG),
                tori.orientation_peaks(gauss[0], *map(one, args), TCFG))
    if name == "descriptors_octave":
        return (tdesc.descriptors_octave(gauss, kp, TCFG),
                tdesc.descriptors_octave(gauss[0], kp.frame(0), TCFG))
    if name == "orientation_hist":
        rp = TCFG.ori_patch_radius
        po = F.pad(gauss[:, 1:1 + nl], (rp + 1,) * 4)
        args = (kp.layer - 1, kp.r, kp.c,
                *tori.orientation_params(scl, TCFG))
        return (orientation_hist(po, *args, TCFG),
                orientation_hist(po[0], *map(one, args), TCFG))
    rd = TCFG.descr_patch_radius
    pd = F.pad(gauss[:, 1:1 + nl], (rd + 1,) * 4)
    prm = tdesc.descriptor_params(kp.size, kp.angle, torch.ones(1),
                                  tuple(gauss.shape[-2:]), TCFG)
    args = (kp.layer - 1, kp.r, kp.c, prm.cos_t, prm.sin_t, prm.radius,
            prm.ori, kp.valid)
    return (descriptor_hist(pd, *args, TCFG),
            descriptor_hist(pd[0], *map(one, args), TCFG))


@pytest.mark.parametrize("name", ["refine_candidates", "orientation_peaks",
                                  "_octave_tail", "descriptors_octave",
                                  "orientation_hist", "descriptor_hist"])
def test_batch_of_one_equals_single_frame(octaves, name):
    # B = 1: frame 0 of the batched call is the single-frame call, bit
    # for bit
    batched, single = _batch_of_one(name, octaves)
    if not isinstance(single, tuple):
        batched, single = (batched,), (single,)
    assert len(batched) == len(single)
    for g, w in zip(batched, single):
        assert g.shape[0] == 1
        _same(g[0], w)
