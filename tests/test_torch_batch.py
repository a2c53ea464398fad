"""The throughput path, port against sift_tpu: K1-batch and K2-batch
plain versions against the Pallas kernels in interpret mode, the batched
pyramid and candidate scan against the JAX stages, and
detect_and_compute_batch against the JAX package's and against the
port's own single-frame path.

The JAX side runs once per module with the reduced configuration of
tests/test_torch_pipeline.py (exact f32 descriptors, dynamic_slice
gathers, smaller caps) on the frames of tests/test_batch.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import sift as jsift
from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import extrema as jext
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops.conv_pallas import gaussian_blur_multi_batch_pallas
from sift_tpu.ops.extrema_pallas import extrema_scores_batch_pallas

from sift_tpu_torch import sift
from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.ops import extrema as text
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.ops.conv import stack_kernels, zero_last_row_col
from sift_tpu_torch.ops.conv_cuda import blur_vh_batch_plain, blur_vh_plain
from sift_tpu_torch.ops.extrema_cuda import (extrema_scores_batch_plain,
                                             extrema_scores_plain)

from _torch_threads import one_thread  # noqa: F401

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
FIELDS = ("x", "y", "size", "angle", "response", "octave", "layer", "r",
          "c", "valid")


def _frames(n=3, h=96, w=128, seed=7):
    """The recipe of tests/test_batch.py:_frames: a uniform-noise frame
    and shifted, dimmed, re-noised copies of it."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    frames = [base]
    for i in range(1, n):
        f = np.roll(base, 11 * i, axis=1) * 0.9 + rng.uniform(
            0, 25, (h, w)).astype(np.float32)
        frames.append(np.clip(f, 0, 255).astype(np.float32))
    return np.stack(frames)


@pytest.mark.parametrize("which,shape", [("base", (3, 40, 104)),
                                         ("octave", (2, 72, 136))])
def test_k1_batch_plain_matches_pallas(which, shape):
    # rtol 1e-5 / atol 1e-3 on 0..255 values, the K1 bound of
    # tests/test_torch_kernels.py; and each frame equals the single-frame
    # plain K1 exactly (the same elementwise arithmetic)
    rng = np.random.default_rng(13)
    imgs = (rng.random(shape) * 255).astype(np.float32)
    sig = ((TCFG.init_blur_sigma,) if which == "base"
           else TCFG.scale_sigmas()[1:])
    want = np.asarray(gaussian_blur_multi_batch_pallas(jnp.asarray(imgs),
                                                       sig))
    kmat, _ = stack_kernels(sig)
    x = zero_last_row_col(torch.from_numpy(imgs))
    got = blur_vh_batch_plain(x, kmat)
    assert got.shape == (shape[0], len(sig)) + shape[1:]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    for b in range(shape[0]):
        assert torch.equal(got[b], blur_vh_plain(x[b], kmat))


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def jax_pyramid(frames):
    octs = jpyr.build_gaussian_pyramid_batch(jnp.asarray(frames), JCFG)
    return octs, jpyr.build_dog_pyramid_batch(octs)


@pytest.fixture(scope="module")
def textured_dogs(small_image):
    """JAX batch DoG pyramid of three textured frames (the shared
    small_image rolled by 17 columns a frame, bench.py's step), which
    have candidates in every frame of octaves 0 and 1."""
    imgs = np.stack([np.roll(small_image, 17 * i, axis=1) for i in range(3)])
    octs = jpyr.build_gaussian_pyramid_batch(jnp.asarray(imgs), JCFG)
    return [np.array(d) for d in jpyr.build_dog_pyramid_batch(octs)]


def test_k2_batch_plain_matches_pallas_exactly(textured_dogs):
    # exact: the kernel and its plain version only compare values; the
    # DoG of a real batch pyramid has candidates in every frame
    dog = textured_dogs[0][:2, :, :40, :136]
    want = np.asarray(extrema_scores_batch_pallas(jnp.asarray(dog), JCFG))
    got = extrema_scores_batch_plain(torch.from_numpy(dog), TCFG)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(dog.shape[0]):
        assert (want[b] > 0).sum() > 0
        assert torch.equal(got[b],
                           extrema_scores_plain(torch.from_numpy(dog[b]),
                                                TCFG))


def test_pyramid_batch(frames, jax_pyramid):
    # atol 1e-3 on 0..255 values: the blur's bound (test_torch_stages.py)
    octs, dogs = jax_pyramid
    t_octs = tpyr.build_gaussian_pyramid_batch(torch.from_numpy(frames), TCFG)
    t_dogs = tpyr.build_dog_pyramid_batch(t_octs)
    assert len(t_octs) == len(octs) == TCFG.n_octaves
    for a, b in zip(t_octs + t_dogs, octs + dogs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)
    # the batch decimation equals the single-frame pyramid, frame by frame
    for b in range(frames.shape[0]):
        single = tpyr.build_gaussian_pyramid(torch.from_numpy(frames[b]),
                                             TCFG)
        for o in range(TCFG.n_octaves):
            assert torch.equal(t_octs[o][b], single[o])


@pytest.mark.parametrize("o", [0, 1])
def test_top_candidates_batch(textured_dogs, o):
    # per frame, the candidate SET equals JAX's below the cap (JAX's
    # windowed top-k orders the slots differently, ROADMAP Queue 3), and
    # each row equals the single-frame top_candidates
    dog = textured_dogs[o]
    cap = JCFG.detect_caps[o]
    jl, jr, jc, jv = (np.asarray(a) for a in
                      jext.top_candidates_batch(jnp.asarray(dog), cap, JCFG))
    tdog = torch.from_numpy(dog)
    t = text.top_candidates_batch(tdog, cap, TCFG)
    tl, tr, tc, tv = (a.numpy() for a in t)
    assert tl.shape == (dog.shape[0], cap)
    for b in range(dog.shape[0]):
        assert 0 < tv[b].sum() < cap
        assert (set(zip(jl[b][jv[b]], jr[b][jv[b]], jc[b][jv[b]]))
                == set(zip(tl[b][tv[b]], tr[b][tv[b]], tc[b][tv[b]])))
        for got, want in zip(t, text.top_candidates(tdog[b], cap, TCFG)):
            assert torch.equal(got[b], want)


@pytest.fixture(scope="module")
def batch_results(frames):
    jkp, jd = jsift.detect_and_compute_batch(jnp.asarray(frames), JCFG)
    tkp, td = sift.detect_and_compute_batch(torch.from_numpy(frames), TCFG)
    return (jkp, np.asarray(jd)), (tkp, td.numpy())


def _frame_kps(kp, b):
    a = {f: np.asarray(getattr(kp, f))[b] for f in FIELDS}
    return {f: v[a["valid"]] for f, v in a.items()}, a["valid"]


@pytest.mark.parametrize("b", [0, 1, 2])
def test_batch_keypoints_agree_with_jax(batch_results, b):
    # per frame: >= 99 % of JAX's keypoints have a port keypoint at the
    # same (octave, layer, r, c) with x/y within 1e-3 px; counts within 1 %
    (jkp, _), (tkp, _) = batch_results
    jk, _ = _frame_kps(jkp, b)
    tk, _ = _frame_kps(tkp, b)
    n_j, n_t = len(jk["x"]), len(tk["x"])
    assert n_j > 5
    assert abs(n_t - n_j) <= 0.01 * n_j
    port = {}
    for i in range(n_t):
        key = (tk["octave"][i], tk["layer"][i], tk["r"][i], tk["c"][i])
        port.setdefault(key, []).append((tk["x"][i], tk["y"][i]))
    hit = sum(any(abs(x - jk["x"][i]) < 1e-3 and abs(y - jk["y"][i]) < 1e-3
                  for x, y in port.get((jk["octave"][i], jk["layer"][i],
                                        jk["r"][i], jk["c"][i]), ()))
              for i in range(n_j))
    assert hit >= 0.99 * n_j


def test_batch_descriptors_agree_with_jax(batch_results):
    # keypoints paired by identity ((octave, layer, r, c) and angle within
    # 1e-2 deg): descriptors within atol 1e-3, JAX's own batch-vs-single
    # bound (tests/test_batch.py)
    (jkp, jd), (tkp, td) = batch_results
    pairs = 0
    for b in range(jd.shape[0]):
        jk, jv = _frame_kps(jkp, b)
        tk, tv = _frame_kps(tkp, b)
        jdesc, tdesc = jd[b][jv], td[b][tv]
        for i in range(len(jk["x"])):
            for j in range(len(tk["x"])):
                da = abs(jk["angle"][i] - tk["angle"][j]) % 360.0
                if (all(jk[f][i] == tk[f][j]
                        for f in ("octave", "layer", "r", "c"))
                        and min(da, 360.0 - da) < 1e-2):
                    np.testing.assert_allclose(tdesc[j], jdesc[i], atol=1e-3)
                    pairs += 1
                    break
    assert pairs >= 0.99 * sum(int(np.asarray(jkp.valid)[b].sum())
                               for b in range(jd.shape[0]))


def test_batch_rows_equal_single_frame(frames, batch_results):
    # each row of the batch is detect_and_compute on that frame, exactly:
    # the pyramid, the scan and the tail are the same arithmetic batched
    # (the plain K3-ori and K3-desc bin one frame at a time)
    _, (tkp, td) = batch_results
    assert tkp.capacity == sum(TCFG.out_caps)
    assert tuple(tkp.x.shape) == (frames.shape[0], tkp.capacity)
    for b in range(frames.shape[0]):
        kp, d = sift.detect_and_compute(torch.from_numpy(frames[b]), TCFG)
        kb = tkp.frame(b)
        for f in FIELDS:
            assert torch.equal(getattr(kb, f), getattr(kp, f)), f
        np.testing.assert_array_equal(td[b], d.numpy())
        assert int(kb.count()) == int(kp.count()) > 0
        assert torch.equal(sift.octave_saturation(kb, TCFG),
                           sift.octave_saturation(kp, TCFG))


def test_batch_of_one_equals_single(frames):
    kp_b, d_b = sift.detect_and_compute_batch(
        torch.from_numpy(frames[:1]), TCFG)
    kp, d = sift.detect_and_compute(torch.from_numpy(frames[0]), TCFG)
    for f in FIELDS:
        assert torch.equal(getattr(kp_b, f)[0], getattr(kp, f)), f
    assert torch.equal(d_b[0], d)
