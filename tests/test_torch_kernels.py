"""Each kernel's plain PyTorch version against the JAX Pallas kernel it
replaces, the Pallas side in interpret mode on the CPU (as the JAX
package's own tests run it, tests/conftest.py). The CUDA kernels are
held against these same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sift_tpu.config import DEFAULT_CONFIG as JCFG
from sift_tpu.ops.conv_pallas import gaussian_blur_multi_pallas
from sift_tpu.ops.extrema_pallas import extrema_scores_pallas
from sift_tpu.ops.ori_gather_pallas import gather_patches as jax_gather
from sift_tpu.ops.match_pallas import knn2_l1_pallas

from sift_tpu_torch.config import DEFAULT_CONFIG as TCFG
from sift_tpu_torch.ops.conv import stack_kernels, zero_last_row_col
from sift_tpu_torch.ops.conv_cuda import (blur_vh, blur_vh_batch,
                                          blur_vh_batch_plain, blur_vh_plain)
from sift_tpu_torch.ops.extrema_cuda import (extrema_scores,
                                             extrema_scores_batch,
                                             extrema_scores_batch_plain,
                                             extrema_scores_plain)
from sift_tpu_torch.ops.ori_gather_cuda import (gather_patches,
                                                gather_patches_plain)
from sift_tpu_torch.ops.descr_hist_cuda import (descriptor_hist,
                                                descriptor_hist_plain)
from sift_tpu_torch.ops.ori_hist_cuda import (orientation_hist,
                                              orientation_hist_plain)
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops.match import mask_train
from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda, knn2_l1_plain


@pytest.mark.parametrize("which,shape", [("base", (64, 64)),
                                         ("octave", (96, 120))])
def test_k1_blur_plain_matches_pallas(which, shape):
    # rtol 1e-5 / atol 1e-3 on 0..255 values: the bound
    # tests/test_conv_pallas.py holds the Pallas kernel to; both sum the
    # same taps in the same order, so the gap is float32 rounding only
    rng = np.random.default_rng(11)
    img = (rng.random(shape) * 255).astype(np.float32)
    sig = ((TCFG.init_blur_sigma,) if which == "base"
           else TCFG.scale_sigmas()[1:])
    want = np.asarray(gaussian_blur_multi_pallas(jnp.asarray(img), sig))
    kmat, _ = stack_kernels(sig)
    got = blur_vh_plain(zero_last_row_col(torch.from_numpy(img)), kmat)
    assert got.shape == (len(sig),) + shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def _planted_dog(rng, d=4, h=48, w=64):
    dog = (rng.standard_normal((d, h, w)) * 12).astype(np.float32)
    dog[0:3, 10:13, 10:13] = 30.0      # positive 3x3x3 plateau
    dog[1:4, 20:23, 30:33] = -25.0     # negative plateau on layer 2
    dog[1, 2, 2] = 99.0                # strong peak inside the border band
    dog[2, 30, 40] = 8.0               # exactly at the threshold
    dog[1, 24, 50] = 50.0              # peak with a tied neighbour
    dog[2, 24, 50] = 50.0
    return dog


def test_k2_extrema_plain_matches_pallas_exactly():
    # exact: the kernel and its plain version only compare values
    dog = _planted_dog(np.random.default_rng(5))
    want = np.asarray(extrema_scores_pallas(jnp.asarray(dog), JCFG))
    got = extrema_scores_plain(torch.from_numpy(dog), TCFG).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 10


@pytest.mark.parametrize("patch,n", [(39, 37), (85, 64)])
def test_k3_gather_plain_matches_pallas_exactly(patch, n):
    # exact: a gather is a copy; starts out of range are clamped as
    # lax.dynamic_slice clamps them
    rng = np.random.default_rng(patch + n)
    h, w = 40, 56
    hp, wp = h + patch - 1 + 2, w + patch - 1 + 2
    padded = rng.standard_normal((2, hp, wp)).astype(np.float32)
    layer = rng.integers(-1, 3, n).astype(np.int32)
    r = rng.integers(-5, h + patch, n).astype(np.int32)
    c = rng.integers(-5, w + patch, n).astype(np.int32)
    r[:3] = (-7, hp - patch + 4, 0)
    c[:3] = (wp, -1, wp - patch)
    want = np.asarray(jax_gather(jnp.asarray(padded), jnp.asarray(layer),
                                 jnp.asarray(r), jnp.asarray(c), patch))
    got = gather_patches_plain(torch.from_numpy(padded),
                               torch.from_numpy(layer), torch.from_numpy(r),
                               torch.from_numpy(c), patch).numpy()
    np.testing.assert_array_equal(got, want)


def test_k4_knn2_plain_matches_pallas():
    # idx exact (the lowest train index wins ties in both); d1/d2 rtol
    # 1e-6, float32 rounding of 128-term sums
    rng = np.random.default_rng(9)
    n, m = 150, 200
    q = (rng.random((n, 128)) * 0.3).astype(np.float32)
    t = (rng.random((m, 128)) * 0.3).astype(np.float32)
    t[17] = t[5]                       # duplicate rows: tie on d1
    t[120] = t[40]
    q[3] = t[5]                        # exact hit on a duplicated row
    q[4] = t[40] + 0.01
    valid = np.ones(m, bool)
    valid[[7, 33, 150, 199]] = False   # sentinel rows
    q[6] = t[33]                       # best real row is masked out
    want = knn2_l1_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(valid))
    tm = mask_train(torch.from_numpy(t), torch.from_numpy(valid))
    idx, d1, d2 = knn2_l1_plain(torch.from_numpy(q), tm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(d1.numpy(), np.asarray(want.d1), rtol=1e-6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(want.d2), rtol=1e-6)
    assert idx[3] == 5 and d1[3] == 0 and d2[3] == 0
    assert idx[6] != 33


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    img = torch.from_numpy((rng.random((40, 48)) * 255).astype(np.float32))
    kmat, _ = stack_kernels(TCFG.scale_sigmas()[1:])
    dog = torch.from_numpy(_planted_dog(rng))
    q = torch.from_numpy(rng.random((20, 128)).astype(np.float32))
    before = (blur_vh.launches, extrema_scores.launches,
              gather_patches.launches, knn2_l1_cuda.launches)
    assert torch.equal(blur_vh(img, kmat), blur_vh_plain(img, kmat))
    assert torch.equal(extrema_scores(dog, TCFG),
                       extrema_scores_plain(dog, TCFG))
    lrc = [torch.tensor([0, 1, 1], dtype=torch.int32)] * 3
    assert torch.equal(gather_patches(img[None], *lrc, 9),
                       gather_patches_plain(img[None], *lrc, 9))
    for a, b in zip(knn2_l1_cuda(q, q), knn2_l1_plain(q, q)):
        assert torch.equal(a, b)
    # CPU runs never count as kernel launches
    assert before == (blur_vh.launches, extrema_scores.launches,
                      gather_patches.launches, knn2_l1_cuda.launches)


def test_wrappers_raise_on_other_devices():
    kmat, _ = stack_kernels((1.6,))
    meta = torch.empty((16, 16), device="meta")
    lrc = [torch.zeros(2, dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError, match="unsupported device"):
        blur_vh(meta, kmat)
    with pytest.raises(ValueError, match="unsupported device"):
        extrema_scores(torch.empty((4, 16, 16), device="meta"), TCFG)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_patches(meta[None], *lrc, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        knn2_l1_cuda(torch.empty((2, 128), device="meta"),
                     torch.empty((3, 128), device="meta"))


def _batch_args(rng, device="cpu"):
    """Arguments of the two batch wrappers: 3 frames, S = 4 taps, and the
    planted DoG stacks of 2 frames."""
    kmat, _ = stack_kernels(TCFG.scale_sigmas()[1:])
    imgs = torch.from_numpy((rng.random((3, 40, 48)) * 255).astype(np.float32))
    dogs = torch.from_numpy(np.stack([_planted_dog(rng), _planted_dog(rng)]))
    return {"blur_vh_batch": (imgs.to(device), kmat),
            "extrema_scores_batch": (dogs.to(device), TCFG)}


BATCH_WRAPPERS = {
    "blur_vh_batch": (blur_vh_batch, blur_vh_batch_plain, blur_vh),
    "extrema_scores_batch": (extrema_scores_batch, extrema_scores_batch_plain,
                             extrema_scores),
}


@pytest.mark.parametrize("name", sorted(BATCH_WRAPPERS))
def test_batch_wrappers_take_plain_version_on_cpu(name):
    wrapper, plain, single = BATCH_WRAPPERS[name]
    x, arg = _batch_args(np.random.default_rng(4))[name]
    before = (wrapper.launches, single.launches)
    got = wrapper(x, arg)
    assert torch.equal(got, plain(x, arg))
    for b in range(x.shape[0]):        # frame b is the single-frame call
        assert torch.equal(got[b], single(x[b], arg))
    # CPU runs never count as kernel launches
    assert before == (wrapper.launches, single.launches)


@pytest.mark.parametrize("name", sorted(BATCH_WRAPPERS))
def test_batch_wrappers_raise_on_other_devices(name):
    wrapper = BATCH_WRAPPERS[name][0]
    x, arg = _batch_args(np.random.default_rng(4), device="meta")[name]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(x, arg)
    # a single frame is not a batch
    with pytest.raises(ValueError, match="must be"):
        wrapper(torch.empty(x.shape[1:]), arg)


def _fused_hist_args(rng, device="cpu"):
    """Arguments of the two fused-histogram wrappers: a 2-layer stack
    padded for each, 6 keypoints (two with starts outside the image), and
    their per-keypoint parameters."""
    h, w = 40, 48
    img = torch.from_numpy((rng.random((2, h, w)) * 255).astype(np.float32))
    layer = torch.tensor([0, 1, 1, 0, -1, 2], dtype=torch.int32)
    r = torch.tensor([20, 10, 30, 25, -4, h + 3], dtype=torch.int32)
    c = torch.tensor([24, 30, 12, 40, w + 2, -6], dtype=torch.int32)
    scl = torch.from_numpy(rng.uniform(1.6, 2.5, 6).astype(np.float32))
    angle = torch.from_numpy(rng.uniform(0, 360, 6).astype(np.float32))
    valid = torch.tensor([True, True, False, True, True, True])
    rp, rd = TCFG.ori_patch_radius, TCFG.descr_patch_radius
    radius, expf = tori.orientation_params(scl, TCFG)
    prm = tdesc.descriptor_params(2 * scl, angle, torch.ones(1), (h, w), TCFG)
    ori = (torch.nn.functional.pad(img, (rp + 1,) * 4), layer, r, c, radius,
           expf, TCFG)
    desc = (torch.nn.functional.pad(img, (rd + 1,) * 4), layer, r, c,
            prm.cos_t, prm.sin_t, prm.radius, prm.ori, valid, TCFG)
    return {name: tuple(a.to(device) if torch.is_tensor(a) else a
                        for a in args)
            for name, args in (("orientation_hist", ori),
                               ("descriptor_hist", desc))}


FUSED_HIST_WRAPPERS = {
    "orientation_hist": (orientation_hist, orientation_hist_plain),
    "descriptor_hist": (descriptor_hist, descriptor_hist_plain),
}


@pytest.mark.parametrize("name", sorted(FUSED_HIST_WRAPPERS))
def test_fused_hist_wrappers_take_plain_version_on_cpu(name):
    wrapper, plain = FUSED_HIST_WRAPPERS[name]
    args = _fused_hist_args(np.random.default_rng(6))[name]
    before = wrapper.launches
    got = wrapper(*args)
    assert torch.equal(got, plain(*args))
    assert got.any()
    # CPU runs never count as kernel launches
    assert before == wrapper.launches


@pytest.mark.parametrize("name", sorted(FUSED_HIST_WRAPPERS))
def test_fused_hist_wrappers_raise_on_other_devices(name):
    wrapper = FUSED_HIST_WRAPPERS[name][0]
    args = _fused_hist_args(np.random.default_rng(6), device="meta")[name]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*args)
    # a stack not padded for the windows is refused on any device
    cpu = _fused_hist_args(np.random.default_rng(6))[name]
    with pytest.raises(ValueError, match="not padded"):
        wrapper(cpu[0][:, :20, :20], *cpu[1:])
