"""The on-device resize, ops.image.resize_bilinear_u8, against
sift_tpu.ops.image.resize_bilinear_u8 (jax.image.resize, linear, which
antialiases when it shrinks): enlarging, shrinking, both at once, three
channels and the identity; within 1 gray level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import image as jimage

from sift_tpu_torch.ops import image as timage

from _torch_threads import one_thread  # noqa: F401


def _texture(shape, seed):
    """Noise over a smooth field: flat stretches and sharp steps."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    if len(shape) == 3:
        base = base[..., None] + rng.uniform(-20, 20, shape[2])
    img = base + rng.normal(0, 25, shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape,out_hw", [
    ((60, 80), (150, 170)),          # enlarge
    ((120, 160), (47, 61)),          # shrink (antialiased)
    ((64, 64), (32, 32)),            # shrink by exactly 2
    ((90, 70), (45, 140)),           # shrink rows, enlarge columns
    ((96, 128, 3), (40, 50)),        # three channels, shrink
    ((96, 128, 3), (200, 333)),      # three channels, enlarge
    ((57, 83), (57, 83)),            # identity
])
def test_resize_bilinear_u8_matches_jax(shape, out_hw):
    img = _texture(shape, seed=sum(shape))
    want = np.asarray(jimage.resize_bilinear_u8(jnp.asarray(img), *out_hw))
    got = timage.resize_bilinear_u8(torch.from_numpy(img), *out_hw)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == out_hw + shape[2:]
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    if out_hw == shape[:2]:
        np.testing.assert_array_equal(got.numpy(), img)


def test_resize_shrink_antialiases():
    # a one-pixel checkerboard shrunk 4x is flat gray with the antialias
    # filter; point sampling would keep it black and white
    img = (np.indices((64, 64)).sum(axis=0) % 2 * 255).astype(np.uint8)
    got = timage.resize_bilinear_u8(torch.from_numpy(img), 16, 16).numpy()
    want = np.asarray(jimage.resize_bilinear_u8(jnp.asarray(img), 16, 16))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got[2:-2, 2:-2].astype(int) - 128).max() <= 2
