"""The input recipes are deterministic from the seed, and the seeds the
driver uses (over 32 bits) are taken."""

import numpy as np

from benchmark.inputs import recipes

BIG = 2 ** 33 + 12345


def test_object_scene_repeats_and_varies():
    a = recipes.object_scene((120, 200), (40, 56), BIG)
    b = recipes.object_scene((120, 200), (40, 56), BIG)
    c = recipes.object_scene((120, 200), (40, 56), BIG + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    scene, obj, h, corners = a
    assert scene.dtype == obj.dtype == np.float32
    assert scene.min() >= 0 and scene.max() <= 255
    assert np.allclose(corners, recipes.project(
        np.array([[0, 0], [56, 0], [56, 40], [0, 40]], float), h))
    # the object lies inside the scene
    assert (corners >= 0).all() and (corners[:, 0] < 200).all() \
        and (corners[:, 1] < 120).all()


def test_pan_frames_repeat_and_pan():
    a = recipes.pan_frames((64, 96), (24, 32), 6, 17, BIG)
    b = recipes.pan_frames((64, 96), (24, 32), 6, 17, BIG)
    assert a.shape == (6, 64, 96) and np.array_equal(a, b)
    # frame i + 1 is frame i moved 17 columns to the left
    assert np.array_equal(a[1][:, :96 - 17], a[0][:, 17:])
    assert not np.array_equal(a, recipes.pan_frames((64, 96), (24, 32), 6,
                                                    17, BIG + 1))
