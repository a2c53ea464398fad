"""The port's configuration and blur taps against sift_tpu's.

SIFT has no learned weights: the state that must carry across is the
configuration and the Gaussian taps, so both are held equal exactly.
"""

import dataclasses

import numpy as np
import pytest

from sift_tpu.config import SIFTConfig as JaxConfig, DEFAULT_CONFIG as JCFG
from sift_tpu.ops.conv import _stack_kernels as jax_stack_kernels

from sift_tpu_torch.config import (SIFTConfig, DEFAULT_CONFIG as TCFG,
                                   from_jax_config)
from sift_tpu_torch.ops.conv import stack_kernels

# implementation-choice fields the port does not carry (one formulation
# per stage; descriptors always exact f32)
_DROPPED = {"ori_hist_impl", "ori_gather_impl", "descr_gather_impl",
            "descr_layout", "frames_per_chip_mode", "descr_rc_bf16"}


def test_constants_equal_jax_defaults():
    jd = dataclasses.asdict(JCFG)
    td = dataclasses.asdict(TCFG)
    assert set(jd) - set(td) == _DROPPED
    assert set(td) <= set(jd)
    for k, v in td.items():
        assert v == jd[k], k


@pytest.mark.parametrize("prop", ["n_scales", "n_dog", "descr_size",
                                  "init_blur_sigma", "max_scl_octv",
                                  "ori_patch_radius", "descr_patch_radius"])
def test_derived_properties_equal(prop):
    assert getattr(TCFG, prop) == getattr(JCFG, prop)


def test_scale_sigmas_and_patch_radii():
    assert TCFG.scale_sigmas() == JCFG.scale_sigmas()
    assert TCFG.ori_patch_radius == 18
    assert TCFG.descr_patch_radius == 41


@pytest.mark.parametrize("which", ["base", "octave"])
def test_taps_bit_identical(which):
    sig = ((TCFG.init_blur_sigma,) if which == "base"
           else TCFG.scale_sigmas()[1:])
    km, w = stack_kernels(sig)
    jkm, jw = jax_stack_kernels(list(sig))
    assert w == jw
    assert km.dtype == jkm.dtype == np.float32
    np.testing.assert_array_equal(km, jkm)


def test_from_jax_config_round_trips():
    jcfg = JaxConfig(descr_rc_bf16=False, detect_caps=(512, 256, 128, 64, 32),
                     out_caps=(256, 128, 64, 64, 64), match_ratio=0.8)
    tcfg = from_jax_config(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, SIFTConfig)
    back = JaxConfig(**dataclasses.asdict(tcfg), descr_rc_bf16=False,
                     ori_hist_impl=jcfg.ori_hist_impl,
                     ori_gather_impl=jcfg.ori_gather_impl,
                     descr_gather_impl=jcfg.descr_gather_impl,
                     descr_layout=jcfg.descr_layout,
                     frames_per_chip_mode=jcfg.frames_per_chip_mode)
    assert back == jcfg
    assert from_jax_config(dataclasses.asdict(
        JaxConfig(descr_rc_bf16=False))) == TCFG


def test_from_jax_config_rejects_bf16():
    with pytest.raises(ValueError, match="descr_rc_bf16"):
        from_jax_config(dataclasses.asdict(JCFG))
