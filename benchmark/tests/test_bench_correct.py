"""`correct` against the reference, at a small size on the CPU: the
program as it ships passes; its lower-precision descriptor arm (the
control) and each fault a cell can have fail.

The faults (benchmark/faults.py) are planted in the program's timed
path: a request that returns the previous request's answer (state left
unchanged), half of a batch's frames left out, an answer altered where
it is produced (one frame's descriptors, or the scene's), one keypoint
of each frame or one match of each pair left out, and the homography
taken without its refit on the inliers. No cell spans chips, so none
can lose an exchange between them."""

import pytest

from benchmark import run
from benchmark.faults import FAULTS, planted
from benchmark.tests.small import OVERRIDES, SECONDS

SEED = 2 ** 33 + 77


def run_small(cell, **extra):
    over = {**OVERRIDES[cell], **extra}
    return run.run_cell(cell, SEED, SECONDS, False, device="cpu",
                        overrides=over)


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_sound_program_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], (out["checked"], out["_notes"][:3])
    assert out["attempted"] >= 2 and out["failed"] == 0


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_control_is_not_correct(cell):
    """The program with descr_rc_bf16 on, the nearest precision below the
    configuration's float32."""
    out = run_small(cell, program_sift={"descr_rc_bf16": True})
    assert not out["correct"], out["checked"]
    assert out["checked"]["feat_gap"]["value"] > \
        out["checked"]["feat_gap"]["limit"]


CASES = [(cell, name) for name, (cells, *_) in sorted(FAULTS.items())
         for cell in cells]


@pytest.mark.parametrize("cell, fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault):
    with planted(fault):
        out = run_small(cell)
    assert not out["correct"], out["checked"]
    assert out["attempted"] >= 2 and out["failed"] == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_control_fails_at_the_cells_size(card, cell):
    """The control at the cell's own size, three seeds: each not correct
    (the readings behind the limits are in PERF.md)."""
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
        out = run.run_cell(cell, seed, 5.0, False, overrides={
            "program_sift": {"descr_rc_bf16": True}})
        assert not out["correct"], (seed, out["checked"])
