"""The match count of `correct` on hand-made keypoints: a match that
only one side makes counts, unless the reference's ratio test of its
query lies within what the program's descriptor gaps can shift."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.reference import compare

RATIO = 0.86


def keypoints(n):
    z = torch.zeros(n)
    return SimpleNamespace(x=torch.arange(n, dtype=torch.float32), y=z,
                           angle=z, octave=z.long(), layer=z.long(),
                           r=z.long(), c=torch.arange(n),
                           valid=torch.ones(n, dtype=torch.bool))


def pair_one_query(moved_best: float, prog_good: bool):
    """One query and three train keypoints; the reference's ratio test
    passes by 0.0074 (d1 0.5, d2 0.59). The program's best train
    descriptor is moved by `moved_best` (L1) and its match kept or not."""
    q = torch.tensor([[1.0, 0.0, 0.0]])
    t = torch.tensor([[0.5, 0.0, 0.0], [1.0, 0.59, 0.0], [0.0, 0.0, 2.0]])
    t_prog = t.clone()
    t_prog[0, 2] += moved_best
    _, _, q_pair = compare.frame_gap(keypoints(1), q, keypoints(1), q,
                                     None, None)
    _, _, t_pair = compare.frame_gap(keypoints(3), t_prog, keypoints(3), t,
                                     None, None)
    ref = (torch.tensor([True]), torch.tensor([0]), torch.tensor([0.5]))
    prog = (torch.tensor([prog_good]), torch.tensor([0]),
            torch.tensor([0.5 + moved_best]))
    return compare.match_gap(prog, ref, q, q_pair, t_pair, ratio=RATIO,
                             ref_train_desc=t)


@pytest.mark.parametrize("moved, good, one_sided, undecided", [
    (0.0, True, 0, 0),      # the same match
    (0.01, False, 0, 1),    # a gap of 0.01 can undo a margin of 0.0074
    (0.0, False, 1, 0),     # left out with no gap to explain it
    (0.005, False, 1, 0),   # the gap is too small to explain it
])
def test_one_sided_unless_undecided(moved, good, one_sided, undecided):
    _, counts = pair_one_query(moved, good)
    assert counts["one_sided"] == one_sided
    assert len(counts["undecided"]) == undecided
    if undecided:
        _, margin, shift = counts["undecided"][0]
        assert margin == pytest.approx(0.0074, abs=1e-6)
        assert shift == pytest.approx(0.01, abs=1e-6)


def test_listed_queries_excuse_their_inliers():
    """The inlier comparison takes the match comparison's undecided
    queries, and only those."""
    _, _, q_pair = compare.frame_gap(keypoints(2), torch.eye(2),
                                     keypoints(2), torch.eye(2), None, None)
    sel = (torch.tensor([True, True]), torch.tensor([0, 1]),
           torch.tensor([0.0, 0.0]))
    half = (torch.tensor([False, False]), torch.tensor([0, 1]),
            torch.tensor([0.0, 0.0]))
    _, counts = compare.match_gap(half, sel, torch.eye(2), q_pair, q_pair,
                                  undecided=[1])
    assert counts["one_sided"] == 1 and counts["undecided"] == [[1]]
