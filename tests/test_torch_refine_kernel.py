"""The refine kernel (sift_tpu_torch/csrc/refine.cu) on the CPU: a NumPy
float32 twin of its per-slot loop, in the .cu file's order of operations
with every constant cast to float32, held bit for bit against
`refine_candidates_plain` in every field of every slot, on the synthetic
frames (one frame's (N,) candidates and three frames' (B, N), with and
without row_bounds) and on planted cubes: an invalid slot at (1, 0, 0),
a flat (singular) cube, cubes that diverge (by size and by a NaN), one
that steps out of the border box, one that steps across a layer and one
still moving after the last step. The twin reads what the wrapper would
hand the kernel (`refine.kernel_args`), so a stack that is not
contiguous is checked as the copy the wrapper makes. Also: the wrapper
refuses a wrong dtype, shape or device, and CPU tensors take the plain
version without counting a launch.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from sift_tpu_torch.config import DEFAULT_CONFIG
from sift_tpu_torch.ops import extrema as ext
from sift_tpu_torch.ops import pyramid as pyr
from sift_tpu_torch.ops import refine as ref

from _torch_threads import one_thread  # noqa: F401

F32 = np.float32
# csrc/refine.cu's constants: each the float32 rounding of the plain
# version's Python double
IMG_SCALE = F32(1.0 / 255.0)
DERIV_SCALE = F32(1.0 / 255.0 * 0.5)
SECOND_DERIV_SCALE = F32(1.0 / 255.0)
CROSS_DERIV_SCALE = F32(1.0 / 255.0 * 0.25)
DIVERGE_LIMIT = F32(2.0 ** 31 / 3.0)
SINGULAR = F32(1e-30)
# reduced caps (tests/test_torch_batch.py's), so every octave keeps
# invalid slots and the twin's loop stays short
CFG = dataclasses.replace(DEFAULT_CONFIG, detect_caps=(512, 256, 128, 64, 32),
                          out_caps=(256, 128, 64, 64, 64))
NB = 3


def _i32(v: int) -> int:
    """v wrapped to int32, as the plain version's int32 index is."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _site(dog, b, lay, r, c, nl):
    """csrc/refine.cu site(): the plain version's flat gather index of
    (lay, r, c) in frame b -> (frame, stack layer, row, col)."""
    nb, _, h, w = dog.shape
    total = nb * nl * h * w
    idx = _i32(_i32(_i32(_i32((lay - 1) * h) + r) * w) + c) + b * nl * h * w
    if idx < 0:
        idx += total
    idx = min(max(idx, 0), total - 1)
    k, rem = divmod(idx, h * w)
    return k // nl, k % nl + 1, rem // w, rem % w


def _derivs(dog, site):
    """csrc/refine.cu derivs(): ops/refine.py:derivative_fields at one
    site, zero outside the stack."""
    f, l0, r0, c0 = site
    _, d, h, w = dog.shape

    def at(dl, dr, dc):
        l, r, c = l0 + dl, r0 + dr, c0 + dc
        if 0 <= l < d and 0 <= r < h and 0 <= c < w:
            return dog[f, l, r, c]
        return F32(0.0)

    v = at(0, 0, 0)
    xp, xm, yp, ym = at(0, 0, 1), at(0, 0, -1), at(0, 1, 0), at(0, -1, 0)
    sp, sm = at(1, 0, 0), at(-1, 0, 0)
    v2 = v * F32(2.0)
    return dict(
        d0=(xp - xm) * DERIV_SCALE, d1=(yp - ym) * DERIV_SCALE,
        d2=(sp - sm) * DERIV_SCALE,
        dxx=((xp + xm) - v2) * SECOND_DERIV_SCALE,
        dyy=((yp + ym) - v2) * SECOND_DERIV_SCALE,
        dss=((sp + sm) - v2) * SECOND_DERIV_SCALE,
        dxy=(((at(0, 1, 1) - at(0, 1, -1)) - at(0, -1, 1)) + at(0, -1, -1))
        * CROSS_DERIV_SCALE,
        dxs=(((at(1, 0, 1) - at(1, 0, -1)) - at(-1, 0, 1)) + at(-1, 0, -1))
        * CROSS_DERIV_SCALE,
        dys=(((at(1, 1, 0) - at(1, -1, 0)) - at(-1, 1, 0)) + at(-1, -1, 0))
        * CROSS_DERIV_SCALE,
        center=v)


def _dot3(a0, b0, a1, b1, a2, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def twin_slot(dog, b, lay, r, c, valid, nl, border, row_lo, row_hi, steps,
              thr, edge, edge_sq):
    """csrc/refine.cu refine_kernel for one (frame, slot): the eight
    Refined fields, and how many Newton steps ran."""
    xi = xr = xc = F32(0.0)
    alive, converged = bool(valid), False
    ran = 0
    while ran < steps and alive and not converged:
        ran += 1
        d = _derivs(dog, _site(dog, b, lay, r, c, nl))
        h00, h01, h02 = d["dxx"], d["dxy"], d["dxs"]
        h11, h12, h22 = d["dyy"], d["dys"], d["dss"]
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        det = (h00 * c00 + h01 * c01) + h02 * c02
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        inv_det = F32(1.0) / det if abs(det) > SINGULAR else F32(0.0)
        b0, b1, b2 = d["d0"], d["d1"], d["d2"]
        x0 = _dot3(c00, b0, c01, b1, c02, b2) * inv_det
        x1 = _dot3(c01, b0, c11, b1, c12, b2) * inv_det
        x2 = _dot3(c02, b0, c12, b1, c22, b2) * inv_det
        nxi, nxr, nxc = -x2, -x1, -x0
        finite = bool(np.isfinite(nxi) and np.isfinite(nxr)
                      and np.isfinite(nxc))
        conv_now = (abs(nxi) < F32(0.5) and abs(nxr) < F32(0.5)
                    and abs(nxc) < F32(0.5) and finite)
        diverged = (not finite or abs(nxi) > DIVERGE_LIMIT
                    or abs(nxr) > DIVERGE_LIMIT or abs(nxc) > DIVERGE_LIMIT)
        xi, xr, xc = nxi, nxr, nxc
        move = not conv_now and not diverged
        nlay, nr, nc = lay, r, c
        if move:   # cv_round: round half to even
            nlay += int(np.rint(nxi))
            nr += int(np.rint(nxr))
            nc += int(np.rint(nxc))
        w = dog.shape[3]
        oob = (nlay < 1 or nlay > nl or nc < border or nc >= w - border
               or nr < row_lo + border or nr >= row_hi - border)
        if diverged or (move and oob):
            alive = False
        converged = converged or conv_now
        if move and not oob:
            lay, r, c = nlay, nr, nc
    alive = alive and converged
    d = _derivs(dog, _site(dog, b, lay, r, c, nl))
    t = _dot3(d["d0"], xc, d["d1"], xr, d["d2"], xi)
    contr = d["center"] * IMG_SCALE + t * F32(0.5)
    alive = alive and abs(contr) * F32(nl) >= thr
    tr = d["dxx"] + d["dyy"]
    det = d["dxx"] * d["dyy"] - d["dxy"] * d["dxy"]
    alive = alive and det > F32(0.0) and (tr * tr) * edge < edge_sq * det
    return (lay, r, c, xi, xr, xc, contr, alive), ran


def twin(dog, layer, r, c, valid, cfg=CFG, row_bounds=None,
         with_steps=False):
    """The kernel's launch, slot by slot, on what the wrapper would hand
    it (refine.kernel_args): Refined with the candidates' shape."""
    (stack, lay_f, r_f, c_f, v_f, n, nb, _d, _h, _w, nl, border, row_lo,
     row_hi, steps, thr, edge, edge_sq) = ref.kernel_args(
        dog, layer, r, c, valid, cfg, row_bounds)
    assert stack.is_contiguous()
    stack = stack.numpy()
    lay_f, r_f, c_f, v_f = (a.numpy() for a in (lay_f, r_f, c_f, v_f))
    rows, ran = [], []
    with np.errstate(all="ignore"):
        for i in range(nb * n):
            out, k = twin_slot(stack, i // n, int(lay_f[i]), int(r_f[i]),
                               int(c_f[i]), bool(v_f[i]), nl, border, row_lo,
                               row_hi, steps, F32(thr), F32(edge),
                               F32(edge_sq))
            rows.append(out)
            ran.append(k)
    cols = list(zip(*rows))
    out = ref.Refined(*(torch.from_numpy(np.array(col, dtype=dt)).reshape(
        layer.shape) for col, dt in zip(cols, (np.int32,) * 3 + (F32,) * 4
                                         + (bool,))))
    return (out, np.array(ran).reshape(layer.shape)) if with_steps else out


def assert_bits_equal(got, want):
    """Every field of every slot equal, floats by their bits."""
    for name, g, w in zip(ref.Refined._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (name, int((g != w).sum()))


@pytest.fixture(scope="module")
def frames(small_image):
    img = torch.from_numpy(small_image)
    return torch.stack([torch.roll(img, 17 * i, dims=1) for i in range(NB)])


@pytest.fixture(scope="module")
def octaves(frames):
    """(B, D, H, W) DoG stacks of the usable octaves and their (B, cap)
    candidates."""
    dogs = pyr.build_dog_pyramid_batch(
        pyr.build_gaussian_pyramid_batch(frames, CFG))
    return [(d, ext.top_candidates_batch(d, CFG.detect_caps[o], CFG))
            for o, d in enumerate(dogs) if min(d.shape[2:]) >= 13]


@pytest.mark.parametrize("bounds", [None, "band"])
@pytest.mark.parametrize("form", ["single", "batch"])
def test_twin_matches_plain_on_frames(octaves, form, bounds):
    assert len(octaves) >= 3
    n_valid = 0
    for dog, cands in octaves:
        if form == "single":
            dog, cands = dog[1], tuple(a[1] for a in cands)
        h = dog.shape[-2]
        # a band's true image begins 9 rows in and ends past the stack
        rows = None if bounds is None else (9, h + 20)
        want = ref.refine_candidates_plain(dog, *cands, CFG, rows)
        assert_bits_equal(twin(dog, *cands, CFG, rows), want)
        n_valid += int(want.valid.sum())
    assert n_valid > 10


def quad_stack(hess, grad, center, shape=(4, 24, 40), base=0.0):
    """A (D, H, W) stack holding base + g.d + d.H.d / 2 with d = (col,
    row, layer) - center: each cube's Newton step aims at the quadric's
    stationary point."""
    d_, h, w = shape
    lay, row, col = np.meshgrid(np.arange(d_), np.arange(h), np.arange(w),
                                indexing="ij")
    d = np.stack([col - center[2], row - center[1],
                  lay - center[0]]).astype(np.float64)
    q = (base + np.einsum("i...,i->...", d, np.asarray(grad, float))
         + 0.5 * np.einsum("i...,ij,j...->...", d, np.asarray(hess, float), d))
    return torch.from_numpy(q.astype(np.float32))


def _ridge():
    """exp(col) with a peak across rows and layers: every step's fit
    points one column left, so the slot never converges."""
    lay, row, col = np.meshgrid(np.arange(4), np.arange(24), np.arange(40),
                                indexing="ij")
    q = np.exp(col / 4.0) - (row - 12.0) ** 2 - 40.0 * (lay - 1.0) ** 2
    return torch.from_numpy(q.astype(np.float32))


def _flat():
    return torch.full((4, 24, 40), 10.0)


def _with_nan():
    dog = quad_stack(-np.eye(3), [0.5, 0.2, 0.1], (1, 12, 20), base=50.0)
    dog[1, 13, 21] = float("nan")
    return dog


# (stack, (layer, r, c) of the planted slot, what the twin must see: the
# steps that ran and whether the slot survives; moved: its final (layer,
# r, c) differs from the start)
PLANTED = {
    # singular: a zero update, converged at once; the edge test rejects
    "flat": (_flat, (1, 12, 20), dict(ran=1, valid=False, moved=False)),
    # a near-singular 2x2 block in (col, row): a step of ~1.6e9 columns
    "diverges": (lambda: quad_stack(
        [[1, 1, 0], [1, 1 + 2.0 ** -14, 0], [0, 0, -1]], [1e5, 0, 0],
        (1, 12, 20)), (1, 12, 20), dict(ran=1, valid=False, moved=False)),
    # a NaN in the cube: a non-finite step
    "nan": (_with_nan, (1, 12, 20), dict(ran=1, valid=False, moved=False)),
    # the peak lies 7 columns right, past the border box
    "out_of_border": (lambda: quad_stack(-np.eye(3), [7, 0, 0], (1, 12, 30),
                                         base=80.0),
                      (1, 12, 30), dict(ran=1, valid=False, moved=False)),
    # the peak lies 0.8 layers up: one step to layer 2, then converged
    "across_layer": (lambda: quad_stack(-np.eye(3), [0.3, -0.2, 0.8],
                                        (1, 12, 20), base=80.0),
                     (1, 12, 20), dict(ran=2, valid=True, moved=True)),
    # still moving after the last step: rejected where it stopped
    "still_moving": (_ridge, (1, 12, 30), dict(ran=5, valid=False,
                                               moved=True)),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_twin_matches_plain_on_planted_cubes(name):
    make, (lay, r, c), expect = PLANTED[name]
    dog = make()
    # the planted slot, then an invalid slot at (1, 0, 0), whose cube
    # reads zeros above and left of the stack, and an invalid slot at
    # the planted site
    layer = torch.tensor([lay, 1, lay], dtype=torch.int32)
    rr = torch.tensor([r, 0, r], dtype=torch.int32)
    cc = torch.tensor([c, 0, c], dtype=torch.int32)
    valid = torch.tensor([True, False, False])
    want = ref.refine_candidates_plain(dog, layer, rr, cc, valid, CFG)
    got, ran = twin(dog, layer, rr, cc, valid, CFG, with_steps=True)
    assert_bits_equal(got, want)
    assert int(ran[0]) == expect["ran"] and list(ran[1:]) == [0, 0]
    assert bool(want.valid[0]) == expect["valid"]
    moved = (int(want.layer[0]), int(want.r[0]), int(want.c[0])) != (lay, r,
                                                                      c)
    assert moved == expect["moved"]
    assert not bool(want.valid[1:].any())
    # the same slots as frame 1 of a batch, beside the synthetic frame 0
    both = torch.stack([torch.zeros_like(dog), dog])
    cands = [torch.stack([a, a]) for a in (layer, rr, cc)]
    bvalid = torch.stack([torch.zeros_like(valid), valid])
    want_b = ref.refine_candidates_plain(both, *cands, bvalid, CFG)
    assert_bits_equal(twin(both, *cands, bvalid, CFG), want_b)
    assert_bits_equal(tuple(a[1] for a in want_b), want)


def test_noncontiguous_band_is_copied(octaves):
    # a row band viewed out of a larger stack (parallel/spatial.py's
    # bands are such views before the wrapper copies them)
    dog, cands = octaves[0]
    band = dog[0, :, 20:-20, :]
    assert not band.is_contiguous()
    keep = (cands[1][0] >= 25) & (cands[1][0] < band.shape[1] + 15)
    lay, r, c = (a[0][keep][:200] for a in cands[:3])
    r = r - 20
    valid = torch.ones_like(lay, dtype=torch.bool)
    rows = (-20, band.shape[1] + 20)
    want = ref.refine_candidates_plain(band, lay, r, c, valid, CFG, rows)
    assert_bits_equal(twin(band, lay, r, c, valid, CFG, rows), want)
    assert int(want.valid.sum()) > 0


def _args():
    dog = torch.zeros((4, 20, 24))
    idx = torch.full((3,), 6, dtype=torch.int32)
    return [dog, idx, idx.clone(), idx.clone(),
            torch.ones(3, dtype=torch.bool)]


@pytest.mark.parametrize("fault", [
    "dog_float64", "dog_2d", "too_few_layers", "layer_int64", "valid_uint8",
    "batch_candidates_for_one_frame", "frames_differ", "shapes_differ",
    "meta_device", "candidates_on_other_device"])
def test_wrapper_refuses(fault):
    args = _args()
    if fault == "dog_float64":
        args[0] = args[0].double()
    elif fault == "dog_2d":
        args[0] = args[0][0]
    elif fault == "too_few_layers":
        args[0] = args[0][:3]
    elif fault == "layer_int64":
        args[1] = args[1].long()
    elif fault == "valid_uint8":
        args[4] = args[4].to(torch.uint8)
    elif fault == "batch_candidates_for_one_frame":
        args[1:] = [a[None] for a in args[1:]]
    elif fault == "frames_differ":
        args[0] = torch.stack([args[0]] * 2)
        args[1:] = [torch.stack([a] * 3) for a in args[1:]]
    elif fault == "shapes_differ":
        args[3] = args[3][:2]
    elif fault == "meta_device":
        args = [a.to("meta") for a in args]
    else:
        args[1:] = [a.to("meta") for a in args[1:]]
    before = ref.refine_candidates.launches
    with pytest.raises(ValueError):
        ref.refine_candidates(*args, CFG)
    assert ref.refine_candidates.launches == before


@pytest.mark.parametrize("form", ["single", "batch"])
def test_cpu_takes_plain_without_a_launch(octaves, form):
    dog, cands = octaves[1]
    if form == "single":
        dog, cands = dog[0], tuple(a[0] for a in cands)
    before = ref.refine_candidates.launches
    got = ref.refine_candidates(dog, *cands, CFG)
    assert ref.refine_candidates.launches == before
    assert_bits_equal(got, ref.refine_candidates_plain(dog, *cands, CFG))


def test_kernel_threads_are_the_kernels():
    # launch floors are measured at the kernel's grid: KERNEL_THREADS
    # must be csrc/refine.cu's kThreads
    src = (pathlib.Path(ref.__file__).resolve().parent.parent / "csrc"
           / "refine.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(
        ref.KERNEL_THREADS)
