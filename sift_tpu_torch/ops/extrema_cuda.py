"""K2 and K2-batch wrappers: DoG 26-neighbour extremum scan, dense and
compact, and the candidate selection that consumes the compact scan.

Counterpart of sift_tpu/ops/extrema_pallas.py (extrema_scores_pallas
and extrema_scores_batch_pallas, one kernel body). Each wrapper launches
its CUDA kernel (csrc/extrema.cu) for a CUDA tensor, runs its plain
PyTorch version for a CPU tensor, and keeps its own launch count:
- `extrema_scores` / `extrema_scores_batch` (dense): for DoG layers
  1..nL, |v| where the pixel is a candidate (`extrema_mask`) and -1
  elsewhere; the Pallas kernels' output.
- `extrema_compact` (compact, B frames): no score field; each frame's
  candidate keys (`pack_keys`) in a list, with its count. It takes a
  candidate box inside the border box (`check_box`): a row band of a
  larger image (parallel/spatial.py) scans only the rows it owns.
- `select_candidates` (B frames): the top `cap` keys of each list as
  (layer, r, c, valid), the slots a stable descending sort of the dense
  scores gives (ops/extrema.py:top_candidates_plain), without a host
  synchronisation: each key's slot is its rank in its frame's list,
  counted by `select_shape`'s CTAs a frame.
The scan only compares and the selection only moves keys, so every
kernel is bit-identical to its plain version (the compact list up to its
order, which is free).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG

# Most slots (min(cap, nL*H*W)), and staged keys, a rank-select CTA holds
# in shared memory (kMaxSharedKeys in csrc/extrema.cu); more slots sort in
# a device-memory scratch.
SHARED_SORT_KEYS = 16384
# select_shape: the least CTAs a select launch gives each SM, and the
# fewest slots a CTA ranks
_SELECT_CTAS_PER_SM = 2
_SELECT_SLOTS_PER_CTA = 32
# Largest nL*H*W field of a frame the compact scan and the select take:
# flat indices and counts are 32-bit.
MAX_FIELD = 2 ** 31 - 1
_INDEX_MASK = 0xFFFFFFFF


def _check_args(dog: torch.Tensor, cfg: SIFTConfig, ndim: int) -> None:
    if dog.dtype != torch.float32 or dog.dim() != ndim:
        want = "(D, H, W)" if ndim == 3 else "(B, D, H, W)"
        raise ValueError(f"DoG stack must be {want} float32, got "
                         f"{tuple(dog.shape)} {dog.dtype}")
    if dog.shape[-3] < cfg.n_octave_layers + 2:
        raise ValueError(f"DoG stack has {dog.shape[-3]} layers; scanning "
                         f"{cfg.n_octave_layers} needs {cfg.n_octave_layers + 2}")


def check_field(nl: int, hw) -> None:
    """Raise unless a frame's (nl, H, W) field fits the compact scan's
    32-bit flat indices; the same on every device."""
    if nl * hw[0] * hw[1] > MAX_FIELD:
        raise ValueError(f"a {nl}x{hw[0]}x{hw[1]} candidate field has more "
                         f"than {MAX_FIELD} pixels")


def check_box(box, cfg: SIFTConfig, hw) -> tuple:
    """`box` (r_lo, r_hi, c_lo, c_hi) as Python ints, or for None the
    border box (img_border pixels inside the (H, W) frame); raise unless
    it lies inside the border box (r_hi <= r_lo or c_hi <= c_lo is an
    empty box). The kernel's neighbour loads stay inside the frame only
    while r_lo, c_lo >= 1; both devices refuse the same boxes."""
    b = cfg.img_border
    outer = (b, hw[0] - b, b, hw[1] - b)
    if box is None:
        return outer
    r_lo, r_hi, c_lo, c_hi = (int(v) for v in box)
    if not (outer[0] <= r_lo and r_hi <= outer[1] and outer[2] <= c_lo
            and c_hi <= outer[3]):
        raise ValueError(f"candidate box {(r_lo, r_hi, c_lo, c_hi)} is not "
                         f"inside the border box {outer}")
    return r_lo, r_hi, c_lo, c_hi


def _check_device(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor, False for a CUDA one; raise otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def extrema_mask(dog: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG,
                 box=None) -> torch.Tensor:
    """(..., D, H, W) DoG stack(s) -> (..., nL, H, W) candidate mask for
    layers 1..nL inside `box` (check_box; default the border box); a
    leading batch axis is carried through."""
    nl = cfg.n_octave_layers
    h, w = dog.shape[-2:]
    val = dog[..., 1:1 + nl, :, :]
    p = F.pad(dog, (1, 1, 1, 1))
    nmax = torch.full_like(val, float("-inf"))
    nmin = torch.full_like(val, float("inf"))
    for dl in (-1, 0, 1):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if dl == 0 and dr == 1 and dc == 1:
                    continue  # centre
                s = p[..., 1 + dl:1 + dl + nl, dr:dr + h, dc:dc + w]
                nmax = torch.maximum(nmax, s)
                nmin = torch.minimum(nmin, s)
    mask = (val.abs() > cfg.nms_threshold) & (
        ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin)))
    r_lo, r_hi, c_lo, c_hi = check_box(box, cfg, (h, w))
    rr = torch.arange(h, device=dog.device)
    cc = torch.arange(w, device=dog.device)
    inside = ((rr >= r_lo) & (rr < r_hi))[:, None] & (
        (cc >= c_lo) & (cc < c_hi))[None, :]
    return mask & inside


def _plain(dog: torch.Tensor, cfg: SIFTConfig, box=None) -> torch.Tensor:
    val = dog[..., 1:1 + cfg.n_octave_layers, :, :]
    return torch.where(extrema_mask(dog, cfg, box), val.abs(),
                       torch.full_like(val, -1.0))


def _launch(dog: torch.Tensor, cfg: SIFTConfig, compact: bool = False,
            box=None) -> tuple:
    """The CUDA scan on (B, D, H, W): dense -> ((B, nL, H, W) scores,);
    compact -> (keys (B, nL*H*W) int64, count (B,) int32) of the
    candidates inside `box` (check_box)."""
    # the kernel's border test keeps every neighbour load inside the
    # frame only while the border is at least one pixel
    if cfg.img_border < 1:
        raise ValueError(f"K2 kernel needs img_border >= 1, got "
                         f"{cfg.img_border}")
    dog = dog.contiguous()
    nl = cfg.n_octave_layers
    b, d, h, w = dog.shape
    if compact:
        name = "sift_extrema_compact"
        out = (torch.empty((b, nl * h * w), dtype=torch.int64,
                           device=dog.device),
               torch.empty((b,), dtype=torch.int32, device=dog.device))
        region = check_box(box, cfg, (h, w))
    else:
        name = "sift_extrema_scores"
        out = (torch.empty((b, nl, h, w), dtype=torch.float32,
                           device=dog.device),)
        region = (cfg.img_border,)
    with torch.cuda.device(dog.device):
        err = getattr(_build.library(), name)(
            dog.data_ptr(), *(o.data_ptr() for o in out), b, d, nl, h, w,
            float(cfg.nms_threshold), *region,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def extrema_scores_plain(dog: torch.Tensor,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Plain PyTorch K2: (D, H, W) -> (nL, H, W) scores."""
    _check_args(dog, cfg, 3)
    return _plain(dog, cfg)


def extrema_scores(dog: torch.Tensor,
                   cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """K2: (D, H, W) DoG stack -> (nL, H, W) masked |response| scores.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_args(dog, cfg, 3)
    if _check_device(dog, "extrema_scores"):
        return extrema_scores_plain(dog, cfg)
    out = _launch(dog[None], cfg)[0][0]
    extrema_scores.launches += 1
    return out


def extrema_scores_batch_plain(dog: torch.Tensor,
                               cfg: SIFTConfig = DEFAULT_CONFIG
                               ) -> torch.Tensor:
    """Plain PyTorch K2-batch: (B, D, H, W) -> (B, nL, H, W) scores."""
    _check_args(dog, cfg, 4)
    return _plain(dog, cfg)


def extrema_scores_batch(dog: torch.Tensor,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """K2-batch: (B, D, H, W) DoG stacks -> (B, nL, H, W) scores, one
    launch for all frames. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_args(dog, cfg, 4)
    if _check_device(dog, "extrema_scores_batch"):
        return extrema_scores_batch_plain(dog, cfg)
    out = _launch(dog, cfg)[0]
    extrema_scores_batch.launches += 1
    return out


extrema_scores.launches = 0
extrema_scores_batch.launches = 0


def pack_keys(score: torch.Tensor) -> torch.Tensor:
    """(..., N) scores -> (..., N) int64 keys: the score's float bits in
    the high word, 0xFFFFFFFF - (flat index) in the low one. For the
    positive scores of candidates the larger key is the earlier slot of
    a stable descending sort of the scores."""
    idx = torch.arange(score.shape[-1], dtype=torch.int64,
                       device=score.device)
    return (score.view(torch.int32).to(torch.int64) << 32) | (
        _INDEX_MASK - idx)


def extrema_compact_plain(dog: torch.Tensor,
                          cfg: SIFTConfig = DEFAULT_CONFIG, box=None):
    """Plain PyTorch compact scan: (B, D, H, W) -> (keys (B, nL*H*W)
    int64, count (B,) int32); row b holds the keys of frame b's
    candidates inside `box` (check_box; default the border box) in
    ascending flat index, then zeros."""
    _check_args(dog, cfg, 4)
    score = _plain(dog, cfg, box).reshape(dog.shape[0], -1)
    cand = score > 0
    count = cand.sum(dim=1, dtype=torch.int32)
    # a stable sort on "no candidate" puts each row's candidates first
    order = torch.sort((~cand).to(torch.uint8), dim=1, stable=True).indices
    slot = torch.arange(score.shape[1], device=dog.device)
    keys = torch.where(slot < count[:, None],
                       pack_keys(score).gather(1, order), 0)
    return keys, count


def extrema_compact(dog: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG,
                    box=None):
    """K2 compact scan: (B, D, H, W) DoG stacks -> (keys (B, nL*H*W)
    int64, count (B,) int32), one launch for all frames; frame b's
    candidate keys (inside `box`, default the border box) are
    keys[b, :count[b]], in any order on the card (the rest is not
    written). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check_args(dog, cfg, 4)
    check_field(cfg.n_octave_layers, dog.shape[-2:])
    check_box(box, cfg, dog.shape[-2:])
    if _check_device(dog, "extrema_compact"):
        return extrema_compact_plain(dog, cfg, box)
    keys, count = _launch(dog, cfg, compact=True, box=box)
    extrema_compact.launches += 1
    return keys, count


def _check_select_args(keys: torch.Tensor, count: torch.Tensor, cap: int,
                       hw) -> None:
    h, w = hw
    if (keys.dtype != torch.int64 or keys.dim() != 2
            or count.dtype != torch.int32
            or tuple(count.shape) != (keys.shape[0],)):
        raise ValueError(f"keys must be (B, nL*H*W) int64 and count (B,) "
                         f"int32, got {tuple(keys.shape)} {keys.dtype}, "
                         f"{tuple(count.shape)} {count.dtype}")
    if h < 1 or w < 1 or keys.shape[1] < h * w or keys.shape[1] % (h * w):
        raise ValueError(f"keys of {keys.shape[1]} per frame are no whole "
                         f"number of {h}x{w} layers")
    check_field(keys.shape[1] // (h * w), hw)
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")


def sort_keys(cap: int, total: int) -> int:
    """The select kernel's sort size: the power of two at or above
    min(cap, total)."""
    return 1 << max(min(cap, total) - 1, 0).bit_length()


def select_shape(cap: int, total: int, frames: int, sms: int) -> tuple:
    """(ctas, stage) of a rank-select launch over `frames` frames of
    `total` = nL*H*W flat indices on a card of `sms` SMs: `ctas` CTAs a
    frame, the fewest that give every SM _SELECT_CTAS_PER_SM CTAs, but no
    more than one for each _SELECT_SLOTS_PER_CTA slots; each stages up to
    `stage` keys, twice the slots up to SHARED_SORT_KEYS, so a list of up
    to twice cap keys is ranked whole in shared memory, with no radix
    select. Only the time depends on it, never the result."""
    slots = min(cap, total)
    ctas = max(1, min(-(-_SELECT_CTAS_PER_SM * sms // max(frames, 1)),
                      -(-slots // _SELECT_SLOTS_PER_CTA)))
    stage = max(slots, min(2 * slots, SHARED_SORT_KEYS, total))
    return ctas, stage


def unpack_indices(idx: torch.Tensor, valid: torch.Tensor, hw):
    """Flat (nL*H*W) indices -> (layer 1..nL, r, c) int32, and valid."""
    h, w = hw
    rem = idx % (h * w)
    return ((idx // (h * w) + 1).to(torch.int32),
            (rem // w).to(torch.int32), (rem % w).to(torch.int32), valid)


def select_candidates_plain(keys: torch.Tensor, count: torch.Tensor,
                            cap: int, hw):
    """Plain PyTorch selection: keys (B, nL*H*W), count (B,) -> layer, r,
    c (int32), valid (bool), each (B, cap). Slots 0..n-1 (n = min(count,
    cap)) take the largest keys in descending order; the next take the
    lowest flat indices that are no candidate, ascending; slots past
    nL*H*W take index 0; only the first n are valid."""
    _check_select_args(keys, count, cap, hw)
    b, total = keys.shape
    dev = keys.device
    slot = torch.arange(total, device=dev)
    listed = slot < count[:, None]
    k = min(cap, total)
    ranked = torch.sort(torch.where(listed, keys, -1), dim=1,
                        descending=True).values[:, :k]
    cand = torch.zeros((b, total), dtype=torch.int32, device=dev)
    cand.scatter_add_(1, torch.where(listed, _INDEX_MASK - (keys & _INDEX_MASK),
                                     0), listed.to(torch.int32))
    # a stable sort on "candidate" puts the other indices first, ascending
    free = torch.sort((cand > 0).to(torch.uint8), dim=1, stable=True).indices
    n = torch.clamp(count.to(torch.int64), max=k)[:, None]
    pos = torch.arange(k, device=dev)
    valid = pos < n
    idx = torch.where(valid, _INDEX_MASK - (ranked & _INDEX_MASK),
                      free.gather(1, (pos - n).clamp(min=0)))
    if k < cap:
        idx = F.pad(idx, (0, cap - k))
        valid = F.pad(valid, (0, cap - k))
    return unpack_indices(idx, valid, hw)


def select_candidates(keys: torch.Tensor, count: torch.Tensor, cap: int,
                      hw):
    """K2 select: each frame's top `cap` candidate keys (from
    extrema_compact) -> layer, r, c (int32), valid (bool), each (B, cap),
    reading the counts on the device: a grid of select_shape's CTAs a
    frame, each ranking a slice of the frame's keys. CPU tensors take the
    plain version; CUDA tensors launch the kernel. Past SHARED_SORT_KEYS
    slots the kernel sorts in a (B, sort_keys) scratch, one block a
    frame."""
    _check_select_args(keys, count, cap, hw)
    if _check_device(keys, "select_candidates"):
        return select_candidates_plain(keys, count, cap, hw)
    keys, count = keys.contiguous(), count.contiguous()
    h, w = hw
    b, total = keys.shape
    nl = total // (h * w)
    out = [torch.empty((b, cap), dtype=torch.int32, device=keys.device)
           for _ in range(3)]
    valid = torch.empty((b, cap), dtype=torch.bool, device=keys.device)
    n2 = sort_keys(cap, total)
    scratch = (torch.empty((b, n2), dtype=torch.int64, device=keys.device)
               if n2 > SHARED_SORT_KEYS else None)
    ctas, stage = select_shape(
        cap, total, b,
        torch.cuda.get_device_properties(keys.device).multi_processor_count)
    with torch.cuda.device(keys.device):
        err = _build.library().sift_extrema_select(
            keys.data_ptr(), count.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            *(o.data_ptr() for o in out), valid.data_ptr(), b, cap, nl, h, w,
            ctas, stage, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_extrema_select")
    select_candidates.launches += 1
    return (*out, valid)


def select_floor(frames: int, cap: int, nl: int, hw,
                 device: torch.device) -> None:
    """Launch an empty kernel with the select's shape for these
    arguments (select_shape's grid, its threads and shared memory): the
    launch floor that chip_smoke.py prints beside the select's time. No
    path calls it, and it counts no launch."""
    h, w = hw
    ctas, stage = select_shape(
        cap, nl * h * w, frames,
        torch.cuda.get_device_properties(device).multi_processor_count)
    with torch.cuda.device(device):
        err = _build.library().sift_extrema_select_floor(
            frames, cap, nl, h, w, ctas, stage,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_extrema_select_floor")


extrema_compact.launches = 0
select_candidates.launches = 0
