"""Build and load the port's CUDA kernels (csrc/*.cu).

All sources compile with nvcc into ONE shared library with a plain C
interface, loaded through ctypes: seconds to build, where an extension
that includes PyTorch's headers takes minutes. Each source compiles in
its own nvcc process, all started together, and one more links them.
The library lands in build/sift_tpu_torch/<hash of the sources and
flags>/ under the checkout, so a changed source rebuilds and an
unchanged one loads the existing library. The build runs at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "sift_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; every one returns the
# cudaError_t of its launch as an int. ctypes does not check these
# against the C functions, so they must change with the sources.
_SIGNATURES = {
    # img, out, B, H, W, S, K, taps, ranges (per-scale nonzero taps),
    # stream
    "sift_blur_multi": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # dog, out, B, D, nl, H, W, thr, border, stream
    "sift_extrema_scores": (_P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # dog, keys, count, B, D, nl, H, W, thr, r_lo, r_hi, c_lo, c_hi
    # (the candidate box), stream
    "sift_extrema_compact": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                             _I, _P),
    # keys, count, scratch, layer, row, col, valid, B, cap, nl, H, W,
    # ctas (CTAs a frame), stage (keys a CTA stages), stream
    "sift_extrema_select": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P),
    # B, cap, nl, H, W, ctas, stage, stream: an empty kernel launched with
    # the select's shape (its launch floor; measurement only)
    "sift_extrema_select_floor": (_I, _I, _I, _I, _I, _I, _I, _P),
    # src, layer, row, col, out, N, L, Hp, Wp, p, warps (a CTA), stream
    "sift_gather_patches": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # src, layer, row, col, radius, expf_scale, out, N, B (frames), L,
    # Hp, Wp, rp, row_lo, row_hi (the image's rows), cluster (CTAs a
    # keypoint), stream
    "sift_ori_hist": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P),
    # src, layer, row, col, cos_t, sin_t, radius, ori, valid, out,
    # N, B (frames), L, Hp, Wp, rd, row_lo, row_hi, rc_bf16 (the bf16
    # arm), cluster (CTAs a keypoint), stream
    "sift_descr_hist": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # query, train, G (pairs), N, M, D, P, span (P train splits of span
    # rows), part_d1, part_d2, part_idx ((P, G, N) scratch), idx, d1, d2,
    # stream
    "sift_knn2_l1": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P, _P),
    # dog, layer, row, col, valid, then the eight Refined fields (layer,
    # r, c, xi, xr, xc, contr, valid); N, B, D, H, W, nl, border, row_lo,
    # row_hi, steps, contrast_thr, edge, edge_sq, stream
    "sift_refine": (_P,) * 13 + (_I,) * 10 + (_F,) * 3 + (_P,),
    # out, x, perm, offsets, O (rows of x), S (segments), W (floats a
    # row), stream
    "sift_segsum": (_P, _P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the library unless it exists; its path."""
    out_dir = _BUILD_ROOT / _digest()
    lib = out_dir / "libsift_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename the library: a
    # concurrent build never sees a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        nvcc = _nvcc()
        objs = [pathlib.Path(tmp_dir) / f"{src.stem}.o" for src in _sources()]
        _run_all([[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        tmp_lib = pathlib.Path(tmp_dir) / lib.name
        _run_all([[nvcc, *_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib)
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of the
    first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
