"""Compile edited copies of the port's CUDA sources into a kernel library
of their own and load it in place of the package's: the step that
tools/torch_k3_split.py, torch_select_split.py and torch_gather_split.py
share.

Every library built here also holds one empty kernel,
`variant_empty(grid x, grid y, threads, dynamic shared bytes, stream)`:
its launch is a launch shape's floor, the time a kernel of that shape
takes before it does any work. `floor_library` builds it alone, for
chip_smoke.py phase 2, which prints K3's time beside it.

The package's sources are never touched: a variant's files are copies
under the `out` directory its caller names (under build/), edited by
`edit`'s rules. Needs nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess

FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void variant_empty_kernel() {}
extern "C" int variant_empty(int bx, int by, int threads, int smem,
                             void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        variant_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  variant_empty_kernel<<<dim3(bx, by), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""
_FLOOR = "variant_floor.cu"


def edit(text: str, rules) -> str:
    """Apply the first rule (regular expression, replacement) whose
    pattern occurs in text; it must occur once."""
    for pattern, repl in rules:
        found = re.findall(pattern, text)
        if found:
            if len(found) != 1:
                raise RuntimeError(f"{pattern!r} occurs {len(found)} times")
            return re.sub(pattern, lambda _: repl, text)
    raise RuntimeError(f"no rule of {[p for p, _ in rules]} matches")


def build(out: pathlib.Path, sources: dict, build_mod):
    """Write `sources` ({file name: text}, headers included) and the
    empty kernel into a fresh `out`, compile every .cu with the package's
    nvcc flags and -Xptxas -v, one process each, all started together,
    and link them into out/libvariant.so. Returns the .so path, the
    objects of `sources` and ptxas's report on them."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for name, text in {**sources, _FLOOR: FLOOR_SRC}.items():
        (out / name).write_text(text)
    units = [n for n in sources if n.endswith(".cu")] + [_FLOOR]
    nvcc = build_mod._nvcc()
    flags = [*build_mod._FLAGS, "-Xptxas", "-v"]
    objs = [out / f"{n[:-3]}.o" for n in units]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(out / n)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, o in zip(units, objs)]
    reports = [p.communicate()[0] for p in procs]
    for p, rep in zip(procs, reports):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed in {out}:\n{rep}")
    lib = out / "libvariant.so"
    subprocess.run([nvcc, *build_mod._FLAGS, "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    return lib, objs[:-1], "".join(reports[:-1])


def build_variant(tree: pathlib.Path, names, rules: dict,
                  out: pathlib.Path, build_mod):
    """`build` of the tree's csrc/<name> for each of `names`, each edited
    by `edit` with rules[name] where rules has it."""
    sources = {}
    for name in names:
        text = (tree / "sift_tpu_torch" / "csrc" / name).read_text()
        sources[name] = edit(text, rules[name]) if name in rules else text
    return build(out, sources, build_mod)


def load(lib_path, build_mod, entries=()) -> ctypes.CDLL:
    """The library, with the package's argument types on `entries` and
    the empty kernel's on variant_empty."""
    lib = ctypes.CDLL(str(lib_path))
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = list(build_mod._SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.variant_empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.variant_empty.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def in_place_of_library(build_mod, lib):
    """Inside the block, the package's wrappers launch `lib`'s kernels:
    build_mod.library() returns it."""
    real = build_mod.library
    build_mod.library = lambda: lib
    try:
        yield lib
    finally:
        build_mod.library = real


def floor_library(out: pathlib.Path, build_mod) -> ctypes.CDLL:
    """A library that holds the empty kernel alone, built in `out`."""
    return load(build(out, {}, build_mod)[0], build_mod)


def launch_empty(lib, grid, threads: int, smem: int = 0) -> None:
    """Launch the empty kernel of `lib` on the current stream with grid
    (x, y), `threads` threads a CTA and `smem` dynamic shared bytes."""
    import torch
    err = lib.variant_empty(grid[0], grid[1], threads, smem,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant_empty failed: CUDA error {err}")
