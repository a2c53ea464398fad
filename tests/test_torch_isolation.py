"""The port stands alone: it imports no JAX, and no kernel of its path is
a library stand-in or sits behind a fallback."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

from _torch_threads import one_thread  # noqa: F401

PKG = pathlib.Path(__file__).resolve().parent.parent / "sift_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sift_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    sift_tpu_torch.__path__, 'sift_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'sift_tpu.'))\n"
        "             or k == 'sift_tpu')\n"
        "assert len(mods) >= 60, mods\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["sift_tpu_torch.sfm.mapping",
                                    "sift_tpu_torch.eval"])
def test_mapping_path_loads_no_cv2(module):
    # the card's machine has no OpenCV: the mapping path and the eval
    # harness import it only inside the functions that read or warp
    # corpus images, and rendering from given textures runs with cv2
    # unimportable
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        f"import {module}\n"
        "import numpy as np\n"
        "from sift_tpu_torch.sfm.mapping import render_corner_sequence\n"
        "texs = [np.full((48, 64), 50.0 * i, np.float32) for i in range(4)]\n"
        "frames, k, gt = render_corner_sequence(n_frames=2, size=(24, 32),\n"
        "                                       textures=texs)\n"
        "assert frames.shape == (2, 24, 32)\n"
        "assert sys.modules['cv2'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pattern", [r"torch\.compile",
                                     r"scaled_dot_product_attention",
                                     r"^\s*(import jax|from jax)",
                                     r"^\s*(import|from) sift_tpu(\.|\s)"])
def test_no_forbidden_source(pattern):
    for src in SOURCES:
        text = src.read_text()
        assert not re.search(pattern, text, re.M), (src, pattern)


def test_kernel_launches_have_no_fallback():
    # a module that launches a kernel carries no try: a CUDA tensor goes
    # through the kernel or the call raises
    launching = [s for s in SOURCES if "_build.library()" in s.read_text()]
    assert {s.name for s in launching} == {
        "conv_cuda.py", "extrema_cuda.py", "ori_gather_cuda.py",
        "ori_hist_cuda.py", "descr_hist_cuda.py", "match_cuda.py",
        "refine.py", "segsum.py"}
    for src in launching:
        assert not re.search(r"^\s*try\s*:", src.read_text(), re.M), src
        assert ".launches += 1" in src.read_text()


def test_every_kernel_has_a_cuda_source():
    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert names == {"blur.cu", "extrema.cu", "gather.cu", "ori_hist.cu",
                     "descr_hist.cu", "knn2.cu", "refine.cu", "segsum.cu"}
    entries = set()
    for p in (PKG / "csrc").glob("*.cu"):
        text = p.read_text()
        # each source names the Pallas kernel it replaces, or says it
        # replaces none and what sift_tpu does instead
        assert "sift_tpu/ops/" in text and (
            "_pallas.py" in text or "Replaces no Pallas kernel" in text), p
        assert 'extern "C"' in text and "cudaGetLastError" in text, p
        entries |= set(re.findall(r'extern "C" int (\w+)\(', text))
    # ctypes binds exactly the C entry points the sources define
    from sift_tpu_torch import _build
    assert entries == set(_build._SIGNATURES)


def test_ctypes_argument_types_follow_the_c_signatures():
    # ctypes passes what _SIGNATURES says: a pointer for each pointer
    # parameter, an int or a float for each scalar, in the C order
    from sift_tpu_torch import _build
    kinds = {"P": _build._P, "I": _build._I, "F": _build._F}
    for p in (PKG / "csrc").glob("*.cu"):
        decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', p.read_text())
        for name, params in decls:
            want = []
            for param in params.split(","):
                param = param.strip()
                want.append(kinds["P" if "*" in param else
                                  "F" if param.startswith("float") else "I"])
            assert list(_build._SIGNATURES[name]) == want, name


def test_match_wrapper_tiles_are_the_kernels():
    # split_plan sizes the splits and scratch from copies of knn2.cu's
    # tile constants: they must be the kernel's
    from sift_tpu_torch.ops import match_cuda
    src = (PKG / "csrc" / "knn2.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kQB|kTT) = (\d+);", src))
    assert int(consts["kQB"]) == match_cuda._QUERY_TILE
    assert int(consts["kTT"]) == match_cuda._TRAIN_TILE


PARALLEL = sorted((PKG / "parallel").glob("*.py"))
BACKEND_LITERALS = {"gloo", "nccl"}


def _front_end_functions() -> set:
    """Names of the functions that reach a kernel: everything defined in
    ops/, sift.py and pipeline.py, and in parallel/ but for mesh.py (the
    process group and collectives)."""
    names = set()
    srcs = [*(PKG / "ops").glob("*.py"), PKG / "sift.py", PKG / "pipeline.py",
            *(p for p in PARALLEL if p.name != "mesh.py")]
    for src in srcs:
        names |= {n.name for n in ast.walk(ast.parse(src.read_text()))
                  if isinstance(n, ast.FunctionDef)}
    return names


def _called(nodes) -> set:
    out = set()
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                f = n.func
                out.add(f.attr if isinstance(f, ast.Attribute) else
                        getattr(f, "id", None))
    return out


def _literals(node) -> set:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and n.value in BACKEND_LITERALS}


def test_parallel_has_no_fallback_around_kernels():
    # a try with an except in parallel/ never wraps a call that reaches a
    # kernel: a rank's kernel fails loudly, it is not retried another way
    front = _front_end_functions()
    assert {"detect_and_compute_batch", "top_candidates", "knn2_l1",
            "gaussian_blur_multi", "detect_and_compute_tiled"} <= front
    for src in PARALLEL:
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Try) and node.handlers:
                hit = _called(node.body) & front
                assert not hit, (src.name, node.lineno, hit)


def test_parallel_backend_is_the_callers():
    # the process group is created in one place, with the backend its
    # caller passed; no code picks a backend from what the machine has,
    # and no handler falls back to another backend
    inits = []
    for src in PARALLEL:
        tree = ast.parse(src.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                for call in ast.walk(node):
                    if (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "init_process_group"):
                        inits.append((src.name, node.name, call))
            if isinstance(node, (ast.If, ast.IfExp, ast.BoolOp, ast.Compare)):
                probes = {n.attr for n in ast.walk(node)
                          if isinstance(n, ast.Attribute)}
                assert not (_literals(node) and probes & {
                    "is_available", "device_count"}), (src.name, node.lineno)
            if isinstance(node, ast.Try):
                for h in node.handlers:
                    assert not _literals(h) and not (
                        _called(h.body) & {"init_process",
                                           "init_process_group"}), \
                        (src.name, h.lineno)
    assert [(f, fn) for f, fn, _ in inits] == [("mesh.py", "init_process")]
    call = inits[0][2]
    assert isinstance(call.args[0], ast.Name) and call.args[0].id == "backend"


def test_parallel_has_no_default_backend_or_device():
    # a default would choose for a caller who names neither: no function
    # of parallel/ or of sfm/checkpoint.py gives `backend` a default, or
    # `device` a device name (make_mesh's device=None follows the world's
    # backend; load_ba's device=None is CUDA, as the rest of the SfM
    # path resolves it)
    checked = set()
    for src in PARALLEL + [PKG / "sfm" / "checkpoint.py"]:
        for node in ast.walk(ast.parse(src.read_text())):
            if not isinstance(node, ast.FunctionDef):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            named = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            named += [(x, d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            for arg, default in named:
                assert arg.arg != "backend", (src.name, node.name)
                assert not (arg.arg == "device"
                            and isinstance(default, ast.Constant)
                            and isinstance(default.value, str)), \
                    (src.name, node.name)
            checked |= {node.name} & {"run_spmd", "init_process",
                                      "supervise_ba", "load_ba"}
    assert checked == {"run_spmd", "init_process", "supervise_ba", "load_ba"}
