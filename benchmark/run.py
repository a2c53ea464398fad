#!/usr/bin/env python3
"""Run one cell of the benchmark of sift_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell is an entry of BENCHMARK.json's `workloads`; its files are found
by name: benchmark/workloads/<cell>.json (configuration, traffic kind and
its parameters, the statistic behind each end-to-end metric, the limits
of `correct`), benchmark/configs/<config>.json, benchmark/traffic/
<kind>.py (the driver), benchmark/window_stats/<name>.py (the statistic
of the window behind an end-to-end metric), benchmark/layer_metrics/
<metric>.py (a reader of the traced run) and benchmark/roofline/
<kernel>.py (a kernel's launches, bytes and operations from the
configuration and the shapes of a request).

A run: checks for the card, loads the port's kernel library, makes the
inputs from --seed, warms up the cell's own shapes (all of that is
setup_s), then runs requests in a closed loop, one client, each ended by
a device synchronisation, until --seconds have passed; the window ends
with the last request. With --trace 1 the first requests of the window
run under torch.profiler and the rest inside the benchmark's spans,
each ended by a synchronisation. After the window the reference in
benchmark/reference/ recomputes a sample of the answers, drawn from the
seed, and `correct` holds each number compared within its limit. The
last line of standard output is one JSON object; the last lines of
standard error are the numbers compared beside their limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "sift_tpu")
TORCH_THREADS = 1


def load_module(path: pathlib.Path, name: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> tuple:
    """(workload, configuration) of cell `name`, read by name."""
    work = read_json(HERE / "workloads" / f"{name}.json")
    cfg = read_json(HERE / "configs" / f"{work['config']}.json")
    return work, cfg


def traffic(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py",
                       f"bench_traffic_{kind}")


def layer_reader(metric: str):
    return load_module(HERE / "layer_metrics" / f"{metric}.py",
                       "bench_layer_" + metric.replace(".", "_"))


def roofline(kernel: str):
    return load_module(HERE / "roofline" / f"{kernel}.py",
                       f"bench_roofline_{kernel}")


def statistic(name: str):
    """The statistic `name` of a window (window_stats/<name>.py): a
    function of run_window's result."""
    return load_module(HERE / "window_stats" / f"{name}.py",
                       f"bench_statistic_{name}").value


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Spans:
    """Wall-clock spans around the calls into the program's layers, each
    ended by a device synchronisation; a no-op unless recording."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.recording = False
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.recording:
            yield
            return
        import torch
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


def run_window(driver, seconds: float, sync, spans: Spans, first: int,
               record: bool) -> dict:
    """Requests first, first + 1, ... until `seconds` have passed since
    the window opened and every entry of the driver's pool has been
    served; each request waits for its device work. Returns the window's
    length (to the end of its last request), the requests attempted and
    failed, the units completed and every latency."""
    lat, units, failed = [], 0, 0
    i = first
    t0 = time.perf_counter()
    while True:
        spans.recording = record
        t = time.perf_counter()
        try:
            units += driver.step(i, spans)
            sync()
        except Exception as exc:  # a failed request is counted, not fatal
            failed += 1
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
        end = time.perf_counter()
        lat.append(end - t)
        i += 1
        if end - t0 >= seconds and i - first >= driver.pool_size:
            break
    spans.recording = False
    return {"window_s": end - t0, "attempted": i - first, "failed": failed,
            "units": units, "latencies_s": lat, "next": i}


def profile_requests(driver, n: int, first: int, sync, spans: Spans) -> dict:
    """n requests under torch.profiler (host and device activity); the
    raw kineto events are read directly, as building the profiler's
    EventList of ~10^5 events takes minutes. Returns the device busy
    time (the union of the device events' intervals), the slice's wall
    time, the device events, device time by name and the idle gaps
    between device events by what the host was doing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    units = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            units += driver.step(i, spans)
            sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return summarize_profile(dev, host, wall, units, n)


def summarize_profile(dev, host, wall_s: float, units: int, steps: int
                      ) -> dict:
    """The profile's numbers from (start_ns, end_ns, name) rows of the
    device and the host."""
    import bisect
    spans = sorted((a, b) for a, b, _ in dev)
    busy_ns, end = 0, float("-inf")
    gaps = []
    for a, b in spans:
        if a > end and end != float("-inf"):
            gaps.append((end, a))
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    host = sorted(host)
    starts = [a for a, _, _ in host]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        what = "(no host event)"
        # the innermost host event around the gap's middle: the latest
        # to start of those still running
        for j in range(k, max(k - 4000, -1), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        what = what[:80]
        idle[what] = idle.get(what, 0.0) + (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_ns * 1e-9, "window_s": wall_s,
            "device_events": len(dev), "units": units, "steps": steps,
            "device_s_by_name": by_name,
            "device_ops": [[k[:80], v] for k, v in top[:10]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def window_trend(lat: List[float], parts: int = 5) -> str:
    """The median latency (ms) of each fifth of the window's requests:
    whether the pace drifts within a run."""
    n = len(lat)
    if n < parts:
        return "too few requests"
    cuts = [lat[k * n // parts:(k + 1) * n // parts] for k in range(parts)]
    return (f"{n} requests, median ms by fifth: "
            + " ".join(f"{statistics.median(c) * 1e3:.2f}" for c in cuts))


def cell_metrics(bench: dict, cell: str, key: str) -> List[dict]:
    """The metrics of BENCHMARK.json's `key` that cell `cell` reports."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Trace:
    """What a layer metric's reader reads: the spans (seconds by name),
    the profiled slice, the configuration's SIFT block and the shapes of
    one request (the traffic driver's `shapes()`: the batches of images
    it detects in, as [frames, h, w], and the pairs of frames it
    matches)."""

    def __init__(self, spans, profile, sift: dict, shapes: dict):
        self.spans = spans
        self.profile = profile
        self.sift = sift
        self.shapes = shapes

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """100 x the least time the profiled requests' launches of
        `kernel` could take on the card / their device time."""
        mod = roofline(kernel)
        dev_s = sum(v for k, v in self.profile["device_s_by_name"].items()
                    if any(n in k for n in mod.KERNELS))
        launches = mod.launches(self.sift, self.shapes)
        if dev_s <= 0 or not launches:
            return None
        bound = sum(mod.bound_s(s) for s in launches) * self.profile["steps"]
        return 100.0 * bound / dev_s


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """One run of `cell` on `device`: the result line's object.
    `overrides`, merged into the workload's parameters, let a test drive
    a run at a small size on the CPU and the control switch on the
    program's lower-precision arm."""
    import torch
    torch.set_num_threads(TORCH_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bench = manifest()
    work, cfg = cell_files(cell)
    params = {**work["params"], **(overrides or {})}
    if on_card:
        from sift_tpu_torch import _build
        _build.library()
        torch.cuda.reset_peak_memory_stats()
    drv = traffic(work["kind"]).make(cfg, params, seed, torch.device(device))
    spans = Spans(sync)
    drv.warmup(spans)
    sync()
    setup_s = time.perf_counter() - T_START
    profile = None
    first = 0
    if trace:
        profile = profile_requests(drv, params["profile_requests"], 0, sync,
                                   spans)
        first = params["profile_requests"]
    win = run_window(drv, seconds, sync, spans, first, trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    from benchmark.reference.compare import judge
    try:
        numbers, notes = drv.check(seed)
    except Exception as exc:  # a check that gives no number has failed
        numbers, notes = {}, [f"the check raised {exc!r}"]
    ok, checked = judge(numbers, work["limits"])
    correct = ok and bool(numbers) and win["failed"] == 0

    metrics = {}
    if trace:
        tr = Trace(spans.times, profile, cfg["sift"], drv.shapes())
        for m in cell_metrics(bench, cell, "per_layer"):
            v = layer_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = statistic(work["metrics"][m["name"]])(win)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(0) if on_card else "cpu")
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                      "count": 1 if on_card else 0,
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = profile["busy_s"]
        out["device"]["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    out["checked"] = checked
    out["_notes"] = notes
    out["_trend"] = window_trend(win["latencies_s"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    work, _ = cell_files(args.workload)
    chips = int(work["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of {FORBIDDEN} were loaded: {bad}", file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"window: {out.pop('_trend')}", file=sys.stderr)
    for n in notes:
        print(n, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    for name, c in out["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
