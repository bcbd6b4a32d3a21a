"""One run of a cell: set-up, the measured window, the check, the line.

`main` is what `portbench/run.py` runs. `prepare` and `measure` are the
parts it is made of, which tests and the control drive on their own.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import reference, spec, stats
from .pool import load_stream
from .schedule import cycles
from .sessions import Driver

# top-level module names that no run may have loaded once its window has
# closed: JAX and the JAX package (the port's name begins with the
# latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dav1d_tpu")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def settings_of(cell, device: str) -> dict:
    s = dict(cell.config["settings"])
    s["device"] = device
    return s


def prepare(cell, device="cuda", settings=None, streams=None) -> Driver:
    """Load the program and the pool (the cell's streams, or `streams`:
    {name: pool.Stream}), and decode each item of the pool once: every
    shape this cell's traffic uses is built and warm."""
    from dav1d_tpu_torch import api
    if streams is None:
        streams = {n: load_stream(n) for n in cell.config["streams"]}
    driver = Driver(api, settings or settings_of(cell, device), streams,
                    cell.traffic)
    for rec in driver.warm():
        if rec["error"]:
            raise RuntimeError(f"warm-up decode of {rec['stream']} failed: "
                               f"{rec['error']}")
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return driver


def launches() -> int:
    """The program's count of its kernel launches so far
    (`LAUNCHES` of each loaded `dav1d_tpu_torch.ops` module)."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("dav1d_tpu_torch.ops.")]
    return sum(sum(m.LAUNCHES.values()) for m in mods
               if isinstance(getattr(m, "LAUNCHES", None), dict))


@dataclass
class Window:
    sessions: list
    t0: float
    t1: float
    cpu_s: float
    phases: dict = field(default_factory=dict)
    device_events: list = None
    spans: list = field(default_factory=list)
    launches: int = 0
    gc: object = None               # devtrace.GcLog of the window

    def returns(self):
        return [t for s in self.sessions for t in s["returns"]]

    def pictures(self) -> int:
        return sum(len(s["returns"]) for s in self.sessions)


def measure(driver, seed: int, seconds: float, trace: bool = False) -> Window:
    """The measured window: the mix's loop of sessions in the seed's order."""
    order = cycles(driver.items, seed)
    loop = spec.loop_runner(driver.traffic["loop"])
    if not trace:
        c0 = time.process_time()
        sessions, t0, t1 = loop(driver, order, seconds)
        return Window(sessions, t0, t1, time.process_time() - c0)
    import torch
    from dav1d_tpu_torch.utils import timing
    from .devtrace import DeviceTrace, GcLog, PhaseLog
    dev = DeviceTrace(torch)
    log = PhaseLog(timing)
    gcl = GcLog()
    n0 = launches()
    dev.start()
    log.install()
    gcl.install()
    c0 = time.process_time()
    try:
        sessions, t0, t1 = loop(driver, order, seconds)
    finally:
        cpu = time.process_time() - c0
        gcl.remove()
        phases = log.remove()
        events = dev.stop()
    return Window(sessions, t0, t1, cpu, phases, events, log.spans,
                  launches() - n0, gcl)


def traced_kernels(window) -> int:
    from .devtrace import kernel_of
    return sum(1 for name, _, _ in window.device_events or []
               if kernel_of(name) is not None)


TRACE_TAKES = 3


def measure_traced(driver, seed, seconds) -> list:
    """The traced window, taken again (up to TRACE_TAKES times) while
    the profiler returns none of the kernels the program launched in it
    (it drops events at times); every window taken, the last first."""
    taken = []
    for _ in range(TRACE_TAKES):
        w = measure(driver, seed, seconds, trace=True)
        taken.insert(0, w)
        if w.device_events and (traced_kernels(w) or not w.launches):
            break
    return taken


def judge(window, driver, control=None) -> dict:
    """Hash every picture the window returned and compare it with the
    reference; `control` replaces the program's samples first."""
    out = []
    for s in window.sessions:
        md5s = []
        for planes, w, h, bpc, sh, sv in s["pictures"]:
            if control is not None:
                planes = control(planes, bpc)
            md5s.append(reference.picture_md5(planes, w, h, bpc, sh, sv))
        out.append({"stream": s["stream"], "unit": s["unit"], "md5s": md5s,
                    "complete": s["complete"], "error": s["error"]})
    records = {n: st.record for n, st in driver.streams.items()}
    return reference.compare(out, records)


@dataclass
class Context:
    """What a per-layer metric's reader reads (metrics/<name>.py): the
    traced window is the sessions' loop, [lo, hi] on the host clock."""
    pictures: int                 # pictures returned in the window
    cpu_s: float                  # the process's CPU seconds in it
    phases: dict                  # timing phase -> seconds, over threads
    latencies_s: list             # each session's start to its last return
    device_events: list           # [(name, start, end)], host seconds
    lo: float
    hi: float
    picture_records: list         # reference records of those pictures
    gc_s: float = None            # seconds in the cyclic GC in the window


def context(driver, window) -> Context:
    lat = [s["returns"][-1] - s["start"] for s in window.sessions
           if s["returns"] and s["complete"] and not s["error"]]
    recs = []
    for s in window.sessions:
        pics = driver.streams[s["stream"]].record["pictures"]
        if s["unit"] is not None:
            pics = [p for p in pics if p["unit"] == s["unit"]]
        recs += pics[:len(s["returns"])]
    return Context(pictures=window.pictures(), cpu_s=window.cpu_s,
                   phases=window.phases, latencies_s=lat,
                   device_events=window.device_events or [],
                   lo=window.t0, hi=window.t1, picture_records=recs,
                   gc_s=window.gc.seconds if window.gc else None)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def end_to_end(cell, window, setup_s) -> dict:
    _, _, rate = stats.window_rate(window.returns())
    values = {"pictures_per_s": rate, "setup_s": setup_s}
    out = {}
    for m in cell.end_to_end:
        if values.get(m["name"]) is None:
            raise RuntimeError(f"no reading of {m['name']} in this window")
        out[m["name"]] = _metric(values[m["name"]], m["unit"])
    return out


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = _metric(v, m["unit"])
    return out


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else f"nvidia-smi exit {r.returncode}"


def by_stream(window) -> dict:
    """For each stream (and keyframe unit) of the window: sessions run
    to their end, pictures returned, and the median, least and most
    seconds a session took."""
    out = {}
    for s in window.sessions:
        key = s["stream"] if s["unit"] is None else \
            f"{s['stream']}@{s['unit']}"
        out.setdefault(key, {"pictures": 0, "times": []})
        out[key]["pictures"] += len(s["returns"])
        if s["complete"] and not s["error"]:
            out[key]["times"].append(s["end"] - s["start"])
    for v in out.values():
        t = sorted(v.pop("times"))
        v.update(complete=len(t), median_s=t[len(t) // 2] if t else None,
                 min_s=t[0] if t else None, max_s=t[-1] if t else None)
    return out


def merged(verdicts) -> dict:
    out = {}
    for v in verdicts:
        for k, n in v.items():
            out[k] = out.get(k, 0) + n
    return out


def checks_of(verdict) -> dict:
    return {k: {"value": verdict[k], "limit": 0}
            for k in ("mismatched", "missing", "errors")}


def main(argv, t_process: float) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    parts = {"before_torch": time.perf_counter() - t_process}
    import torch
    parts["torch_import"] = time.perf_counter() - t_process - \
        parts["before_torch"]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"this machine has {n}; nothing measured", file=sys.stderr)
        return 3
    t = time.perf_counter()
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    parts["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = prepare(cell)
    parts["program_and_warm_pass"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process

    if args.trace:
        windows = measure_traced(driver, args.seed, args.seconds)
    else:
        windows = [measure(driver, args.seed, args.seconds)]
    window = windows[0]
    if args.trace and not window.device_events:
        print(f"portbench: the profiler returned no device event in "
              f"{len(windows)} traced windows; nothing reported",
              file=sys.stderr)
        return 5
    torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated())

    verdict = merged(judge(w, driver) for w in windows)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict["failed"] == 0 and verdict["errors"] == 0,
              "attempted": verdict["attempted"],
              "failed": verdict["failed"]}
    if args.trace:
        from .devtrace import breakdown
        ctx = context(driver, window)
        result["metrics"] = per_layer(cell, ctx)
        device["busy_s"] = stats.busy_seconds(
            [(a, b) for _, a, b in ctx.device_events], ctx.lo, ctx.hi)
        device["window_s"] = ctx.hi - ctx.lo
        result["device"] = device
        result["breakdown"] = breakdown(ctx.device_events, window.spans,
                                        ctx.lo, ctx.hi)
        result["trace"] = {"windows_taken": len(windows),
                           "kernels_traced": traced_kernels(window),
                           "launches_counted": window.launches,
                           "gc_collections": window.gc.collections}
    else:
        result["metrics"] = end_to_end(cell, window, setup_s)
        result["device"] = device
    result["card"] = nvidia_smi()
    result["host"] = {"cpus": os.cpu_count(), "window_cpu_s": window.cpu_s,
                      "setup_parts_s": parts}
    result["sessions"] = by_stream(window)
    for s in (s for w in windows for s in w.sessions):
        if s["error"]:
            print(f"portbench: session of {s['stream']} failed: "
                  f"{s['error']}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    checks = checks_of(verdict)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(argv, t_process) -> int:
    try:
        return main(argv, t_process)
    except Exception:
        traceback.print_exc()
        return 1


def cache_dirs(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
