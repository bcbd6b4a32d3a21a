"""What a traced run reads: the program's stage timers, the device
profile, and where the device sat idle.

Host stages are `dav1d_tpu_torch.utils.timing` phases, switched on for
the traced window only; each phase is also kept as an interval (label,
start, end, thread) so that an idle stretch of the device can be named
by the host phase that was running. Note that with its timers on the
program synchronises inside its device stages (`ops/device.py`
`sync_if_timed`), so a traced window runs slower than an untraced one
and reports no end-to-end metric.

The device profile is `torch.profiler` with CUDA activity only. Its
clock is tied to the host's by an anchor: one fill of a one-element
tensor, launched at a known host time with the device idle, the first
device event of the trace.
"""
from __future__ import annotations

import gc
import threading
import time
import warnings

from . import stats

# the port's CUDA kernels (dav1d_tpu_torch/csrc/*.cu) as a trace names
# them, by the kernel each wrapper launches (chip_smoke.py KERNEL_NAMES)
PORT_KERNELS = {"deblock": ("deblock_",), "mc_put": ("mc_put_kernel",),
                "mc_comp": ("mc_comp_kernel",),
                "itx_add": ("itx_add_kernel", "itx_wht_kernel"),
                "mc_warp": ("mc_warp_kernel",),
                "mc_obmc": ("mc_obmc_kernel",), "cdef": ("cdef_kernel",),
                "lr_wiener": ("lr_wiener_kernel",),
                "lr_sgr": ("lr_sgr_kernel",),
                "superres": ("superres_kernel",),
                "film_grain": ("film_grain_kernel",),
                "ipred": ("ipred_frame_kernel",)}
FILTER_KERNELS = ("deblock", "cdef", "lr_wiener", "lr_sgr")
BREAKDOWN_N = 10


def kernel_of(name: str):
    """The port kernel a trace event's name is of, or None."""
    for k, keys in PORT_KERNELS.items():
        if any(s in name for s in keys):
            return k
    return None


class PhaseLog:
    """Keeps every timing phase as an interval while installed: wraps
    the timing module's accumulator, which each phase calls at its end
    with its length."""

    def __init__(self, timing, clock=time.perf_counter):
        self.timing = timing
        self.clock = clock
        self.spans = []
        self._orig = None

    def install(self):
        orig = self._orig = self.timing._add
        spans, clock = self.spans, self.clock

        def add(label, dt):
            end = clock()
            spans.append((label, end - dt, end,
                          threading.current_thread().name))
            orig(label, dt)
        self.timing._add = add
        self.timing.reset()
        self.timing.ENABLED = True

    def remove(self) -> dict:
        """Uninstall; returns the phases' seconds, summed over threads."""
        self.timing.ENABLED = False
        self.timing._add = self._orig
        sums = dict(self.timing._T)
        self.timing.reset()
        return sums


class GcLog:
    """Seconds the interpreter spent in its cyclic garbage collector
    while installed (`gc.callbacks`), and the collections, by
    generation."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = self.clock()
        elif self._t0 is not None:
            self.seconds += self.clock() - self._t0
            self.collections[info["generation"]] += 1
            self._t0 = None

    def install(self):
        gc.callbacks.append(self)

    def remove(self):
        gc.callbacks.remove(self)


def thread_kind(name: str) -> str:
    return name.split("_")[0].rstrip("0123456789") or name


def label_gap(gap, spans) -> str:
    """The host phase that overlapped an idle stretch most (the shorter
    on a tie, so a nested phase wins over its parent)."""
    a, b = gap
    best, best_key = "no phase", None
    for label, s, e, thread in spans:
        ov = min(b, e) - max(a, s)
        if ov <= 0:
            continue
        key = (ov, -(e - s))
        if best_key is None or key > best_key:
            best, best_key = f"{label}@{thread_kind(thread)}", key
    return best


def breakdown(device_events, spans, lo, hi) -> dict:
    """device_ops: the device operations that took most time; idle_gaps:
    the longest idle stretches of [lo, hi], by the host phase running."""
    per = {}
    for name, a, b in device_events:
        key = name if len(name) <= 96 else name[:93] + "..."
        per[key] = per.get(key, 0.0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:BREAKDOWN_N]
    idle = sorted(stats.gaps([(a, b) for _, a, b in device_events], lo, hi),
                  key=lambda g: g[0] - g[1])[:BREAKDOWN_N]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[label_gap(g, spans), g[1] - g[0]] for g in idle]}


class DeviceTrace:
    """torch.profiler over a window, its events on the host clock."""

    def __init__(self, torch, clock=time.perf_counter):
        self.torch = torch
        self.clock = clock
        self._x = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.prof = None
        self.anchor_host = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.torch.cuda.synchronize()
        self.anchor_host = self.clock()
        self._x.fill_(1.0)
        self.torch.cuda.synchronize()

    def stop(self) -> list:
        """[(name, start, end)] of every device event after the anchor,
        in host seconds; [] when the trace came back without the anchor
        or without events."""
        self.torch.cuda.synchronize()
        cuda = self.torch.autograd.DeviceType.CUDA
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one
            # cycle here, so nothing is lost
            warnings.simplefilter("ignore", UserWarning)
            self.prof.__exit__(None, None, None)
            evs = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in self.prof.events() if e.device_type == cuda)
        self.prof = None
        anchor = next((i for i, e in enumerate(evs)
                       if "fill" in e[2].lower()), None)
        if anchor is None or anchor + 1 >= len(evs):
            return []
        offset = self.anchor_host - evs[anchor][0] / 1e6
        return [(name, a / 1e6 + offset, b / 1e6 + offset)
                for a, b, name in evs[anchor + 1:]]
