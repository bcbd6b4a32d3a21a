"""Lightweight phase timers for the decode hot path.

Enabled by DAV1D_TPU_TIMING=1; otherwise every call is a no-op with
one dict lookup of overhead. `phase(label)` is a context manager that
accumulates wall time; `report()` prints the table (also printed at
process exit when enabled). Device phases should wrap their section so
the accounted time includes the XLA dispatch they trigger; callers that
want compute attributed correctly must block inside the section.

Phases run on the Stage-B workers too. With more than one Stage-B frame
in flight (decoder.stageb_depth > 1) their phases overlap in time, so a
phase's total is a sum over threads and the totals may exceed the wall.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(int(os.environ.get("DAV1D_TPU_TIMING", "0") or "0"))

_T = defaultdict(float)
_N = defaultdict(int)
_LOCK = threading.Lock()        # the Stage-B workers add at once


@contextmanager
def phase(label):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _add(label, time.perf_counter() - t0)


def _add(label, dt):
    with _LOCK:
        _T[label] += dt
        _N[label] += 1


def add(label, dt):
    if ENABLED:
        _add(label, dt)


def report():
    if not _T:
        return
    print(f"\n{'timing phase':32s} {'total_s':>9s} {'count':>6s} "
          f"{'ms/call':>9s}  (summed over threads: Stage-B phases "
          f"overlap at depth > 1)", flush=True)
    for k in sorted(_T, key=lambda k: -_T[k]):
        print(f"{k:32s} {_T[k]:9.3f} {_N[k]:6d} "
              f"{1000 * _T[k] / max(1, _N[k]):9.2f}", flush=True)


def reset():
    _T.clear()
    _N.clear()


if ENABLED:
    atexit.register(report)
