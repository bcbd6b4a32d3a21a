"""The program's recorder: phase spans, GC pauses and counters.

Enabled by DAV1D_TPU_TIMING=1 (or by setting ENABLED); otherwise every
call is a no-op with one global lookup of overhead. `phase(label)` is a
context manager that accumulates wall time on `clock`; `count(name, n)`
adds to a counter; `report()` prints both tables (also printed at
process exit when enabled).

Spans time the host only. A device stage's span holds what its thread
did, its launches' enqueue included, and never waits for the device:
device time comes from a device trace, which maps the device's events
onto `clock`.

Every span ends in `_add(label, seconds)`, looked up at call time, so a
caller can wrap that one function to keep each span's start, end and
thread.

While enabled, each thread keeps the stack of its open phases, so a
span knows its parent. A pause of CPython's cyclic garbage collector is
recorded as the phase `gc.<innermost open phase of the collecting
thread>`, or `gc.outside` with none open (a `gc.callbacks` hook,
installed by the first enabled `phase()`). A collection can start
inside `_add` or `count` while its thread holds the module's lock, so
the hook never takes it: it keeps the pause on its thread, and the
thread hands it to `_add` at its next phase boundary (a span log places
the pause there, with its own length).

`reset()` closes a recording period: its phase totals, call counts and
counters stay readable through `last()`, and the live ones start anew.

Phases run on the tile threads and the Stage-B workers too. Where
threads overlap in time, a phase's total is a sum over threads and the
totals may exceed the wall.
"""
from __future__ import annotations

import atexit
import gc
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(int(os.environ.get("DAV1D_TPU_TIMING", "0") or "0"))

clock = time.perf_counter       # every span's clock

_T = defaultdict(float)         # phase -> seconds, summed over threads
_N = defaultdict(int)           # phase -> calls
_C = defaultdict(int)           # counter -> count
_LOCK = threading.Lock()        # the tile threads and Stage-B workers add at once
_LAST = {"phases": {}, "calls": {}, "counters": {}}
_period = 0                     # reset() count: a pause is handed over in its own
_local = threading.local()      # .stack: open phases; .pauses: (period, label, s)
_gc_hooked = False
_gc_t0 = None


def _thread_state():
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.pauses = [], []
        return _local.stack


def _on_gc(step, info):
    """gc.callbacks hook: keeps each collection's pause on its thread
    (never takes _LOCK: the collection may have started under it)."""
    global _gc_t0
    if not ENABLED:
        return
    if step == "start":
        _gc_t0 = clock()
    elif _gc_t0 is not None:
        dt = clock() - _gc_t0
        _gc_t0 = None
        stack = _thread_state()
        _local.pauses.append(
            (_period, "gc." + (stack[-1] if stack else "outside"), dt))


def _hook_gc():
    global _gc_hooked
    with _LOCK:
        if not _gc_hooked:
            gc.callbacks.append(_on_gc)
            _gc_hooked = True


def _hand_over():
    """This thread's kept GC pauses of the current period, to _add (a
    collection inside _add keeps its pause for the next boundary)."""
    done, _local.pauses = _local.pauses, []
    for period, label, dt in done:
        if period == _period:
            _add(label, dt)


@contextmanager
def phase(label):
    if not ENABLED:
        yield
        return
    if not _gc_hooked:
        _hook_gc()
    stack = _thread_state()
    _hand_over()
    stack.append(label)
    t0 = clock()
    try:
        yield
    finally:
        dt = clock() - t0
        stack.pop()
        _add(label, dt)
        _hand_over()


def _add(label, dt):
    with _LOCK:
        _T[label] += dt
        _N[label] += 1


def count(name, n=1):
    """Add n to the counter `name` (once a tile or a frame, not a block)."""
    if ENABLED:
        with _LOCK:
            _C[name] += n


def report():
    if not _T and not _C:
        return
    print(f"\n{'timing phase':32s} {'total_s':>9s} {'count':>6s} "
          f"{'ms/call':>9s}  (summed over threads)", flush=True)
    for k in sorted(_T, key=lambda k: -_T[k]):
        print(f"{k:32s} {_T[k]:9.3f} {_N[k]:6d} "
              f"{1000 * _T[k] / max(1, _N[k]):9.2f}", flush=True)
    if _C:
        print(f"\n{'counter':32s} {'count':>12s}", flush=True)
        for k in sorted(_C):
            print(f"{k:32s} {_C[k]:12d}", flush=True)


def reset():
    """Close the recording period: its phase totals, call counts and
    counters become last()'s, and the live ones are cleared."""
    global _LAST, _period
    with _LOCK:
        _LAST = {"phases": dict(_T), "calls": dict(_N),
                 "counters": dict(_C)}
        _T.clear()
        _N.clear()
        _C.clear()
        _period += 1


def last() -> dict:
    """The last closed period: {"phases": seconds, "calls": calls,
    "counters": counts}, each by name."""
    return _LAST


if ENABLED:
    atexit.register(report)
