"""Frame-pipeline scheduler: the analog of the reference's
task scheduler + 2-pass frame threading (reference src/thread_task.c,
decode.c frame_thread structs; SURVEY §2.5/§2.7.3-4).

The reference decouples entropy decode (pass 1) from reconstruction
(pass 2) so multiple frames are in flight, with atomic progress
counters gating inter-frame motion compensation. Here the same seam is
exploited with a much simpler invariant: Stage A (symbol decode) of
frame N+1 runs on the submitting thread while Stage B (reconstruction
+ in-loop filters + film grain) of earlier frames runs on up to `depth`
workers, which take frames in submission order. A frame's Stage B
first waits for the REF-READY promise of each of its references, so
the reference's per-sbrow `lowest_pixel` watermark (decode.c:576-682)
collapses to promise resolution. Stage A only needs reference *state*
(headers, CDFs, temporal MVs, segmaps), which the submitting thread
has immediately.

A REF-READY promise resolves when the reference's reconstruction and
filter chain have been *enqueued* on the device, not finished. Every
worker launches on the current stream of the decode's device
(ops/cuda_build.py launch_stream), and no code of the port makes
another stream current, so all workers enqueue onto the device's
default stream: enqueue order is execution order, and a frame's
kernels run after those of its references. Host readers of a
reference's pixels wait for its queued fetch (ops/device.py
fetch_pic_host).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils import timing


class FramePromise:
    """A settable future for a decoded frame with resolve hooks
    (metadata attachment happens at resolution time)."""

    __slots__ = ("_event", "_value", "_exc", "_hooks", "_lock", "_resolved")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None
        self._hooks = []
        self._lock = threading.Lock()
        self._resolved = False

    def set_result(self, value):
        with self._lock:
            self._value = value
            self._resolved = True
            hooks, self._hooks = self._hooks, []
        for fn in hooks:
            fn(value)
        self._event.set()

    def set_exception(self, exc):
        with self._lock:
            self._exc = exc
            self._resolved = True
            self._hooks = []
        self._event.set()

    def add_hook(self, fn):
        """fn(value) runs once at resolution (or immediately if the
        promise already resolved); used to attach parse-time state
        (metadata) to the resolved picture."""
        with self._lock:
            if not self._resolved:
                self._hooks.append(fn)
                return
        if self._exc is None:
            fn(self._value)

    def result(self):
        self._event.wait()
        if self._exc is not None:
            raise self._exc
        return self._value


class _View:
    """Resolves one element of a tuple-valued FramePromise."""

    __slots__ = ("_promise", "_idx")

    def __init__(self, promise, idx):
        self._promise = promise
        self._idx = idx

    def add_hook(self, fn):
        idx = self._idx
        self._promise.add_hook(lambda v: fn(v[idx]))

    def result(self):
        return self._promise.result()[self._idx]


def resolve(pic):
    """Picture-or-promise -> Picture."""
    return pic.result() if hasattr(pic, "result") else pic


def peek(pic):
    """Picture-or-promise -> Picture without waiting: None while a
    promise is pending or when it failed."""
    if isinstance(pic, FramePromise):
        with pic._lock:
            return pic._value if pic._resolved and pic._exc is None \
                else None
    if isinstance(pic, _View):
        base = peek(pic._promise)
        return None if base is None else base[pic._idx]
    return pic


class ReconPipeline:
    """In-order Stage-B worker pool with bounded depth.

    depth=1 reproduces the single in-order worker. depth>=2 keeps
    multiple Stage-B frames in flight (the whole-frame coarsening of
    the reference's n_fc frame contexts, thread_task.c:409-436): frame
    N+1's Stage B starts as soon as a worker frees up and blocks only
    on the REF-READY promise of its reference frames — which resolves
    when frame N's reconstruction+filter chain has been *enqueued* on
    the device (split submit), not when its output fetch / film grain
    finished, so frame N's download and grain ride under frame N+1's
    work. Submission applies backpressure at `depth` frames in flight
    (the reference gates on max_frame_delay the same way,
    lib.c:109-126)."""

    def __init__(self, depth: int = 1):
        self.depth = max(1, depth)
        self._pool = ThreadPoolExecutor(max_workers=self.depth,
                                        thread_name_prefix="stageb")
        self._slots = threading.Semaphore(self.depth)

    def submit(self, job) -> FramePromise:
        """Single-phase submit: promise resolves with job()'s value."""
        promise = FramePromise()
        self._slots.acquire()

        def run():
            try:
                promise.set_result(job())
            except BaseException as e:          # surfaced at result()
                promise.set_exception(e)
            finally:
                self._slots.release()

        self._pool.submit(run)
        return promise

    def submit_split(self, job):
        """Two-phase submit: job() returns (ref_value, finish_fn).
        Returns (ref_promise, out_promise); ref_promise resolves with
        ref_value as soon as phase 1 is done (references may proceed),
        out_promise resolves with finish_fn()'s value."""
        ref_promise = FramePromise()
        out_promise = FramePromise()
        with timing.phase("pipeline.submit_wait"):
            self._slots.acquire()

        def run():
            try:
                ref_value, finish = job()
                ref_promise.set_result(ref_value)
            except BaseException as e:
                ref_promise.set_exception(e)
                out_promise.set_exception(e)
                self._slots.release()
                return
            try:
                out_promise.set_result(finish())
            except BaseException as e:
                out_promise.set_exception(e)
            finally:
                self._slots.release()

        self._pool.submit(run)
        return ref_promise, out_promise

    def view(self, promise, idx):
        return _View(promise, idx)

    def shutdown(self):
        self._pool.shutdown(wait=True)
