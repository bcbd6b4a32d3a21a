"""The port's recorder (`dav1d_tpu_torch/utils/timing.py`) and what it
records on the decode path, on the CPU.

- the recorder: its clock, the per-thread stack of open phases, GC
  pauses named by the phase they interrupted (inside a phase, outside
  any, a collection inside `_add` or `count` while the lock is held),
  counters and `last()` across recording periods, nothing recorded and
  no hook installed while it is off, the counters in `report()`, and
  portbench's PhaseLog wrapped around it;
- Stage A on a 2x2-tile stream at n_threads 4: each Stage A span
  fires, the `stage_a.objects` counter equals the plans' Block and
  CoefBlock objects, the API and pipeline spans fire, every frame of a
  decode on the device route is counted in `stage_a.lazy_frames`, and
  the pictures are the same with the recorder on and off;
- the `stage_a.objects` count of each keyframe of the benchmark's
  1080p pool (portbench's av1-1080p8 streams), recorded here;
- the readers of the per-layer metrics that read these spans and
  counters (`portbench/metrics/`), on a synthetic Context, and None
  where a program lacks them.
"""
import gc
import threading
import time
from collections import defaultdict

import pytest

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.decoder import ObuStreamDecoder
from dav1d_tpu_torch.utils import timing
from dav1d_tpu_torch.utils.muxers import Md5Muxer
from portbench import spec
from portbench.devtrace import PhaseLog
from portbench.harness import Context
from portbench.pool import load_stream
from tools.streamgen.gen import generate_stream

from torch_port_cases import rec  # noqa: F401 (fixture)

TIMEOUT = 30            # seconds any wait of a test may take


@pytest.fixture
def manual_gc():
    """Only the test's own gc.collect() calls collect."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def _run(fn):
    """fn() on a thread of its own, which must end within TIMEOUT."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_run_on_perf_counter():
    """portbench maps device events onto time.perf_counter."""
    assert timing.clock is time.perf_counter


def test_nesting_and_parent_stacks_across_threads(rec, manual_gc):
    """Each thread has its own stack of open phases: a collection is
    named by its own thread's innermost phase, whatever the other
    thread has open at that moment."""
    step = threading.Barrier(2, timeout=TIMEOUT)   # the threads in turns
    stacks = {}

    def a():
        with timing.phase("a"):
            with timing.phase("a.b"):
                step.wait()                 # both open
                stacks["a"] = list(timing._local.stack)
                gc.collect()
                step.wait()
                step.wait()                 # b has collected
            gc.collect()

    def b():
        with timing.phase("b"):
            step.wait()
            stacks["b"] = list(timing._local.stack)
            step.wait()                     # a has collected
            gc.collect()
            step.wait()
        stacks["b_after"] = list(timing._local.stack)

    threads = [threading.Thread(target=f, daemon=True) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert stacks == {"a": ["a", "a.b"], "b": ["b"], "b_after": []}
    assert timing._N["a"] == timing._N["a.b"] == timing._N["b"] == 1
    assert timing._T["a"] >= timing._T["a.b"] > 0
    for label in ("gc.a.b", "gc.a", "gc.b"):
        assert timing._N[label] >= 1 and timing._T[label] > 0
    assert "gc.outside" not in timing._T


def test_gc_inside_a_phase_and_outside_any(rec, manual_gc):
    with timing.phase("work"):
        gc.collect()
    assert timing._N["gc.work"] >= 1
    gc.collect()                  # no phase open: kept until a boundary
    assert "gc.outside" not in timing._T
    with timing.phase("next"):
        pass
    assert timing._N["gc.outside"] >= 1 and timing._T["gc.outside"] > 0


class _CollectsOnce(defaultdict):
    """A table whose first store runs a collection (under _LOCK)."""
    armed = True

    def __setitem__(self, key, value):
        if self.armed:
            self.armed = False
            gc.collect()
        super().__setitem__(key, value)


@pytest.mark.parametrize("table", ["_T", "_C"])
def test_a_collection_under_the_lock_is_kept(rec, monkeypatch, table):
    """A collection that starts inside _add or count, with the lock
    held, neither deadlocks nor is lost: it is handed to _add when the
    phase it interrupted closes."""
    kind = float if table == "_T" else int
    monkeypatch.setattr(timing, table, _CollectsOnce(kind))

    def work():
        with timing.phase("outer"):
            with timing.phase("inner"):
                pass                      # inner's _add collects
            timing.count("n")             # or count does
    _run(work)
    assert not getattr(timing, table).armed
    assert timing._N["gc.outer"] >= 1
    assert timing._N["inner"] == timing._N["outer"] == 1


def test_count_and_last_across_two_resets(rec):
    timing.count("x")
    timing.count("x", 4)
    with timing.phase("p"):
        pass
    timing.reset()
    first = timing.last()
    assert first["counters"] == {"x": 5}
    assert first["calls"] == {"p": 1} and first["phases"]["p"] > 0
    assert not timing._C and not timing._T and not timing._N
    timing.count("y", 2)
    timing.reset()
    assert timing.last() == {"phases": {}, "calls": {},
                             "counters": {"y": 2}}
    assert first["counters"] == {"x": 5}        # the earlier period's


def test_a_pause_of_a_closed_period_is_dropped(rec, manual_gc):
    gc.collect()                  # outside any phase: kept ...
    timing.reset()                # ... past the end of its period
    with timing.phase("p"):
        pass
    assert "gc.outside" not in timing._T


def _unhook():
    while timing._on_gc in gc.callbacks:
        gc.callbacks.remove(timing._on_gc)


def test_nothing_recorded_or_installed_while_off(rec, monkeypatch):
    hooked = timing._on_gc in gc.callbacks
    monkeypatch.setattr(timing, "ENABLED", False)
    monkeypatch.setattr(timing, "_gc_hooked", False)
    _unhook()
    try:
        with timing.phase("p"):
            timing.count("c")
            gc.collect()
        assert timing._on_gc not in gc.callbacks
        gc.callbacks.append(timing._on_gc)     # installed, but off
        gc.collect()
        _unhook()
        assert not getattr(timing._local, "pauses", [])
        assert not getattr(timing._local, "stack", [])
        assert not timing._T and not timing._N and not timing._C
        monkeypatch.setattr(timing, "ENABLED", True)
        with timing.phase("p"):               # the first enabled phase
            pass
        assert timing._gc_hooked and gc.callbacks.count(timing._on_gc) == 1
    finally:
        _unhook()
        if hooked:
            gc.callbacks.append(timing._on_gc)


def test_report_prints_the_counters(rec, capsys):
    with timing.phase("stage"):
        timing.count("things", 7)
    timing.report()
    out = capsys.readouterr().out
    assert "stage" in out and "things" in out and " 7" in out


def test_phaselog_window_is_the_period(monkeypatch):
    """portbench's PhaseLog (unchanged) around the recorder: after
    remove(), last() holds that window's phases and counters, and the
    GC pauses are spans of the log with their thread."""
    for name, kind in (("_T", float), ("_N", int), ("_C", int)):
        monkeypatch.setattr(timing, name, defaultdict(kind))
    monkeypatch.setattr(timing, "_LAST", dict(timing._LAST))
    monkeypatch.setattr(timing, "_period", timing._period)
    monkeypatch.setattr(timing, "_local", threading.local())
    monkeypatch.setattr(timing, "ENABLED", False)
    orig_add = timing._add
    log = PhaseLog(timing)
    log.install()
    try:
        with timing.phase("stage_a"):
            with timing.phase("stage_a.materialize"):
                timing.count("stage_a.objects", 3)
                gc.collect()
    finally:
        sums = log.remove()
    assert timing._add is orig_add and not timing.ENABLED
    last = timing.last()
    assert last["phases"] == sums
    assert last["counters"] == {"stage_a.objects": 3}
    labels = {s[0] for s in log.spans}
    assert {"stage_a", "stage_a.materialize",
            "gc.stage_a.materialize"} <= labels
    assert all(s[3] == threading.current_thread().name for s in log.spans)


# ---------------------------------------------------------------------------
# the decode path
# ---------------------------------------------------------------------------

STAGE_A_SPANS = ("stage_a", "stage_a.tile_parse", "stage_a.tiles_wait",
                 "stage_a.materialize")


@pytest.fixture(scope="module")
def tiled():
    data, _ = generate_stream(192, 128, n_frames=3, seed=21,
                              tile_log2_cols=1, tile_log2_rows=1)
    return data


def test_stage_a_spans_and_object_count(rec, tiled):
    dec = ObuStreamDecoder(do_recon=False,
                           settings=Settings(device="cpu", n_threads=4))
    plans = [p for fr in IvfReader(tiled)
             for p in dec.decode_temporal_unit(fr.data)]
    frames = len(plans)
    assert frames == 3 and all(p.f.frame_hdr.tiling.cols == 2 and
                               p.f.frame_hdr.tiling.rows == 2
                               for p in plans)
    assert timing._N["stage_a"] == timing._N["stage_a.tiles_wait"] == \
        timing._N["stage_a.materialize"] == frames
    assert timing._N["stage_a.tile_parse"] == 4 * frames
    assert all(timing._T[k] > 0 for k in STAGE_A_SPANS)
    assert timing._C["stage_a.objects"] == \
        sum(len(p.blocks) + len(p.coefs) for p in plans)


def _md5s(data):
    dec = Decoder(Settings(device="cpu", n_threads=4))
    for fr in IvfReader(data):
        dec.send_data(fr.data)
    out = []
    for pic in dec.pictures():
        m = Md5Muxer()
        m.write_picture(pic)
        out.append(m.digest())
    dec.close()
    return out


def test_pictures_equal_with_the_recorder_on_and_off(rec, monkeypatch,
                                                     tiled):
    on = _md5s(tiled)
    for k in STAGE_A_SPANS + ("api.open", "api.close", "api.wait",
                              "pipeline.submit_wait", "pipeline.ref_wait"):
        assert timing._N[k] >= 1, k
    # every frame on the device route is lazy: the counter fires, and
    # reads 0 where no fallback built an object
    assert "stage_a.objects" in timing._C
    assert timing._C["stage_a.lazy_frames"] == 3
    monkeypatch.setattr(timing, "ENABLED", False)
    n = dict(timing._N)
    assert _md5s(tiled) == on and len(on) == 3
    assert dict(timing._N) == n


# the Block and CoefBlock objects of each keyframe of portbench's
# av1-1080p8 pool (its seek cell's requests): stage_a_objects_per_pic
# lies between the least and the most
POOL_KEYFRAME_OBJECTS = {"1920x1080_8b_flt_s31_enc.ivf": 27139,
                         "1920x1080_8b_flt_s7.ivf": 18536,
                         "1920x1080_8b_flt_s21_realistic.ivf": 27999}


@pytest.mark.parametrize("name", sorted(POOL_KEYFRAME_OBJECTS))
def test_pool_keyframe_objects(rec, name):
    stream = load_stream(name)
    assert stream.record["key_units"] == [0]
    dec = ObuStreamDecoder(do_recon=False,
                           settings=Settings(device="cpu", n_threads=4))
    (plan,) = dec.decode_temporal_unit(stream.units[0])
    n = len(plan.blocks) + len(plan.coefs)
    assert timing._C["stage_a.objects"] == n == POOL_KEYFRAME_OBJECTS[name]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _ctx(phases, pictures=4):
    return Context(pictures=pictures, cpu_s=1.0, phases=phases,
                   latencies_s=[], device_events=[], lo=0.0, hi=1.0,
                   picture_records=[])


SPAN_READERS = [
    ("stage_a_parse_ms_per_pic", {"stage_a.tile_parse": 0.4}, 100.0),
    ("stage_a_tiles_wait_ms_per_pic", {"stage_a.tiles_wait": 0.08}, 20.0),
    ("stage_a_materialize_ms_per_pic", {"stage_a.materialize": 1.0},
     250.0),
    ("stage_a_gc_ms_per_pic", {"gc.stage_a": 0.1,
                               "gc.stage_a.materialize": 0.5,
                               "gc.stage_a.tile_parse": 0.2,
                               "gc.stage_ab": 9.0, "gc.outside": 9.0,
                               "gc.filters.cdef": 9.0}, 200.0),
    ("api_wait_ms_per_pic", {"api.wait": 0.24}, 60.0),
    ("session_ms_per_pic", {"api.open": 0.1, "api.close": 0.3}, 100.0),
]


@pytest.mark.parametrize("name,phases,want", SPAN_READERS)
def test_span_reader(name, phases, want):
    read = spec.metric_reader(name)
    other = {"stage_a": 2.0, "intra.frame_recon": 0.1}
    assert read(_ctx({**other, **phases})) == pytest.approx(want)
    assert read(_ctx(other)) is None
    assert read(_ctx({**other, **phases}, pictures=0)) is None


def test_counter_reader(rec, monkeypatch):
    read = spec.metric_reader("stage_a_objects_per_pic")
    timing.count("stage_a.objects", 98232)
    timing.reset()
    assert read(_ctx({})) == pytest.approx(24558.0)
    assert read(_ctx({}, pictures=0)) is None
    timing.reset()                          # a period without the counter
    assert read(_ctx({})) is None
    monkeypatch.delattr(timing, "last")     # a program without last()
    assert read(_ctx({})) is None
