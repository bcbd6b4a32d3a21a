"""The port's Stage-B frame pipeline depth (ROADMAP item 7) on the CPU.

- the depth rule: the port's decoder.stageb_depth against dav1d_tpu's
  (its decoder.py: 3 on the device backend, 1 on the golden host route,
  Settings.max_frame_delay caps, DAV1D_TPU_STAGEB_DEPTH overrides), with
  the port's own DEFAULT_STAGEB_DEPTH in place of dav1d_tpu's 3;
- the counterpart of tests/test_thread_invariance.py: its generated
  192x128 tiled stream (seed 21) through the port at n_threads {1, 2, 4}
  x max_frame_delay {0, 3} and at DAV1D_TPU_STAGEB_DEPTH 2 and 4, each
  picture's md5 equal to dav1d_tpu's Settings(n_threads=1) (its golden
  numpy path, which its own tests hold equal to its device backend);
- frames forced to overlap and to finish out of order at depth 3
  (seeded sleeps in the filter chain and the film grain, the first
  grained frame held until a later one is done): the same md5s;
- committed golden streams at depth 3 and a mesh stream on a CPU mesh
  at depth 2, on their recorded md5s;
- the pipeline itself: depth frames in Stage B at once, backpressure at
  the depth, a failure raised through both promises;
- one test for each race repaired for depth > 1: a picture's output
  fetch from several threads at once, a reference's upload from several
  workers at once, a reader of a reference's device planes while the
  caller's thread drops them (release_device_planes), the grain LUT
  memo, the launch counters and the stage timers.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dav1d_tpu.decoder import ObuStreamDecoder as JaxDecoder
from dav1d_tpu.api import Settings as JaxSettings
from dav1d_tpu_torch import decoder as port_decoder
from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.ops import cuda_build, device, fg
from dav1d_tpu_torch.parallel import executor
from dav1d_tpu_torch.parallel.sharded import Mesh
from dav1d_tpu_torch.recon import filters, sharded_stageb
from dav1d_tpu_torch.recon.picture import Picture
from dav1d_tpu_torch.utils import timing
from dav1d_tpu_torch.utils.muxers import Md5Muxer
from tools.streamgen.gen import generate_stream

import chip_smoke
from torch_port_cases import GOLDEN_DIR, golden_md5s

CPU = torch.device("cpu")
TIMEOUT = 30            # seconds any wait of a test may take


def _data(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        return fh.read()


def _decode(data, **settings):
    """The port's decode on the CPU through the public API, every unit
    sent before the pictures are drained (so api.get_picture parses
    ahead while earlier frames are in Stage B): per-picture md5s and the
    depth of its Stage-B pipeline (None without one)."""
    dec = Decoder(Settings(device="cpu", **settings))
    for fr in IvfReader(data):
        dec.send_data(fr.data)
    out = []
    for pic in dec.pictures():
        m = Md5Muxer()
        m.write_picture(pic)
        out.append(m.digest())
    pipe = dec._dec.pipeline
    dec.close()
    return out, None if pipe is None else pipe.depth


# ---------------------------------------------------------------------------
# the depth rule
# ---------------------------------------------------------------------------

def _depths(monkeypatch, n_threads, mfd, env, golden):
    """(port depth, dav1d_tpu depth) of decoders built from the same
    Settings under the same switches."""
    if env is None:
        monkeypatch.delenv("DAV1D_TPU_STAGEB_DEPTH", raising=False)
    else:
        monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", env)
    if golden:
        monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    else:
        monkeypatch.delenv("DAV1D_TPU_BACKEND", raising=False)
    port = port_decoder.ObuStreamDecoder(settings=Settings(
        device="cpu", n_threads=n_threads, max_frame_delay=mfd))
    jax = JaxDecoder(settings=JaxSettings(n_threads=n_threads,
                                          max_frame_delay=mfd))
    depth = [None if d.pipeline is None else d.pipeline.depth
             for d in (port, jax)]
    for d in (port, jax):
        if d.pipeline is not None:
            d.pipeline.shutdown()
    return depth


RULE_CASES = [(mfd, env, golden) for golden in (False, True)
              for env in (None, "1", "2", "4", "0")
              for mfd in (0, 1, 2, 3, 4)]


@pytest.mark.parametrize("mfd,env,golden", RULE_CASES)
def test_depth_rule_is_dav1d_tpus(monkeypatch, mfd, env, golden):
    """With dav1d_tpu's default (3) in place of the port's constant,
    the port picks dav1d_tpu's depth for every max_frame_delay, every
    DAV1D_TPU_STAGEB_DEPTH and both routes."""
    monkeypatch.setattr(port_decoder, "DEFAULT_STAGEB_DEPTH", 3)
    port, jax = _depths(monkeypatch, 2, mfd, env, golden)
    assert port == jax


@pytest.mark.parametrize("mfd", [0, 1, 2, 3, 4])
def test_depth_rule_with_the_measured_default(monkeypatch, mfd):
    """The device route's default is DEFAULT_STAGEB_DEPTH, capped by
    max_frame_delay; the golden route keeps one worker; one thread has
    no pipeline at all."""
    default = port_decoder.DEFAULT_STAGEB_DEPTH
    want = default if mfd == 0 else max(1, min(default, mfd))
    assert _depths(monkeypatch, 4, mfd, None, False)[0] == want
    assert _depths(monkeypatch, 4, mfd, None, True)[0] == 1
    assert _depths(monkeypatch, 1, mfd, None, False)[0] is None


def test_depth_variable_overrides(monkeypatch):
    assert port_decoder.stageb_depth(1, False) == 1
    monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", "4")
    assert port_decoder.stageb_depth(1, False) == 4
    assert port_decoder.stageb_depth(0, True) == 4
    monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", "-3")
    assert port_decoder.stageb_depth(4, False) == 1


# ---------------------------------------------------------------------------
# md5s at every depth and thread setting
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiled_stream():
    """tests/test_thread_invariance.py's stream and dav1d_tpu's
    per-picture md5s of it at Settings(n_threads=1)."""
    data, _ = generate_stream(192, 128, n_frames=5, seed=21,
                              tile_log2_cols=1, tile_log2_rows=1)
    with pytest.MonkeyPatch.context() as mp:
        want = golden_md5s(data, mp)
    return data, want


@pytest.mark.parametrize("n_threads,delay,env", [
    (1, 0, None), (2, 0, None), (4, 0, None),
    (1, 3, None), (2, 3, None), (4, 3, None),
    (4, 0, "2"), (4, 4, "4")])
def test_md5s_invariant_across_depths(tiled_stream, monkeypatch, n_threads,
                                      delay, env):
    data, want = tiled_stream
    if env is not None:
        monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", env)
    got, depth = _decode(data, n_threads=n_threads, max_frame_delay=delay)
    assert got == want
    if n_threads > 1:
        assert depth == port_decoder.stageb_depth(delay, False)


@pytest.mark.parametrize("name", ["lo-base", "fg-inter"])
def test_golden_streams_at_depth_3(monkeypatch, name):
    monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", "3")
    recorded = {**chip_smoke.LO_STREAMS, **chip_smoke.POST_FILTERS}
    got, depth = _decode(_data(name), n_threads=4, max_frame_delay=3)
    assert depth == 3
    assert got == recorded[name][0]


def test_mesh_stream_at_depth_2(monkeypatch):
    """mesh-inter-256x128 column-sharded over 2 CPU shards (the mesh of
    tests/test_torch_sharded.py) with two frames in Stage B."""
    monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", "2")
    name = "mesh-inter-256x128"
    mesh = Mesh(np.array([CPU] * 2, dtype=object), ("tile",))
    dec = Decoder(Settings(device="cpu", n_threads=2, max_frame_delay=2,
                           sharding_mesh=mesh))
    whole = Md5Muxer()
    for fr in IvfReader(_data(name)):
        dec.send_data(fr.data)
    for pic in dec.pictures():
        whole.write_picture(pic)
    assert dec._dec.pipeline.depth == 2
    dec.close()
    assert whole.digest() == chip_smoke.MESH_MD5S[name]


def test_forced_overlap_keeps_md5s(monkeypatch):
    """fg-inter at depth 3 with seeded random sleeps in the filter chain
    and the film grain, and the first grained frame's grain held until a
    later frame's is done: frames overlap in Stage B and finish out of
    order, and every picture keeps its recorded md5."""
    monkeypatch.setenv("DAV1D_TPU_STAGEB_DEPTH", "3")
    rng = np.random.default_rng(1717)
    lock = threading.Lock()
    state = {"active": 0, "most": 0, "done": [], "grains": 0}
    later_done = threading.Event()
    chain = filters.run_filter_chain_device
    grain = port_decoder.ObuStreamDecoder._apply_grain

    def nap(hi):
        with lock:
            t = rng.uniform(0, hi)
        time.sleep(t)

    def enter():
        with lock:
            state["active"] += 1
            state["most"] = max(state["most"], state["active"])

    def leave():
        with lock:
            state["active"] -= 1

    def slow_chain(*a, **k):
        enter()
        try:
            nap(0.05)
            return chain(*a, **k)
        finally:
            leave()

    def slow_grain(self, pic, fh, seq):
        with lock:
            first = state["grains"] == 0
            state["grains"] += 1
        enter()
        try:
            if first:
                assert later_done.wait(TIMEOUT), \
                    "no later frame finished while the first was held"
            nap(0.05)
            out = grain(self, pic, fh, seq)
        finally:
            leave()
        with lock:
            state["done"].append(fh.frame_offset)
        if not first:
            later_done.set()
        return out
    monkeypatch.setattr(filters, "run_filter_chain_device", slow_chain)
    monkeypatch.setattr(port_decoder.ObuStreamDecoder, "_apply_grain",
                        slow_grain)
    got, depth = _decode(_data("fg-inter"), n_threads=4, max_frame_delay=3)
    assert depth == 3
    assert got == chip_smoke.POST_FILTERS["fg-inter"][0]
    assert state["most"] >= 2
    assert state["done"] != sorted(state["done"])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_runs_depth_frames_at_once():
    """At depth 3 three jobs are in phase 1 together, and a fourth
    submit waits for a slot."""
    pipe = executor.ReconPipeline(3)
    together = threading.Barrier(3, timeout=TIMEOUT)
    release = threading.Event()

    def job(i):
        def run():
            if i < 3:
                together.wait()
                assert release.wait(TIMEOUT)
            return i, lambda: i
        return run
    promises = [pipe.submit_split(job(i)) for i in range(3)]
    fourth = []
    t = threading.Thread(target=lambda: fourth.append(
        pipe.submit_split(job(3))))
    t.start()
    t.join(0.2)
    assert t.is_alive()          # held at the depth
    release.set()
    t.join(TIMEOUT)
    assert not t.is_alive()
    for i, (ref, out) in enumerate(promises + fourth):
        assert ref.result() == i and out.result() == i
    pipe.shutdown()


def test_pipeline_failure_raises_through_both_promises():
    pipe = executor.ReconPipeline(2)

    def bad():
        raise ValueError("stage b failed")
    ref, out = pipe.submit_split(bad)
    with pytest.raises(ValueError):
        ref.result()
    with pytest.raises(ValueError):
        out.result()
    ok_ref, ok_out = pipe.submit_split(lambda: (1, lambda: 2))
    assert (ok_ref.result(), ok_out.result()) == (1, 2)
    pipe.shutdown()


# ---------------------------------------------------------------------------
# the races repaired for depth > 1
# ---------------------------------------------------------------------------

def _picture():
    pic = Picture(64, 32, 1, 8)
    rng = np.random.default_rng(3)
    hosts = [torch.from_numpy(rng.integers(0, 256, p.shape, np.uint8))
             for p in pic.planes]
    pic.pending_fetch = (hosts, None)
    pic.host_stale = True
    return pic, [h.numpy() for h in hosts]


def _together(n, fn):
    """fn() on n threads released at once; their results."""
    start = threading.Barrier(n, timeout=TIMEOUT)
    out = [None] * n

    def run(i):
        start.wait()
        out[i] = fn()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return out


def test_fetch_once_from_several_threads(monkeypatch):
    pic, want = _picture()
    calls = []
    materialize = device._materialize

    def slow(p, pending):
        calls.append(1)
        time.sleep(0.05)
        materialize(p, pending)
    monkeypatch.setattr(device, "_materialize", slow)
    _together(8, lambda: device.fetch_pic_host(pic))
    assert len(calls) == 1
    assert pic.pending_fetch is None and not pic.host_stale
    for hp, w in zip(pic.planes, want):
        np.testing.assert_array_equal(hp, w)


def test_reference_uploaded_once_from_several_workers(monkeypatch):
    pic, want = _picture()
    calls = []
    upload = device.upload_planes

    def slow(planes, dev):
        calls.append(1)
        time.sleep(0.05)
        return upload(planes, dev)
    monkeypatch.setattr(device, "upload_planes", slow)
    got = _together(8, lambda: device.planes_on_device(pic, CPU))
    assert len(calls) == 1
    assert all(g is got[0] for g in got) and pic.dev is got[0]
    for t, w in zip(got[0], want):
        np.testing.assert_array_equal(t.numpy(), w)


class _DroppedAfterRead(Picture):
    """A picture whose device planes the caller's thread drops
    (decoder.release_device_planes) right after a reader's first look
    at them."""
    __slots__ = ("_planes",)

    @property
    def dev(self):
        planes, self._planes = self._planes, None
        return planes

    @dev.setter
    def dev(self, planes):
        self._planes = planes


@pytest.mark.parametrize("reader", ["planes_on_device", "ref_planes_on"])
def test_reader_keeps_its_snapshot_of_dropped_planes(reader):
    pic = _DroppedAfterRead(64, 32, 1, 8)
    planes = [torch.full(p.shape, 7, dtype=torch.int32)
              for p in pic.planes]
    pic.dev = planes
    got = device.planes_on_device(pic, CPU) if reader == \
        "planes_on_device" else sharded_stageb.ref_planes_on(pic, CPU, CPU)
    assert got is planes


def test_release_skips_frames_in_flight():
    """release_device_planes keeps a frame still in Stage B (pending
    promise), a picture whose host planes are stale and one a ref slot
    holds; it drops the planes of a fetched picture no slot holds."""
    dec = port_decoder.ObuStreamDecoder(do_recon=False)
    pending = executor.FramePromise()
    dec.refs[0].pic = pending
    dec.release_device_planes(pending)          # pending: nothing read
    stale, _ = _picture()
    stale.dev = [torch.zeros(1)]
    dec.release_device_planes(stale)
    assert stale.dev is not None
    held, _ = _picture()
    device.fetch_pic_host(held)
    held.dev = [torch.zeros(1)]
    dec.refs[1].pic = held
    dec.release_device_planes(held)
    assert held.dev is not None
    dec.refs[1].pic = None
    dec.release_device_planes(held)
    assert held.dev is None and held.dev_rep is None


def test_grain_tables_made_once(monkeypatch):
    from dav1d_tpu_torch.bitstream.headers import FilmGrainData
    fgd = FilmGrainData(seed=4242, num_y_points=2,
                        y_points=[(0, 64), (255, 96)], scaling_shift=8,
                        ar_coeff_shift=6)
    calls = []
    data = fg._grain_data

    def slow(*a):
        calls.append(1)
        time.sleep(0.05)
        return data(*a)
    monkeypatch.setattr(fg, "_grain_data", slow)
    monkeypatch.setattr(fg, "_DEVICE_CACHE", {})
    got = _together(6, lambda: fg.grain_tables(fgd, 1, 1, 8, CPU))
    assert len(calls) == 1
    assert all(g is got[0] for g in got)


def _hammer(fn, threads=16, n=4000):
    """fn() n times on each of `threads` threads (more than the cores),
    with the interpreter switching threads as often as it can."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(threads, lambda: [fn() for _ in range(n)])
    finally:
        sys.setswitchinterval(old)
    return threads * n


def test_launch_counts_exact_across_threads():
    counts = {"k": 0}
    n = _hammer(lambda: cuda_build.count_launch(counts, "k"))
    assert counts["k"] == n


def test_stage_timers_exact_across_threads(monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", True)
    monkeypatch.setattr(timing, "_T", timing.defaultdict(float))
    monkeypatch.setattr(timing, "_N", timing.defaultdict(int))
    monkeypatch.setattr(timing, "_C", timing.defaultdict(int))

    def both():
        timing.count("x", 2)
        with timing.phase("y"):
            pass
    n = _hammer(both, n=1000)
    assert timing._N["y"] == n
    assert timing._C["x"] == 2 * n
