"""The av1-2160p10 configuration's inter layer: its check, its readers
and the least work of its roofline.

On the CPU: a 192x128 10-bit inter stream with the pool's tool mix and
its recorded md5s (a copy of
tests/data/torch_golden/hdr-transcode-192x128.ivf), driven through the
`transcode` mix with the configuration's settings on `device="cpu"`;
the readers of inter Stage B's span, the leftover and upload counters
and the MC roofline on synthetic Contexts and on a window of that
stream; `mc_work`'s least bytes on the two 4K records.
"""
import os

import pytest

from portbench import harness, mc_work, pool, reference, spec
from portbench.devtrace import PhaseLog
from portbench.harness import Context
from test_portbench_check import Faulty

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
STREAM = "hdr-transcode-192x128.ivf"
SEEDS = (2 ** 31 + 21, 2 ** 31 + 22)
READ = spec.metric_reader


def _cell():
    cfg = spec.load_json(os.path.join(spec.HERE, "configs",
                                      "av1-2160p10.json"))
    return spec.Cell(name="small.transcode", chips=1, config=cfg,
                     traffic=spec.load_json(os.path.join(
                         spec.HERE, "traffic", "transcode.json")),
                     end_to_end=[], per_layer=[])


@pytest.fixture(scope="module")
def small():
    return {STREAM: pool.load_stream(STREAM, DATA, DATA)}


def _window(small, seed, fault=None, seconds=1.5):
    driver = harness.prepare(_cell(), device="cpu", streams=small)
    if fault is not None:
        driver.api = Faulty(driver.api, fault)
    return driver, harness.measure(driver, seed, seconds)


def test_program_is_correct_and_control_is_not(small):
    driver, window = _window(small, SEEDS[0])
    verdict = harness.judge(window, driver)
    assert verdict["attempted"] >= 4
    assert (verdict["failed"], verdict["errors"]) == (0, 0)
    # one step below 10 bits: 8 significant bits
    control = harness.judge(window, driver, reference.requantized)
    assert control["mismatched"] >= 1


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_every_fault_fails(small, fault):
    driver, window = _window(small, SEEDS[1], fault)
    assert harness.judge(window, driver)["failed"] >= 1


def test_program_readers_read_a_window(small):
    """The span and counter readers on a window of the program, with
    the recorder on as in a traced run."""
    from dav1d_tpu_torch.utils import timing
    driver = harness.prepare(_cell(), device="cpu", streams=small)
    log = PhaseLog(timing)
    log.install()
    try:
        window = harness.measure(driver, SEEDS[0], 1.5)
    finally:
        window.phases = log.remove()
    ctx = harness.context(driver, window)
    assert ctx.pictures >= 4
    for name in ("inter_ms_per_pic", "inter_tables_ms_per_pic",
                 "leftovers_ms_per_pic", "leftover_blocks_per_pic",
                 "upload_mb_per_pic"):
        assert READ(name)(ctx) > 0, name
    # a quarter of the pictures are keyframes: no more leftovers a
    # picture than an inter frame has blocks
    assert READ("leftover_blocks_per_pic")(ctx) < 192 * 128 / 16


def _ctx(events=(), phases=None, pictures=4, recs=()):
    return Context(pictures=pictures, cpu_s=1.0, phases=phases or {},
                   latencies_s=[], device_events=list(events), lo=0.0,
                   hi=1.0, picture_records=list(recs))


def test_inter_span_reader():
    read = READ("inter_ms_per_pic")
    other = {"stage_a": 2.0, "inter.emit_jobs": 5.0}
    assert read(_ctx(phases={**other, "inter.frame_recon": 0.2})) == \
        pytest.approx(50.0)
    assert read(_ctx(phases=other)) is None
    assert read(_ctx(phases={"inter.frame_recon": 0.2}, pictures=0)) is None


@pytest.mark.parametrize("name,counter,n,want", [
    ("leftover_blocks_per_pic", "inter.leftover_blocks", 6000, 1500.0),
    ("upload_mb_per_pic", "upload.bytes", 30_000_000, 7.5)])
def test_counter_readers(monkeypatch, name, counter, n, want):
    from dav1d_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "_LAST", {"phases": {}, "calls": {},
                                          "counters": {counter: n}})
    read = READ(name)
    assert read(_ctx()) == pytest.approx(want)
    assert read(_ctx(pictures=0)) is None
    # a period without the counter, as on a program that has none
    monkeypatch.setattr(timing, "_LAST", {"phases": {}, "calls": {},
                                          "counters": {"other": 1}})
    assert read(_ctx()) is None
    monkeypatch.delattr(timing, "last")
    assert read(_ctx()) is None


def _pic(frame_type, w=3840, h=2160, bpc=10):
    return {"frame_type": frame_type, "w": w, "h": h, "bpc": bpc,
            "planes": 3, "ss_hor": 1, "ss_ver": 1}


def test_inter_bytes_from_headers():
    assert mc_work.inter_bytes(_pic(1)) == 49_766_400
    assert mc_work.inter_bytes(_pic(3)) == 49_766_400
    assert mc_work.inter_bytes(_pic(0)) == mc_work.inter_bytes(_pic(2)) == 0
    # 8 bits: a byte a sample; odd sizes round the chroma up
    assert mc_work.inter_bytes(_pic(1, 1919, 1079, 8)) == \
        2 * (1919 * 1079 + 2 * 960 * 540)
    assert mc_work.inter_least_seconds([_pic(1), _pic(0)]) == \
        pytest.approx(49_766_400 / 3.35e12)
    assert mc_work.inter_least_seconds([_pic(1)]) * 1e6 == \
        pytest.approx(14.856, abs=1e-3)


@pytest.mark.parametrize("name", ["3840x2160_10b_flt_s33_enc.ivf",
                                  "3840x2160_10b_flt_s11.ivf"])
def test_inter_bytes_of_the_4k_pool(name):
    pics = pool.load_stream(name).record["pictures"]
    assert [mc_work.inter_bytes(p) for p in pics] == [0] + [49_766_400] * 3


def test_mc_roofline_on_a_synthetic_trace():
    pics = [_pic(0), _pic(1), _pic(1)]
    least = mc_work.inter_least_seconds(pics)
    events = [("mc_put_kernel", 0.1, 0.1 + least),
              ("void mc_comp_kernel<10>", 0.2, 0.2 + least),
              ("itx_add_kernel", 0.3, 0.3 + least),
              ("itx_wht_kernel", 0.4, 0.4 + least),
              ("mc_warp_kernel", 0.5, 0.5 + least),
              ("mc_obmc_kernel", 0.95, 1.05),     # half inside the window
              ("cdef_kernel", 0.6, 0.7),
              ("ipred_frame_kernel", 0.7, 0.8),
              ("Memcpy HtoD (Pageable -> Device)", 0.8, 0.9)]
    read = READ("mc_roofline")
    assert read(_ctx(events, recs=pics)) == pytest.approx(
        100 * least / (5 * least + 0.05))
    # no MC kernel in the trace, or no inter picture: nothing
    assert read(_ctx(events[6:], recs=pics)) is None
    assert read(_ctx(events, recs=[_pic(0)])) is None
