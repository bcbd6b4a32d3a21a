"""The schedule and the metric arithmetic, on synthetic data."""
import itertools

import pytest

from portbench import devtrace, schedule, stats, work
from portbench.harness import Context

BIG_SEED = 2 ** 31 + 987654321


@pytest.mark.parametrize("n_items", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, -3])
def test_schedule_shares_equal_within_one(n_items, seed):
    items = [f"s{i}" for i in range(n_items)]
    drawn = list(itertools.islice(schedule.cycles(items, seed), 200))
    for k in range(1, len(drawn) + 1):
        counts = [drawn[:k].count(x) for x in items]
        assert max(counts) - min(counts) <= 1, (k, counts)


def test_schedule_differs_between_seeds_and_repeats_within_one():
    items = ["a", "b", "c", "d"]
    first = list(itertools.islice(schedule.cycles(items, BIG_SEED), 40))
    again = list(itertools.islice(schedule.cycles(items, BIG_SEED), 40))
    other = list(itertools.islice(schedule.cycles(items, BIG_SEED + 1), 40))
    assert first == again
    assert first != other
    assert sorted(first) == sorted(other)


def test_schedule_refuses_an_empty_pool():
    with pytest.raises(ValueError):
        next(schedule.cycles([], 1))


def test_window_rate_counts_returns_after_the_first():
    n, span, rate = stats.window_rate([10.0, 10.5, 11.0, 12.0])
    assert (n, span) == (3, 2.0)
    assert rate == pytest.approx(1.5)
    assert stats.window_rate([1.0])[2] is None


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([], 90) is None


def test_union_gaps_and_idle_share():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (8.0, 7.0)]
    assert stats.union(iv) == [(1.0, 3.0), (5.0, 6.0)]
    assert stats.busy_seconds(iv, 0.0, 10.0) == pytest.approx(3.0)
    assert stats.busy_seconds(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]
    assert stats.idle_share_pct(iv, 0.0, 10.0) == pytest.approx(70.0)
    assert stats.idle_share_pct([], 0.0, 10.0) == pytest.approx(100.0)


def test_roofline_is_none_without_a_measurement():
    assert stats.roofline_pct(1.0, 4.0) == pytest.approx(25.0)
    assert stats.roofline_pct(1.0, 0.0) is None
    assert stats.roofline_pct(0.0, 1.0) is None


def _pic(w, h, bpc, lr=(1, 2, 2), deblock=(1, 1, 1), cdef=(1, 1, 1)):
    return {"w": w, "h": h, "bpc": bpc, "planes": 3, "ss_hor": 1,
            "ss_ver": 1, "deblock": list(deblock), "cdef": list(cdef),
            "lr": list(lr)}


def test_filter_bytes_from_headers():
    # 1080p 8-bit 4:2:0: 1920*1080 + 2 * 960*540 samples, three passes
    px = 1920 * 1080 + 2 * 960 * 540
    assert work.filter_bytes(_pic(1920, 1080, 8)) == 2 * px * 3
    # 10 bits: two bytes a sample; odd sizes round the chroma up
    px = 3839 * 2159 + 2 * 1920 * 1080
    assert work.filter_bytes(_pic(3839, 2159, 10)) == 2 * 2 * px * 3
    # a plane without restoration and a picture without CDEF
    p = _pic(64, 64, 8, lr=(0, 2, 0), cdef=(0, 0, 0))
    assert work.filter_bytes(p) == 2 * (64 * 64 * 1 + 32 * 32 * 2 +
                                        32 * 32 * 1)
    assert work.filter_least_seconds([_pic(1920, 1080, 8)] * 2) == \
        pytest.approx(2 * work.filter_bytes(_pic(1920, 1080, 8)) / 3.35e12)


def _ctx(events, phases=None, pictures=2, lo=0.0, hi=1.0, recs=None,
         lat=()):
    return Context(pictures=pictures, cpu_s=0.5, phases=phases or {}, latencies_s=list(lat),
                   device_events=events, lo=lo, hi=hi,
                   picture_records=recs or [])


def test_readers_on_a_synthetic_trace():
    from portbench import spec
    pic = _pic(1920, 1080, 8)
    least = work.filter_least_seconds([pic, pic])
    events = [("void deblock_frame<8>(int*)", 0.10, 0.10 + least),
              ("cdef_kernel", 0.20, 0.20 + least),
              ("Memcpy HtoD (Pageable -> Device)", 0.30, 0.40),
              ("mc_put_kernel", 0.50, 0.60),
              ("lr_sgr_kernel", 0.95, 1.05)]     # half inside the window
    ctx = _ctx(events, {"stage_a": 0.2, "fetch": 0.01,
                        "filters.fetch_queue": 0.01}, recs=[pic, pic],
               lat=[0.1 * i for i in range(1, 21)])
    read = spec.metric_reader
    assert read("kernel_us_per_pic")(ctx) == pytest.approx(
        1e6 * (2 * least + 0.1 + 0.05) / 2)
    assert read("filter_roofline")(ctx) == pytest.approx(
        100 * least / (2 * least + 0.05))
    busy = 2 * least + 0.1 + 0.1 + 0.05
    assert read("device_idle_share")(ctx) == pytest.approx(100 * (1 - busy))
    assert read("stage_a_ms_per_pic")(ctx) == pytest.approx(100.0)
    assert read("fetch_ms_per_pic")(ctx) == pytest.approx(10.0)
    assert read("inter_tables_ms_per_pic")(ctx) is None
    assert read("leftovers_ms_per_pic")(ctx) is None
    assert read("host_cpu_ms_per_pic")(ctx) == pytest.approx(250.0)
    assert read("seek_p90_ms")(ctx) == pytest.approx(1800.0)
    assert read("seek_p90_ms")(_ctx([], lat=[0.1] * 9)) is None
    empty = _ctx([])
    for name in ("kernel_us_per_pic", "filter_roofline", "device_idle_share"):
        assert read(name)(empty) is None


def test_breakdown_names_gaps_by_the_host_phase():
    events = [("k1", 0.0, 0.1), ("k2", 0.5, 0.6), ("k1", 0.9, 1.0)]
    spans = [("stage_a", 0.1, 0.45, "MainThread"),
             ("filters.lr", 0.6, 0.9, "stageb_0"),
             ("stage_a", 0.62, 0.95, "MainThread")]
    b = devtrace.breakdown(events, spans, 0.0, 1.0)
    assert b["device_ops"][0] == ["k1", pytest.approx(0.2)]
    assert [g[0] for g in b["idle_gaps"]] == ["stage_a@MainThread",
                                              "filters.lr@stageb"]
    assert b["idle_gaps"][0][1] == pytest.approx(0.4)
    assert devtrace.label_gap((2.0, 3.0), spans) == "no phase"
    assert devtrace.kernel_of("void lr_wiener_kernel<16>") == "lr_wiener"
    assert devtrace.kernel_of("Memset (Device)") is None


def test_gc_log_counts_collections_and_time():
    import gc
    log = devtrace.GcLog()
    log.install()
    try:
        gc.collect(0)
        gc.collect(2)
    finally:
        log.remove()
    assert log.collections[0] >= 1 and log.collections[2] >= 1
    assert log.seconds > 0
    from portbench import spec
    ctx = _ctx([], pictures=4)
    ctx.gc_s = 0.2
    assert spec.metric_reader("gc_ms_per_pic")(ctx) == pytest.approx(50.0)
    ctx.gc_s = None
    assert spec.metric_reader("gc_ms_per_pic")(ctx) is None
