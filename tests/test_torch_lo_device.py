"""Intra leftovers on the device (ROADMAP item 5b) in the port, through
its public API on the CPU (device="cpu": ops/ipred.py plan_plain, the
frame kernel's contract: level_plain and ops/itx.py's plain residuals
level by level): the five configs of
tests/test_lo_device.py (tests/torch_port_cases.py LO_STREAMS: 96-160
px, CFL and the directional modes, 4:4:4, 4:2:2 at 10 bit, 2x2 tiles)
decode under DAV1D_TPU_LO=device with the leftovers of their inter
frames served on the device (no row fetched back), and under =host
through the replay, to the same pictures as dav1d_tpu's golden numpy
path (DAV1D_TPU_BACKEND=numpy), whose md5s chip_smoke.py holds; per
inter frame the port's plan (levels, group keys, rows) equals the plan
dav1d_tpu's ipred_device.build makes on the same frame (every unit at
dav1d_tpu's level, its edge runs expanding to dav1d_tpu's index row
through ops/ipred.py run_indices); a palette
leftover (LO_PALETTE) and interintra leftovers (GOLDEN_WALKS
"interintra") decline the plan and take the host route, still
matching; DAV1D_TPU_LO's other values and the auto limit route as in
dav1d_tpu, with the port's default limit of 0 (the host route under
auto). Tolerance: none (md5-equal)."""
import os

import numpy as np
import pytest
import torch

from dav1d_tpu.recon import ipred_device as jdev
from dav1d_tpu_torch.ops import ipred
from dav1d_tpu_torch.recon import inter_device, ipred_device
from tools.streamgen.gen import generate_stream

import chip_smoke
from torch_port_cases import (GOLDEN_DIR, LO_PALETTE, LO_STREAMS,
                              golden_md5s, lo_stream, port_md5s)

torch.set_num_threads(2)


def _read(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        return fh.read()


def _same_plan(a, b, nflat):
    """Two leftover plans (the port's, dav1d_tpu's) hold the same levels
    (every unit at dav1d_tpu's level), group keys in the same order, and
    rows: a prediction row's edge runs expand (ops/ipred.py run_indices,
    nflat the flat size of each plane) to dav1d_tpu's index row, the
    rest equal."""
    assert a.n_units == b.n_units
    assert len(a.levels) == len(b.levels)
    for ga, gb in zip(a.levels, b.levels):
        assert list(ga) == list(gb)
        for key in ga:
            assert len(ga[key]) == len(gb[key])
            for ra, rb in zip(ga[key], gb[key]):
                assert len(ra) == len(rb)
                if key[1] != "res":
                    assert len(ra[0]) == ipred.NRUN
                    ra = (ipred.run_indices(ra[0], nflat[key[0]])[0],
                          *ra[1:])
                for x, y in zip(ra, rb):
                    assert np.array_equal(np.asarray(x), np.asarray(y)), key


@pytest.fixture
def route(monkeypatch):
    """Decode under a DAV1D_TPU_LO value, recording each built plan
    (beside dav1d_tpu's on the same reconstructor) and the row
    fetches of the host route."""
    seen = {"plans": [], "fetches": 0}
    build = ipred_device.build
    fetch = inter_device.fetch_rows

    def spy_build(recon, leftovers):
        plan = build(recon, leftovers)
        if plan is not None:
            seen["plans"].append((plan, jdev.build(recon, leftovers),
                                  [p.size for p in recon.pic.planes]))
        else:
            seen["plans"].append((None, None, None))
        return plan

    def spy_fetch(*a):
        seen["fetches"] += 1
        return fetch(*a)
    monkeypatch.setattr(ipred_device, "build", spy_build)
    monkeypatch.setattr(inter_device, "fetch_rows", spy_fetch)

    def run(data, lo):
        monkeypatch.setenv("DAV1D_TPU_LO", lo)
        seen["plans"].clear()
        seen["fetches"] = 0
        before = dict(ipred_device.STATS)
        md5s = port_md5s(data)
        stats = {k: ipred_device.STATS[k] - before[k] for k in before}
        return md5s, stats, list(seen["plans"]), seen["fetches"]
    return run


@pytest.mark.parametrize("name", sorted(LO_STREAMS))
def test_lo_stream_committed(name):
    assert _read(name) == lo_stream(name)


@pytest.mark.parametrize("name", sorted(LO_STREAMS))
def test_device_route_matches_golden(name, route, monkeypatch):
    data = _read(name)
    dev, stats, plans, fetches = route(data, "device")
    assert stats["frames"] > 0 and stats["fallbacks"] == 0, stats
    assert stats["frames"] == len(plans) and fetches == 0
    for ours, theirs, nflat in plans:
        _same_plan(ours, theirs, nflat)
    host, hstats, hplans, hfetches = route(data, "host")
    assert hstats["frames"] == 0 and hfetches == len(hplans) == len(plans)
    assert all(p is None for p, *_ in hplans)
    assert dev == host == chip_smoke.LO_STREAMS[name][0]
    assert golden_md5s(data, monkeypatch) == dev


def test_palette_leftover_takes_host_route(route, monkeypatch):
    cfg = dict(LO_PALETTE)
    w, h = cfg.pop("w"), cfg.pop("h")
    data, _ = generate_stream(w, h, **cfg)
    dev, stats, plans, fetches = route(data, "device")
    assert stats["fallbacks"] == 1 and (None, None, None) in plans
    assert fetches == sum(p is None for p, *_ in plans)
    assert dev == route(data, "host")[0] == golden_md5s(data, monkeypatch)


def test_interintra_leftovers_take_host_route(route):
    dev, stats, plans, fetches = route(_read("interintra"), "device")
    assert stats["fallbacks"] == 0 and fetches > 0
    assert any(p is None for p, *_ in plans)
    assert dev == chip_smoke.GOLDEN_WALKS["interintra"][0]


def test_route_switches(route, monkeypatch):
    data = _read("lo-base")
    n_lo = len(route(data, "device")[2])
    assert route(data, "anything")[1]["frames"] == 0
    # the port's default limit (0) keeps every frame with leftovers on
    # the host route under auto
    assert ipred_device.AUTO_LIMIT == 0
    md5s, stats, plans, fetches = route(data, "auto")
    assert stats["frames"] == 0 and fetches == n_lo
    assert md5s == chip_smoke.LO_STREAMS["lo-base"][0]
    # dav1d_tpu's limit serves them
    monkeypatch.setattr(ipred_device, "AUTO_LIMIT", 1200)
    md5s, stats, plans, fetches = route(data, "auto")
    assert stats["frames"] == n_lo and fetches == 0
    assert md5s == chip_smoke.LO_STREAMS["lo-base"][0]
