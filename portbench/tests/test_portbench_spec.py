"""BENCHMARK.json: every cell finds its files by name, and every name,
unit and entry keeps to the benchmark's contract."""
import json
import os

import pytest

from portbench import pool, spec
from portbench.sessions import pool_items

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]

CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.config["streams"]
    for name in c.config["streams"]:
        st = pool.load_stream(name)          # bytes match the record
        assert len(st.record["pictures"]) >= 1
    assert callable(spec.loop_runner(c.traffic["loop"]))
    streams = {n: pool.load_stream(n) for n in c.config["streams"]}
    assert pool_items(c.traffic, streams)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


def test_names_units_and_entries_keep_to_the_contract():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert spec.valid_name(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for c in BENCH["configs"]:
        assert set(c) == CONFIG_KEYS
        assert c["file"].startswith("portbench/")
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))["name"] \
            == c["name"]
        assert all(spec.valid_name(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == CELL_KEYS
        assert spec.valid_name(w["config"]) and spec.valid_name(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in METRICS:
        assert spec.valid_unit(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert all(w in CELLS for w in m.get("workloads", CELLS))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("s,ok", [
    ("pictures_per_s", True), ("av1-1080p8.seek", True), ("_x", True),
    ("a b", False), ("a/b", False), ("a,b", False), ("-a", False),
    ("x" * 65, False), ("µs", False), ("", False)])
def test_name_characters(s, ok):
    assert spec.valid_name(s) is ok


@pytest.mark.parametrize("s,ok", [
    ("pictures/s", True), ("%", True), ("us", True), ("ms", True),
    ("tokens per second", False), ("µs", False), ("x" * 17, False)])
def test_unit_characters(s, ok):
    assert spec.valid_unit(s) is ok


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")
