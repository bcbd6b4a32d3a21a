"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; the configuration's file lies at its `file`, the mix at
`traffic/<traffic>.json`, the loop the mix names at
`loops/<loop>.py`, and each per-layer metric's reader at
`metrics/<name>.py`. Adding a configuration, mix or metric adds files
and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME_RE.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT_RE.fullmatch(s) is not None


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files resolved."""
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def _reports(metric, cell_name):
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def _function(folder: str, name: str, attr: str):
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def metric_reader(name: str):
    """The `read(ctx)` function of metrics/<name>.py."""
    return _function("metrics", name, "read")


def loop_runner(name: str):
    """The `run(driver, order, seconds)` function of loops/<name>.py."""
    return _function("loops", name, "run")
