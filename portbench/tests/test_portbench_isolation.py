"""What the benchmark loads and when it refuses to measure."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, spec

CELLS = [w["name"] for w in spec.load_json(
    os.path.join(spec.ROOT, "BENCHMARK.json"))["workloads"]]
CELL = CELLS[0]


def _python(code, cwd=spec.ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["dav1d_tpu_torch.api", "numpy",
                                      "jaxtyping"]) == []
    assert harness.forbidden_modules(["dav1d_tpu.api", "jax.numpy",
                                      "flax"]) == ["dav1d_tpu", "flax", "jax"]


def test_harness_and_program_load_no_jax():
    loaded = _python(
        "import json, sys, glob, os\n"
        "from portbench import harness, reference, spec, devtrace, readers\n"
        "import dav1d_tpu_torch.api, dav1d_tpu_torch.decoder\n"
        "for f in glob.glob('portbench/metrics/*.py'):\n"
        "    spec.metric_reader(os.path.basename(f)[:-3])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "dav1d_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_reference_loads_nothing_of_the_program():
    loaded = _python(
        "import json, sys\n"
        "import portbench.reference, portbench.work, portbench.pool\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "dav1d_tpu_torch" not in loaded
    assert harness.forbidden_modules(loaded) == []


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "portbench", "run.py"),
         "--workload", CELL, "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    r = _run(spec.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_card_check_counts_devices(monkeypatch, capsys):
    """The look for a card refuses a cell that asks for more devices
    than the machine has."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = harness.main(["--workload", CELL, "--seed", "1", "--seconds", "1"],
                      0.0)
    assert rc != 0
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_refuses_without_a_card(cell, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", cell, "--seed", "1", "--seconds",
                         "1"], 0.0) == 3
    assert capsys.readouterr().out == ""
