"""The comparison that decides `correct`: it passes the program, and it
fails the control and every fault a cell can have.

On the CPU: a 96x96 inter stream with its recorded md5s (a copy of
tests/data/torch_golden/gmv-compound.ivf), the port on `device="cpu"`.
On the card (marker `cuda`): each cell at its own size, the program and
the control on three seeds each, and each fault; every reading is
printed as a JSON line (`pytest -s`).
"""
import json
import os

import pytest

from portbench import harness, pool, reference, spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
CELLS = [w["name"] for w in spec.load_json(
    os.path.join(spec.ROOT, "BENCHMARK.json"))["workloads"]]


class Faulty:
    """The program's API with its output path broken underneath:
      altered    one sample of every picture changed where it is made
      half       every second picture left out
      unchanged  every second picture is the one returned before it
    """

    def __init__(self, api, fault):
        self.Settings = api.Settings
        last = {}

        class Decoder(api.Decoder):
            calls = 0

            def get_picture(self):
                pic = super().get_picture()
                if pic is None:
                    return None
                Decoder.calls += 1
                odd = Decoder.calls % 2 == 0
                if fault == "altered":
                    pic.planes[0][0, 0] ^= 1
                elif fault == "half" and odd:
                    return self.get_picture()
                elif fault == "unchanged" and odd and "pic" in last:
                    return last["pic"]
                last["pic"] = pic
                return pic
        self.Decoder = Decoder


def _small_cell(traffic):
    cfg = spec.load_json(os.path.join(spec.HERE, "configs",
                                      "av1-1080p8.json"))
    return spec.Cell(name=f"small.{traffic}", chips=1, config=cfg,
                     traffic=spec.load_json(os.path.join(
                         spec.HERE, "traffic", f"{traffic}.json")),
                     end_to_end=[], per_layer=[])


@pytest.fixture(scope="module")
def small():
    return {"gmv-compound.ivf": pool.load_stream("gmv-compound.ivf", DATA,
                                                 DATA)}


def _drive(cell, streams, seed, seconds, fault=None, device="cpu"):
    driver = harness.prepare(cell, device=device, streams=streams)
    if fault is not None:
        driver.api = Faulty(driver.api, fault)
    window = harness.measure(driver, seed, seconds)
    return driver, window


@pytest.mark.parametrize("traffic", ["transcode", "seek"])
def test_program_is_correct_and_control_is_not(traffic, small):
    driver, window = _drive(_small_cell(traffic), small, SEEDS[0], 1.5)
    verdict = harness.judge(window, driver)
    assert verdict["attempted"] >= 4
    assert (verdict["failed"], verdict["errors"]) == (0, 0)
    control = harness.judge(window, driver, reference.requantized)
    assert control["mismatched"] >= 1


@pytest.mark.parametrize("traffic,fault", [
    ("transcode", "altered"), ("transcode", "half"),
    ("transcode", "unchanged"), ("seek", "altered"), ("seek", "half")])
def test_every_fault_fails(traffic, fault, small):
    driver, window = _drive(_small_cell(traffic), small, SEEDS[1], 1.5,
                            fault)
    verdict = harness.judge(window, driver)
    assert verdict["failed"] >= 1, verdict


def test_a_failed_session_fails_the_run(small):
    driver = harness.prepare(_small_cell("transcode"), device="cpu",
                             streams=small)
    st = small["gmv-compound.ivf"]
    broken = pool.Stream(st.name, [st.units[0], b"\x12\x00" + b"\xff" * 40]
                         + st.units[2:], st.record)
    driver.streams = {st.name: broken}
    verdict = harness.judge(harness.measure(driver, SEEDS[2], 1.0), driver)
    assert verdict["failed"] >= 1


def _readings(tag, cell, seed, verdict):
    print(json.dumps({"reading": tag, "cell": cell, "seed": seed,
                      **verdict}), flush=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_and_faults_at_the_cells_size(cell_name, card):
    """The program on three seeds (the lower reading, 0), the control on
    the same windows (requantized samples) and with loop restoration
    switched off, and each fault: every one of them must fail."""
    cell = spec.load_cell(cell_name)
    seconds = spec.load_json(os.path.join(spec.ROOT,
                                          "BENCHMARK.json"))["run_seconds"]
    driver = harness.prepare(cell)
    for seed in SEEDS:
        window = harness.measure(driver, seed, seconds)
        program = harness.judge(window, driver)
        _readings("program", cell_name, seed, program)
        assert (program["failed"], program["errors"]) == (0, 0)
        control = harness.judge(window, driver, reference.requantized)
        _readings("control_requantized", cell_name, seed, control)
        assert control["failed"] >= 1
    settings = harness.settings_of(cell, "cuda")
    settings["inloop_filters"] = 3      # deblock and CDEF, no restoration
    no_lr = harness.prepare(cell, settings=settings)
    for seed in SEEDS:
        control = harness.judge(harness.measure(no_lr, seed, 10), no_lr)
        _readings("control_no_restoration", cell_name, seed, control)
        assert control["failed"] >= 1
    faults = ("altered", "half", "unchanged")
    api = driver.api
    for fault in faults:
        driver.api = Faulty(api, fault)
        verdict = harness.judge(harness.measure(driver, SEEDS[0], 10), driver)
        driver.api = api
        _readings(f"fault_{fault}", cell_name, SEEDS[0], verdict)
        assert verdict["failed"] >= 1
