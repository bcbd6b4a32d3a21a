"""A decode's device work runs with the decode's device made current: the
kernel libraries launch in the current CUDA device's context, so a
decode on another card than the current one enters
cuda_build.device_guard(its device) for Stage B, the filter chain, the
film grain and the output fetch, on the Stage-B worker thread and on
the synchronous path. Here the guard is replaced by a recorder on a CPU
decode. A wrapper handed tensors of another device than the current
one raises before it launches (launch_stream; the card test is
tests/test_torch_cuda.py's)."""
import contextlib
import os
import threading

import pytest
import torch

from dav1d_tpu_torch.ops import cuda_build

from torch_port_cases import GOLDEN_DIR, port_md5s

import chip_smoke


@pytest.fixture
def entered(monkeypatch):
    """Every device_guard entry: (device, thread name)."""
    seen = []

    def guard(device):
        seen.append((torch.device(device), threading.current_thread().name))
        return contextlib.nullcontext()
    monkeypatch.setattr(cuda_build, "device_guard", guard)
    return seen


def _grain_stream():
    with open(os.path.join(GOLDEN_DIR, "fg-inter.ivf"), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("n_threads", [0, 1], ids=["worker", "sync"])
def test_decode_runs_under_its_device_guard(n_threads, entered):
    want = chip_smoke.POST_FILTERS["fg-inter"]
    assert port_md5s(_grain_stream(), stream_md5=True,
                     n_threads=n_threads) == want
    n_pics = len(want[0])
    assert {d for d, _ in entered} == {torch.device("cpu")}
    main = threading.current_thread().name
    on_main = sum(t == main for _, t in entered)
    if n_threads == 1:
        # Stage B, grain: one entry each a frame, all on this thread
        assert on_main == len(entered) >= 2 * n_pics
    else:
        # Stage B and grain on the worker, the fetch here
        assert len(entered) - on_main >= 2 * n_pics
        assert on_main >= n_pics


def test_golden_route_enters_no_guard(entered, monkeypatch):
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    assert port_md5s(_grain_stream(), stream_md5=True) == \
        chip_smoke.POST_FILTERS["fg-inter"]
    assert not entered


def test_launch_on_another_device_raises(monkeypatch):
    """launch_stream, which every wrapper calls for its launch, refuses
    a device that is not the current CUDA device."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="device_guard"):
        cuda_build.launch_stream(torch.device("cuda", 1))
