"""The intra golden fallback: an intra frame that the native engine does
not serve (DAV1D_TPU_INTRA=numpy, or a plan without native Stage-A
records) is reconstructed by the golden walk (recon/intra_ref.py), as
dav1d_tpu's recon/intra_ref.py `reconstruct_intra_frame` does. Small
generated intra streams decode through the port's public API
(device="cpu") to the md5s of dav1d_tpu's golden numpy path, and the
walk's picture equals the native engine's. A key frame's plan reaches
Stage B lazy (no Python Block objects); the walk builds them first."""
import numpy as np
import pytest

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu_torch.decoder import ObuStreamDecoder
from dav1d_tpu_torch.recon import intra, intra_native, intra_ref
from tools.streamgen.gen import generate_intra_stream

from torch_port_cases import (FILTERS, golden_md5s, port_md5s,
                              rec)  # noqa: F401 (fixture)

FALLBACK_STREAMS = {
    "8bit-420-filter-intra": dict(w=64, h=64, n_frames=2, seed=71,
                                  filter_intra=1),
    "10bit-444": dict(w=64, h=48, n_frames=2, seed=72, hbd=1, layout=3),
}


def _stream(name):
    cfg = dict(FALLBACK_STREAMS[name])
    w, h = cfg.pop("w"), cfg.pop("h")
    return generate_intra_stream(w, h, **cfg, **FILTERS)[0]


def _count_walks(monkeypatch):
    runs = []
    run = intra_ref.IntraReconstructor.run

    def counted(self):
        runs.append(1)
        return run(self)
    monkeypatch.setattr(intra_ref.IntraReconstructor, "run", counted)
    return runs


@pytest.mark.parametrize("name", sorted(FALLBACK_STREAMS))
def test_fallback_md5_matches_golden(name, monkeypatch):
    data = _stream(name)
    monkeypatch.setenv("DAV1D_TPU_INTRA", "numpy")
    want = golden_md5s(data, monkeypatch)
    runs = _count_walks(monkeypatch)
    got = port_md5s(data)
    assert len(want) == FALLBACK_STREAMS[name]["n_frames"]
    assert got == want
    assert len(runs) == len(want)       # every frame took the walk


@pytest.mark.parametrize("name", sorted(FALLBACK_STREAMS))
def test_fallback_materializes_a_lazy_plan(name, rec, monkeypatch):
    """A key frame's plan leaves Stage A lazy (no Block objects) whatever
    intra route Stage B takes; the walk builds the plan's objects first,
    counted in stage_a.objects, and decodes to the golden md5s."""
    data = _stream(name)
    monkeypatch.setenv("DAV1D_TPU_INTRA", "numpy")
    want = golden_md5s(data, monkeypatch)
    plans = []
    walk = intra_ref.IntraReconstructor.__init__

    def recording(self, plan):
        plans.append((plan, plan.lazy_blocks))
        walk(self, plan)
    monkeypatch.setattr(intra_ref.IntraReconstructor, "__init__", recording)
    assert port_md5s(data) == want
    assert len(plans) == len(want) == rec._C["stage_a.lazy_frames"]
    for plan, lazy in plans:
        n_blocks = sum(len(t["blocks"]) for t in plan.native_tiles)
        assert not lazy and not plan.lazy_blocks
        assert len(plan.blocks) == n_blocks > 0
    assert rec._C["stage_a.objects"] == sum(
        len(p.blocks) + len(p.coefs) for p, _ in plans)


def test_fallback_replaces_the_raise(monkeypatch):
    """Without native Stage-A records the native engine gives None; the
    port used to raise there and now returns the walk's picture, equal
    plane for plane to the native engine's."""
    data = _stream("8bit-420-filter-intra")
    dec = ObuStreamDecoder(do_recon=False)
    plans = [p for fr in IvfReader(data)
             for p in dec.decode_temporal_unit(fr.data)]
    assert plans and all(p.native_tiles for p in plans)
    for plan in plans:
        native = intra.reconstruct_intra_frame(plan)
        plan.native_tiles = []
        assert intra_native.reconstruct_intra_frame_native(plan) is None
        runs = _count_walks(monkeypatch)
        walked = intra.reconstruct_intra_frame(plan)
        assert runs == [1]
        for a, b in zip(native.planes, walked.planes):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
