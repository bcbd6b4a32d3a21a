"""The golden host route (ROADMAP item 16): under DAV1D_TPU_BACKEND=numpy
(or ref, off) the port decodes on its host golden models, as dav1d_tpu
does under the same switch. Every stream committed under
tests/data/torch_golden/ decodes through the public Decoder, pipelined
and with n_threads=1, to the golden md5s chip_smoke.py records
(dav1d_tpu's golden numpy path: the golden walks, super-res and film
grain streams with grain applied, the leftover streams, and the mesh
streams with a mesh in the Settings, which the route ignores). No
device code runs: no upload, no kernel dispatcher, no device route, no
tensor op. A default Settings() (device "cuda") decodes under the
switch on a machine without a card and still raises without it. The
port's apply_superres, the one golden model the route adds, equals
dav1d_tpu's on a frame's planes."""
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dav1d_tpu.api import Settings as JaxSettings
from dav1d_tpu.bitstream.ivf import IvfReader as JaxIvfReader
from dav1d_tpu.decoder import ObuStreamDecoder as JaxDecoder
from dav1d_tpu.ops import superres as jax_superres
from dav1d_tpu_torch import decoder as port_decoder
from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.ops import device, superres
from dav1d_tpu_torch.parallel.sharded import Mesh

import chip_smoke
from torch_port_cases import GOLDEN_DIR, port_md5s

# every committed small stream with its recorded golden md5s
GOLDEN = {**chip_smoke.GOLDEN_WALKS, **chip_smoke.POST_FILTERS,
          **chip_smoke.LO_STREAMS}
# the modules whose *_plain / *_cuda functions are the device route's
DEVICE_MODULES = ("cdef", "fg", "ipred", "itx", "lf", "lr", "mc",
                  "mc_fused", "mc_obmc", "mc_warp", "superres")


def _data(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        return fh.read()


@pytest.fixture
def golden(monkeypatch):
    """The switch set, and every entry into device code made to raise:
    the upload, each device module's plain versions and kernel
    wrappers, the device reconstruction and filter chain, the device
    grain."""
    import importlib
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    called = []

    def trap(name):
        def fn(*a, **k):
            called.append(name)
            raise AssertionError(f"{name} called on the golden route")
        return fn
    targets = [(device, "upload_planes")]
    for mod_name in DEVICE_MODULES:
        mod = importlib.import_module(f"dav1d_tpu_torch.ops.{mod_name}")
        targets += [(mod, n) for n in dir(mod)
                    if n.endswith(("_plain", "_cuda")) and
                    callable(getattr(mod, n))]
    from dav1d_tpu_torch.ops import fg
    from dav1d_tpu_torch.recon import filters, inter_device
    targets += [(inter_device, "reconstruct_inter_frame_device"),
                (filters, "run_filter_chain_device"),
                (fg, "apply_film_grain_device")]
    for mod, name in targets:
        monkeypatch.setattr(mod, name, trap(f"{mod.__name__}.{name}"))
    return called


class _TensorOps(TorchDispatchMode):
    """Counts every tensor op dispatched on this thread."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_committed_streams_on_the_golden_route(name, golden):
    data = _data(name)
    want = GOLDEN[name]
    assert port_md5s(data, stream_md5=True) == want
    with _TensorOps() as mode:
        assert port_md5s(data, stream_md5=True, n_threads=1) == want
    assert not mode.ops
    assert not golden


@pytest.mark.parametrize("name", sorted(chip_smoke.MESH_MD5S))
def test_mesh_ignored_on_the_golden_route(name, golden, monkeypatch):
    # CUDA shards under a CPU decode: resolve_mesh would raise on them
    mesh = Mesh(["cuda:0", "cuda:1"], ("tile",))
    decoders = []
    init = port_decoder.ObuStreamDecoder.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        decoders.append(self)
    monkeypatch.setattr(port_decoder.ObuStreamDecoder, "__init__", record)
    _, md5 = port_md5s(_data(name), stream_md5=True, sharding_mesh=mesh)
    assert md5 == chip_smoke.MESH_MD5S[name]
    assert decoders and all(d.golden and d.device is None and
                            d.shard_devices is None for d in decoders)
    assert not golden


@pytest.mark.parametrize("value", ["ref", "off"])
def test_every_switch_value_takes_the_route(value, golden, monkeypatch):
    monkeypatch.setenv("DAV1D_TPU_BACKEND", value)
    assert not device.device_enabled()
    name = "gmv-compound"
    assert port_md5s(_data(name), stream_md5=True, n_threads=1) == \
        GOLDEN[name]
    assert not golden


def test_default_settings_decode_without_a_card(golden, monkeypatch):
    """Settings() asks for "cuda": the golden route resolves no device,
    so it decodes where no card is; without the switch it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name = "fg-inter"
    dec = Decoder(Settings())
    got = []
    for fr in IvfReader(_data(name)):
        dec.send_data(fr.data)
        got += list(dec.pictures())
    assert len(got) == len(GOLDEN[name][0])
    assert dec._dec.device is None
    monkeypatch.delenv("DAV1D_TPU_BACKEND")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Settings())
    assert not golden


def test_switch_read_once_per_decoder(monkeypatch):
    """A decoder keeps the route it was built with (dav1d_tpu reads the
    switch at each frame)."""
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    dec = Decoder(Settings(device="cpu"))
    monkeypatch.delenv("DAV1D_TPU_BACKEND")
    assert dec._dec.golden
    assert not Decoder(Settings(device="cpu"))._dec.golden


def test_apply_superres_matches_dav1d_tpu(monkeypatch):
    """The port's apply_superres against dav1d_tpu's on the planes,
    pre-CDEF snapshot and plan of every frame of a super-res stream
    (4:2:0, LR on) on dav1d_tpu's golden path."""
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    seen = []
    run = jax_superres.apply_superres

    def spy(pic, pre_cdef, plan):
        out, out_pre = run(pic, pre_cdef, plan)
        mine, mine_pre = superres.apply_superres(pic, pre_cdef, plan)
        # copies: LR then filters dav1d_tpu's result in place
        seen.append(([p.copy() for p in out.planes], out_pre and
                     [None if p is None else p.copy() for p in out_pre],
                     mine, mine_pre, (out.w, out.h, out.layout)))
        return out, out_pre
    monkeypatch.setattr(jax_superres, "apply_superres", spy)
    dec = JaxDecoder(settings=JaxSettings(n_threads=1))
    for fr in JaxIvfReader(_data("sr-inter-filters")):
        dec.decode_temporal_unit(fr.data)
    assert len(seen) == 4
    assert any(s[1] is not None for s in seen)
    for planes, out_pre, mine, mine_pre, geo in seen:
        assert (mine.w, mine.h, mine.layout) == geo
        for a, b in zip(planes, mine.planes):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (out_pre is None) == (mine_pre is None)
        for a, b in zip(out_pre or (), mine_pre or ()):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_whole_stream_md5s_recorded_alike():
    """The whole-stream md5s of tools/torch_golden_md5s.py, as
    tests/torch_port_cases.py and chip_smoke.py hold them: the same,
    s33's first pictures its recorded prefix MD5S_S33, s21_realistic's
    stream md5 the prefix on record before."""
    from torch_port_cases import WHOLE_STREAM_MD5S
    s33 = WHOLE_STREAM_MD5S[chip_smoke.STREAM_4K10]
    s21 = WHOLE_STREAM_MD5S[chip_smoke.STREAM_S21]
    assert s33 == (chip_smoke.MD5S_S33_WHOLE, chip_smoke.MD5_S33_WHOLE)
    assert s21 == (chip_smoke.MD5S_S21, chip_smoke.MD5_S21)
    assert s33[0][:2] == chip_smoke.MD5S_S33
    assert s33[1].startswith("efde4596") and s21[1].startswith("63042eb1")
