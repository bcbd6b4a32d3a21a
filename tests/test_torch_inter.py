"""The inter slice end to end on small synthetic streams: key + inter
frames with every in-loop filter on decode through the port's public
API (device="cpu", so the kernels' plain versions run) to the md5s of
dav1d_tpu's golden numpy path (DAV1D_TPU_BACKEND=numpy), for one stream
also equal to the md5s recorded from dav1d_tpu's device path (the JAX
per-group job kernels, DEVICE_PATH_MD5S). Covered: 8-bit 4:2:0,
distance-weighted and masked (wedge, seg) compounds, 10-bit, 4:2:2 and
4:4:4, two tile columns, lossless (WHT), OBMC and local warp (8- and
10-bit, 4:2:0, 4:2:2, 4:4:4, an odd frame size whose laps cross the
plane's right and bottom edges) and global-motion warp, each stream
showing that its warp / OBMC jobs ran; monochrome and 12-bit 4:2:0
streams with every in-loop filter on. The host golden walks: leftovers
that are not pure intra (interintra, also at an odd frame size, blocks
on scaled references, scaled and warped compounds) and intrabc frames,
on the streams committed for chip_smoke.py (torch_port_cases
GOLDEN_WALKS), each showing that its walk ran. Inter streams with
super-res and with film grain to the golden md5s; a frame the native
job emitter declines takes the Python collector walk (ROADMAP item
9b; tests/test_torch_collector.py holds that route). Every pass's jobs
write disjoint pixels (the kernels rely on it): puts, warp tiles,
compounds, each direction's OBMC blends, residuals."""
import os

import numpy as np
import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.decoder import ObuStreamDecoder
from dav1d_tpu.utils.muxers import Md5Muxer as JaxMd5
from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.entropy import levels as lv
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops import mc_fused, mc_obmc
from dav1d_tpu_torch.recon import inter_device, inter_ref
from dav1d_tpu_torch.utils.muxers import Md5Muxer
from tools.streamgen.gen import generate_stream

import chip_smoke
from torch_port_cases import FILTERS, GOLDEN_DIR, GOLDEN_WALKS, PYR, \
    golden_walk_stream

torch.set_num_threads(2)

MOTION = dict(warped_motion=1, switchable_motion_mode=1)
STREAMS = {
    "8bit-420": dict(w=96, h=64, n_frames=3, seed=3),
    "jnt-masked": dict(w=96, h=96, n_frames=5, seed=27, jnt_comp=1,
                       masked_compound=1, **PYR),
    "10bit": dict(w=96, h=96, n_frames=4, seed=50, hbd=1,
                  masked_compound=1),
    "2-tile-cols": dict(w=128, h=128, n_frames=4, seed=46,
                        tile_log2_cols=1, **PYR),
    "lossless": dict(w=96, h=64, n_frames=3, seed=61, qidx=0),
    "8bit-444": dict(w=96, h=64, n_frames=3, seed=62, layout=3,
                     masked_compound=1),
    "8bit-422": dict(w=96, h=64, n_frames=3, seed=63, layout=2,
                     masked_compound=1),
    "obmc": dict(w=96, h=96, n_frames=4, seed=40, switchable_motion_mode=1,
                 **PYR),
    "warp": dict(w=96, h=96, n_frames=4, seed=41, **MOTION, **PYR),
    "gmv": dict(w=96, h=96, n_frames=4, seed=44, warped_motion=1,
                switchable_comp_refs=0,
                gmv_types=lambda fi, rng: [2, 0, 1, 0, 3, 0, 0]),
    "warp-10bit": dict(w=96, h=96, n_frames=4, seed=52, hbd=1, **MOTION,
                       **PYR),
    "warp-444": dict(w=96, h=64, n_frames=4, seed=45, layout=3, **MOTION,
                     **PYR),
    "warp-422": dict(w=96, h=64, n_frames=4, seed=65, layout=2, **MOTION,
                     **PYR),
    "warp-odd-size": dict(w=70, h=50, n_frames=4, seed=43, **MOTION, **PYR),
    "interintra": dict(w=96, h=96, n_frames=5, seed=25, inter_intra=1,
                       **PYR),
    "interintra-odd-size": dict(w=70, h=50, n_frames=4, seed=26,
                                inter_intra=1, **PYR),
}
# the warp / OBMC job tables each stream must have run
WARP_OBMC = {"obmc": ("obmc",), "gmv": ("warps",),
             **{k: ("warps", "obmc") for k in STREAMS
                if k.startswith("warp")}}
# two tests/test_e2e_layouts.py configs with their own filter sets:
# monochrome and 12-bit 4:2:0 inter streams, every in-loop filter on
LAYOUT_STREAMS = {
    "mono-filters": dict(w=96, h=96, n_frames=3, seed=322, monochrome=1,
                         lf_levels=(20, 18, 0, 0),
                         cdef_params=(2, 1, [9, 5], [0, 0]),
                         lr_types=(2, 0, 0)),
    "i420-12b-filters": dict(w=96, h=96, n_frames=3, seed=332, hbd=2,
                             lf_levels=(20, 18, 12, 10),
                             cdef_params=(2, 1, [9, 5], [3, 2]),
                             lr_types=(2, 2, 2)),
}
# the streams whose leftovers the golden inter walk replays
LEFTOVER_WALKS = ("interintra", "interintra-odd-size")
# inter streams with super-res (inter frames predict from references of
# the other width through the host golden walk) and with film grain
SUPERRES_GRAIN = {
    "superres": dict(w=96, h=96, n_frames=3, seed=80, superres_denom=12),
    "film-grain": dict(w=96, h=96, n_frames=3, seed=95, film_grain=dict(
        seed=1234, y_points=[(0, 64), (255, 48)], ar_coeff_lag=0,
        ar_coeffs_y=[], scaling_shift=9, uv_points=[[(0, 32)], [(16, 48)]],
        ar_coeffs_uv=[[5], [7]], overlap_flag=0)),
}


def _stream(cfg):
    cfg = dict(cfg)
    w, h = cfg.pop("w"), cfg.pop("h")
    data, _ = generate_stream(w, h, **cfg, **FILTERS)
    return data


def _port_md5s(data, **settings):
    dec = Decoder(Settings(device="cpu", **settings))
    out = []
    for fr in IvfReader(data):
        dec.send_data(fr.data)
        for pic in dec.pictures():
            m = Md5Muxer()
            m.write_picture(pic)
            out.append(m.digest())
    return out


def _jax_md5s(data):
    dec = ObuStreamDecoder()
    out = []
    for fr in IvfReader(data):
        for _plan, pic in dec.decode_temporal_unit(fr.data):
            if pic is not None:
                m = JaxMd5()
                m.write_picture(pic)
                out.append(m.digest())
    return out


@pytest.fixture
def walks(monkeypatch):
    """Counts of the host golden walks the port runs: leftover blocks of
    inter frames that are not pure intra (replayed through
    _recon_b_inter) and intrabc frames."""
    seen = {"leftover_blocks": 0, "intrabc_frames": 0}
    cls = inter_device.DeviceInterReconstructor
    run_b, run_f = cls._recon_b_inter, inter_ref.reconstruct_inter_frame

    def leftover(self, *a):
        seen["leftover_blocks"] += 1
        return run_b(self, *a)

    def intrabc(*a):
        seen["intrabc_frames"] += 1
        return run_f(*a)
    monkeypatch.setattr(cls, "_recon_b_inter", leftover)
    monkeypatch.setattr(inter_ref, "reconstruct_inter_frame", intrabc)
    return seen


@pytest.fixture
def jobs_seen(monkeypatch):
    """Every job table the port's inter Stage B executes, with its
    picture's plane shapes."""
    seen = []
    run = mc_fused.execute

    def spy(recon, jobs):
        seen.append((jobs, [p.shape for p in recon.pic.planes]))
        return run(recon, jobs)
    monkeypatch.setattr(mc_fused, "execute", spy)
    return seen


# the md5s of STREAMS["8bit-420"] on dav1d_tpu's device path (its JAX
# per-group job kernels, DAV1D_TPU_FUSED=0 as tests/conftest.py sets:
# _jax_md5s without DAV1D_TPU_BACKEND=numpy), recorded once: that
# decode compiles its programs for ~90 s on a CPU. The golden test of
# that stream holds the live golden md5s to them.
DEVICE_PATH_MD5S = {"8bit-420": ["65fd9902d674cdbd48a0aa4a65e7ec36",
                                 "e5c6b8ca1934f229f42d3db34db76bc8",
                                 "8ef32c94fc574322d1c4f7119f721e07"]}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inter_stream_md5s_match_golden(name, monkeypatch, jobs_seen,
                                        walks):
    data = _stream(STREAMS[name])
    got = _port_md5s(data)
    with monkeypatch.context() as mp:
        # dav1d_tpu's golden path only: the port's decodes stay on the
        # device route, not on the port's golden route
        mp.setenv("DAV1D_TPU_BACKEND", "numpy")
        want = _jax_md5s(data)
    assert len(want) == STREAMS[name]["n_frames"]
    assert want == DEVICE_PATH_MD5S.get(name, want)
    assert got == want
    # the synchronous decoder (no Stage-B worker) agrees too
    assert _port_md5s(data, n_threads=1) == want
    assert jobs_seen and all(len(j["puts"]) + len(j["comp"])
                             for j, _ in jobs_seen)
    if name == "lossless":
        assert any((j["res"][:, 2] == lv.WHT_WHT).any()
                   for j, _ in jobs_seen)
    if name == "jnt-masked":
        modes = set(np.concatenate([j["comp"][:, 5] for j, _ in jobs_seen]))
        assert {1, 3, 4} <= modes
    for kind in WARP_OBMC.get(name, ()):
        assert any(len(j[kind]) for j, _ in jobs_seen), kind
    if "obmc" in WARP_OBMC.get(name, ()):
        tops = {int(t) for j, _ in jobs_seen for t in j["obmc"][:, 0]}
        assert tops == {0, 1}
    if name == "warp-odd-size":
        # blends across the frame's right and bottom edges, into the
        # planes' allocated padding
        frame = [(50, 70), (25, 35), (25, 35)]
        assert any(_laps_past_edge(j, frame) for j, _ in jobs_seen)
    # the golden inter walk replayed leftovers here and nowhere else
    assert (walks["leftover_blocks"] > 0) == (name in LEFTOVER_WALKS)


@pytest.mark.parametrize("name", sorted(GOLDEN_WALKS))
def test_golden_walk_streams_match_golden(name, monkeypatch, walks):
    """The committed stream is its config's, and decodes to the md5s of
    dav1d_tpu's golden path that chip_smoke.py holds, through the
    golden walks (ROADMAP item 5a)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        data = fh.read()
    assert data == golden_walk_stream(name)
    got = _port_md5s(data)
    if name == "i444-intrabc":
        assert walks["intrabc_frames"] > 0
    else:
        assert walks["leftover_blocks"] > 0
    assert _port_md5s(data, n_threads=1) == got
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    assert got == _jax_md5s(data) == chip_smoke.GOLDEN_WALKS[name][0]


@pytest.mark.parametrize("name", sorted(LAYOUT_STREAMS))
def test_layout_stream_md5s_match_golden(name, monkeypatch):
    from dav1d_tpu_torch.ops import cdef, lr
    cfg = dict(LAYOUT_STREAMS[name])
    w, h = cfg.pop("w"), cfg.pop("h")
    data, _ = generate_stream(w, h, **cfg)
    ran = []
    for mod, fn in ((cdef, "cdef_planes_device"), (lr, "lr_planes_device")):
        def spy(*a, _run=getattr(mod, fn), _fn=fn):
            ran.append(_fn)
            return _run(*a)
        monkeypatch.setattr(mod, fn, spy)
    got = _port_md5s(data)
    assert set(ran) == {"cdef_planes_device", "lr_planes_device"}
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    want = _jax_md5s(data)
    assert len(want) == cfg["n_frames"]
    assert got == want


def _laps_past_edge(jobs, shapes):
    """Laps whose blend crosses the right or bottom edge of their
    plane's (rows, cols) in `shapes`."""
    n = 0
    for top in (1, 0):
        o = jobs["obmc"][jobs["obmc"][:, 0] == top]
        rows, cols = mc_obmc.blend_dims(o, top)
        hw = np.array(shapes)[o[:, 1]].reshape(-1, 2)
        n += int(((o[:, 5] + rows > hw[:, 0]) |
                  (o[:, 6] + cols > hw[:, 1])).sum())
    return n


@pytest.mark.parametrize("name", sorted(SUPERRES_GRAIN))
def test_superres_and_grain_inter_streams_match_golden(name, monkeypatch):
    data = _stream(SUPERRES_GRAIN[name])
    got = _port_md5s(data)
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    want = _jax_md5s(data)
    assert len(want) == SUPERRES_GRAIN[name]["n_frames"]
    assert got == want


def test_missing_native_emitter_raises(monkeypatch):
    """A frame the native job emitter declines no longer raises (ROADMAP
    item 9b): it takes the Python collector walk, to the emitter
    route's md5s."""
    from dav1d_tpu_torch.recon import inter_jobs_native
    data = _stream(STREAMS["8bit-420"])
    want = _port_md5s(data)
    walked = []
    run = inter_device.DeviceInterReconstructor.run

    def walk(self):
        walked.append(1)
        return run(self)
    monkeypatch.setattr(inter_device.DeviceInterReconstructor, "run", walk)
    monkeypatch.setattr(inter_jobs_native, "emit", lambda *a: None)
    assert _port_md5s(data) == want
    assert len(walked) == STREAMS["8bit-420"]["n_frames"] - 1


def _pass_overlaps(jobs, shapes):
    """{(pass, plane): pixels written twice within one pass}."""
    out = {}
    for pi, shape in enumerate(shapes):
        for kind in ("puts", "comp"):
            j = jobs[kind][jobs[kind][:, 0] == pi]
            out[kind, pi] = kc.overlaps(j[:, 3], j[:, 4], j[:, 1], j[:, 2],
                                        shape)
        w = jobs["warps"][jobs["warps"][:, 0] == pi]
        eight = np.full(len(w), 8)
        out["warps", pi] = kc.overlaps(w[:, 1], w[:, 2], eight, eight, shape)
        for top in (1, 0):
            o = jobs["obmc"][(jobs["obmc"][:, 1] == pi) &
                             (jobs["obmc"][:, 0] == top)]
            rows, cols = mc_obmc.blend_dims(o, top)
            out["obmc", top, pi] = kc.overlaps(o[:, 5], o[:, 6], rows, cols,
                                               shape)
        r = jobs["res"][jobs["res"][:, 0] == pi]
        tw = np.array([4 * t.w for t in lv.TXFM_INFO])
        th = np.array([4 * t.h for t in lv.TXFM_INFO])
        out["res", pi] = kc.overlaps(r[:, 3], r[:, 4], th[r[:, 1]],
                                     tw[r[:, 1]], shape)
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_job_passes_write_disjoint_pixels(name, jobs_seen):
    _port_md5s(_stream(STREAMS[name]))
    assert jobs_seen
    for jobs, shapes in jobs_seen:
        assert not any(_pass_overlaps(jobs, shapes).values())


def test_s7_job_passes_write_disjoint_pixels(jobs_seen):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "bench_streams", "1920x1080_8b_flt_s7.ivf")
    dec = Decoder(Settings(device="cpu"))
    for i, fr in enumerate(IvfReader(open(path, "rb").read())):
        if i >= 2:
            break
        dec.send_data(fr.data)
        list(dec.pictures())
    (jobs, shapes), = jobs_seen
    assert len(jobs["puts"]) > 1000 and len(jobs["comp"]) > 1000
    assert not any(_pass_overlaps(jobs, shapes).values())
