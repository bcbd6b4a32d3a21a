"""A small 4K-HDR-shaped transcode on the CPU: the port's normal route
on a 10-bit 4:2:0 inter stream with the tool mix of portbench's
av1-2160p10 pool, and what the recorder counts on it.

The stream (`tests/data/torch_golden/hdr-transcode-192x128.ivf`,
`write_stream()`) is 4 temporal units, a keyframe and 3 inter frames,
2x2 tiles, deblock, CDEF and loop restoration on; every inter frame has
puts, warps, OBMC laps, compounds, residuals and leftover blocks. Its
md5s come from dav1d_tpu's golden numpy path, decoded here on the same
bytes (`torch_port_cases.golden_md5s`).

- the committed stream is what `write_stream()` generates;
- the normal route on `device="cpu"` and the port's golden host route
  (`DAV1D_TPU_BACKEND=numpy`) give those md5s;
- with the recorder on, on the leftovers' host route, their device
  route and a sharded decode: the span `inter.frame_recon` fires once an
  inter frame, the counter `inter.leftover_blocks` is the frames'
  leftovers, and `upload.bytes` is the bytes the upload sites hand
  over (counted here by wrapping the sites); the md5s are the same with
  the recorder on and off;
- each upload site counts the bytes of its one copy.
"""
import os
import sys

import numpy as np
import pytest

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.ops import cdef, device, lf, lr, mc_fused
from dav1d_tpu_torch.parallel.sharded import Mesh
from dav1d_tpu_torch.recon import inter_device, sharded_stageb
from dav1d_tpu_torch.utils import timing
from dav1d_tpu_torch.utils.muxers import Md5Muxer

from torch_port_cases import (GOLDEN_DIR, HDR_TRANSCODE,  # noqa: F401
                              hdr_golden, rec)

NAME = HDR_TRANSCODE
CONFIG = dict(n_frames=4, seed=4, qidx=60, tile_log2_cols=1,
              tile_log2_rows=1, hbd=1, warped_motion=1,
              switchable_motion_mode=1, jnt_comp=1, masked_compound=1,
              allow_skip_mode=1, lf_levels=(32, 32, 20, 20),
              cdef_params=(2, 1, [9, 25], [5, 13]), lr_types=(1, 2, 2))
INTER_FRAMES = 3
JOB_KINDS = ("puts", "warps", "obmc", "comp", "res")


def _generate():
    from tools.streamgen.gen import generate_stream
    return generate_stream(192, 128, **CONFIG)[0]


def write_stream():
    """Write the stream to GOLDEN_DIR/<NAME>.ivf:
    python -c 'import sys; sys.path[:0] = ["tests", "."];
    import test_torch_hdr_transcode as t; t.write_stream()'"""
    with open(os.path.join(GOLDEN_DIR, f"{NAME}.ivf"), "wb") as fh:
        fh.write(_generate())


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(GOLDEN_DIR, f"{NAME}.ivf"), "rb") as fh:
        return fh.read()


def test_stream_committed(data):
    assert data == _generate()


def _md5s(data, **settings):
    dec = Decoder(Settings(n_threads=4, **settings))
    for fr in IvfReader(data):
        dec.send_data(fr.data)
    out = []
    for pic in dec.pictures():
        m = Md5Muxer()
        m.write_picture(pic)
        out.append(m.digest())
    dec.close()
    return out


@pytest.fixture
def frames(monkeypatch):
    """Each inter frame's job counts and leftovers, as its device
    passes start."""
    seen = []
    for cls in (inter_device.DeviceInterReconstructor,
                sharded_stageb.ShardedInterReconstructor):
        def execute(self, jobs, orig=cls._execute):
            seen.append({**{k: len(jobs[k]) for k in JOB_KINDS},
                         "leftovers": len(self.leftovers)})
            return orig(self, jobs)
        monkeypatch.setattr(cls, "_execute", execute)
    return seen


def test_normal_route_gives_the_golden_md5s(data, hdr_golden, frames):
    assert _md5s(data, device="cpu") == hdr_golden
    assert len(frames) == INTER_FRAMES
    for f in frames:
        assert all(f[k] > 0 for k in (*JOB_KINDS, "leftovers")), f


def test_stream_is_10_bit_with_2x2_tiles_and_every_filter(data):
    from dav1d_tpu_torch.decoder import ObuStreamDecoder
    dec = ObuStreamDecoder(do_recon=False,
                           settings=Settings(device="cpu", n_threads=4))
    plans = [p for fr in IvfReader(data)
             for p in dec.decode_temporal_unit(fr.data)]
    assert [p.f.frame_hdr.frame_type for p in plans] == [0, 1, 1, 1]
    for p in plans:
        fh = p.f.frame_hdr
        assert (fh.tiling.cols, fh.tiling.rows) == (2, 2)
        assert p.f.seq_hdr.hbd == 1 and (p.f.ss_hor, p.f.ss_ver) == (1, 1)
        assert fh.loopfilter.level_y[0] and fh.loopfilter.level_u
        assert any(fh.cdef.y_strength) and any(fh.cdef.uv_strength)
        assert all(t != 0 for t in fh.restoration.type)


def test_golden_host_route_gives_the_golden_md5s(data, hdr_golden,
                                                  monkeypatch):
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    assert _md5s(data) == hdr_golden


def _site_bytes(monkeypatch):
    """Wrap every upload site of the decode path; returns {site: bytes
    handed to it}, counted from the sites' own arguments and results."""
    got = {}

    def add(site, n):
        got[site] = got.get(site, 0) + n

    orig_planes = device.upload_planes

    def upload_planes(host_planes, dev):
        add("planes", sum(np.asarray(p).nbytes for p in host_planes))
        return orig_planes(host_planes, dev)
    for name, mod in list(sys.modules.items()):
        if name.startswith("dav1d_tpu_torch") and \
                getattr(mod, "upload_planes", None) is orig_planes:
            monkeypatch.setattr(mod, "upload_planes", upload_planes)

    orig_upload = mc_fused._upload

    def _upload(tables, pool, dev):
        add("inter_tables", sum(t.nbytes for t in tables.values()) +
            pool.nbytes)
        return orig_upload(tables, pool, dev)
    monkeypatch.setattr(mc_fused, "_upload", _upload)

    orig_maps = lf.upload_maps

    def upload_maps(maps, dev):
        add("deblock_maps", sum(a.nbytes for _, _, vm, hm in maps
                                for a in (*vm, *hm)))
        return orig_maps(maps, dev)
    monkeypatch.setattr(lf, "upload_maps", upload_maps)

    orig_tables = lr.upload_tables

    def upload_tables(tbl, dev):
        add("lr_tables", sum(a.nbytes for a in tbl))
        return orig_tables(tbl, dev)
    monkeypatch.setattr(lr, "upload_tables", upload_tables)

    orig_block_maps = cdef._block_maps

    def _block_maps(plan, bd):
        out = orig_block_maps(plan, bd)
        add("cdef_maps", out.nbytes)
        return out
    monkeypatch.setattr(cdef, "_block_maps", _block_maps)
    return got


@pytest.mark.parametrize("route", ["host", "device"])
def test_spans_and_counters_on_the_leftover_routes(rec, monkeypatch, data,
                                                   hdr_golden, frames, route):
    monkeypatch.setenv("DAV1D_TPU_LO", route)
    sites = _site_bytes(monkeypatch)
    assert _md5s(data, device="cpu") == hdr_golden
    assert timing._N["inter.frame_recon"] == INTER_FRAMES
    assert timing._T["inter.frame_recon"] > 0
    assert timing._N["intra.frame_recon"] == 1
    lo = sum(f["leftovers"] for f in frames)
    assert lo > 0 and timing._C["inter.leftover_blocks"] == lo
    # the leftovers' own phases: the replay on the host route, the
    # device plan on the device route
    assert timing._N["inter.leftovers" if route == "host"
                     else "inter.lo_device"] == INTER_FRAMES
    # the keyframe's planes after host intra recon, the inter tables,
    # the deblock and CDEF maps (LR's tables cross on the card only)
    assert {"planes", "inter_tables", "deblock_maps", "cdef_maps"} <= \
        set(sites)
    assert timing._C["upload.bytes"] == sum(sites.values())


def test_spans_and_counters_of_a_sharded_decode(rec, data, hdr_golden, frames):
    mesh = Mesh(np.array(["cpu", "cpu"], dtype=object), ("tile",))
    assert _md5s(data, device="cpu", sharding_mesh=mesh) == hdr_golden
    assert timing._N["inter.frame_recon"] == INTER_FRAMES
    assert timing._N["inter.sharded_exec"] == INTER_FRAMES
    lo = sum(f["leftovers"] for f in frames)
    assert lo > 0 and timing._C["inter.leftover_blocks"] == lo
    assert timing._C["upload.bytes"] > 0


def test_md5s_equal_with_the_recorder_on_and_off(rec, monkeypatch, data,
                                                  hdr_golden):
    on = _md5s(data, device="cpu")
    assert timing._C["upload.bytes"] > 0
    monkeypatch.setattr(timing, "ENABLED", False)
    counters = dict(timing._C)
    assert _md5s(data, device="cpu") == on == hdr_golden
    assert dict(timing._C) == counters


def _u8(*shape):
    return np.arange(np.prod(shape), dtype=np.uint8).reshape(shape)


UPLOADS = {
    "upload": (lambda: device.upload(_u8(5, 7), "cpu"), 35),
    "planes_8bit": (lambda: device.upload_planes(
        [_u8(8, 12), _u8(4, 6), _u8(4, 6)], "cpu"), 96 + 2 * 24),
    "planes_10bit": (lambda: device.upload_planes(
        [np.zeros((8, 12), np.uint16)[2:6]], "cpu"), 2 * 4 * 12),
    "inter_tables": (lambda: mc_fused._upload(
        {"put": np.zeros((3, 11), np.int32)}, np.zeros(9, np.int32),
        "cpu"), 4 * (33 + 9)),
    "deblock_maps": (lambda: lf.upload_maps(
        [(0, True, (np.zeros((2, 3), np.int8), _u8(2, 3)),
          (np.zeros((2, 3), np.int8), _u8(2, 3)))], "cpu"), 24),
    "lr_tables": (lambda: lr.upload_tables(
        [np.zeros((2, 5), np.int32), np.zeros(3, np.int32)], "cpu"),
        4 * 13),
}


@pytest.mark.parametrize("site", sorted(UPLOADS))
def test_an_upload_site_counts_its_bytes_once(rec, site):
    call, want = UPLOADS[site]
    call()
    assert timing._C["upload.bytes"] == want


def test_uploads_count_nothing_while_the_recorder_is_off(rec, monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", False)
    device.upload(_u8(5, 7), "cpu")
    device.upload_planes([_u8(8, 12)], "cpu")
    assert "upload.bytes" not in timing._C
