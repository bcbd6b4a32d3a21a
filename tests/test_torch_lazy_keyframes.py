"""Key and intra frames on Stage A's lazy-block route, on the CPU.

A key or intra frame that is not intrabc, decoded with reconstruction on
the device route, keeps its Stage-A output as the native tile records
and builds no Python Block or CoefBlock object: the native intra engine,
the deblock masks, CDEF and loop restoration read the records and the
plan's grids. Each case decodes through the port's public API
(device="cpu") to dav1d_tpu's golden md5s, or to the committed record of
portbench's 1080p pool, and checks that every plan stayed lazy with an
empty Block list, that `stage_a.objects` is counted and reads 0, and
that `stage_a.lazy_frames` counts every frame.

The routes that keep their objects: intrabc frames (recon/inter_ref.py
walks plan.blocks), the golden host route (DAV1D_TPU_BACKEND=numpy) and
parse-only decoders; and `native_tile.native_complete`, the test the
native Stage-B consumers share before they read the records.
"""
import os

import numpy as np
import pytest

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.decoder import ObuStreamDecoder
from dav1d_tpu_torch.entropy import native_tile
from dav1d_tpu_torch.utils.muxers import Md5Muxer
from portbench.pool import load_stream
from tools.streamgen.gen import generate_intra_stream

from torch_port_cases import (COMMITTED_MD5S, FILTERS, GOLDEN_DIR,
                              golden_md5s, port_md5s,
                              rec)  # noqa: F401 (fixture)

# (generator arguments, n_threads): 4:2:0 with filter intra, 10-bit
# 4:4:4, a screen-content keyframe with palettes, and 2x2 tiles parsed
# in one thread and on the tile pool
INTRA_STREAMS = {
    "8bit-420-filter-intra": (dict(w=64, h=64, n_frames=2, seed=71,
                                   filter_intra=1), 4),
    "10bit-444": (dict(w=64, h=48, n_frames=2, seed=72, hbd=1,
                       layout=3), 4),
    "palette": (dict(w=64, h=64, n_frames=2, seed=0, screen_content=1), 4),
    "tiles-2x2-threads-1": (dict(w=192, h=128, n_frames=2, seed=33,
                                 tile_log2_cols=1, tile_log2_rows=1), 1),
    "tiles-2x2-threads-4": (dict(w=192, h=128, n_frames=2, seed=33,
                                 tile_log2_cols=1, tile_log2_rows=1), 4),
}
POOL_KEYFRAME = "1920x1080_8b_flt_s7.ivf"


def _stream(name):
    cfg = dict(INTRA_STREAMS[name][0])
    w, h = cfg.pop("w"), cfg.pop("h")
    return generate_intra_stream(w, h, **cfg, **FILTERS)[0]


def _record_plans(monkeypatch):
    """The plans of every frame the port's decoders decode from here on."""
    plans = []
    decode = ObuStreamDecoder.decode_temporal_unit

    def recording(self, data):
        out = decode(self, data)
        for r in out:
            plan = r[0] if self.do_recon else r
            if plan is not None:          # None: a frame shown again
                plans.append(plan)
        return out
    monkeypatch.setattr(ObuStreamDecoder, "decode_temporal_unit", recording)
    return plans


def _n_records(plan, key):
    return sum(len(t[key]) for t in plan.native_tiles)


def _assert_lazy(plans, timing):
    assert plans
    for plan in plans:
        assert plan.lazy_blocks and len(plan.blocks) == 0
        assert len(plan.coefs) == 0 and _n_records(plan, "blocks") > 0
    assert timing._C["stage_a.lazy_frames"] == len(plans)
    assert "stage_a.objects" in timing._C
    assert timing._C["stage_a.objects"] == 0


@pytest.mark.parametrize("name", sorted(INTRA_STREAMS))
def test_intra_streams_decode_lazily(name, rec, monkeypatch):
    data = _stream(name)
    want = golden_md5s(data, monkeypatch)
    plans = _record_plans(monkeypatch)
    got = port_md5s(data, n_threads=INTRA_STREAMS[name][1])
    assert got == want and len(got) == INTRA_STREAMS[name][0]["n_frames"]
    _assert_lazy(plans, rec)
    if name.startswith("tiles"):
        assert all(len(p.native_tiles) == 4 for p in plans)
    if name == "palette":         # the palette records reached the engine
        assert any((t["blocks"][:, native_tile.BF_PAL_SZ0] > 0).any()
                   for p in plans for t in p.native_tiles)


def test_pool_keyframe_decodes_lazily(rec, monkeypatch):
    """The seek cell's request: the keyframe unit of a pool stream, sent
    to a new Decoder with decode_frame_type 3 and n_threads 4."""
    stream = load_stream(POOL_KEYFRAME)
    plans = _record_plans(monkeypatch)
    dec = Decoder(Settings(device="cpu", n_threads=4, decode_frame_type=3))
    dec.send_data(stream.units[0])
    got = []
    for pic in dec.pictures():
        m = Md5Muxer()
        m.write_picture(pic)
        got.append(m.digest())
    dec.close()
    assert got == [stream.record["pictures"][0]["md5"]]
    _assert_lazy(plans, rec)


# ---------------------------------------------------------------------------
# the routes that keep their objects
# ---------------------------------------------------------------------------

def _assert_eager(plan):
    assert not plan.lazy_blocks
    assert len(plan.blocks) == _n_records(plan, "blocks") > 0
    assert len(plan.coefs) == _n_records(plan, "coefs")


def test_intrabc_frames_keep_their_objects(rec, monkeypatch):
    with open(os.path.join(GOLDEN_DIR, "i444-intrabc.ivf"), "rb") as fh:
        data = fh.read()
    plans = _record_plans(monkeypatch)
    assert port_md5s(data, n_threads=1) == COMMITTED_MD5S["i444-intrabc"][0]
    intrabc = [p for p in plans if p.f.frame_hdr.allow_intrabc]
    assert intrabc
    for plan in plans:
        if plan.f.frame_hdr.allow_intrabc:
            _assert_eager(plan)
        else:
            assert plan.lazy_blocks and len(plan.blocks) == 0
    assert rec._C["stage_a.lazy_frames"] == len(plans) - len(intrabc)
    assert rec._C["stage_a.objects"] == sum(
        len(p.blocks) + len(p.coefs) for p in intrabc)


def test_golden_route_builds_every_block(rec, monkeypatch):
    data = _stream("8bit-420-filter-intra")
    want = golden_md5s(data, monkeypatch)
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    plans = _record_plans(monkeypatch)
    assert port_md5s(data, n_threads=1) == want
    assert len(plans) == len(want)
    for plan in plans:
        _assert_eager(plan)
    assert rec._C["stage_a.lazy_frames"] == 0
    assert rec._C["stage_a.objects"] == sum(
        len(p.blocks) + len(p.coefs) for p in plans)


def test_parse_only_decoder_builds_every_block(rec, monkeypatch):
    data = _stream("tiles-2x2-threads-4")
    dec = ObuStreamDecoder(do_recon=False,
                           settings=Settings(device="cpu", n_threads=4))
    plans = [p for fr in IvfReader(data)
             for p in dec.decode_temporal_unit(fr.data)]
    assert len(plans) == 2
    for plan in plans:
        _assert_eager(plan)
    assert rec._C["stage_a.lazy_frames"] == 0


# ---------------------------------------------------------------------------
# native_complete
# ---------------------------------------------------------------------------

def _parsed_plan():
    """A complete eager plan of a 2x2-tile keyframe."""
    dec = ObuStreamDecoder(do_recon=False,
                           settings=Settings(device="cpu", n_threads=4))
    data = _stream("tiles-2x2-threads-4")
    plan = dec.decode_temporal_unit(next(iter(IvfReader(data))).data)[0]
    assert len(plan.native_tiles) == 4
    return plan


def _drop_a_tile(plan):
    plan.native_tiles.pop()


def _extra_block(plan):
    plan.blocks.append(plan.blocks[0])


def _extra_coef(plan):
    plan.coefs.append(plan.coefs[0])


def _no_tiles(plan):
    plan.native_tiles = []


def _lazy_empty_lists(plan):
    plan.blocks.clear()
    plan.coefs.clear()
    plan.lazy_blocks = True


def _lazy_without_tiles(plan):
    _lazy_empty_lists(plan)
    _no_tiles(plan)


COMPLETENESS = [
    ("complete", lambda plan: None, True),
    ("lazy", _lazy_empty_lists, True),
    ("a tile not native", _drop_a_tile, False),
    ("a Python block", _extra_block, False),
    ("a Python coefficient block", _extra_coef, False),
    ("no native tiles", _no_tiles, False),
    ("lazy without tiles", _lazy_without_tiles, False),
]


@pytest.mark.parametrize("alter,want",
                         [c[1:] for c in COMPLETENESS],
                         ids=[c[0] for c in COMPLETENESS])
def test_native_complete(alter, want):
    plan = _parsed_plan()
    alter(plan)
    assert native_tile.native_complete(plan) is want


def test_materialize_pending_builds_what_the_eager_route_builds():
    """A lazy plan's late build equals the eager plan, object for object,
    and makes the plan eager."""
    eager = _parsed_plan()
    lazy = _parsed_plan()
    _lazy_empty_lists(lazy)
    native_tile.materialize_pending(lazy)
    assert not lazy.lazy_blocks and not lazy.want_lazy
    assert len(lazy.blocks) == len(eager.blocks)
    assert len(lazy.coefs) == len(eager.coefs)
    for a, b in zip(eager.blocks, lazy.blocks):
        for k in ("bx", "by", "bs", "y_mode", "uv_mode", "tx", "coef_start",
                  "coef_end", "pal_sz", "cfl_alpha"):
            assert getattr(a, k) == getattr(b, k), k
    for a, b in zip(eager.coefs, lazy.coefs):
        assert (a.plane, a.x4, a.y4, a.tx, a.txtp, a.eob) == \
            (b.plane, b.x4, b.y4, b.tx, b.txtp, b.eob)
        np.testing.assert_array_equal(a.cf, b.cf)
