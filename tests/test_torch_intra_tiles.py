"""The native intra engine's tile calls at once on the decoder's Stage-B
pool (`recon/intra_native.py` `_run_tiles`), on the committed 2x2-tile
10-bit stream `hdr-transcode-192x128.ivf` (a keyframe, 3 inter frames
with leftover blocks), against dav1d_tpu's golden md5s of it:

- the md5s are the same at `n_threads` 1 (no pool) and 4;
- `intra.pool_tiles` counts the keyframe's 4 tiles and, on the inter
  frames, the tiles of each leftover run that has more than one; 0 at
  `n_threads` 1;
- the tile calls run in reverse order give the same planes, so no tile
  reads another's pixels;
- a failed tile call makes `reconstruct_intra_frame_native` give None,
  and the golden walk still decodes the frame to its md5;
- the Stage-B thread runs one tile call itself, beside a pool of
  `n_threads` - 1, and closing the decoder shuts its pools.
"""
import os
import threading

import pytest

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.recon import intra_native
from dav1d_tpu_torch.utils.muxers import Md5Muxer

from torch_port_cases import (GOLDEN_DIR, HDR_TRANSCODE,  # noqa: F401
                              hdr_golden, rec)

KEY_TILES = 4


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(GOLDEN_DIR, f"{HDR_TRANSCODE}.ivf"), "rb") as fh:
        return fh.read()


@pytest.fixture(autouse=True)
def host_leftovers(monkeypatch):
    """The leftovers' host route, which replays through the engine."""
    monkeypatch.setenv("DAV1D_TPU_LO", "host")


def _md5s(data, n_threads):
    dec = Decoder(Settings(n_threads=n_threads, device="cpu"))
    for fr in IvfReader(data):
        dec.send_data(fr.data)
    out = []
    for pic in dec.pictures():
        m = Md5Muxer()
        m.write_picture(pic)
        out.append(m.digest())
    dec.close()
    return out


def _runs_on_several_tiles(monkeypatch):
    """Records, for each leftover run handed to the engine, the number of
    tiles its blocks lie in (found block by block)."""
    seen = []
    orig = intra_native.recon_blocks_native

    def recon_blocks_native(plan, pic, idxs, pool=None):
        tiles = set()
        for i in idxs:
            for t, tr in enumerate(plan.native_tiles):
                if tr["block_base"] <= i < \
                        tr["block_base"] + len(tr["blocks"]):
                    tiles.add(t)
        seen.append(len(tiles))
        return orig(plan, pic, idxs, pool)
    monkeypatch.setattr(intra_native, "recon_blocks_native",
                        recon_blocks_native)
    return seen


@pytest.mark.parametrize("n_threads", [1, 4])
def test_md5s_and_pool_tiles(rec, monkeypatch, data, hdr_golden,
                             n_threads):
    runs = _runs_on_several_tiles(monkeypatch)
    assert _md5s(data, n_threads) == hdr_golden
    assert runs and max(runs) > 1
    if n_threads == 1:
        assert rec._C["intra.pool_tiles"] == 0
    else:
        assert rec._C["intra.pool_tiles"] == \
            KEY_TILES + sum(n for n in runs if n > 1)


def test_tiles_in_reverse_order_give_the_same_planes(monkeypatch, data,
                                                     hdr_golden):
    run = intra_native._run_tiles
    ran = []

    def reversed_tiles(plan, pic, jobs, pool):
        ran.append(len(jobs))
        return run(plan, pic, jobs[::-1], None)
    monkeypatch.setattr(intra_native, "_run_tiles", reversed_tiles)
    assert _md5s(data, 4) == hdr_golden
    assert ran[0] == KEY_TILES and max(ran[1:]) > 1


def test_a_failed_tile_call_falls_back_to_the_golden_walk(monkeypatch,
                                                          data, hdr_golden):
    call = intra_native._call
    calls = []

    def failing(plan, pic, tile, sel):
        calls.append(sel is None)
        if sel is None and tile is plan.native_tiles[2]:
            return False
        return call(plan, pic, tile, sel)
    monkeypatch.setattr(intra_native, "_call", failing)
    native = intra_native.reconstruct_intra_frame_native
    got = []

    def recording(plan, pool=None):
        got.append(native(plan, pool))
        return got[-1]
    monkeypatch.setattr(intra_native, "reconstruct_intra_frame_native",
                        recording)
    assert _md5s(data, 4) == hdr_golden
    assert got == [None]
    assert calls.count(True) == KEY_TILES


def test_the_stage_b_thread_runs_a_tile_and_close_ends_the_pools(
        monkeypatch, data):
    """A keyframe's 4 tile calls at `n_threads` 4: one on the Stage-B
    thread, the rest on a pool of 3; the decoder's close shuts its
    Stage-A and Stage-B pools."""
    call = intra_native._call
    threads = []

    def recording(plan, pic, tile, sel):
        threads.append(threading.current_thread().name.split("_")[0])
        return call(plan, pic, tile, sel)
    monkeypatch.setattr(intra_native, "_call", recording)
    dec = Decoder(Settings(n_threads=4, device="cpu"))
    dec.send_data(next(iter(IvfReader(data))).data)
    assert len(list(dec.pictures())) == 1
    assert sorted(threads) == ["recon"] * 3 + ["stageb"]
    inner = dec._dec
    assert inner._recon_pool._max_workers == 3
    dec.close()
    for pool in (inner._tile_pool, inner._recon_pool):
        with pytest.raises(RuntimeError):
            pool.submit(int)
