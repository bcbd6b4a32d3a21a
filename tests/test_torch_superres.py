"""Super-res (ROADMAP item 4) in the port: the plain resize against
dav1d_tpu's jitted `_resize_fn` (JAX on the CPU) and its golden
mc_ref.resize_plane, exactly, at bd 8/10/12 in every layout, on the
seeded cases of ops/kernel_cases.py superres_cases; the closed-form
source positions against dav1d_tpu's `_resize_tables` recurrence on
every geometry of the cases and of chip_smoke.py's 1080p ones, up to
8192 columns; the frame contract of resize_frame (zeros outside the
resized area, sources untouched); and the super-res streams of
tests/torch_port_cases.py SUPERRES_STREAMS decoded through the port's
public API (device="cpu") to the md5s of dav1d_tpu's golden numpy path
(DAV1D_TPU_BACKEND=numpy), each running the resize. The committed
post_filters streams of chip_smoke.py: bytes equal to their generator,
md5s (dav1d_tpu's and the port's) equal to the ones chip_smoke.py
holds."""
import functools
import os
import re

import numpy as np
import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.ops import superres as jsr
from dav1d_tpu.ops.backend import device_scope
from dav1d_tpu.ops.mc_ref import resize_plane
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops import superres

import chip_smoke
from torch_port_cases import (BIG_POST_FILTERS, GOLDEN_DIR, POST_FILTERS,
                              SUPERRES_STREAMS, golden_md5s,
                              post_filter_stream, port_md5s)

torch.set_num_threads(2)


def _case_widths():
    """(src_w, dst_w, step, mx0) of every job of the kernel cases and of
    the 1080p super-res from 960 and 1280 columns, luma and chroma."""
    seen = set()
    cases = [kc.superres_case(8, layout, *g, pre=False)
             for layout in (1, 2, 3) for g in kc.SUPERRES_GEOMETRIES]
    cases += [kc.superres_case(8, layout, in_w, 1920, 8, pre=False)
              for layout in (1, 3) for in_w in (960, 1280)]
    for case in cases:
        for _src, src_w, _h, _shape, dst_w, step, mx0 in case["jobs"]:
            seen.add((src_w, dst_w, step, mx0))
    return sorted(seen)


def test_positions_match_the_recurrence():
    widths = _case_widths()
    assert max(d for _, d, _, _ in widths) == 8192
    for src_w, dst_w, step, mx0 in widths:
        idx, flt = jsr._resize_tables(dst_w, src_w, step, mx0)
        src_x, phase = superres.positions(dst_w, step, mx0)
        taps = (src_x[:, None] - 3 + torch.arange(8)).clamp(0, src_w - 1)
        assert np.array_equal(taps.numpy(), idx), (src_w, dst_w)
        assert np.array_equal(superres._resize_filter()[phase.numpy()],
                              flt), (src_w, dst_w)
        # the port's copy of the recurrence is dav1d_tpu's
        for a, b in zip(superres._resize_tables(dst_w, src_w, step, mx0),
                        (idx, flt)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["mono", "420", "422", "444"])
def test_resize_plane_plain_matches_dav1d_tpu(bd, layout):
    for g in ((53, 70, 21), (157, 256, 12)):
        case = kc.superres_case(bd, layout, *g, pre=False)
        for src, src_w, h, _shape, dst_w, step, mx0 in case["jobs"]:
            got = superres.resize_plane_plain(torch.from_numpy(src), src_w,
                                              h, dst_w, step, mx0, bd)
            idx, flt = jsr._resize_tables(dst_w, src_w, step, mx0)
            with device_scope():
                want = np.asarray(jsr._resize_fn(h, dst_w, bd)(
                    src[:h], idx, flt))
            assert np.array_equal(got.numpy(), want)
            if g[1] == 70:          # the golden per-pixel loop: small only
                assert np.array_equal(want, resize_plane(
                    src[:h], src_w, h, dst_w, step, mx0, bd))


def test_resize_frame_plain_contract():
    for case in kc.superres_cases() + kc.superres_edge_cases():
        jobs = kc.superres_args(case, "cpu")
        srcs = [j[0].clone() for j in jobs]
        out = superres.resize_frame(jobs, case["bd"])
        for (src, src_w, h, dst, dst_w, step, mx0), o, s0 in zip(
                jobs, out, srcs):
            assert o is dst and torch.equal(src, s0)
            want = torch.zeros_like(dst)
            want[:h, :dst_w] = superres.resize_plane_plain(
                src, src_w, h, dst_w, step, mx0, case["bd"])
            assert torch.equal(dst, want)
    # the widest case against dav1d_tpu too
    case = kc.superres_case(10, 1, *kc.SUPERRES_GEOMETRIES[-1], pre=False)
    src, src_w, h, _shape, dst_w, step, mx0 = case["jobs"][0]
    out = superres.resize_frame(kc.superres_args(case, "cpu"), 10)[0]
    idx, flt = jsr._resize_tables(dst_w, src_w, step, mx0)
    with device_scope():
        want = np.asarray(jsr._resize_fn(h, dst_w, 10)(src[:h], idx, flt))
    assert np.array_equal(out[:h, :dst_w].numpy(), want)


def _cu_constants(name):
    """The `constexpr int NAME = value;` constants of csrc/<name>.cu."""
    path = os.path.join(os.path.dirname(superres.__file__), "..", "csrc",
                        f"{name}.cu")
    with open(path) as fh:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (\w+) = (\d+);", fh.read())}


def test_tile_constants_are_the_kernels():
    c = _cu_constants("superres")
    assert (c["TW"], c["RT"], c["SPAN"]) == (superres.TILE_W,
                                             superres.TILE_ROWS,
                                             superres.SPAN)


@functools.lru_cache(maxsize=None)
def _legal_geometries():
    """(dst_w, step, mx0) of every super-res plane a frame can have:
    output widths 1 to 8192, denominators 9 to 16 (the coded width as
    the frame header computes it), luma and subsampled chroma (the
    rounded widths of ops/superres.py frame_geometry)."""
    out = set()
    for out_w in range(1, 8193):
        for d in range(9, 17):
            in_w = max((out_w * 8 + (d >> 1)) // d, min(16, out_w))
            for ss in (0, 1):
                iw, ow = (in_w + ss) >> ss, (out_w + ss) >> ss
                step = superres.scale_fac(iw, ow)
                out.add((ow, step, superres.get_upscale_x0(iw, ow, step)))
    return tuple(sorted(out))


def _case_geometries():
    cases = kc.superres_cases() + kc.superres_edge_cases() + [
        kc.superres_case(8, layout, in_w, 1920, 8, pre=False)
        for layout in (1, 3) for in_w in (960, 1280)]
    return sorted({(j[4], j[5], j[6]) for c in cases for j in c["jobs"]})


def test_tile_spans_fit_the_stage():
    """Every legal geometry's tiles stage at most SPAN columns from a
    multiple of 4; the spans are the kernel's (16-byte copies)."""
    geos = _legal_geometries()
    assert len(geos) > 10000
    worst = 0
    for dst_w, step, mx0 in geos:
        c0, lo, nvec = superres.tile_spans(dst_w, step, mx0)
        assert not (lo % 4).any()
        worst = max(worst, int(nvec.max()))
    assert 4 * worst <= superres.SPAN


def test_taps_lie_in_their_staged_span():
    """Every tap of every output lies in its tile's staged span, on the
    kernel cases' geometries (up to 8192 columns, the 1080p ones and the
    edge cases) and on every legal geometry of a sample of widths."""
    sample = [g for g in _legal_geometries()
              if g[0] % 97 in (0, 1) or g[0] < 64 or g[0] > 8100]
    for dst_w, step, mx0 in _case_geometries() + sample:
        c0, lo, nvec = superres.tile_spans(dst_w, step, mx0)
        src_x, _ = superres.positions(dst_w, step, mx0)
        tile = np.arange(dst_w) // superres.TILE_W
        first = src_x.numpy() - 3 - lo[tile]          # staged column of tap 0
        assert (first >= 0).all(), (dst_w, step, mx0)
        assert (first + 7 < 4 * nvec[tile]).all(), (dst_w, step, mx0)
        assert (4 * nvec <= superres.SPAN).all()


def _tile_writes(H, W, h, dst_w):
    """How often csrc/superres.cu writes each pixel of an H x W
    destination: per tile of TILE_ROWS x TILE_W, a warp per row in
    steps of 8; a live row (< h) by lanes at c0 + lane + 32 k (k < 4), a
    zero row or padding tile as a lane's 16-byte store at c0 + 4 lane."""
    n = np.zeros((H, W), np.int64)
    TW, RT = superres.TILE_W, superres.TILE_ROWS
    lane = np.arange(32)
    for r0 in range(0, H, RT):
        for c0 in range(0, W, TW):
            pad = r0 >= h or c0 >= dst_w
            for warp in range(8):
                for r in range(r0 + warp, min(r0 + RT, H), 8):
                    if pad or r >= h:
                        for c in c0 + 4 * lane:
                            if c < min(c0 + TW, W):
                                n[r, c:c + 4] += 1
                    else:
                        for k in range(4):
                            c = c0 + lane + 32 * k
                            np.add.at(n[r], c[c < min(c0 + TW, W)], 1)
    return n


def test_tiles_write_every_pixel_once():
    cases = kc.superres_edge_cases()[:8] + [
        kc.superres_case(8, 1, *g, pre=False)
        for g in kc.SUPERRES_GEOMETRIES[:4]]
    for case in cases:
        for _src, _src_w, h, (H, W), dst_w, _step, _mx0 in case["jobs"]:
            assert W % 4 == 0
            assert (_tile_writes(H, W, h, dst_w) == 1).all(), (H, W, h)


def test_resize_frame_checks():
    case = kc.superres_case(8, 1, 53, 70, 21)
    jobs = kc.superres_args(case, "cpu")
    with pytest.raises(ValueError, match="resize jobs"):
        superres.resize_frame(jobs * 2, 8)
    src, src_w, h, dst, dst_w, step, mx0 = jobs[0]
    for bad in ((src, src_w, h, dst, dst_w, 0, mx0),
                (src, src_w, h, dst, dst_w, step, 1 << 14)):
        with pytest.raises(ValueError, match="step"):
            superres.resize_frame([bad], 8)
    with pytest.raises(ValueError, match="outside"):
        superres.resize_frame([(src, src.shape[1] + 1, h, dst, dst_w, step,
                                mx0)], 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        superres.resize_frame_cuda(jobs, 8)


@pytest.fixture
def resized(monkeypatch):
    """The resize_frame calls of a decode (their job counts)."""
    seen = []
    run = superres.resize_frame

    def spy(jobs, bd):
        seen.append(len(jobs))
        return run(jobs, bd)
    monkeypatch.setattr(superres, "resize_frame", spy)
    return seen


@pytest.mark.parametrize("name", sorted(SUPERRES_STREAMS))
def test_superres_stream_md5s_match_golden(name, monkeypatch, resized):
    data = post_filter_stream(name)
    got, whole = port_md5s(data, stream_md5=True)
    intra, cfg = SUPERRES_STREAMS[name]
    assert len(resized) == cfg["n_frames"]
    # every plane and, where LR runs, the pre-CDEF snapshot: one call
    n_planes = 1 if cfg.get("monochrome") else 3
    lr = any(cfg.get("lr_types", (0,)))
    assert set(resized) <= {n_planes, 2 * n_planes}
    assert (2 * n_planes in resized) == lr
    want = golden_md5s(data, monkeypatch)
    assert len(want) == cfg["n_frames"]
    assert got == want
    if name in POST_FILTERS:
        assert (want, whole) == chip_smoke.POST_FILTERS[name]


@pytest.mark.parametrize("name", POST_FILTERS)
def test_post_filter_streams_are_committed(name):
    """The committed stream is its config's (whose md5s the super-res
    and grain parity tests hold to dav1d_tpu's golden path and to the
    ones chip_smoke.py holds)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        assert fh.read() == post_filter_stream(name)


def test_big_post_filter_streams_are_committed():
    # the 1080p streams take tens of seconds to generate: their bytes
    # are checked by size and header here, their md5s on the card
    for name in BIG_POST_FILTERS:
        with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
            data = fh.read()
        frames = list(IvfReader(data))
        assert len(frames) == BIG_POST_FILTERS[name][1]["n_frames"]
        assert name in chip_smoke.BIG_POST_FILTERS
