"""Shared inputs of the PyTorch-port parity tests: small synthetic intra
streams with every in-loop filter on (4:2:0 at 8, 10 and 12 bit, 4:2:2,
4:4:4 and monochrome), parsed by both packages; the streams of the host
golden walks (GOLDEN_WALKS); the super-res and film grain streams
(SUPERRES_STREAMS, GRAIN_STREAMS, BIG_POST_FILTERS); the kernels'
decompositions (deblock and CDEF tiles, the OBMC and warp assignments)
in plain torch; the `rec` fixture, the port's recorder turned on; and
the `hdr_golden` fixture, dav1d_tpu's md5s of the committed
stream HDR_TRANSCODE, decoded once a process. A test module that wants
a fixture imports it by name."""
import functools
import os
import threading
from collections import defaultdict

import numpy as np
import pytest

from tools.streamgen.gen import generate_intra_stream, generate_stream

# the tests/test_e2e_big.py filter set: deblock, CDEF, LR (luma
# switchable Wiener/SGR, chroma Wiener)
FILTERS = dict(lf_levels=(28, 28, 16, 16),
               cdef_params=(2, 1, [9, 25], [5, 13]), lr_types=(1, 2, 2))

STREAMS = {
    "8bit-420": dict(w=160, h=96, n_frames=2, seed=31),
    "10bit-420": dict(w=128, h=96, n_frames=2, seed=32, hbd=1),
    "8bit-444-tiles": dict(w=192, h=128, n_frames=2, seed=33, layout=3,
                           tile_log2_cols=1),
    "8bit-422": dict(w=96, h=64, n_frames=2, seed=34, layout=2),
    "12bit-420": dict(w=96, h=64, n_frames=2, seed=35, hbd=2),
    "8bit-mono": dict(w=96, h=64, n_frames=2, seed=36, monochrome=1),
}



@pytest.fixture
def rec(monkeypatch):
    """The port's recorder (dav1d_tpu_torch.utils.timing) on, with empty
    tables, period and thread state."""
    from dav1d_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "ENABLED", True)
    for name, kind in (("_T", float), ("_N", int), ("_C", int)):
        monkeypatch.setattr(timing, name, defaultdict(kind))
    monkeypatch.setattr(timing, "_LAST", {"phases": {}, "calls": {},
                                          "counters": {}})
    monkeypatch.setattr(timing, "_period", 0)
    monkeypatch.setattr(timing, "_local", threading.local())
    timing._hook_gc()             # as the first enabled phase() does
    return timing


def _pyr_refidx(fi):
    m = {1: (0,) * 7, 2: (0, 0, 0, 0, 1, 1, 1), 3: (0, 0, 0, 0, 2, 2, 1),
         4: (2, 2, 2, 2, 3, 3, 1), 5: (3, 2, 0, 4, 1, 1, 4)}
    return m[min(fi, 5)]


PYR = dict(order_hints=[0, 8, 4, 2, 6, 5], refidx_fn=_pyr_refidx,
           refresh_fn=lambda fi: 1 << fi)
# the streams whose frames need the host golden walks: leftovers that
# are not pure intra (interintra, blocks on scaled references with
# 8-tap and bilinear filters, scaled compounds, warped compounds of
# global motion) and intrabc frames; (intra stream?, generator
# arguments), the configs of tests/test_torch_inter.py (interintra,
# gmv with compounds allowed), tests/test_e2e_superres.py (scaled-ref*)
# and tests/test_e2e_layouts.py (i444-intrabc). Their bytes are
# committed under tests/data/torch_golden/ for chip_smoke.py's
# golden_walks phase (write_golden_walks), which holds their md5s.
GOLDEN_WALKS = {
    "interintra": (False, dict(w=96, h=96, n_frames=5, seed=25,
                               inter_intra=1, **PYR, **FILTERS)),
    "scaled-ref": (False, dict(
        w=96, h=96, n_frames=3, seed=84,
        frame_size_fn=lambda fi: (64, 64) if fi == 1 else None)),
    "scaled-ref-bilin": (False, dict(
        w=96, h=96, n_frames=3, seed=89, subpel_filter_switchable=0,
        subpel_filter=3,
        frame_size_fn=lambda fi: (64, 64) if fi == 1 else None)),
    "scaled-ref-compound": (False, dict(
        w=96, h=96, n_frames=4, seed=86, jnt_comp=1, masked_compound=1,
        inter_intra=1, order_hints=[0, 8, 4, 2], refidx_fn=_pyr_refidx,
        refresh_fn=lambda fi: 1 << fi,
        frame_size_fn=lambda fi: {2: (64, 64), 3: (72, 56)}.get(fi))),
    "gmv-compound": (False, dict(
        w=96, h=96, n_frames=4, seed=44, warped_motion=1,
        switchable_comp_refs=1,
        gmv_types=lambda fi, rng: [2, 0, 1, 0, 3, 0, 0])),
    "i444-intrabc": (True, dict(w=96, h=96, qidx=100, seed=306, n_frames=2,
                                layout=3, screen_content=1,
                                allow_intrabc=1)),
}
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "torch_golden")


def golden_walk_stream(name):
    """The generated bytes of a GOLDEN_WALKS stream."""
    intra, cfg = GOLDEN_WALKS[name]
    cfg = dict(cfg)
    w, h = cfg.pop("w"), cfg.pop("h")
    gen = generate_intra_stream if intra else generate_stream
    return gen(w, h, **cfg)[0]


def write_golden_walks():
    """Write every GOLDEN_WALKS stream to GOLDEN_DIR/<name>.ivf:
    python -c 'import sys; sys.path[:0] = ["tests", "."];
    import torch_port_cases as c; c.write_golden_walks()'"""
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in GOLDEN_WALKS:
        with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "wb") as fh:
            fh.write(golden_walk_stream(name))


# super-res and film grain (ROADMAP items 4 and 6): the configs of
# tests/test_e2e_superres.py (its sr-* streams), tests/test_e2e_layouts
# .py (its *-superres and *-grain streams) and tests/test_e2e_filmgrain
# .py (every stream; names prefixed fg-), as (intra stream?, generator
# arguments), and two 4:2:0 grain streams: of an odd luma width, whose
# chroma reads the luma one column past it, and of a luma width that
# fills the padded plane
FG_FULL = dict(seed=1234, y_points=[(0, 64), (128, 96), (255, 48)],
               ar_coeff_lag=2,
               ar_coeffs_y=[3, -2, 5, 1, -4, 2, 0, 6, -1, 2, 4, -3],
               scaling_shift=9,
               uv_points=[[(0, 32), (255, 80)], [(16, 48), (200, 64)]],
               ar_coeffs_uv=[[1, -1, 2, 0, 3, -2, 1, 0, 2, -1, 0, 1, 5],
                             [0, 2, -3, 1, 0, 4, -1, 2, 0, 1, -2, 3, 7]],
               uv_mult=[20, -10], uv_luma_mult=[60, 80],
               uv_offset=[30, -40], overlap_flag=1,
               clip_to_restricted_range=0)
FG_CSFL = dict(seed=999, y_points=[(0, 40), (255, 120)], ar_coeff_lag=1,
               ar_coeffs_y=[10, -5, 3, 2], chroma_scaling_from_luma=1,
               ar_coeffs_uv=[[1, 2, 3, 4, 5], [5, 4, 3, 2, 1]],
               overlap_flag=0, clip_to_restricted_range=1,
               grain_scale_shift=1)
FG_LAG3 = dict(seed=5, y_points=[(0, 80), (255, 100)], ar_coeff_lag=3,
               ar_coeffs_y=list(range(-12, 12)), overlap_flag=1,
               uv_points=[[(0, 60)], [(0, 50)]],
               ar_coeffs_uv=[list(range(-12, 13)),
                             list(range(12, -13, -1))],
               uv_mult=[5, -5], uv_luma_mult=[70, 50],
               uv_offset=[10, -10])
# FG_FULL with chroma scaled by the luma alone, steeply: the chroma
# grain follows every step of the luma average
FG_STEEP = dict(FG_FULL, uv_points=[[(0, 0), (255, 255)], [(0, 255),
                                                          (255, 0)]],
                uv_mult=[0, 0], uv_luma_mult=[64, 64], uv_offset=[0, 0])
# tests/test_e2e_layouts.py's grain and filter sets
FG_LAYOUTS = dict(seed=77, y_points=[(0, 60), (255, 90)], ar_coeff_lag=2,
                  ar_coeffs_y=[3, -2, 5, 1, -4, 2, 0, 6, -1, 2, 4, -3],
                  uv_points=[[(0, 32), (255, 80)], [(16, 48), (200, 64)]],
                  ar_coeffs_uv=[[1, -1, 2, 0, 3, -2, 1, 0, 2, -1, 0, 1, 5],
                                [0, 2, -3, 1, 0, 4, -1, 2, 0, 1, -2, 3, 7]],
                  uv_mult=[20, -10], uv_luma_mult=[60, 80],
                  uv_offset=[30, -40], overlap_flag=1)
LAYOUT_FILTERS = dict(lf_levels=(20, 18, 12, 10),
                      cdef_params=(2, 1, [9, 5], [3, 2]), lr_types=(2, 2, 2))


def _sr_pyr_refidx(fi):
    m = {1: (0,) * 7, 2: (0, 0, 0, 0, 1, 1, 1), 3: (0, 0, 0, 0, 2, 2, 1)}
    return m[min(fi, 3)]


SR_PYR = dict(order_hints=[0, 8, 4, 2], refidx_fn=_sr_pyr_refidx,
              refresh_fn=lambda fi: 1 << fi)
SUPERRES_STREAMS = {
    "sr-intra": (True, dict(w=96, h=96, qidx=120, seed=70, n_frames=2,
                            superres_denom=12)),
    "sr-intra-lr": (True, dict(w=96, h=96, qidx=120, seed=71, n_frames=2,
                               superres_denom=12, lr_types=(2, 2, 2))),
    "sr-intra-all-filters": (True, dict(
        w=128, h=96, qidx=130, seed=72, n_frames=2, superres_denom=10,
        lr_types=(1, 1, 1), lr_unit_shift=1,
        cdef_params=(1, 1, [4, 6], [2, 1]), lf_levels=(18, 16, 10, 8))),
    "sr-intra-hbd": (True, dict(w=96, h=96, qidx=120, seed=73, n_frames=2,
                                hbd=1, superres_denom=16,
                                lr_types=(2, 0, 0))),
    "sr-intra-odd": (True, dict(w=70, h=50, qidx=120, seed=74, n_frames=2,
                                superres_denom=13)),
    "sr-inter": (False, dict(w=96, h=96, n_frames=3, seed=80,
                             superres_denom=12)),
    "sr-inter-filters": (False, dict(
        w=96, h=96, n_frames=4, seed=81, superres_denom=14,
        lf_levels=(20, 18, 12, 10), cdef_params=(2, 1, [9, 5], [3, 2]),
        lr_types=(2, 2, 2))),
    "sr-inter-pyr": (False, dict(w=96, h=96, n_frames=4, seed=82,
                                 superres_denom=11, jnt_comp=1, **SR_PYR)),
    "sr-inter-hbd": (False, dict(w=96, h=96, n_frames=3, seed=83, hbd=1,
                                 superres_denom=12)),
    "sr-bilin": (False, dict(w=96, h=96, n_frames=3, seed=90,
                             subpel_filter_switchable=0, subpel_filter=3,
                             superres_denom=12)),
    "i444-superres": (False, dict(w=96, h=96, n_frames=3, seed=340,
                                  layout=3, superres_denom=12)),
    "i422-superres": (False, dict(w=96, h=96, n_frames=3, seed=341,
                                  layout=2, superres_denom=12)),
    "mono-superres": (False, dict(w=96, h=96, n_frames=3, seed=342,
                                  monochrome=1, superres_denom=12)),
}
GRAIN_STREAMS = {
    "fg-full": (True, dict(w=96, h=96, qidx=120, seed=30, n_frames=2,
                           film_grain=FG_FULL)),
    "fg-chroma-from-luma": (True, dict(w=96, h=96, qidx=120, seed=31,
                                       n_frames=2, film_grain=FG_CSFL)),
    "fg-inter": (False, dict(w=96, h=96, n_frames=3, seed=95,
                             film_grain=FG_FULL,
                             lf_levels=(20, 20, 14, 14))),
    "fg-hbd": (True, dict(w=96, h=96, qidx=120, seed=32, n_frames=2,
                          hbd=1, film_grain=FG_FULL)),
    "fg-odd-size": (True, dict(w=70, h=50, qidx=120, seed=33, n_frames=2,
                               film_grain=FG_FULL)),
    "fg-lag3": (True, dict(w=96, h=96, qidx=150, seed=34, n_frames=2,
                           film_grain=FG_LAG3)),
    "i444-grain": (True, dict(w=96, h=96, qidx=120, seed=304, n_frames=2,
                              layout=3, film_grain=FG_LAYOUTS)),
    "i422-grain": (True, dict(w=96, h=96, qidx=120, seed=314, n_frames=2,
                              layout=2, film_grain=FG_LAYOUTS)),
    "i420-12b-grain": (True, dict(w=96, h=96, qidx=120, seed=335,
                                  n_frames=2, hbd=2, film_grain=FG_LAYOUTS)),
    "fg-odd-width-420": (True, dict(w=71, h=49, qidx=120, seed=36,
                                    n_frames=2, film_grain=FG_STEEP,
                                    **LAYOUT_FILTERS)),
    "fg-full-width-420": (True, dict(w=128, h=64, qidx=120, seed=37,
                                     n_frames=1, film_grain=FG_FULL)),
}
# the streams chip_smoke.py decodes on the card (committed under
# GOLDEN_DIR, write_post_filters): its phases sr-1080p, fg-1080p and
# fg-1080p-10b (1080p intra streams, every in-loop filter on; sr-1080p
# is coded 960 wide and LR runs on the upscaled frame), and the small
# streams of its post_filters phase
BIG_POST_FILTERS = {
    "sr-1080p": (True, dict(w=1920, h=1080, qidx=120, seed=72, n_frames=2,
                            superres_denom=16, **FILTERS)),
    "fg-1080p": (True, dict(w=1920, h=1080, qidx=120, seed=30, n_frames=2,
                            film_grain=FG_FULL, **FILTERS)),
    "fg-1080p-10b": (True, dict(w=1920, h=1080, qidx=120, seed=30,
                                n_frames=2, hbd=1, film_grain=FG_CSFL,
                                **FILTERS)),
}
POST_FILTERS = ("sr-inter-filters", "sr-intra-hbd", "i422-superres",
                "mono-superres", "fg-inter", "fg-chroma-from-luma",
                "fg-lag3", "i420-12b-grain", "i444-grain")
POST_FILTER_CONFIGS = {**SUPERRES_STREAMS, **GRAIN_STREAMS,
                       **BIG_POST_FILTERS}


def post_filter_stream(name):
    """The generated bytes of a SUPERRES_STREAMS, GRAIN_STREAMS or
    BIG_POST_FILTERS stream."""
    intra, cfg = POST_FILTER_CONFIGS[name]
    cfg = dict(cfg)
    w, h = cfg.pop("w"), cfg.pop("h")
    gen = generate_intra_stream if intra else generate_stream
    return gen(w, h, **cfg)[0]


def write_post_filters(names=POST_FILTERS + tuple(BIG_POST_FILTERS)):
    """Write the POST_FILTERS and BIG_POST_FILTERS streams to
    GOLDEN_DIR/<name>.ivf:
    python -c 'import sys; sys.path[:0] = ["tests", "."];
    import torch_port_cases as c; c.write_post_filters()'"""
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names:
        with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "wb") as fh:
            fh.write(post_filter_stream(name))


def port_md5s(data, stream_md5=False, **settings):
    """Per-picture md5s of the port's decode on the CPU (and, with
    stream_md5, the md5 of one muxer over all of them)."""
    from dav1d_tpu.bitstream.ivf import IvfReader
    from dav1d_tpu_torch.api import Decoder, Settings
    from dav1d_tpu_torch.utils.muxers import Md5Muxer
    dec = Decoder(Settings(device="cpu", **settings))
    out, whole = [], Md5Muxer()
    for fr in IvfReader(data):
        dec.send_data(fr.data)
        for pic in dec.pictures():
            m = Md5Muxer()
            m.write_picture(pic)
            whole.write_picture(pic)
            out.append(m.digest())
    return (out, whole.digest()) if stream_md5 else out


def golden_md5s(data, monkeypatch, **settings):
    """Per-picture md5s of dav1d_tpu's golden numpy path."""
    from dav1d_tpu.api import Settings as JaxSettings
    from dav1d_tpu.bitstream.ivf import IvfReader
    from dav1d_tpu.decoder import ObuStreamDecoder
    from dav1d_tpu.utils.muxers import Md5Muxer as JaxMd5
    monkeypatch.setenv("DAV1D_TPU_BACKEND", "numpy")
    dec = ObuStreamDecoder(settings=JaxSettings(n_threads=1, **settings))
    out = []
    for fr in IvfReader(data):
        for _plan, pic in dec.decode_temporal_unit(fr.data):
            if pic is not None:
                m = JaxMd5()
                m.write_picture(pic)
                out.append(m.digest())
    monkeypatch.delenv("DAV1D_TPU_BACKEND")
    return out


HDR_TRANSCODE = "hdr-transcode-192x128"


@functools.lru_cache(maxsize=None)
def _hdr_golden():
    with open(os.path.join(GOLDEN_DIR, f"{HDR_TRANSCODE}.ivf"), "rb") as fh:
        data = fh.read()
    with pytest.MonkeyPatch.context() as mp:
        return tuple(golden_md5s(data, mp))


@pytest.fixture
def hdr_golden():
    """dav1d_tpu's golden numpy path's md5s of HDR_TRANSCODE, the
    committed 10-bit 2x2-tile stream of a keyframe and 3 inter frames,
    decoded once a process."""
    out = list(_hdr_golden())
    assert len(out) == 4
    return out


def stream(name):
    cfg = dict(STREAMS[name])
    w, h = cfg.pop("w"), cfg.pop("h")
    data, _ = generate_intra_stream(w, h, **cfg, **FILTERS)
    return data


def frame_planes(name):
    """Per frame: (dav1d_tpu plan, port plan, bitdepth, reconstructed
    int32 planes, dav1d_tpu-deblocked int32 planes)."""
    from dav1d_tpu.bitstream.ivf import IvfReader
    from dav1d_tpu.decoder import ObuStreamDecoder
    from dav1d_tpu.ops.lf import deblock_planes_device
    from dav1d_tpu.recon.intra_ref import reconstruct_intra_frame
    from dav1d_tpu_torch.decoder import ObuStreamDecoder as PortDecoder

    dj, dt = ObuStreamDecoder(do_recon=False), PortDecoder(do_recon=False)
    out = []
    for fr in IvfReader(stream(name)):
        for pj, pt in zip(dj.decode_temporal_unit(fr.data),
                          dt.decode_temporal_unit(fr.data)):
            pic = reconstruct_intra_frame(pj)
            planes = [np.asarray(p, np.int32) for p in pic.planes]
            dbk = [np.asarray(a) for a in
                   deblock_planes_device(planes, pj, pic.bpc)]
            out.append((pj, pt, pic.bpc, planes, dbk))
    assert out
    return out


def deblock_tiled_plain(entries, lut_e, lut_i, bd, tile=64, halo=12):
    """csrc/deblock.cu's decomposition of a frame's deblock, in plain
    torch: every tile x tile output tile of every plane deblocked (both
    directions, ops/lf.py deblock_frame_plain) on its own crop with a
    halo of `halo` pixels, zeros and inactive maps outside the plane,
    and the crop's interior kept. Equal to deblocking the whole planes
    exactly when the halo covers every edge that writes into a tile."""
    import torch
    from dav1d_tpu_torch.ops.lf import deblock_frame_plain
    out = []
    for plane, luma, vmaps, hmaps in entries:
        H, W = plane.shape
        res = torch.empty_like(plane)
        n = tile + 2 * halo
        for r0 in range(0, H, tile):
            for c0 in range(0, W, tile):
                y0, x0 = r0 - halo, c0 - halo
                ys, xs = max(y0, 0), max(x0, 0)
                ye, xe = min(y0 + n, H), min(x0 + n, W)
                crop = torch.zeros((n, n), dtype=plane.dtype)
                crop[ys - y0:ye - y0, xs - x0:xe - x0] = plane[ys:ye, xs:xe]
                maps = []
                for m in (vmaps, hmaps):
                    cls = torch.full((n // 4, n // 4), -1, dtype=torch.int8)
                    L = torch.zeros((n // 4, n // 4), dtype=torch.uint8)
                    sl = (slice((ys - y0) // 4, (ye - y0) // 4),
                          slice((xs - x0) // 4, (xe - x0) // 4))
                    cls[sl] = m[0][ys // 4:ye // 4, xs // 4:xe // 4]
                    L[sl] = m[1][ys // 4:ye // 4, xs // 4:xe // 4]
                    maps.append((cls, L))
                got = deblock_frame_plain([(crop, luma, *maps)], lut_e, lut_i,
                                          bd)[0]
                ih, iw = min(tile, H - r0), min(tile, W - c0)
                res[r0:r0 + ih, c0:c0 + iw] = got[halo:halo + ih,
                                                  halo:halo + iw]
        out.append(res)
    return out



def cdef_tiled_plain(planes, maps, Hy, Wy, layout, bd, damping, proj,
                     tile=64, apron=2, seed=0):
    """csrc/cdef.cu's decomposition of a frame's CDEF, in plain torch:
    per tile x tile luma tile (and its co-located chroma tiles), the
    8x8 blocks' directions searched in the tile alone
    (ops/cdef.py block_params_plain), and each plane's tile filtered
    (filter_plane_plain) from a window that holds the plane only within
    `apron` pixels of the tile (FILL outside the crop, as the kernel
    stages it), and random pixels and block parameters beyond; the
    crop's pixels kept, the rest copied through. Equal to
    cdef_planes_plain exactly when no tap of a tile's pixels reaches
    past the apron and no pixel depends on another tile's directions."""
    import torch
    from dav1d_tpu_torch.ops.cdef import (FILL, block_params_plain,
                                          filter_plane_plain)
    rng = np.random.default_rng(seed)
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    out = [p.clone() for p in planes]
    for ty in range(0, Hy, tile):
        for tx in range(0, Wy, tile):
            by0, bx0 = ty // 8, tx // 8
            by1, bx1 = min(Hy, ty + tile) // 8, min(Wy, tx + tile) // 8
            sub = maps[:, by0:by1, bx0:bx1]
            adj, y_dir, uv_dir = block_params_plain(
                planes[0][ty:by1 * 8, tx:bx1 * 8], sub, layout, bd, proj)
            for p, plane in enumerate(planes):
                sv, sh = (ss_ver, ss_hor) if p else (0, 0)
                bv, bh = 8 >> sv, 8 >> sh
                ch, cw = Hy >> sv, Wy >> sh
                th, tw = (by1 - by0) * bv, (bx1 - bx0) * bh
                y0, x0 = ty >> sv, tx >> sh
                # the window: one block of junk around the tile, the plane
                # (or FILL outside the crop) within the apron
                wh, ww = th + 2 * bv, tw + 2 * bh
                win = rng.integers(0, 1 << bd, (wh, ww)).astype(np.int32)
                yy = np.arange(y0 - apron, y0 + th + apron)[:, None]
                xx = np.arange(x0 - apron, x0 + tw + apron)[None, :]
                inside = (yy >= 0) & (yy < ch) & (xx >= 0) & (xx < cw)
                src = plane.numpy()[np.clip(yy, 0, ch - 1),
                                    np.clip(xx, 0, cw - 1)]
                win[bv - apron:bv + th + apron, bh - apron:bh + tw + apron] = \
                    np.where(inside, src, FILL)
                own = (adj, sub[1], y_dir, sub[4]) if p == 0 else \
                    (sub[2], sub[3], uv_dir, sub[5])
                grid = []
                for m in own:
                    g = torch.from_numpy(rng.integers(
                        0, 8, (by1 - by0 + 2, bx1 - bx0 + 2)).astype(
                            np.int32))
                    g[1:-1, 1:-1] = m
                    grid.append(g)
                got = filter_plane_plain(torch.from_numpy(win), grid[0],
                                         grid[1], grid[2],
                                         damping - (p > 0), wh, ww, bv, bh,
                                         grid[3], bd)
                out[p][y0:y0 + th, x0:x0 + tw] = got[bv:bv + th, bh:bh + tw]
    return out


def _frame_tiled_plain(kind, planes, tables, bd, tw):
    """csrc/lr_wiener.cu's or csrc/lr_sgr.cu's addressing of a frame's
    Wiener or SGR pass (kind), in plain torch: per block (item, first
    output column c0) of lr.item_blocks, the window's rows from the
    item's row table (a row r >= Hp from row r - Hp of pre) and its
    columns clamp(colbase + c0 + c, 0, w - 1) of the unpadded planes,
    the item's filter over tw output columns (lr._wiener_math or
    lr._sgr_math), written under the item's rows and the tile's columns
    into each plane's dst in place. planes and tables as lr.wiener_frame
    / lr.sgr_frame take them."""
    import torch
    from dav1d_tpu_torch.ops import lr
    from dav1d_tpu_torch.ops.device import device_tables
    items, rowt = tables
    blocks = lr.item_blocks(items)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64))
    for p, (src, pre, dst, w, _hmax) in enumerate(planes):
        blk = blocks[items[blocks[:, 0], 0] == p]
        if not len(blk):
            continue
        it, c0 = items[blk[:, 0]].astype(np.int64), blk[:, 1]
        cols = np.clip(it[:, 1, None] + c0[:, None] +
                       np.arange(tw + 6)[None, :], 0, w - 1)
        S = torch.cat([src, pre])[T(rowt[blk[:, 0]])[:, :, None],
                                  T(cols)[:, None, :]]
        hmax = rowt.shape[1] - 6
        if kind == "wiener":
            vals = lr._wiener_math(S, T(it[:, 6:13]).int(),
                                   T(it[:, 13:20]).int(), hmax, tw, bd)
        else:
            vals = lr._sgr_math(S, *(T(it[:, k]).int() for k in range(6, 10)),
                                hmax, tw, bd,
                                device_tables("cpu")["sgr_x_by_x"])
        lr._write_back(dst, vals, T(it[:, 2]), T(it[:, 3] + c0), T(it[:, 4]),
                       T(np.minimum(tw, it[:, 5] - c0)))


def wiener_frame_tiled_plain(planes, tables, bd, tw=64):
    """_frame_tiled_plain of a frame's Wiener pass."""
    _frame_tiled_plain("wiener", planes, tables, bd, tw)


def sgr_frame_tiled_plain(planes, tables, bd, tw=64):
    """_frame_tiled_plain of a frame's SGR pass."""
    _frame_tiled_plain("sgr", planes, tables, bd, tw)


def _i32(*arrays):
    """Raise unless every value fits int32 (the kernel's type there)."""
    for a in arrays:
        a = np.asarray(a)
        assert a.size == 0 or (a.min() >= -2 ** 31 and a.max() < 2 ** 31)


def sgr_separable_plain(S, s0, s1, w0, w1, bd, xbyx, threads=512):
    """csrc/lr_sgr.cu's arithmetic for one block, in numpy: S is its
    window ((ohs + 6) x (cw + 6), int64), xbyx the x_by_x table. Box
    sums separable: per strip (threads // (cw + 2) strips of an even
    number of rows), each A/B column slides down the window rows from 3
    rows before the strip's first box, the 3- and 5-wide sums of the
    last 3 / 5 rows kept, and emits the boxes that end in the strip's
    rows (each once: checked);
    then the blend per strip of threads // cw strips of row pairs, the
    3x3 weighted sums of A and B as 3 x (three rows' 3-wide sums) + the
    middle row's + the centres above and below, from a 3-row window,
    and box5's 6/5 sums one per row pair. Checks that every sum the
    kernel keeps in int32 fits it. Returns the (ohs, cw) outputs."""
    S = np.asarray(S, np.int64)
    xbyx = np.asarray(xbyx, np.int64)
    rows, cols = S.shape
    ohs, cw = rows - 6, cols - 6
    bdm8 = bd - 8
    bw = cw + 2
    nj = (ohs + 1) // 2 + 1

    def calc_ab(sq, sm, s, nn, one_by_x):
        _i32(sq, sm)
        a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
        b = (sm + ((1 << bdm8) >> 1)) >> bdm8
        _i32(a * nn, b * b)
        p = np.maximum(a * nn - b * b, 0)
        x = xbyx[np.minimum((p * s + (1 << 19)) >> 20, 255)]
        A = (x * sm * one_by_x + (1 << 11)) >> 12
        _i32(A)
        assert x.max() <= 255
        return A, x

    A3 = np.zeros((ohs + 2, bw), np.int64)
    B3 = np.zeros_like(A3)
    A5 = np.zeros((nj, bw), np.int64)
    B5 = np.zeros_like(A5)
    n3 = np.zeros(ohs + 2, int)
    n5 = np.zeros(nj, int)
    strips = threads // bw
    per = (-(-(ohs + 3) // strips) + 1) & ~1
    for q in range(strips):
        e0 = 3 + q * per
        e1 = min(ohs + 6, e0 + per)
        if e0 >= e1:
            continue
        z = np.zeros(bw, np.int64)
        h3, q3, h5, q5 = [z] * 2, [z] * 2, [z] * 4, [z] * 4
        for r in range(e0 - 3, e1):
            v = [S[r, k:k + bw] for k in range(5)]
            h3r = v[1] + v[2] + v[3]
            q3r = v[1] ** 2 + v[2] ** 2 + v[3] ** 2
            h5r, q5r = h3r + v[0] + v[4], q3r + v[0] ** 2 + v[4] ** 2
            if r >= e0:
                if w1 and r <= ohs + 4:
                    A3[r - 3], B3[r - 3] = calc_ab(
                        q3[0] + q3[1] + q3r, h3[0] + h3[1] + h3r, s1, 9, 455)
                    n3[r - 3] += 1
                if w0 and r % 2 == 0 and 4 <= r < 2 * nj + 4:
                    A5[(r - 4) // 2], B5[(r - 4) // 2] = calc_ab(
                        sum(q5) + q5r, sum(h5) + h5r, s0, 25, 164)
                    n5[(r - 4) // 2] += 1
            h3, q3 = [h3[1], h3r], [q3[1], q3r]
            h5, q5 = h5[1:] + [h5r], q5[1:] + [q5r]
    assert (n3 == (1 if w1 else 0)).all() and (n5 == (1 if w0 else 0)).all()

    def row3(M, k):
        return M[k, 0:cw] + M[k, 1:cw + 1] + M[k, 2:cw + 2], M[k, 1:cw + 1]

    def hwin(M, j):
        return 6 * M[j, 1:cw + 1] + 5 * (M[j, 0:cw] + M[j, 2:cw + 2])

    out = np.full((ohs, cw), -1, np.int64)
    strips = threads // cw
    per = ((-(-ohs // strips)) + 1) & ~1
    for q in range(strips):
        r0, r1 = q * per, min(ohs, q * per + per)
        if r0 >= r1:
            continue
        a3 = [row3(A3, r0), row3(A3, r0 + 1)]
        b3 = [row3(B3, r0), row3(B3, r0 + 1)]
        a5, b5 = hwin(A5, r0 // 2), hwin(B5, r0 // 2)
        for r in range(r0, r1, 2):
            a5n, b5n = hwin(A5, r // 2 + 1), hwin(B5, r // 2 + 1)
            for rr in range(r, min(r + 2, r1)):
                px = S[rr + 3, 3:3 + cw]
                v = np.zeros(cw, np.int64)
                if w1:
                    a3.append(row3(A3, rr + 2))
                    b3.append(row3(B3, rr + 2))
                    wa = 3 * (a3[0][0] + a3[1][0] + a3[2][0]) + a3[1][0] + \
                        a3[0][1] + a3[2][1]
                    wb = 3 * (b3[0][0] + b3[1][0] + b3[2][0]) + b3[1][0] + \
                        b3[0][1] + b3[2][1]
                    _i32(wa, wb * px)
                    v += w1 * ((wa - wb * px + (1 << 8)) >> 9)
                    a3, b3 = a3[1:], b3[1:]
                if w0:
                    if rr & 1:
                        t5 = (a5n - b5n * px + (1 << 7)) >> 8
                    else:
                        _i32(a5 + a5n, (b5 + b5n) * px)
                        t5 = (a5 + a5n - (b5 + b5n) * px + (1 << 8)) >> 9
                    v += w0 * t5
                _i32(v)
                out[rr] = np.clip(px + ((v + (1 << 10)) >> 11), 0,
                                  (1 << bd) - 1)
            a5, b5 = a5n, b5n
    assert (out >= 0).all()
    return out


def obmc_assigned_plain(planes, top, left, bd, fb, om, max_blocks,
                        warps=3):
    """csrc/mc_obmc.cu's assignment of laps to warps, in plain torch: a
    grid of min(max_blocks, ceil(max(top, left laps) / warps)) blocks of
    `warps` warps; warp g of the grid blends laps g, g + G, g + 2 G, ..
    (G the grid's warps) of the top laps, all warps meet at the
    grid-wide barrier, then the same over the left laps. The laps of a
    direction go in an order no warp would keep (each round's warps in
    reverse) through ops/mc_obmc.py obmc_plain one lap at a time.
    Checks that every lap is blended once. planes as obmc_cuda takes
    them, in place; top / left (n, 13) int32 tensors or None."""
    from dav1d_tpu_torch.ops.mc_obmc import obmc_plain
    n = [0 if t is None else len(t) for t in (top, left)]
    blocks = min(max_blocks, -(-max(n) // warps))
    G = blocks * warps
    for t, jobs, m in ((1, top, n[0]), (0, left, n[1])):
        done = np.zeros(m, int)
        for k in range(-(-m // G) if m else 0):
            for g in reversed(range(G)):
                i = g + k * G
                if i < m:
                    refs, plane, rh, rw = planes[int(jobs[i, 1])]
                    obmc_plain(refs, jobs[i:i + 1], plane, rh, rw, bd, fb,
                               om, t)
                    done[i] += 1
        assert (done == 1).all()        # the barrier: this direction ends
    return [p for _, p, _, _ in planes]


def warp_assigned_plain(planes, jobs, bd, wf, warps=8):
    """csrc/mc_warp.cu's assignment of tiles and its arithmetic, in
    numpy: ceil(tiles / warps) blocks of `warps` warps; warp w of block
    b warps tile b * warps + w (none past the last tile), taken here in
    an order no warp would keep (each block's warps in reverse, the
    blocks from the last). A tile's window is read as the kernel reads
    it: 16 columns a row, row and column 15 read at 14 and dropped, the
    clamp only where the window touches the frame's edge; the bank goes
    through the kernel's int8 rows, each tap sign-extended from its
    byte of two little-endian 32-bit words; the horizontal sums by lane
    (y, h) = (l >> 1, l & 1), l < 30, outputs x = 4 h + i, i < 4, of
    row y from window columns 4 h .. 4 h + 10; the vertical ones by
    lane (g, x) = (l >> 3, l & 7), rows 2 g + t, t < 2, from
    intermediate rows 2 g .. 2 g + 8. Checks that every tile is warped
    once. planes as warp_cuda takes them (CPU tensors), in place; jobs
    (n, 12)."""
    bank = np.ascontiguousarray(np.asarray(wf), np.int8)
    words = np.frombuffer(bank.tobytes(), "<u4").reshape(-1, 2)
    taps = np.concatenate(
        [np.stack([((words[:, w] >> (8 * b)) & 0xff).astype(np.uint8)
                   .view(np.int8) for b in range(4)], 1) for w in (0, 1)],
        1).astype(np.int64)
    assert np.array_equal(taps, np.asarray(wf))
    ib = 2 if bd == 12 else 4
    jobs = np.asarray(jobs)
    n = len(jobs)
    done = np.zeros(n, int)
    e = np.arange(256)
    rows, cols = np.minimum(e >> 4, 14), np.minimum(e & 15, 14)
    keep = ((e >> 4) < 15) & ((e & 15) < 15)
    lh = np.arange(30)
    yh = np.repeat(lh >> 1, 4)                     # per (lane, i)
    xh = np.repeat(4 * (lh & 1), 4) + np.tile(np.arange(4), 30)
    lv = np.arange(32)
    yv = (2 * (lv >> 3))[:, None] + np.arange(2)   # (lane, t)
    xv = np.broadcast_to((lv & 7)[:, None], yv.shape)
    yv, xv = yv.reshape(-1), xv.reshape(-1)
    for b in reversed(range(-(-n // warps))):
        for w in reversed(range(warps)):
            i = b * warps + w
            if i >= n:
                continue
            pl, py, px, slot, dy, dx, mx, my, al, be, ga, de = \
                (int(v) for v in jobs[i])
            refs, plane, rh, rw = planes[pl]
            ref = refs[slot].numpy()
            y, x = dy - 3 + rows, dx - 3 + cols
            if not (dy >= 3 and dx >= 3 and dy + 12 <= rh and
                    dx + 12 <= rw):
                y, x = np.clip(y, 0, rh - 1), np.clip(x, 0, rw - 1)
            win = np.zeros((15, 15), np.int64)
            win[(e >> 4)[keep], (e & 15)[keep]] = ref[y, x][keep]
            fh = taps[np.clip(64 + ((mx + be * yh + al * xh + 512) >> 10),
                              0, 192)]
            s = sum(fh[:, t] * win[yh, xh + t] for t in range(8))
            mid = np.zeros((15, 8), np.int64)
            mid[yh, xh] = (s + ((1 << (7 - ib)) >> 1)) >> (7 - ib)
            fv = taps[np.clip(64 + ((my + de * yv + ga * xv + 512) >> 10),
                              0, 192)]
            s = sum(fv[:, t] * mid[yv + t, xv] for t in range(8))
            s = np.clip((s + ((1 << (7 + ib)) >> 1)) >> (7 + ib), 0,
                        (1 << bd) - 1)
            oy, ox = py + yv, px + xv
            m = (oy < plane.shape[0]) & (ox < plane.shape[1])
            plane.numpy()[oy[m], ox[m]] = s[m]
            done[i] += 1
    assert (done == 1).all()
    return [p for _, p, _, _ in planes]


# the intra-leftover streams (ROADMAP item 5b): the five CONFIGS of
# tests/test_lo_device.py (inter frames whose leftover blocks use CFL
# and the directional modes; 4:4:4, 4:2:2 at 10 bit, 2x2 tiles) as
# lo-<name>, and a screen-content stream whose inter frame has a
# palette leftover (the device plan declines it: the host route).
# Committed under GOLDEN_DIR (write_lo_streams); chip_smoke.py holds
# their golden md5s.
LO_STREAMS = {
    "lo-base": dict(w=96, h=96, n_frames=5, seed=3),
    "lo-dense": dict(w=160, h=128, n_frames=5, seed=13, qidx=60),
    "lo-444": dict(w=96, h=96, n_frames=4, seed=7, layout=3),
    "lo-422-hbd": dict(w=96, h=96, n_frames=4, seed=9, layout=2, hbd=1),
    "lo-multitile": dict(w=128, h=128, n_frames=4, seed=46,
                         tile_log2_cols=1, tile_log2_rows=1),
}
LO_PALETTE = dict(w=64, h=64, n_frames=3, seed=0, screen_content=1)


def lo_stream(name):
    """The generated bytes of a LO_STREAMS stream."""
    cfg = dict(LO_STREAMS[name])
    w, h = cfg.pop("w"), cfg.pop("h")
    return generate_stream(w, h, **cfg)[0]


def write_lo_streams():
    """Write every LO_STREAMS stream to GOLDEN_DIR/<name>.ivf:
    python -c 'import sys; sys.path[:0] = ["tests", "."];
    import torch_port_cases as c; c.write_lo_streams()'"""
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in LO_STREAMS:
        with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "wb") as fh:
            fh.write(lo_stream(name))


# the mesh streams (ROADMAP item 10): tests/test_multichip.py's RICH
# stream (256x128, 2x2 tiles, every inter tool, the full filter chain;
# every inter frame has intra leftovers, so its planes come back to the
# host), the same with 128x128 superblocks and without intra or
# interintra blocks (its inter frames' planes stay on the shards into
# the filter chain; at 8 shards of 64 columns its 128-wide blocks
# straddle the bands, so their jobs reach into the MC apron) and
# test_multichip's
# super-res stream (192x96, denominator 12), committed under
# GOLDEN_DIR (write_mesh_streams); tools/torch_mesh_md5s.py records
# dav1d_tpu's single_device_md5 and golden md5 of each (chip_smoke.py
# MESH_MD5S)
MESH_STREAMS = {
    "mesh-rich-256x128": (256, 128, dict(
        n_frames=4, seed=5, tile_log2_cols=1, tile_log2_rows=1,
        warped_motion=1, switchable_motion_mode=1, jnt_comp=1,
        inter_intra=1, masked_compound=1, allow_skip_mode=1,
        lf_levels=(32, 32, 20, 20),
        cdef_params=(2, 1, [9, 25], [5, 13]), lr_types=(1, 2, 2))),
    "mesh-inter-256x128": (256, 128, dict(
        n_frames=4, seed=5, tile_log2_cols=1, tile_log2_rows=1, sb128=1,
        warped_motion=1, switchable_motion_mode=1, jnt_comp=1,
        masked_compound=1, allow_skip_mode=1, intra_prob=0.0,
        lf_levels=(32, 32, 20, 20),
        cdef_params=(2, 1, [9, 25], [5, 13]), lr_types=(1, 2, 2))),
    "mesh-superres-192x96": (192, 96, dict(
        n_frames=3, seed=9, superres_denom=12,
        lf_levels=(24, 24, 12, 12), lr_types=(1, 1, 1))),
}


def write_mesh_streams():
    """Write every MESH_STREAMS stream to GOLDEN_DIR/<name>.ivf:
    python -c 'import sys; sys.path[:0] = ["tests", "."];
    import torch_port_cases as c; c.write_mesh_streams()'"""
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (w, h, cfg) in MESH_STREAMS.items():
        with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "wb") as fh:
            fh.write(generate_stream(w, h, **cfg)[0])


# the golden md5s of the GOLDEN_WALKS and LO_STREAMS streams committed
# under GOLDEN_DIR, as chip_smoke.py holds them (dav1d_tpu's golden
# numpy path: DAV1D_TPU_BACKEND=numpy, Settings(n_threads=1),
# dav1d_tpu.utils.muxers.Md5Muxer): per picture, and over the stream
COMMITTED_MD5S = {
    "interintra": ([
        "b51d9fe04f7b1ccda13f06c37c4d02a7",
        "bb082a011dfad46646abc50b00223c09",
        "c9694df0a7d74d45682707a660ef440c",
        "858ff9c3524b8d239a18f97739a0f68d",
        "e901f9863a40740c31d979c444973cf0"],
        "082cc584f3404d73a4470fe63e04f663"),
    "scaled-ref": ([
        "3a7b61513ad272ec99fad7569eeee006",
        "1d09e5943b3b265c2c6d454f54cf7ff6",
        "1f80038e5848d9789015ce697b359adf"],
        "3deb78aea7a4adaa2ad81f348df5c161"),
    "scaled-ref-bilin": ([
        "fc370c12cc1686efc7a11cf6665600ff",
        "5ee7278384fda49bde370bf140188200",
        "a6f5a4989e5350fe5dc5888ff59f9ed1"],
        "aa7f923769e695e542ead4b731386a0f"),
    "scaled-ref-compound": ([
        "de905a63f314787e5b62b570a27d261a",
        "376e147ebb3a9c44f7d952363ffaca29",
        "d8349135dd7437c042269b79d78a0f4f",
        "19b6fd60f1009ec7d99322cce55b6f90"],
        "dbe88cf410ac60997573bb2be5ca15c5"),
    "gmv-compound": ([
        "c592adce0c1ce94510b3cb0b99c0b1f2",
        "fd5c4363073048b8f999e019c3126afc",
        "9373ccbd697084195846ab77f58803c7",
        "e92965be78ad51615be9ddb3b013a759"],
        "0c6952401fb7efa5c3b3b2ef74ec19f4"),
    "i444-intrabc": ([
        "d5ba24a049e6d0e44d9a01a11b49b424",
        "39df4a5e05d890c910eef9d5442e01f5"],
        "4e0798ea6c5711b258752c57151ab9f9"),
    "lo-base": ([
        "c906785a93e8a9d93b24337f8c7b3641",
        "92ab5684d1e68404bdec59009d66532c",
        "bc942e38bcc6ee6d25ad22adfc51d091",
        "85aa2c2eadf36d6313feafe454fb4b46",
        "e42f587f345ff1c16aac054ddc83711a"],
        "5e87399e27bd981cb785061d8250501a"),
    "lo-dense": ([
        "beca61e863abb95d3b252c43c4b45584",
        "594899087e2954d972cfadd0ad703dfe",
        "a65f4cca26e3f68acea1162ce2958799",
        "c31c2ffbb48315ea186ad4c3d7616456",
        "ea6dd5a7d1d3ac31d6e03291a61e6ada"],
        "cf10ca2b761b2df9f1d5763b076723af"),
    "lo-444": ([
        "59f99a8daec927c475d0403ab3b1aa67",
        "6235cc095c44c6aa248d0aae9158e7f8",
        "959d9a4e2b9707bdaeaf8cf822ec50b6",
        "7887fb85b3c062fc447772ea1e661dc0"],
        "e69b1feff882fbbecbd43067e12f91a1"),
    "lo-422-hbd": ([
        "be9566fec58caae6b2952aa39bfee7b6",
        "4fda2ce8778d3955fa296741cfc9d7a0",
        "926d6e6e40a0719c2aa68091587ebcfe",
        "b72e1c5e82c74978e95e1bc7bae6c703"],
        "da547a124006071b45d7f68eaa101e8e"),
    "lo-multitile": ([
        "88be97e22317daceb314947a2b85a1e3",
        "cf84a97dd9f9bed7d52e9d8fea6ed19b",
        "9cc350126feb60d38acc2a15818765b6",
        "3ed1498a87d35d35e6e920c77b807d2a"],
        "2503f1161c70844b20fd4a8a95cf8ec2")}



# whole bench streams on the CPU (tools/torch_golden_md5s.py): the port's
# golden host route and dav1d_tpu's golden numpy path
# (DAV1D_TPU_BACKEND=numpy, Settings(n_threads=1)) gave the same per
# picture and over the stream; chip_smoke.py holds them as
# MD5S_S33_WHOLE / MD5_S33_WHOLE and MD5S_S21 / MD5_S21
WHOLE_STREAM_MD5S = {
    "bench_streams/3840x2160_10b_flt_s33_enc.ivf": ([
        "2ed9103fb6b4e5d644968bac73475bed",
        "b002aae1da5dad11bfaeb690e02324eb",
        "0ea3a49559a62da3697d5c0361b0634e",
        "b289b5e89d996ffdcd398f3db7f16936"],
        "efde4596f0e92078596e7f3718950adc"),
    "bench_streams/1920x1080_8b_flt_s21_realistic.ivf": ([
        "4f8685f869bd6b58685032fc33e76148",
        "88b1e76baec5b245a6811512e8399a78",
        "c383b45c31ec8260db6b347d81014be9",
        "06bc52ee7b1442c41dd15d74a928ed16",
        "8318eba61c0e7ac90dc381e171779043",
        "bd715cb6979b2a20ede813ac294660b1",
        "cd9ce8a7cfbfec0cce39391df9768dac",
        "13c63c4030659a15295efab93cc7efe0"],
        "63042eb16c0d77b60d33b02bf5cc152d"),
}
