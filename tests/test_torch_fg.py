"""Film grain (ROADMAP item 6) in the port: the LUTs of ops/fg.py
(`_grain_data`, `_block_offsets`) equal to dav1d_tpu's on the grain
parameters of every test stream at bd 8/10/12 and every subsampling;
the plain `fgy_plain` / `fguv_plain` against dav1d_tpu's `_fgy_fn` /
`_fguv_fn` (JAX on the CPU, op by op), exactly, at bd 8/10/12 in every layout,
on the seeded cases of ops/kernel_cases.py grain_cases (overlap on and
off, chroma scaling from luma, the restricted range with and without
is_id, odd widths whose chroma reads one luma column past the width);
the frame contract of film_grain (copies outside the visible area and
of planes without grain); and the grain streams of
tests/torch_port_cases.py GRAIN_STREAMS decoded through the port's
public API (device="cpu") to the md5s of dav1d_tpu's golden numpy path
(DAV1D_TPU_BACKEND=numpy, fg_ref.apply_film_grain), each running the
grain, with apply_grain=False to the un-grained md5s, and a frame
shown again by show_existing_frame (an OBU appended here: the stream
generator writes none)."""
import os
import re
import struct

import jax
import numpy as np
import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.decoder import ObuStreamDecoder as JaxDecoder
from dav1d_tpu.ops import fg as jfg
from dav1d_tpu.ops.backend import device_scope
from dav1d_tpu_torch.bitstream.headers import ObuType
from dav1d_tpu_torch.decoder import ObuStreamDecoder as PortDecoder
from dav1d_tpu_torch.ops import fg
from dav1d_tpu_torch.ops import kernel_cases as kc
from tools.streamgen.gen import generate_intra_stream
from tools.streamgen.putbits import PutBits, wrap_obu

import chip_smoke
from torch_port_cases import (FG_CSFL, FG_FULL, FG_LAG3, FG_LAYOUTS,
                              GRAIN_STREAMS, POST_FILTERS, golden_md5s,
                              post_filter_stream, port_md5s)

torch.set_num_threads(2)


def _grain_params(cfg, **kw):
    """The film grain data of a 64x64 intra stream with grain
    parameters cfg, as dav1d_tpu's and the port's parsers give it."""
    data, _ = generate_intra_stream(64, 64, seed=1, film_grain=cfg, **kw)
    out = []
    for cls in (JaxDecoder, PortDecoder):
        dec = cls(do_recon=False)
        plans = [p for fr in IvfReader(data)
                 for p in dec.decode_temporal_unit(fr.data)]
        out.append(plans[0].f.frame_hdr.film_grain_data)
    return out


@pytest.mark.parametrize("name,cfg", [("full", FG_FULL), ("csfl", FG_CSFL),
                                      ("lag3", FG_LAG3),
                                      ("layouts", FG_LAYOUTS)],
                         ids=["full", "csfl", "lag3", "layouts"])
def test_luts_match_dav1d_tpu(name, cfg):
    for bd, ss in ((8, (1, 1)), (10, (1, 0)), (12, (0, 0))):
        hbd = {8: 0, 10: 1, 12: 2}[bd]
        layout = {(1, 1): 1, (1, 0): 2, (0, 0): 3}[ss]
        fj, fp = _grain_params(cfg, hbd=hbd, layout=layout)
        lj, sj = jfg._grain_data(fj, *ss, bd)
        lp, sp = fg._grain_data(fp, *ss, bd)
        for a, b in zip(lj + sj, lp + sp):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b)
        for n_rows, n_bx in ((34, 60), (2, 3)):
            assert np.array_equal(jfg._block_offsets(fj, n_rows, n_bx),
                                  fg._block_offsets(fp, n_rows, n_bx))
        L, S = fg.pack_tables(lp, sp, bd)
        for i in range(3):
            if lp[i] is not None:
                assert np.array_equal(L[i, :lp[i].shape[0]], lp[i])
            if sp[i] is not None:
                assert np.array_equal(S[i], sp[i])
    for sub in (0, 1):
        for bs in (16, 32):
            assert all(np.array_equal(a, b) for a, b in
                       zip(jfg._w_vecs(bs, sub), fg._w_vecs(bs, sub)))


def _jax_plane(case, p):
    """dav1d_tpu's _fgy_fn / _fguv_fn on plane p of a grain case: the
    grained visible area (numpy). The program runs op by op
    (jax.disable_jit: the same integer operations without XLA's compile
    of each bd and layout's program, most of these tests' time)."""
    pr = case["params"]
    bd, planes = pr["bd"], case["planes"]
    luts = case["luts"].astype(np.int32)
    scal = case["scal"].astype(np.int32)
    h, w, sx, sy = pr["h"], pr["w"], pr["sx"], pr["sy"]
    with device_scope(), jax.disable_jit():
        if p == 0:
            fn = jfg._fgy_fn(h, w, bd, pr["scaling_shift"], pr["overlap"],
                             pr["clip_range"], 82)
            return np.asarray(fn(planes[0][:h, :w], luts[0, :73], scal[0],
                                 case["off"]))
        ch, cw = (h + sy) >> sy, (w + sx) >> sx
        fn = jfg._fguv_fn(ch, cw, bd, pr["scaling_shift"], pr["overlap"],
                          pr["clip_range"], pr["is_id"], sx, sy, pr["csfl"],
                          pr["uv_luma_mult"][p - 1], pr["uv_mult"][p - 1],
                          pr["uv_offset"][p - 1], 82)
        return np.asarray(fn(planes[p][:ch, :cw],
                             planes[0][:ch << sy, :(cw << sx) + sx],
                             luts[p], scal[pr["scale_idx"][p]],
                             case["off"]))


def _check_against_dav1d_tpu(case):
    planes, fr, luts, scal, off = kc.grain_args(case, "cpu")
    out = fg.film_grain(planes, fr, luts, scal, off)
    ch, cw = fr.chroma
    assert any(fr.apply)
    for p in range(len(planes)):
        h, w = (fr.h, fr.w) if p == 0 else (ch, cw)
        if fr.apply[p]:
            assert np.array_equal(out[p][:h, :w].numpy(),
                                  _jax_plane(case, p)), (p, fr)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["mono", "420", "422", "444"])
def test_plain_matches_dav1d_tpu(bd, layout):
    # 71x49: blocks cut at both edges, and a 4:2:0 or 4:2:2 chroma that
    # reads the luma one column past its width
    _check_against_dav1d_tpu(kc.grain_case(bd, layout, 71, 49))


@pytest.mark.parametrize("name", sorted(kc.GRAIN_VARIANTS))
def test_plain_flags_match_dav1d_tpu(name):
    _check_against_dav1d_tpu(kc.grain_variant(name))


def test_film_grain_frame_contract():
    for case in kc.grain_cases():
        planes, fr, luts, scal, off = kc.grain_args(case, "cpu")
        srcs = [p.clone() for p in planes]
        out = fg.film_grain(planes, fr, luts, scal, off)
        ch, cw = fr.chroma
        for p, (o, s) in enumerate(zip(out, planes)):
            assert o is not s and torch.equal(s, srcs[p])
            h, w = (fr.h, fr.w) if p == 0 else (ch, cw)
            if not fr.apply[p]:
                assert torch.equal(o, s)
                continue
            inside = torch.zeros_like(s, dtype=torch.bool)
            inside[:h, :w] = True
            assert torch.equal(o[~inside], s[~inside])
            assert not torch.equal(o[inside], s[inside])


def test_film_grain_checks():
    case = kc.grain_case(8, 1, 71, 49)
    planes, fr, luts, scal, off = kc.grain_args(case, "cpu")
    with pytest.raises(ValueError, match="luts"):
        fg.film_grain(planes, fr, luts.int(), scal, off)
    with pytest.raises(ValueError, match="off"):
        fg.film_grain(planes, fr, luts, scal, off[:, :1])
    with pytest.raises(ValueError, match="plane 1"):
        fg.film_grain([planes[0], planes[1][:, :30], planes[2]], fr, luts,
                      scal, off)
    with pytest.raises(ValueError, match="chroma planes' reads"):
        fg.film_grain([planes[0][:, :71], *planes[1:]], fr, luts, scal, off)
    with pytest.raises(ValueError, match="needs CUDA"):
        fg.film_grain_cuda(planes, fr, luts, scal, off)


def test_unit_constant_is_the_kernels():
    path = os.path.join(os.path.dirname(fg.__file__), "..", "csrc",
                        "film_grain.cu")
    with open(path) as fh:
        assert re.search(r"constexpr int UNIT_W = (\d+);",
                         fh.read()).group(1) == str(fg.UNIT_W)


# (layout, luma rows, luma columns) of the unit plans checked: the
# GRAIN_GEOMETRIES' padded planes, 1080p, and planes a unit does not
# divide (rows of a band cut, columns not a multiple of 128)
UNIT_SHAPES = [(layout, -(-h // 128) * 128, -(-w // 128) * 128)
               for layout in (0, 1, 2, 3)
               for w, h in kc.GRAIN_GEOMETRIES + ((1920, 1080),)] + \
    [(1, 50, 132), (2, 33, 68), (3, 17, 260), (0, 9, 4)]


@pytest.mark.parametrize("layout,rows,cols", UNIT_SHAPES)
def test_units_store_every_int4_once(layout, rows, cols):
    """csrc/film_grain.cu's units (fg.grain_units) load and store every
    16-byte group of every plane exactly once, and the luma a chroma
    int4 averages (row k << sy, columns x << sx ..) is loaded in its own
    unit by the lanes it shuffles from: 2q and 2q + 1 when subsampled,
    its own lane otherwise."""
    sx, sy = kc._layout_ss(layout)
    shapes = [(rows, cols)] + [((rows + sy) >> sy, (cols + sx) >> sx)] * \
        (2 if layout else 0)
    shapes = [(r, -(-c // 4) * 4) for r, c in shapes]
    _, _, at = fg.grain_units(shapes, sx, sy)
    for p, (r, c) in enumerate(shapes):
        seen = np.zeros((r, c // 4), np.int64)
        np.add.at(seen, (at[p][:, 2], at[p][:, 3] // 4), 1)
        assert (seen == 1).all(), (p, shapes)
    luma = {(u, ln): (y, x) for u, ln, y, x in at[0].tolist()
            if y % (1 << sy) == 0}
    for p in range(1, len(shapes)):
        for u, ln, k, x in at[p].tolist():
            if sx:          # lanes 2q and 2q + 1 hold luma 2x .. 2x + 7
                q = ln & 15
                for h in (0, 1):
                    want = (k << sy, 2 * x + 4 * h)
                    if want[1] < shapes[0][1]:
                        assert luma[u, 2 * q + h] == want
            else:           # the lane's own luma int4
                assert luma[u, ln] == (k, x)


@pytest.fixture
def grained(monkeypatch):
    """The film_grain calls of a decode (their GrainFrames)."""
    seen = []
    run = fg.film_grain

    def spy(planes, fr, *a):
        seen.append(fr)
        return run(planes, fr, *a)
    monkeypatch.setattr(fg, "film_grain", spy)
    return seen


@pytest.mark.parametrize("name", sorted(GRAIN_STREAMS))
def test_grain_stream_md5s_match_golden(name, monkeypatch, grained):
    data = post_filter_stream(name)
    got, whole = port_md5s(data, stream_md5=True)
    intra, cfg = GRAIN_STREAMS[name]
    assert len(grained) == cfg["n_frames"]
    if name == "fg-odd-width-420":
        assert all(fr.w % 2 and fr.sx for fr in grained)
    want = golden_md5s(data, monkeypatch)
    assert len(want) == cfg["n_frames"]
    assert got == want
    if name in POST_FILTERS:
        assert (want, whole) == chip_smoke.POST_FILTERS[name]


def test_odd_width_chroma_reads_past_the_luma_width(monkeypatch):
    """4:2:0 chroma of an odd luma width w averages luma columns w - 1
    and w: the port reads column w of the clean planes as dav1d_tpu does
    (dav1d replicates column w - 1 there; ROADMAP.md section 3)."""
    from dav1d_tpu.api import Settings as JaxSettings
    from dav1d_tpu_torch.api import Decoder, Settings
    data = post_filter_stream("fg-odd-width-420")
    with monkeypatch.context() as mp:
        # dav1d_tpu's golden path only: the port decodes on the device
        # route, not on the port's golden route
        mp.setenv("DAV1D_TPU_BACKEND", "numpy")
        dec = JaxDecoder(settings=JaxSettings(n_threads=1,
                                              apply_grain=False))
        want = [pic for fr in IvfReader(data)
                for _plan, pic in dec.decode_temporal_unit(fr.data)]
    port = Decoder(Settings(device="cpu", apply_grain=False))
    got = []
    for fr in IvfReader(data):
        port.send_data(fr.data)
        got += list(port.pictures())
    assert len(got) == len(want) == 2
    w, h = want[0].w, want[0].h
    assert w % 2
    for a, b in zip(want, got):
        assert np.array_equal(a.planes[0][:h, w], b.planes[0][:h, w])
    # the column is no copy of column w - 1 here: reading it matters
    assert (want[0].planes[0][:h, w] != want[0].planes[0][:h, w - 1]).any()


def _show_existing(data, idx):
    """data with one more temporal unit: a frame header OBU that shows
    the frame in slot idx again (show_existing_frame = 1)."""
    pb = PutBits()
    pb.put_bit(1)               # show_existing_frame
    pb.put_bits(idx, 3)         # frame_to_show_map_idx
    pb.trailing_bits()
    tu = wrap_obu(ObuType.TD, b"") + wrap_obu(ObuType.FRAME_HDR, pb.data())
    n = len(list(IvfReader(data)))
    return data + struct.pack("<IQ", len(tu), n) + tu


def test_show_existing_frame_is_grained(monkeypatch, grained):
    # fg-inter's frames refresh slot 1 (the inter frames) and every slot
    # (the keyframe): show slot 1, an inter frame, again
    data = _show_existing(post_filter_stream("fg-inter"), 1)
    got = port_md5s(data)
    assert len(got) == 4 and len(grained) == 4
    assert got[3] == got[2]
    assert got == golden_md5s(data, monkeypatch)
    # the grain of the shown copy: the reference picture stayed clean
    clean = port_md5s(data, apply_grain=False)
    assert clean[3] == clean[2] and clean[3] != got[3]
