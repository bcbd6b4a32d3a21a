"""Loop-restoration parity: the port's lr_planes_device (plain torch on
the CPU) against dav1d_tpu's (XLA on the CPU) on the CDEF output and
pre-CDEF planes of small decoded intra streams, Wiener and SGR units
both (4:2:0 at 8/10/12 bit, 4:2:2, 4:4:4, monochrome); the plain
Wiener and SGR against dav1d_tpu's _wiener_fn / _sgr_fn on the CUDA
kernels' seeded cases; the kernels' column tiling, the one-launch
Wiener's and SGR's reads of the unpadded planes (columns clamped), and
the SGR kernel's separable box sums, in plain torch and numpy.
Tolerance 0: bit-exact."""
import numpy as np
import pytest
import torch

from dav1d_tpu.ops.cdef import cdef_planes_device as jax_cdef
from dav1d_tpu.ops.lr import _sgr_fn, _wiener_fn
from dav1d_tpu.ops.lr import lr_planes_device as jax_lr
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops import lr
from dav1d_tpu_torch.ops.device import device_tables
from dav1d_tpu_torch.ops.lr import lr_planes_device

from torch_port_cases import (STREAMS, frame_planes, sgr_frame_tiled_plain,
                              sgr_separable_plain, wiener_frame_tiled_plain)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_lr_matches_dav1d_tpu(name):
    kinds = set()
    for pj, pt, bd, _planes, dbk in frame_planes(name):
        for pl_units in pj.lr_units:
            for row in pl_units or ():
                for u in row or ():
                    if u is not None and u["type"]:
                        kinds.add("wiener" if u["type"] == 2 else "sgr")
        cdf = [np.asarray(a) for a in jax_cdef(dbk, pj, bd)]
        ref = [np.asarray(a) for a in jax_lr(cdf, dbk, pj, bd)]
        got = lr_planes_device([torch.from_numpy(p.copy()) for p in cdf],
                               [torch.from_numpy(p.copy()) for p in dbk],
                               pt, bd)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(g.numpy(), np.asarray(r, np.int32)), \
                f"plane {i}"
    assert kinds == {"wiener", "sgr"}


# --- the kernel cases and the CUDA kernels' tiling, on the CPU ----------

def _xbyx():
    return device_tables("cpu")["sgr_x_by_x"]


def _plain(kind, args, dst=None):
    """The plain filter over an lr_args tuple, into dst (a fresh copy of
    its destination by default); returns dst."""
    dst = args[2].clone() if dst is None else dst
    if kind == "wiener":
        lr.wiener_items_plain(*args[:2], dst, *args[3:])
    else:
        lr.sgr_items_plain(*args[:2], dst, *args[3:], _xbyx())
    return dst


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("kind", ["wiener", "sgr"])
def test_lr_plain_matches_dav1d_tpu_on_kernel_cases(bd, kind):
    """wiener_items_plain / sgr_items_plain, which the CUDA kernels are
    held to on the card, against dav1d_tpu's _wiener_fn / _sgr_fn on the
    kernel cases of the smallest and the largest unit (wmax 48, 384),
    luma and 4:2:0 chroma stripes (10 bit: test_lr_matches_dav1d_tpu's
    10bit-420 stream): every edge-flag combination, Wiener taps at their
    limits, every SGR parameter row."""
    fns = {"wiener": _wiener_fn, "sgr": _sgr_fn}
    for us_log2 in (5, 8):
        for hmax in (64, 32):
            args = kc.lr_args(kc.lr_case_at(bd, kind, us_log2, hmax), "cpu")
            got = _plain(kind, args)
            n = args[3].shape[0]
            ref = fns[kind](n, *args[-3:])(
                *(a.numpy() for a in args[:-3]))
            assert np.array_equal(got.numpy(), np.asarray(ref))
            assert not torch.equal(got, args[2])


def _column_tiles(kind, args, tw):
    """The items of an lr_args tuple cut into tiles of tw output columns
    (each its own item: colbase and ox moved by the tile's first column,
    ows cut), as csrc/lr_wiener.cu and csrc/lr_sgr.cu cut them."""
    n_par = 2 if kind == "wiener" else 4
    rowt, colbase = args[3], args[4]
    par = args[5:5 + n_par]
    oy, ox, ohs, ows = args[5 + n_par:9 + n_par]
    rows = []
    for i in range(rowt.shape[0]):
        for c0 in range(0, int(ows[i]), tw):
            rows.append((i, c0, min(tw, int(ows[i]) - c0)))
    idx = torch.tensor([r[0] for r in rows])
    c0 = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    cw = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    return (*args[:3], rowt[idx], colbase[idx] + c0, *(p[idx] for p in par),
            oy[idx], ox[idx] + c0, ohs[idx], cw, args[-3], tw, args[-1])


@pytest.mark.parametrize("kind,tw", [("wiener", 64), ("sgr", 64)])
@pytest.mark.parametrize("us_log2", kc.LR_UNIT_LOG2,
                         ids=["wmax48", "wmax96", "wmax192", "wmax384"])
def test_lr_column_tiles_equal_the_whole_item(kind, tw, us_log2):
    """The kernels run one block per (item, tile of tw output columns):
    each tile, filtered as an item of its own from the same row table
    and its column window, equals its columns of the whole item (bd 12,
    luma and chroma stripes)."""
    for hmax in (64, 32):
        args = kc.lr_args(kc.lr_case_at(12, kind, us_log2, hmax), "cpu")
        want = _plain(kind, args)
        got = _plain(kind, _column_tiles(kind, args, tw))
        assert torch.equal(got, want)


def test_sgr_cases_leave_int32():
    """At 12 bit the SGR cases reach both products the kernel computes
    in int64, each above 2^31 - 1 (and below 2^32): p * s1 of a box3
    and x * sum * one_by_x of a box5, over the boxes the kernel computes
    for each item (box3 at output rows -1..ohs, box5 at rows -1, 1, ..,
    columns -1..ows), with the item's own strengths and weights."""
    xbyx = _xbyx().numpy()
    ps = xs = 0
    for hmax in (64, 32):
        args = kc.lr_args(kc.lr_case_at(12, "sgr", 8, hmax), "cpu")
        S = lr._gather(torch.cat(args[:2]), args[3], args[4],
                       args[-2] + 6).long().numpy()
        s0, s1, w0, w1, ohs, ows = (args[k].numpy()
                                    for k in (5, 6, 7, 8, 11, 12))
        for i in range(len(S)):
            for r, n, s, w in ((1, 9, s1[i], w1[i]), (2, 25, s0[i], w0[i])):
                if not w:       # the kernel skips a branch of weight 0
                    continue
                k = 2 * r + 1
                # boxes by top-left corner: box3 rows / columns 1..ohs + 2
                # / ows + 2; box5 rows 0, 2, .., columns 0..ows + 1
                rows = slice(1, ohs[i] + 3) if r == 1 else \
                    slice(0, 2 * ((ohs[i] + 1) // 2) + 1, 2)
                win = np.lib.stride_tricks.sliding_window_view(
                    S[i], (k, k))[rows, 2 - r:ows[i] + 4 - r]
                ssum = win.sum(axis=(-1, -2))
                sq = (win * win).sum(axis=(-1, -2))
                p = np.maximum(((sq + (1 << 7)) >> 8) * n -
                               ((ssum + (1 << 3)) >> 4) ** 2, 0)
                if r == 1:
                    ps = max(ps, int(p.max()) * int(s))
                else:
                    x = xbyx[np.minimum((p * int(s) + (1 << 19)) >> 20,
                                        255)]
                    xs = max(xs, int((x * ssum).max()) * 164)
    assert 2 ** 31 <= ps < 2 ** 32 and 2 ** 31 <= xs < 2 ** 32


def test_lr_on_cpu_launches_no_kernel():
    planes, tables, bd = kc.frame_args(kc.lr_frame_case(kc.lr_case_at(
        8, "wiener", 5, 64)), "cpu", "wiener")
    before = dict(lr.LAUNCHES)
    lr.wiener_frame(planes, tables, bd)
    assert lr.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        lr.wiener_frame_cuda(planes, tables, bd)


def _frame_paths(planes, tables, bd, kind="wiener"):
    """(the padded per-plane path, the kernel's addressing): each
    plane's destination after wiener_frame_plain / sgr_frame_plain and
    after wiener_frame_tiled_plain / sgr_frame_tiled_plain, from fresh
    copies."""
    out = []
    for run in ((lr.wiener_frame_plain, wiener_frame_tiled_plain)
                if kind == "wiener" else
                (lr.sgr_frame_plain, sgr_frame_tiled_plain)):
        dsts = [p[2].clone() for p in planes]
        run([(s, q, d, w, h) for (s, q, _, w, h), d in zip(planes, dsts)],
            tables, bd)
        out.append(dsts)
    return out


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_wiener_frame_reads_equal_the_padded_path(bd):
    """csrc/lr_wiener.cu's frame launch reads the unpadded planes with
    each column clamped to the plane's valid width, one block per item
    and 64-column tile (wiener_frame_tiled_plain): equal to
    wiener_frame_plain, the padded per-plane path built from
    plane_sources and wiener_items_plain, on every Wiener case of
    lr_cases (one plane each) and on the frame cases (planes of every
    layout's shapes, junk beyond each plane's valid columns)."""
    cases = [kc.lr_frame_case(c) for c in kc.lr_cases((bd,))
             if c["kind"] == "wiener"]
    cases += [kc.frame_case(bd, layout, "wiener")
              for layout in kc.CDEF_LAYOUTS]
    for case in cases:
        planes, tables, bd = kc.frame_args(case, "cpu", "wiener")
        want, got = _frame_paths(planes, tables, bd)
        for (src, *_), g, w in zip(planes, got, want):
            assert torch.equal(g, w)
            assert not torch.equal(w, src)


def test_wiener_frame_case_covers_both_plane_edges():
    """The frame cases' Wiener items meet every edge-flag combination at
    ox = 0 and at ox + ows = w of each plane, some span two 64-column
    tiles, the chroma planes have no SGR item and the luma plane has."""
    case = kc.frame_case(8, 2, "wiener")
    for p, pl in enumerate(case["planes"]):
        wiener = [it for it in pl["items"] if it[5]["type"] == 2]
        for edge in (lambda it: it[1] == 0,
                     lambda it: it[1] + it[2] == pl["w"]):
            assert {it[4] for it in wiener if edge(it)} == set(range(16))
        assert any(it[2] > 64 for it in wiener) == (p == 0)
        assert any(it[5]["type"] != 2 for it in pl["items"]) == (p == 0)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_wiener_frame_reads_equal_the_padded_path_on_streams(name):
    """The same on the Wiener items of every plane of the streams'
    frames, as lr_planes_device groups them (plane_items,
    frame_tables) over the port's CDEF output."""
    from dav1d_tpu_torch.ops.cdef import cdef_planes_device
    from dav1d_tpu_torch.ops.restore_ref import _sgr_params_tbl
    n = 0
    for _pj, pt, bd, _planes, dbk in frame_planes(name):
        pre = [torch.from_numpy(p.copy()) for p in dbk]
        cur = cdef_planes_device(pre, pt, bd)
        groups = [(p, w, hmax, k["wiener"])
                  for p, w, hmax, _, k in lr.plane_items(pt) if k["wiener"]]
        if not groups:
            continue
        planes = [(cur[p], pre[p][:cur[p].shape[0]], cur[p].clone(), w, h)
                  for p, w, h, _ in groups]
        tables = lr.frame_tables(
            "wiener",
            [(sel, h, cur[p].shape[0]) for p, _, h, sel in groups],
            _sgr_params_tbl())
        want, got = _frame_paths(planes, tables, bd)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        n += len(tables[0])
    assert n


def test_wiener_frame_on_cpu_launches_no_kernel():
    planes, tables, bd = kc.frame_args(kc.frame_case(8, 1, "wiener"),
                                              "cpu", "wiener")
    before = dict(lr.LAUNCHES)
    lr.wiener_frame(planes, tables, bd)
    assert lr.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        lr.wiener_frame_cuda(planes, tables, bd)
    with pytest.raises(ValueError, match="past"):
        lr.wiener_frame(planes[:1], tables, bd)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_sgr_frame_reads_equal_the_padded_path(bd):
    """csrc/lr_sgr.cu's frame launch reads the unpadded planes with each
    column clamped to the plane's valid width, one block per item and
    64-column tile (sgr_frame_tiled_plain): equal to sgr_frame_plain,
    the padded per-plane path built from plane_sources and
    sgr_items_plain, on every SGR case of lr_cases (one plane each) and
    on the SGR frame cases (planes of every layout's shapes, junk beyond
    each plane's valid columns)."""
    cases = [kc.lr_frame_case(c) for c in kc.lr_cases((bd,))
             if c["kind"] == "sgr"]
    cases += [kc.frame_case(bd, layout, "sgr") for layout in kc.CDEF_LAYOUTS]
    for case in cases:
        planes, tables, bd = kc.frame_args(case, "cpu", "sgr")
        want, got = _frame_paths(planes, tables, bd, "sgr")
        for (src, *_), g, w in zip(planes, got, want):
            assert torch.equal(g, w)
            assert not torch.equal(w, src)


def test_sgr_frame_case_covers_both_plane_edges():
    """The SGR frame cases meet every edge-flag combination at ox = 0 and
    at ox + ows = w of each plane, every parameter row on each plane,
    some items span two 64-column tiles, and the luma plane has a
    Wiener item."""
    case = kc.frame_case(8, 2, "sgr")
    for p, pl in enumerate(case["planes"]):
        sgr = [it for it in pl["items"] if it[5]["type"] != 2]
        for edge in (lambda it: it[1] == 0,
                     lambda it: it[1] + it[2] == pl["w"]):
            assert {it[4] for it in sgr if edge(it)} == set(range(16))
        assert {it[5]["type"] for it in sgr} == set(range(3, 19))
        assert any(it[2] > 64 for it in sgr) == (p == 0)
        assert any(it[5]["type"] == 2 for it in pl["items"]) == (p == 0)


def test_sgr_frame_reads_equal_the_padded_path_on_s31_keyframe(monkeypatch):
    """The same on the SGR items of the 1080p keyframe of the primary
    bench stream (bench_streams/1920x1080_8b_flt_s31_enc.ivf), as the
    decoder hands them to sgr_frame on the CPU: its own tables and
    planes."""
    import os
    from dav1d_tpu_torch.api import DECODEFRAMETYPE_KEY, Decoder, Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    seen = []
    run = lr.sgr_frame

    def spy(planes, tables, bd):
        seen.append(([(s, q, d.clone(), w, h) for s, q, d, w, h in planes],
                     tables, bd))
        return run(planes, tables, bd)
    monkeypatch.setattr(lr, "sgr_frame", spy)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_streams",
        "1920x1080_8b_flt_s31_enc.ivf")
    dec = Decoder(Settings(device="cpu",
                           decode_frame_type=DECODEFRAMETYPE_KEY))
    for fr in IvfReader(open(path, "rb").read()):
        dec.send_data(fr.data)
        list(dec.pictures())
    assert len(seen) == 1
    planes, tables, bd = seen[0]
    assert len(tables[0]) > 100
    want, got = _frame_paths(planes, tables, bd, "sgr")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bd,us_log2", [(8, 6), (12, 6), (12, 8)],
                         ids=["8bit-wmax96", "12bit-wmax96",
                              "12bit-wmax384"])
def test_sgr_separable_sums_equal_the_direct_sums(bd, us_log2):
    """The SGR kernel's arithmetic (sgr_separable_plain: box sums by
    sliding 3- and 5-wide row sums down strips of rows, calc_ab at each
    box's last row, the blend's 3x3 sums from 3-wide row sums) equals
    the direct box sums of lr._sgr_math, tile by tile (64 output
    columns), on every SGR parameter row and edge flag of the kernel
    cases (luma and 4:2:0 chroma stripes; at 12 bit the cases whose p s
    and x sum one_by_x leave int32), with every sum the kernel keeps in
    int32 inside it."""
    xbyx = _xbyx()
    for hmax in (64, 32):
        args = _column_tiles("sgr", kc.lr_args(
            kc.lr_case_at(bd, "sgr", us_log2, hmax), "cpu"), lr.LR_TW)
        S = lr._gather(torch.cat(args[:2]), args[3], args[4], lr.LR_TW + 6)
        s0, s1, w0, w1, ohs, ows = (args[k].tolist()
                                    for k in (5, 6, 7, 8, 11, 12))
        assert len(set(zip(s0, s1))) == 16
        for i in range(len(S)):
            # the plain math takes an even row count: odd stripes one
            # row more, which no output above it reads
            h, w = ohs[i], ows[i]
            he = h + (h & 1)
            want = lr._sgr_math(S[i:i + 1, :he + 6, :w + 6],
                                *(args[k][i:i + 1] for k in (5, 6, 7, 8)),
                                he, w, bd, xbyx)[0, :h]
            got = sgr_separable_plain(S[i, :h + 6, :w + 6].numpy(), s0[i],
                                      s1[i], w0[i], w1[i], bd, xbyx.numpy())
            assert np.array_equal(got, want.numpy()), i


def test_sgr_frame_on_cpu_launches_no_kernel():
    planes, tables, bd = kc.frame_args(kc.frame_case(8, 1, "sgr"), "cpu",
                                       "sgr")
    before = dict(lr.LAUNCHES)
    lr.sgr_frame(planes, tables, bd)
    assert lr.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        lr.sgr_frame_cuda(planes, tables, bd)
    with pytest.raises(ValueError, match="past"):
        lr.sgr_frame(planes[:1], tables, bd)
    with pytest.raises(ValueError, match="shapes"):     # Wiener's columns
        lr.sgr_frame(planes, kc.frame_args(
            kc.frame_case(8, 1, "wiener"), "cpu", "wiener")[1], bd)
