"""dav1d_tpu's batched per-block MC programs (its ops/mc.py `_put8_fn` ...
`_residual_scatter_fn`, ROADMAP queue 2 entry 15) against their plain
torch counterparts of the same names in the port's ops/mc.py, bit-exact
at bd 8/10/12 on seeded numpy inputs, dav1d_tpu's run under
jax.disable_jit(): the 8-tap and bilinear put and prep, the compound's
four combine modes with the seg mask subsampled for 4:2:0, 4:2:2 and
4:4:4, the warp's put and prep, OBMC's top and left blends, the
residual add, and every scatter form with out-of-bounds sentinels on
its padding (dropped, as jax's mode="drop" drops them). Where ops/mc_ref.py
has the function (put_8tap, prep_8tap, put_bilin, prep_bilin, avg,
w_avg, mask, w_mask, warp_affine_8x8 and its prep form, blend_h,
blend_v), the port is held to it too, on windows inside the
reference. chip_smoke.py's mc_batch phase (the programs on the card
against the CPU) runs its cases here on the CPU alone."""
import jax
import numpy as np
import pytest
import torch

from dav1d_tpu.ops import mc as jmc
from dav1d_tpu_torch.ops import mc, mc_ref

BDS = [8, 10, 12]
R, HR, WR = 3, 48, 56           # reference planes of the cases
SENTINEL = 1 << 20              # a destination past every plane


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, *args):
    with jax.disable_jit():
        out = fn(*map(jax.numpy.asarray, args))
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype))


class Case:
    """Seeded inputs of n jobs: references, windows at (y, x) (inside
    the references unless clamped), taps of random filter types and
    phases."""

    def __init__(self, bd, n=6, seed=0):
        self.rng = np.random.default_rng(bd * 1000 + seed)
        self.bd, self.n = bd, n
        self.REF = self.rng.integers(0, 1 << bd, (R, HR, WR)).astype(
            np.int32)
        self.slot = self.rng.integers(0, R, n).astype(np.int32)

    def ids(self, start, length, size, clamp=True):
        idx = start[:, None] + np.arange(length)
        return (np.clip(idx, 0, size - 1) if clamp else idx).astype(np.int32)

    def window(self, h, w, apron, lo=-4, inside=False):
        """rows (n, h + apron), cols (n, w + apron) from random origins
        (y, x) of the block, the apron starting 3 before it for an 8-tap
        window (apron 7) and at it otherwise; clamped into the
        references, or wholly inside them with inside=True."""
        back = 3 if apron == 7 else 0
        if inside:
            y = self.rng.integers(back, HR - h - apron + back + 1, self.n)
            x = self.rng.integers(back, WR - w - apron + back + 1, self.n)
        else:
            y = self.rng.integers(lo, HR + 2, self.n)
            x = self.rng.integers(lo, WR + 2, self.n)
        return (y, x, self.ids(y - back, h + apron, HR),
                self.ids(x - back, w + apron, WR))

    def taps(self, h, w):
        """(ft, mx, my, fh, fv): filter types 0..15 and phases 0..15 of
        each job, resolved as dav1d_tpu's resolve_filters does."""
        fb = mc.filter_banks()
        ft = self.rng.integers(0, 16, self.n)
        mx = self.rng.integers(0, 16, self.n)
        my = self.rng.integers(0, 16, self.n)
        return (ft, mx, my, fb[int(w <= 4), ft & 3, mx],
                fb[int(h <= 4), (ft >> 2) & 3, my])


SIZES = [(8, 4), (16, 16), (2, 32)]


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("put", [True, False], ids=["put", "prep"])
def test_put8(bd, put):
    for k, (h, w) in enumerate(SIZES):
        c = Case(bd, seed=k)
        _, _, rows, cols = c.window(h, w, 7)
        _, _, _, fh, fv = c.taps(h, w)
        args = (c.REF, rows, cols, c.slot, fh, fv)
        want = _jax(jmc._put8_fn(c.n, h, w, bd, put), *args)
        _eq(mc._put8_fn(*map(_t, args), bd, put), want)
        # mc_ref on windows inside the references
        y, x, rows, cols = c.window(h, w, 7, inside=True)
        ft, mx, my, fh, fv = c.taps(h, w)
        got = mc._put8_fn(*map(_t, (c.REF, rows, cols, c.slot, fh, fv)),
                          bd, put)
        ref = mc_ref.put_8tap if put else mc_ref.prep_8tap
        for j in range(c.n):
            _eq(got[j], ref(c.REF[c.slot[j]], y[j], x[j], w, h, mx[j],
                            my[j], ft[j], bd))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("put", [True, False], ids=["put", "prep"])
def test_bilin(bd, put):
    for k, (h, w) in enumerate(SIZES):
        c = Case(bd, seed=k)
        y, x, rows, cols = c.window(h, w, 1)
        amx = c.rng.integers(0, 16, c.n).astype(np.int32)
        amy = c.rng.integers(0, 16, c.n).astype(np.int32)
        amx[0] = amy[0] = 0                 # a copy
        args = (c.REF, rows, cols, c.slot, amx, amy)
        want = _jax(jmc._bilin_fn(c.n, h, w, bd, put), *args)
        _eq(mc._bilin_fn(*map(_t, args), bd, put), want)
        y, x, rows, cols = c.window(h, w, 1, inside=True)
        got = mc._bilin_fn(*map(_t, (c.REF, rows, cols, c.slot, amx, amy)),
                           bd, put)
        ref = mc_ref.put_bilin if put else mc_ref.prep_bilin
        for j in range(c.n):
            _eq(got[j], ref(c.REF[c.slot[j]], y[j], x[j], w, h, amx[j],
                            amy[j], bd))


def _compound_args(c, h, w, inside=False):
    """Both references' windows and taps, the modes (every COMP_* mode),
    weights, signs and mask weights of a compound case."""
    parts, preps = [], []
    for _ in range(2):
        y, x, rows, cols = c.window(h, w, 7, inside=inside)
        ft, mx, my, fh, fv = c.taps(h, w)
        slot = c.rng.integers(0, R, c.n).astype(np.int32)
        parts += [rows, cols, slot, fh, fv]
        preps.append((y, x, slot, ft, mx, my))
    modes = np.array([mc.COMP_AVG, mc.COMP_WAVG, mc.COMP_SEG, mc.COMP_MASK])
    mode = modes[np.arange(c.n) % 4].astype(np.int32)
    jw = c.rng.integers(0, 17, c.n).astype(np.int32)
    sign = c.rng.integers(0, 2, c.n).astype(np.int32)
    msk = c.rng.integers(0, 65, (c.n, h, w)).astype(np.int8)
    return parts, (mode, jw, sign, msk), preps


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)],
                         ids=["420", "422", "444"])
def test_compound(bd, ss):
    for k, (h, w) in enumerate([(4, 8), (16, 32)]):
        c = Case(bd, n=8, seed=k)
        parts, comb, _ = _compound_args(c, h, w)
        args = (c.REF, *parts, *comb)
        want = _jax(jmc._compound_fn(c.n, h, w, bd, *ss), *args)
        got = mc._compound_fn(*map(_t, args), bd, *ss)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        # each mode against mc_ref's combine of mc_ref's preps
        parts, (mode, jw, sign, msk), preps = _compound_args(c, h, w, True)
        out, seg_sub = mc._compound_fn(
            *map(_t, (c.REF, *parts, mode, jw, sign, msk)), bd, *ss)
        for j in range(c.n):
            t = [mc_ref.prep_8tap(c.REF[s[j]], y[j], x[j], w, h, mx[j],
                                  my[j], ft[j], bd)
                 for y, x, s, ft, mx, my in preps]
            ts = t[::-1] if sign[j] else t
            dst, sub = mc_ref.w_mask(ts[0], ts[1], sign[j], *ss, bd)
            want = {mc.COMP_AVG: lambda: mc_ref.avg(t[0], t[1], bd),
                    mc.COMP_WAVG: lambda: mc_ref.w_avg(t[0], t[1], jw[j],
                                                       bd),
                    mc.COMP_SEG: lambda: dst,
                    mc.COMP_MASK: lambda: mc_ref.mask(
                        ts[0], ts[1], msk[j].astype(np.uint8), bd)}
            _eq(out[j], want[int(mode[j])]())
            _eq(seg_sub[j], sub)


def _warp_params(c):
    """mx, my in the warp's range and shears small enough that every
    filter row lies in the 193-row bank."""
    mx = c.rng.integers(-20000, 20000, c.n).astype(np.int32)
    my = c.rng.integers(-20000, 20000, c.n).astype(np.int32)
    abgd = c.rng.integers(-1000, 1000, (4, c.n)).astype(np.int32)
    return mx, my, abgd


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("put", [True, False], ids=["put", "prep"])
def test_warp(bd, put):
    c = Case(bd, n=8)
    _, _, rows, cols = c.window(8, 8, 7)
    mx, my, (al, be, ga, de) = _warp_params(c)
    args = (c.REF, rows, cols, c.slot, mx, my, al, be, ga, de)
    want = _jax(jmc._warp_fn(c.n, bd, put), *args)
    _eq(mc._warp_fn(*map(_t, args), bd, put), want)
    y, x, rows, cols = c.window(8, 8, 7, inside=True)
    got = mc._warp_fn(*map(_t, (c.REF, rows, cols, c.slot, mx, my, al, be,
                                ga, de)), bd, put)
    ref = mc_ref.warp_affine_8x8 if put else mc_ref.warp_affine_8x8t
    for j in range(c.n):
        _eq(got[j], ref(c.REF[c.slot[j]], y[j], x[j],
                        (al[j], be[j], ga[j], de[j]), mx[j], my[j], bd))


# OBMC laps: (lap_h, ww, hh) with hh the lap height whose masks a top
# lap blends; lap_h > hh computes rows the blend drops
LAPS = [(8, 16, 8), (8, 2, 2), (32, 8, 16)]


def _obmc_args(c, lap_h, ww, rows_out, cols_out, H, W):
    """A lap case: windows, taps, a (H, W) plane and the destination
    region's ids (rows_out x cols_out), inside the plane."""
    _, _, rows, cols = c.window(lap_h, ww, 7)
    _, _, _, fh, fv = c.taps(lap_h, ww)
    plane = c.rng.integers(0, 1 << c.bd, (H, W)).astype(np.int32)
    py = c.rng.integers(0, H - rows_out + 1, c.n)
    px = c.rng.integers(0, W - cols_out + 1, c.n)
    return (rows, cols, c.slot, fh, fv, plane,
            c.ids(py, rows_out, H), c.ids(px, cols_out, W))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("top", [True, False], ids=["top", "left"])
def test_obmc_blend(bd, top):
    for k, (lap_h, ww, hh) in enumerate(LAPS):
        c = Case(bd, seed=k)
        rows_out = (hh * 3) >> 2 if top else lap_h
        cols_out = ww if top else (ww * 3) >> 2
        args = _obmc_args(c, lap_h, ww, rows_out, cols_out, 40, 48)
        want = _jax(jmc._obmc_blend_fn(c.n, ww, hh, lap_h, bd, top),
                    c.REF, *args)
        got = mc._obmc_blend_fn(*map(_t, (c.REF, *args)), bd, top)
        _eq(got, want)
        # mc_ref's blend of the lap over the region
        lap = mc._put8_fn(*map(_t, (c.REF, *args[:5])), bd).numpy()
        plane, drows, dcols = args[5:]
        for j in range(c.n):
            if top:
                dst = plane[drows[j, 0]:drows[j, 0] + hh,
                            dcols[j, 0]:dcols[j, 0] + ww]
                if dst.shape[0] < hh:
                    continue            # the region cut by the plane
                ref = mc_ref.blend_h(dst, lap[j, :hh], ww, hh)[:rows_out]
            else:
                dst = plane[drows[j, 0]:drows[j, 0] + lap_h,
                            dcols[j, 0]:dcols[j, 0] + ww]
                if dst.shape[1] < ww:
                    continue
                ref = mc_ref.blend_v(dst, lap[j], ww, lap_h)[:, :cols_out]
            _eq(got[j], ref)


@pytest.mark.parametrize("bd", BDS)
def test_residual(bd):
    c = Case(bd)
    plane = c.rng.integers(0, 1 << bd, (40, 48)).astype(np.int32)
    for h, w in SIZES:
        rows = c.ids(c.rng.integers(0, 40 - h + 1, c.n), h, 40)
        cols = c.ids(c.rng.integers(0, 48 - w + 1, c.n), w, 48)
        lim = 1 << (bd + 1)
        res = c.rng.integers(-lim, lim, (c.n, h, w)).astype(np.int32)
        args = (plane, rows, cols, res)
        want = _jax(jmc._residual_fn(c.n, h, w, bd), *args)
        _eq(mc._residual_fn(*map(_t, args), bd), want)


def _padded_dst(c, h, w, H, W, PH, PW):
    """Destination ids of jobs of (h, w) padded to (PH, PW) in an (H, W)
    plane: disjoint blocks on a grid, the padding's rows and columns set
    to sentinels past either end of the plane."""
    cells = c.rng.permutation((H // PH) * (W // PW))[:c.n]
    drows = (cells // (W // PW))[:, None] * PH + np.arange(PH)
    dcols = (cells % (W // PW))[:, None] * PW + np.arange(PW)
    drows[:, h:] = np.where(np.arange(PH - h) % 2, SENTINEL, -SENTINEL)
    dcols[:, w:] = SENTINEL
    return drows.astype(np.int32), dcols.astype(np.int32)


SCATTER = ["put8", "bilin", "warp", "compound", "obmc_top", "obmc_left",
           "residual"]


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("form", SCATTER)
def test_scatter_forms(bd, form):
    c = Case(bd, n=6)
    H, W = 64, 64
    plane = c.rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    PH = PW = 16
    h, w = (8, 8) if form == "warp" else (12, 10)
    if form == "warp":
        PH = PW = 8
    drows, dcols = _padded_dst(c, h, w, H, W, PH, PW)
    if form in ("put8", "compound", "obmc_top", "obmc_left"):
        _, _, rows, cols = c.window(PH, PW, 7)
        _, _, _, fh, fv = c.taps(PH, PW)
    if form == "put8":
        args = (c.REF, rows, cols, c.slot, fh, fv, plane, drows, dcols)
        jfn, fn, extra = jmc._put8_scatter_fn(c.n, PH, PW, bd), \
            mc._put8_scatter_fn, ()
    elif form == "bilin":
        _, _, rows, cols = c.window(PH, PW, 1)
        amx = c.rng.integers(0, 16, c.n).astype(np.int32)
        amy = c.rng.integers(0, 16, c.n).astype(np.int32)
        args = (c.REF, rows, cols, c.slot, amx, amy, plane, drows, dcols)
        jfn, fn, extra = jmc._bilin_scatter_fn(c.n, PH, PW, bd), \
            mc._bilin_scatter_fn, ()
    elif form == "warp":
        _, _, rows, cols = c.window(8, 8, 7)
        mx, my, abgd = _warp_params(c)
        args = (c.REF, rows, cols, c.slot, mx, my, *abgd, plane, drows,
                dcols)
        jfn, fn, extra = jmc._warp_scatter_fn(c.n, bd), \
            mc._warp_scatter_fn, ()
    elif form == "compound":
        parts, comb, _ = _compound_args(c, PH, PW)
        args = (c.REF, *parts, *comb, plane, drows, dcols)
        jfn, fn, extra = jmc._compound_scatter_fn(c.n, PH, PW, bd, 1, 1), \
            mc._compound_scatter_fn, (1, 1)
    elif form.startswith("obmc"):
        top = form == "obmc_top"
        # a 16 x 16 lap blends 12 rows (top) or 12 columns (left): the
        # rest of the padded region's destinations are sentinels
        drows, dcols = _padded_dst(c, 12 if top else h, w if top else 12,
                                   H, W, PH, PW)
        drows = drows[:, :12] if top else drows
        dcols = dcols if top else dcols[:, :12]
        args = (c.REF, rows, cols, c.slot, fh, fv, plane, drows, dcols)
        jfn, fn, extra = jmc._obmc_scatter_fn(c.n, PW, PH, PH, bd, top), \
            mc._obmc_scatter_fn, (top,)
    else:
        lim = 1 << (bd + 1)
        res = c.rng.integers(-lim, lim, (c.n, PH, PW)).astype(np.int32)
        args = (plane, drows, dcols, res)
        jfn, fn, extra = jmc._residual_scatter_fn(c.n, PH, PW, bd), \
            mc._residual_scatter_fn, ()
    want = _jax(jfn, *args)
    got = fn(*map(_t, args), bd, *extra)
    if form == "compound":
        _eq(got[1], want[1])
        got, want = got[0], want[0]
    _eq(got, want)
    # the sentinels dropped: outside the jobs' true blocks the plane is
    # unchanged, and inside it changed somewhere
    written = np.zeros((H, W), bool)
    ok_r = (drows >= 0) & (drows < H)
    ok_c = (dcols >= 0) & (dcols < W)
    for j in range(c.n):
        written[np.ix_(drows[j][ok_r[j]], dcols[j][ok_c[j]])] = True
    assert np.array_equal(got.numpy()[~written], plane[~written])
    assert not np.array_equal(got.numpy(), plane)


def test_chip_smoke_cases_run():
    """chip_smoke.py's mc_batch phase on the CPU alone: every program
    on every kernel_cases.mc_batch_cases case at bd 8/10/12."""
    import chip_smoke
    done = chip_smoke.mc_batch_check(torch, "cpu")
    assert set(done) == {n for n in dir(mc) if n.startswith("_") and
                         n.endswith("_fn")}
