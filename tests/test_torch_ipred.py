"""Intra prediction of the leftover levels (ROADMAP item 5b) in the port:
the plain versions of dav1d_tpu_torch/ops/ipred.py against dav1d_tpu's
device programs (dav1d_tpu/ops/ipred.py `*_fn`, jitted on JAX's CPU,
N units a call, a few geometries each) and against the scalar golden
model
(ops/ipred_ref.py, the port's copy), on seeded numpy inputs at bd 8 /
10 / 12: every splat mode, Z1 / Z3 with and without upsampling at
strengths 0-3, Z2 with each upsample pair and cut max_w / max_h, the
five filter-intra kinds, CFL in 4:2:0 / 4:2:2 / 4:4:4 with padded
nh / nw, the gather's constant fills and tlf, and the scatter at the
plane's edges; `level_plain` on every ops/kernel_cases.py ipred_case
unit by unit against the golden model (splat, filter-intra, CFL) and
the directional plain versions alone; the cases' disjointness
(what the kernel relies on); the port's `edge_indices` against
dav1d_tpu's on random availability configs, and `edge_runs` (the frame
kernel's edge runs) expanding to `edge_indices`' rows on those configs
and on every ipred_case unit; `plan_plain` (the frame kernel's
contract) against the per-level sequence on the multi-level plan cases
with residuals at bd 8 / 10 / 12; the device LUTs and the dispatcher.
Tolerance: none (torch.equal / np.array_equal)."""
import jax
import numpy as np
import pytest
import torch

from dav1d_tpu.ops import ipred as jip
from dav1d_tpu.ops.backend import device_scope
from dav1d_tpu.recon import ipred_device as jdev
from dav1d_tpu_torch import tables
from dav1d_tpu_torch.ops import ipred, ipred_ref, kernel_cases as kc
from dav1d_tpu_torch.ops.device import device_tables
from dav1d_tpu_torch.recon import ipred_device

C = ipred.C
BDS = (8, 10, 12)
DERIV = tables.get("dav1d_dr_intra_derivative")
# every angle the builder forms: a directional mode's base angle plus
# 3 * delta, delta in -3..3
ANGLES = sorted({b + 3 * d for b in ipred_ref._MODE_TO_ANGLE
                 for d in range(-3, 4)})


def _jax(fn, *args):
    with device_scope():
        return np.asarray(fn(*(jax.numpy.asarray(a) for a in args)))


N = 16          # units a program call: one compile per geometry


def _fill(units):
    """units repeated or cut to N rows (the programs compile per batch
    size)."""
    return [units[k % len(units)] for k in range(N)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _edges(rng, n, bd):
    return rng.integers(0, 1 << bd, (n, ipred.EDGE_LEN)).astype(np.int32)


def _edge(row):
    e = ipred_ref.Edge()
    e.buf[:] = row
    return e


def test_constants_match_dav1d_tpu():
    assert (ipred.C, ipred.EDGE_LEN) == (jip.C, jip.EDGE_LEN)
    for k in range(5):
        assert np.array_equal(ipred.filter_taps(k), jip.filter_taps(k))
    for n in (4, 8, 16, 32, 64):
        assert np.array_equal(ipred._sm_weights_np(n),
                              jip._sm_weights_np(n))
    lut = device_tables("cpu")
    assert np.array_equal(lut["ipred_sm_weights"].numpy(),
                          tables.get("dav1d_sm_weights").astype(np.int32))
    assert np.array_equal(lut["ipred_filter_taps"].numpy(),
                          np.stack([jip.filter_taps(k) for k in range(5)]))
    # the kernel reads them by pointer
    assert lut["ipred_filter_taps"].is_contiguous()
    assert lut["ipred_sm_weights"].is_contiguous()


@pytest.mark.parametrize("bd", BDS)
def test_edge_gather_plain(bd):
    rng = np.random.default_rng(bd)
    H, W = 24, 40
    half = (1 << bd) >> 1
    flat = np.concatenate([rng.integers(0, 1 << bd, H * W),
                           [half + 1, half - 1, half, 0]]).astype(np.int32)
    idx = rng.integers(0, H * W + 4, (N, ipred.EDGE_LEN)).astype(np.int32)
    tlf = rng.integers(0, 2, N).astype(np.int32)
    got = ipred.edge_gather_plain(_t(flat), _t(idx), _t(tlf)).numpy()
    want = _jax(jip.edge_gather_fn(N, len(flat)), flat, idx, tlf)
    assert np.array_equal(got, want)
    # the constants past the plane's end and the 5-6-5 top-left filter
    ref = flat[idx].astype(np.int64)
    f = ((ref[:, C - 1] + ref[:, C + 1]) * 5 + ref[:, C] * 6 + 8) >> 4
    ref[:, C] = np.where(tlf != 0, f, ref[:, C])
    assert np.array_equal(got, ref)


# (w, h) per bd: every transform shape class at 8 bit, a few at 10 / 12
# (the bit depth enters through the DC multipliers and the clips)
GEOS = {8: ((4, 4), (8, 4), (8, 16), (32, 8), (16, 64), (64, 64)),
        10: ((4, 8), (32, 32)), 12: ((16, 4), (64, 16))}


@pytest.mark.parametrize("bd", BDS)
def test_splat_family_plain(bd):
    rng = np.random.default_rng(10 + bd)
    modes = np.asarray(_fill(kc.IPRED_MODES), np.int32)
    for w, h in GEOS[bd]:
        edges = _edges(rng, N, bd)
        got = ipred.splat_family_plain(_t(edges), _t(modes), w, h, bd)
        want = _jax(jip.splat_family_fn(N, w, h, bd), edges, modes)
        assert np.array_equal(got.numpy(), want), (w, h)
        for k, m in enumerate(modes):
            ref = ipred_ref.PREDICTORS[int(m)](_edge(edges[k]), w, h, 0, bd)
            assert np.array_equal(got[k].numpy(), ref), (w, h, m)


def _dir_units(rng, mode, w, h, n):
    """n (angle flags, params) of a directional mode as the plan builder
    forms them (recon/ipred_device.py _pred_unit): the angle with its
    smooth and edge-filter flags for ipred_ref, and (d..., strengths,
    upsample flags)."""
    lo, hi = {ipred_ref.Z1_PRED: (0, 90), ipred_ref.Z2_PRED: (90, 180),
              ipred_ref.Z3_PRED: (180, 270)}[mode]
    angles = [a for a in ANGLES if lo < a < hi]
    out = []
    for _ in range(n):
        a = int(rng.choice(angles))
        is_sm, ief = int(rng.integers(0, 2)), int(rng.random() < 0.8)
        up = lambda ang: int(ipred_ref._get_upsample(w + h, ang, is_sm)) \
            if ief else 0
        st = lambda ang: ipred_ref._get_filter_strength(w + h, ang, is_sm) \
            if ief else 0
        flags = a | (is_sm << 9) | (ief << 10)
        if mode == ipred_ref.Z1_PRED:
            u = up(90 - a)
            out.append((flags, (int(DERIV[a >> 1]) << u,
                                0 if u else st(90 - a), u)))
        elif mode == ipred_ref.Z3_PRED:
            u = up(a - 180)
            out.append((flags, (int(DERIV[(270 - a) >> 1]) << u,
                                0 if u else st(a - 180), u)))
        else:
            ua, ul = up(a - 90), up(180 - a)
            out.append((flags, (int(DERIV[(180 - a) >> 1]) << ua,
                                int(DERIV[(a - 90) >> 1]) << ul,
                                0 if ua else st(a - 90),
                                0 if ul else st(180 - a), ua, ul)))
    return out


# (w, h, upsample) per bd: upsampling only where w + h <= 16
DIR_GEOS = {8: ((4, 4, 1), (8, 8, 1), (4, 4, 0), (16, 8, 0), (32, 32, 0),
                (64, 64, 0)),
            10: ((8, 4, 1), (16, 16, 0)), 12: ((4, 8, 1), (64, 16, 0))}


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("mode", ["z1", "z3"])
def test_z1_z3_plain(bd, mode):
    rng = np.random.default_rng(20 + bd + (mode == "z3"))
    m = ipred_ref.Z1_PRED if mode == "z1" else ipred_ref.Z3_PRED
    plain = ipred.z1_plain if mode == "z1" else ipred.z3_plain
    jfn = jip.z1_fn if mode == "z1" else jip.z3_fn
    ref_fn = ipred_ref.ipred_z1 if mode == "z1" else ipred_ref.ipred_z3
    seen = set()
    for w, h, up in DIR_GEOS[bd]:
        sel = _fill([u for u in _dir_units(rng, m, w, h, 200)
                     if u[1][2] == up][:N])
        d = np.asarray([u[1][0] for u in sel], np.int32)
        st = np.asarray([u[1][1] for u in sel], np.int32)
        seen |= {(up, int(s)) for s in st}
        edges = _edges(rng, N, bd)
        got = plain(_t(edges), _t(d), _t(st), w, h, bd, up)
        want = _jax(jfn(N, w, h, bd, up), edges, d, st)
        assert np.array_equal(got.numpy(), want), (w, h, up)
        for k, (flags, _) in enumerate(sel):
            ref = ref_fn(_edge(edges[k]), w, h, flags, bd)
            assert np.array_equal(got[k].numpy(), ref), (w, h, flags)
    if bd == 8:
        assert seen >= {(0, 0), (0, 1), (0, 2), (0, 3), (1, 0)}, seen


# (w, h, upsample above, upsample left): the builder never forms both
# (above needs an angle < 130, left one > 140); the pair is checked
# against dav1d_tpu's program alone, with random derivatives
Z2_GEOS = {8: ((4, 4, 0, 1), (8, 8, 1, 0), (4, 8, 1, 1), (16, 8, 0, 0),
               (64, 64, 0, 0)),
           10: ((8, 4, 0, 1), (32, 16, 0, 0)),
           12: ((4, 4, 1, 0), (16, 64, 0, 0))}


@pytest.mark.parametrize("bd", BDS)
def test_z2_plain(bd):
    rng = np.random.default_rng(30 + bd)
    for w, h, ua, ul in Z2_GEOS[bd]:
        if ua and ul:
            sel = [(None, (int(DERIV[rng.integers(1, 44)]) << 1,
                           int(DERIV[rng.integers(1, 44)]) << 1, 0, 0))
                   for _ in range(N)]
        else:
            sel = _fill([u for u in _dir_units(rng, ipred_ref.Z2_PRED, w, h,
                                               400)
                         if u[1][4:] == (ua, ul)][:N])
        cols = np.asarray([u[1][:4] for u in sel], np.int32)
        # max_w / max_h at, inside and past the block
        max_w = rng.integers(1, w + 9, N).astype(np.int32)
        max_h = rng.integers(1, h + 9, N).astype(np.int32)
        edges = _edges(rng, N, bd)
        args = [cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3], max_w, max_h]
        got = ipred.z2_plain(_t(edges), *map(_t, args), w, h, bd, ua, ul)
        want = _jax(jip.z2_fn(N, w, h, bd, ua, ul), edges, *args)
        assert np.array_equal(got.numpy(), want), (w, h, ua, ul)
        for k, (flags, _) in enumerate(sel):
            if flags is None:
                continue
            ref = ipred_ref.ipred_z2(_edge(edges[k]), w, h, flags, bd,
                                     int(max_w[k]), int(max_h[k]))
            assert np.array_equal(got[k].numpy(), ref), (w, h, flags)


@pytest.mark.parametrize("bd", BDS)
def test_filter_plain(bd):
    rng = np.random.default_rng(40 + bd)
    geos = {8: ((4, 4), (16, 8), (32, 32)), 10: ((8, 32),),
            12: ((32, 8),)}[bd]
    for w, h in geos:
        kinds = np.arange(N) % 5
        taps = np.stack([ipred.filter_taps(k) for k in kinds])
        edges = _edges(rng, N, bd)
        got = ipred.filter_plain(_t(edges), _t(taps), w, h, bd)
        want = _jax(jip.filter_fn(N, w, h, bd), edges, taps)
        assert np.array_equal(got.numpy(), want), (w, h)
        for k, kind in enumerate(kinds):
            ref = ipred_ref.ipred_filter(_edge(edges[k]), w, h, int(kind), bd)
            assert np.array_equal(got[k].numpy(), ref), (w, h, kind)


def _cfl_ref(y_plane, edges, job, cw, ch, ss_hor, ss_ver, bd):
    ypy, ypx, nh, nw, alpha, mode = (int(v) for v in job)
    ac = ipred_ref.cfl_ac(y_plane, ypy, ypx, ss_hor, ss_ver, (cw - nw) // 4,
                          (ch - nh) // 4, cw, ch)
    dc = ipred_ref.cfl_dc(mode, _edge(edges), cw, ch, bd)
    return ipred_ref.cfl_pred(dc, ac, alpha, cw, ch, bd)


@pytest.mark.parametrize("bd,ss", [(8, (1, 1)), (8, (1, 0)), (8, (0, 0)),
                                   (10, (1, 0)), (12, (1, 1))],
                         ids=["8-420", "8-422", "8-444", "10-422", "12-420"])
def test_cfl_plain(bd, ss):
    ss_hor, ss_ver = ss
    rng = np.random.default_rng(50 + bd + 3 * ss_hor + ss_ver)
    y_plane = rng.integers(0, 1 << bd, (80, 96)).astype(np.int32)
    for cw, ch in ((4, 4), (16, 8), (32, 32)) if bd == 8 else ((8, 16),):
        nh = 4 * rng.integers(1, ch // 4 + 1, N)
        nw = 4 * rng.integers(1, cw // 4 + 1, N)
        nh[0], nw[0] = ch, cw                        # one unpadded
        ypy = 2 * rng.integers(0, (80 - (ch << ss_ver)) // 2 + 1, N)
        ypx = 2 * rng.integers(0, (96 - (cw << ss_hor)) // 2 + 1, N)
        jobs = np.stack([ypy, ypx, nh, nw, rng.integers(-16, 17, N),
                         _fill(kc.CFL_DC_MODES)], 1).astype(np.int32)
        edges = _edges(rng, N, bd)
        got = ipred.cfl_plain(_t(y_plane), _t(edges), _t(jobs), cw, ch,
                              ss_hor, ss_ver, bd)
        want = _jax(jip.cfl_fn(N, cw, ch, ss_hor, ss_ver, bd), y_plane, edges,
                    jobs)
        assert np.array_equal(got.numpy(), want), (cw, ch)
        for k in range(N):
            ref = _cfl_ref(y_plane, edges[k], jobs[k], cw, ch, ss_hor, ss_ver,
                           bd)
            assert np.array_equal(got[k].numpy(), ref), (cw, ch, k)


def test_scatter_pred_plain():
    rng = np.random.default_rng(60)
    plane = rng.integers(0, 256, (40, 56)).astype(np.int32)
    w = h = 16
    pys = np.asarray([0, 0, 32, 32, 16], np.int32)    # cut at the bottom
    pxs = np.asarray([0, 48, 0, 48, 24], np.int32)    # and right edges
    preds = rng.integers(0, 256, (5, h, w)).astype(np.int32)
    got = ipred.scatter_pred_plain(torch.from_numpy(plane.copy()), _t(pys),
                                   _t(pxs), _t(preds))
    want = _jax(jip.scatter_pred_fn(5, w, h), plane, pys, pxs, preds)
    assert np.array_equal(got.numpy(), want)


def _unit_ref(case, k):
    """Unit k of a case alone, from the planes before the level: the
    golden model for splat, filter-intra and CFL units, the (checked)
    directional plain versions for Z1 / Z2 / Z3 units."""
    bd, sh, sv = case["bd"], case["ss_hor"], case["ss_ver"]
    u = [int(v) for v in case["units"][k]]
    pl, fam, w, h, _, _, tlf, row = u[:8]
    p = u[8:]
    plane = case["planes"][pl]
    half = (1 << bd) >> 1
    flat = np.concatenate([plane.reshape(-1), [half + 1, half - 1, half, 0]])
    e = flat[case["idx"][row]].astype(np.int64)
    if tlf:
        e[C] = ((e[C - 1] + e[C + 1]) * 5 + e[C] * 6 + 8) >> 4
    if fam == ipred.FAM_S:
        return ipred_ref.PREDICTORS[p[0]](_edge(e), w, h, 0, bd)
    if fam == ipred.FAM_F:
        return ipred_ref.ipred_filter(_edge(e), w, h, p[0], bd)
    if fam == ipred.FAM_CFL:
        return _cfl_ref(case["planes"][0], e, p[:6], w, h, sh, sv, bd)
    one = lambda v: _t([v])
    if fam == ipred.FAM_Z2:
        out = ipred.z2_plain(_t(e[None]), *map(one, p[:6]), w, h, bd, p[6],
                             p[7])
    else:
        fn = ipred.z1_plain if fam == ipred.FAM_Z1 else ipred.z3_plain
        out = fn(_t(e[None]), one(p[0]), one(p[1]), w, h, bd, p[2])
    return out[0].numpy()


@pytest.mark.parametrize("k", range(len(kc.IPRED_LAYOUTS)),
                         ids=["%d-%d%d-%dpl" % c for c in kc.IPRED_LAYOUTS])
def test_level_plain_unit_by_unit(k):
    bd, sh, sv, n_planes = kc.IPRED_LAYOUTS[k]
    case = kc.ipred_case(bd, sh, sv, n_planes, seed=90 + k)
    planes, units, idx = kc.ipred_args(case, "cpu")
    ipred.level_plain(planes, units, idx, bd, sh, sv)
    want = [p.copy() for p in case["planes"]]
    for j, (pl, _, w, h, py, px) in enumerate(case["units"][:, :6]):
        H, W = want[pl].shape
        ref = _unit_ref(case, j)
        hh, ww = min(h, H - py), min(w, W - px)
        want[pl][py:py + hh, px:px + ww] = ref[:hh, :ww]
    for got, w in zip(planes, want):
        assert np.array_equal(got.numpy(), w)
    # every family and plane is in the level
    assert set(case["units"][:, 1]) == set(range(6 if n_planes > 1 else 5))
    assert set(case["units"][:, 0]) == set(range(n_planes))


@pytest.mark.parametrize("case", kc.ipred_cases(), ids=lambda c: str(c["bd"]))
def test_ipred_cases_are_one_level(case):
    """The kernel runs a level's units in any order: no two units write
    one pixel, and no unit reads (edges, CFL luma) a pixel one writes;
    some units cross the plane's right and bottom edges."""
    u = case["units"].astype(np.int64)
    written = [np.zeros(p.shape, np.int32) for p in case["planes"]]
    cut = [0, 0]
    for pl, fam, w, h, py, px in u[:, :6]:
        H, W = written[pl].shape
        written[pl][py:py + h, px:px + w] += 1
        cut[0] += px + w > W
        cut[1] += py + h > H
    assert all(m.max() == 1 for m in written)
    assert cut[0] > 0 and cut[1] > 0
    for k, row in enumerate(u):
        pl = row[0]
        flat = written[pl].reshape(-1)
        ix = case["idx"][row[7]]
        assert not flat[ix[ix < flat.size]].any(), k
        if row[1] == ipred.FAM_CFL:
            ypy, ypx, nh, nw = row[8:12]
            rect = written[0][ypy:ypy + (nh << case["ss_ver"]),
                              ypx:ypx + (nw << case["ss_hor"])]
            assert not rect.any(), k


def test_ipred_level_routes_by_device():
    # ipred_plan: the plain version for CPU tensors (a one-level plan of
    # the case, level_plain on its index rows), the kernel only for CUDA
    case = kc.ipred_cases()[2]
    planes, units, idx = kc.ipred_args(case, "cpu")
    ipred.level_plain(planes, units, idx, 8, 1, 1)
    got, tables, pool = kc.plan_args(case, "cpu")
    ipred.ipred_plan(got, tables, pool, 8, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, planes))
    with pytest.raises(ValueError, match="CUDA"):
        ipred.plan_cuda(got, tables, pool, 8, 1, 1)


@pytest.mark.parametrize("tw,th", [(1, 1), (2, 1), (4, 4), (8, 2), (16, 16)])
def test_edge_runs_expand_to_edge_indices(tw, th):
    # the port's edge_runs on random availability configs: the same mode,
    # angle and tlf as edge_indices, and runs that expand to its row
    rng = np.random.default_rng(7 + tw * 131 + th)
    H, W = 128, 160
    w_t, h_t = W // 4, H // 4
    for trial in range(150):
        x = int(rng.integers(0, w_t - tw + 1))
        y = int(rng.integers(0, h_t - th + 1))
        args = (x, bool(x > 0 and rng.integers(0, 2)), y,
                bool(y > 0 and rng.integers(0, 2)), w_t, h_t,
                int(rng.integers(0, 64)), W, x * 4, y * 4,
                int(rng.integers(0, 14)), int(rng.integers(-3, 4)), tw, th,
                int(rng.integers(0, 2)), H * W)
        mode, angle, runs, tlf = ipred_device.edge_runs(*args)
        want = ipred_device.edge_indices(*args)
        assert (mode, angle, tlf) == (want[0], want[1], want[3]), trial
        assert len(runs) == ipred.NRUN
        assert np.array_equal(ipred.run_indices(runs, H * W)[0], want[2]), \
            trial


@pytest.mark.parametrize("case", kc.ipred_cases(), ids=lambda c: str(c["bd"]))
def test_ipred_case_runs_expand(case):
    """Every unit's runs expand to the index row edge_indices gave on
    the same arguments (kernel_cases._edge_source), and the case's walk
    reaches every run shape: pixels with a repeat, constants, absent
    runs, the top-left source."""
    nflat = np.array([p.size for p in case["planes"]])
    u = case["units"]
    got = ipred.run_indices(case["runs"], nflat[u[:, 0]])
    assert np.array_equal(got, case["idx"][u[:, 7]])
    r = case["runs"].astype(np.int64)[u[:, 7]]
    n = nflat[u[:, 0]]
    for c in (ipred.RUN_LEFT, ipred.RUN_BL, ipred.RUN_TOP, ipred.RUN_TR):
        start, stride, count, size = r[:, c:c + 4].T
        assert (size == 0).any() and (size > 0).any()
        assert ((start < n) & (stride > 0)).any()
    left, top = r[:, ipred.RUN_LEFT:], r[:, ipred.RUN_TOP:]
    for run in (left, top):       # pixels and their repeat, constants
        assert ((run[:, 0] < n) & (run[:, 2] < run[:, 3])).any()
        assert ((run[:, 0] >= n) & (run[:, 3] > 0)).any()
    assert (r[:, ipred.RUN_TL] < n).any() and (r[:, ipred.RUN_TL] >= n).any()


@pytest.mark.parametrize("k", range(len(kc.PLAN_LAYOUTS)),
                         ids=["%d-%d%d" % c[:3] for c in kc.PLAN_LAYOUTS])
def test_plan_plain_matches_level_sequence(k):
    """plan_plain on pack_plan's tables equals the per-level sequence
    (level_plain on each level's units and index rows, then each plane's
    residual and WHT jobs through itx_add_plain) on a multi-level plan
    with residuals; the tables keep each level's block_units (every
    64-wide or 64-tall one among them) first and its block rows on their
    planes."""
    from dav1d_tpu_torch.ops import itx
    case = kc.plan_cases()[k]
    args = (case["bd"], case["ss_hor"], case["ss_ver"])
    planes, tables, pool = kc.plan_args(case, "cpu")
    ipred.plan_plain(planes, tables, pool, *args)
    want = [torch.from_numpy(p.copy()) for p in case["planes"]]
    for lv in case["levels"]:
        ipred.level_plain(want, torch.from_numpy(lv["units"]),
                          torch.from_numpy(lv["idx"]), *args)
        for pl, plane in enumerate(want):
            for wht in (False, True):
                j = lv["jobs"][(lv["plane"] == pl) & (lv["wht"] == wht)]
                if len(j):
                    itx.itx_add_plain(pool, torch.from_numpy(j), plane,
                                      args[0], wht=wht)
    for got, w, p in zip(planes, want, case["planes"]):
        assert torch.equal(got, w)
        assert not np.array_equal(got.numpy(), p)
    u = tables["units"].numpy()
    blk = tables["blocks"].numpy()
    res = tables["res"].numpy()
    for u0, ub, u1, b0, b1, w0, w1 in tables["levels"].tolist():
        big = ipred.block_units(u[u0:u1])
        assert big[:ub - u0].all() and not big[ub - u0:].any()
        assert big[(u[u0:u1, 2] == 64) | (u[u0:u1, 3] == 64)].all()
        assert ub > u0 and u1 > ub and b1 > b0
        for _, first, count, pl in blk[b0:b1]:
            for py, px in res[first:first + count, 3:5]:
                assert ((u[u0:u1, 0] == pl) & (u[u0:u1, 4] == py) &
                        (u[u0:u1, 5] == px)).any()
    assert len(tables["wht"]) > 0


@pytest.mark.parametrize("tw,th", [(1, 1), (2, 1), (4, 4), (8, 2), (16, 16)])
def test_edge_indices_match_dav1d_tpu(tw, th):
    rng = np.random.default_rng(tw * 131 + th)
    H, W = 128, 160
    w_t, h_t = W // 4, H // 4
    for trial in range(150):
        x = int(rng.integers(0, w_t - tw + 1))
        y = int(rng.integers(0, h_t - th + 1))
        args = (x, bool(x > 0 and rng.integers(0, 2)), y,
                bool(y > 0 and rng.integers(0, 2)), w_t, h_t,
                int(rng.integers(0, 64)), W, x * 4, y * 4,
                int(rng.integers(0, 14)), int(rng.integers(-3, 4)), tw, th,
                int(rng.integers(0, 2)), H * W)
        got = ipred_device.edge_indices(*args)
        want = jdev.edge_indices(*args)
        assert got[:2] == want[:2] and got[3] == want[3], trial
        assert np.array_equal(got[2], want[2]), trial
