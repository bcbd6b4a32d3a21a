"""The port's plain motion-compensation versions (ops/mc.py put_plain,
comp_plain) against dav1d_tpu: the XLA job kernels of ops/mc_jobs.py
(put8_jobs_fn, bilin_jobs_fn, comp_jobs_fn) and TPU kernel #2 itself,
ops/mc_pallas.put8_pallas in Pallas interpret mode. Bit-exact
(tolerance 0) on seeded inputs from ops/kernel_cases.py, at bd 8 and 10:
every put size 2..128 with every filter type and windows across every
frame edge; compounds with every combine mode, wedge masks of classes
16 and 32, and the seg mask from luma to chroma."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dav1d_tpu.ops import mc as jmc
from dav1d_tpu.ops import mc_jobs
from dav1d_tpu.ops import mc_ref as jref
from dav1d_tpu.ops.mc_fused import _wedge_lut as jax_wedge_lut
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops import mc, mc_obmc, mc_warp
from dav1d_tpu_torch.ops.device import device_tables
from dav1d_tpu_torch.ops.mc_fused import _wedge_lut
from dav1d_tpu_torch.ops.mc_ref import BS_32X32

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def _port_put(case, bd):
    plane = torch.zeros(case["dst_shape"], dtype=torch.int32)
    mc.put([T(r) for r in case["refs"]], T(case["jobs"]), plane,
           case["rh"], case["rw"], bd)
    return plane.numpy()


def test_filter_banks_match_dav1d_tpu():
    assert np.array_equal(mc.filter_banks(), np.asarray(jmc.filter_banks()))
    assert np.array_equal(device_tables("cpu")["mc_filter_banks"].numpy(),
                          np.asarray(jmc.filter_banks()))


@pytest.mark.parametrize("bd", [8, 10])
def test_put_plain_vs_mc_jobs(bd):
    case = kc.put_case(bd, seed=bd)
    jobs = case["jobs"]
    assert set(jobs[:, 10]) == set(kc.FT_VALUES)
    assert {(h, w) for h, w in jobs[:, 1:3]} == set(kc.PUT_SIZES)
    ref = np.zeros(case["dst_shape"], np.int32)
    for bil, fn in ((False, mc_jobs.put8_jobs_fn),
                    (True, mc_jobs.bilin_jobs_fn)):
        sub = jobs[(jobs[:, 10] < 0) == bil]
        run = fn(len(sub), 128, 128, bd, case["rh"], case["rw"])
        ref = np.asarray(run(case["refs"], sub, ref))
    got = _port_put(case, bd)
    assert np.count_nonzero(ref) > ref.size // 4
    assert np.array_equal(got, ref)


_PALLAS_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from dav1d_tpu.ops.mc_pallas import put8_pallas
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops import mc

fb = mc.filter_banks()
fails = 0
for bd, (h, w) in ((8, (8, 8)), (10, (4, 16)), (8, (16, 4))):
    case = kc.put_case(bd, seed=h + w)
    jobs = case["jobs"][case["jobs"][:, 10] >= 0][:6].copy()
    jobs[:, 1], jobs[:, 2] = h, w
    jobs[:, 3], jobs[:, 4], _ = kc.pack([(h, w)] * len(jobs), 256)
    rh, rw = case["rh"], case["rw"]
    dy, dx, amx, amy, ft = (jobs[:, k] for k in (6, 7, 8, 9, 10))
    rows = np.clip(dy[:, None] - 3 + np.arange(h + 7), 0, rh - 1)
    cols = np.clip(dx[:, None] - 3 + np.arange(w + 7), 0, rw - 1)
    fh = fb[int(w <= 4), ft & 3, amx]
    fv = fb[int(h <= 4), (ft >> 2) & 3, amy]
    got = np.asarray(put8_pallas(case["refs"], rows.astype(np.int32),
                                 cols.astype(np.int32), jobs[:, 5], fh, fv,
                                 bd, interpret=True))
    plane = torch.zeros((64, 256), dtype=torch.int32)
    mc.put([torch.from_numpy(r) for r in case["refs"]],
           torch.from_numpy(jobs), plane, rh, rw, bd)
    want = np.stack([plane.numpy()[y:y + h, x:x + w]
                     for y, x in jobs[:, 3:5]])
    ok = np.array_equal(got, want)
    print(f"bd={bd} {h}x{w}: {'ok' if ok else 'MISMATCH'}", flush=True)
    fails += not ok
sys.exit(1 if fails else 0)
"""


def test_put_plain_vs_put8_pallas_interpret():
    # Pallas interpret mode traces deeply and meets pytest's assertion
    # rewriting with a RecursionError (tests/test_mc_pallas.py), so the
    # comparison runs in a clean subprocess
    r = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT, ROOT],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(": ok") == 3


def _wedge_masks(jobs, c):
    """(n, c, c) int8 wedge weights of the mkind-1 rows, as the fused
    path's LUT gather picks them; zeros elsewhere."""
    lut = _wedge_lut(32)
    msk = np.zeros((len(jobs), c, c), np.int8)
    for i, j in enumerate(jobs):
        if j[8] == 1:
            key = (j[9] * 11 + j[10] - BS_32X32) * 32 + j[11] * 16 + j[12]
            msk[i, :32, :32] = lut[key]
    return msk


def _jax_comp(case, bd, ss_hor, ss_ver):
    """dav1d_tpu's comp_jobs_fn: the luma pass writes the seg plane, the
    chroma pass reads it. Returns (luma, chroma, seg) planes."""
    seg = np.zeros(case["seg_shape"], np.int32)
    out = []
    for jobs, dst, (rh, rw), refs, luma in (
            (case["jobs_y"], case["dst_y"], case["bounds_y"],
             case["refs_y"], True),
            (case["jobs_c"], case["dst_c"], case["bounds_c"],
             case["refs_c"], False)):
        j21 = np.concatenate([jobs[:, :9], jobs[:, 13:]], axis=1)
        fn = mc_jobs.comp_jobs_fn(len(jobs), 128, 128, bd, ss_hor, ss_ver,
                                  rh, rw, luma)
        plane, seg = fn(refs, j21, _wedge_masks(jobs, 128),
                        seg, np.zeros(dst, np.int32))
        out.append(np.asarray(plane))
        seg = np.asarray(seg)
    return out[0], out[1], seg


def _port_comp(case, bd, ss_hor, ss_ver):
    seg = torch.zeros(case["seg_shape"], dtype=torch.int32)
    out = []
    for jobs, dst, (rh, rw), refs, luma in (
            (case["jobs_y"], case["dst_y"], case["bounds_y"],
             case["refs_y"], True),
            (case["jobs_c"], case["dst_c"], case["bounds_c"],
             case["refs_c"], False)):
        plane = torch.zeros(dst, dtype=torch.int32)
        mc.comp([T(r) for r in refs], T(jobs), plane, seg, rh, rw, bd,
                luma, ss_hor, ss_ver)
        out.append(plane.numpy())
    return out[0], out[1], seg.numpy()


@pytest.mark.parametrize("bd,ss", [(8, (1, 1)), (10, (1, 1)),
                                   (8, (0, 0)), (10, (1, 0))],
                         ids=["8bit-420", "10bit-420", "8bit-444",
                              "10bit-422"])
def test_comp_plain_vs_mc_jobs(bd, ss):
    case = kc.comp_case(bd, seed=bd + 3 * ss[0] + ss[1], ss_hor=ss[0],
                        ss_ver=ss[1])
    modes = set(case["jobs_y"][:, 5])
    assert modes == {kc.MODE_AVG, kc.MODE_WAVG, kc.MODE_SEG, kc.MODE_MASK}
    assert set(case["jobs_c"][:, 8]) == {0, 1, 2}
    ref = _jax_comp(case, bd, *ss)
    got = _port_comp(case, bd, *ss)
    assert np.count_nonzero(ref[2]) > 0          # the seg plane was used
    for name, a, b in zip(("luma", "chroma", "seg"), got, ref):
        assert np.array_equal(a, b), name


def test_wedge_luts_match_dav1d_tpu():
    for c in (16, 32):
        assert np.array_equal(_wedge_lut(c), jax_wedge_lut(c))


def test_plain_case_destinations_are_disjoint():
    case = kc.put_case(8, seed=1)
    j = case["jobs"]
    assert kc.overlaps(j[:, 3], j[:, 4], j[:, 1], j[:, 2],
                       case["dst_shape"]) == 0
    case = kc.comp_case(8, seed=1, ss_hor=1, ss_ver=1)
    for key, dst in (("jobs_y", "dst_y"), ("jobs_c", "dst_c")):
        j = case[key]
        assert kc.overlaps(j[:, 3], j[:, 4], j[:, 1], j[:, 2],
                           case[dst]) == 0


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_copy_premise(bd):
    """The put kernel's copy classes: with amx = amy = 0 the plain put
    is exactly the clamped copy ref[clamp(dy + r), clamp(dx + c)], for
    every put size, every 8-tap filter type and bilinear, with windows
    across every frame edge (the identity tap 64 at index 3 gives x << ib
    and then x; bilinear's 16 likewise)."""
    n_ft = len(kc.FT_VALUES)
    sizes = [(h, w, True) for h, w in kc.PUT_SIZES for _ in range(n_ft)]
    case = kc.put_case(bd, seed=90 + bd, sizes=sizes)
    jobs = case["jobs"]
    for h, w in kc.PUT_SIZES:
        mine = jobs[(jobs[:, 1] == h) & (jobs[:, 2] == w)]
        assert set(mine[:, 10]) == set(kc.FT_VALUES)
    rh, rw = case["rh"], case["rw"]
    dy, dx, h, w = jobs[:, 6], jobs[:, 7], jobs[:, 1], jobs[:, 2]
    assert (dy < 0).any() and (dy + h > rh).any()       # every frame edge
    assert (dx < 0).any() and (dx + w > rw).any()
    got = _port_put(case, bd)
    want = np.zeros_like(got)
    for j in jobs.tolist():
        _, hh, ww, py, px, slot, y, x = j[:8]
        rows = np.clip(y + np.arange(hh), 0, rh - 1)
        cols = np.clip(x + np.arange(ww), 0, rw - 1)
        want[py:py + hh, px:px + ww] = \
            case["refs"][slot][rows[:, None], cols[None, :]]
    assert np.array_equal(got, want)


def test_wrappers_raise_on_cuda_without_a_kernel_path():
    # CPU tensors take the plain version; anything else must be a CUDA
    # tensor, which launches the kernel (no silent fallback)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc.put_cuda([torch.zeros((8, 8), dtype=torch.int32)],
                    torch.zeros((0, 11), dtype=torch.int32),
                    torch.zeros((8, 8), dtype=torch.int32), 8, 8, 8)


# ---------------------------------------------------------------------------
# warp and OBMC (ops/mc_warp.py, ops/mc_obmc.py)
# ---------------------------------------------------------------------------

def _port_warp(case, bd):
    planes = kc.case_planes(case, "cpu")
    mc_warp.warp_planes(planes, T(case["jobs"]), bd)
    return [p.numpy() for _, p, _, _ in planes]


def _port_obmc(case, bd):
    planes = kc.case_planes(case, "cpu")
    mc_obmc.obmc_planes(planes, T(case["top"]), T(case["left"]), bd)
    return [p.numpy() for _, p, _, _ in planes]


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_warp_filter_rows_in_range(bd):
    # the shears at the ends of the valid range reach filter rows 0 and
    # 192 and never leave them
    jobs = T(kc.warp_case(bd, seed=bd)["jobs"])
    lo = min(int(r.min()) for r in mc_warp.filter_rows(jobs))
    hi = max(int(r.max()) for r in mc_warp.filter_rows(jobs))
    assert (lo, hi) == (0, mc_warp.N_ROWS - 1)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_warp_plain_vs_mc_jobs(bd):
    case = kc.warp_case(bd, seed=bd)
    got = _port_warp(case, bd)
    jobs = case["jobs"]
    for pi, p in enumerate(case["planes"]):
        sub = jobs[jobs[:, 0] == pi]
        assert (sub[:, 4] < 0).any() and (sub[:, 4] + 11 > p["rh"]).any()
        assert (sub[:, 5] < 0).any() and (sub[:, 5] + 11 > p["rw"]).any()
        run = mc_jobs.warp_jobs_fn(len(sub), bd, p["rh"], p["rw"])
        want = np.asarray(run(p["refs"], sub,
                              np.zeros(p["dst_shape"], np.int32)))
        assert np.count_nonzero(want) > want.size // 2
        assert np.array_equal(got[pi], want), pi


@pytest.mark.parametrize("bd,ss", [(8, (0, 0)), (10, (1, 0)), (12, (1, 1))],
                         ids=["8bit-444", "10bit-422", "12bit-420"])
def test_warp_plain_vs_mc_ref(bd, ss):
    case = kc.warp_case(bd, seed=20 + bd, ss_hor=ss[0], ss_ver=ss[1])
    got = _port_warp(case, bd)
    for j in case["jobs"].tolist():
        pi, py, px, slot, dy, dx, mx, my = j[:8]
        p = case["planes"][pi]
        win = jref.emu_edge(15, 15, p["rw"], p["rh"], dx - 3, dy - 3,
                            p["refs"][slot])
        want = jref.warp_affine_8x8(win, 3, 3, j[8:12], mx, my, bd)
        assert np.array_equal(got[pi][py:py + 8, px:px + 8], want), j


@pytest.mark.parametrize("bd", [8, 12])
def test_warp_tile_assignment_equals_plain(bd):
    """csrc/mc_warp.cu's assignment of tiles (a warp per tile, 8 to a
    block) and its window reads, interior and clamped, int8 bank and
    output order (torch_port_cases.warp_assigned_plain) equal
    warp_planes_plain and dav1d_tpu's mc_jobs warp on the warp case: on
    the whole table (144 tiles, its last block full) and on one cut to
    139 tiles (a ragged last block)."""
    from torch_port_cases import warp_assigned_plain
    wf = device_tables("cpu")["mc_warp_filter"]
    case = kc.warp_case(bd, seed=50 + bd)
    j = case["jobs"]
    inner = [(dy >= 3 and dx >= 3 and dy + 12 <= case["planes"][p]["rh"] and
              dx + 12 <= case["planes"][p]["rw"])
             for p, dy, dx in j[:, [0, 4, 5]].tolist()]
    assert any(inner) and not all(inner)     # both window paths taken
    for cut in (None, -5):
        jobs = T(j[:cut])
        want = kc.case_planes(case, "cpu")
        mc_warp.warp_planes_plain(want, jobs, bd, wf)
        for pi, p in enumerate(case["planes"]):
            sub = j[:cut][j[:cut, 0] == pi]
            run = mc_jobs.warp_jobs_fn(len(sub), bd, p["rh"], p["rw"])
            ref = np.asarray(run(p["refs"], sub,
                                 np.zeros(p["dst_shape"], np.int32)))
            assert np.array_equal(want[pi][1].numpy(), ref), pi
        got = kc.case_planes(case, "cpu")
        warp_assigned_plain(got, jobs, bd, wf)
        for (_, g, _, _), (_, w, _, _) in zip(got, want):
            assert w.count_nonzero() > w.numel() // 2
            assert torch.equal(g, w)


def _obmc_jobs_groups(jobs):
    """{(ww, hh, lap_h): rows} of one direction's laps."""
    out = {}
    for key in sorted({tuple(g) for g in jobs[:, 2:5].tolist()}):
        out[key] = jobs[(jobs[:, 2:5] == key).all(1)]
    return out


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_obmc_plain_vs_mc_jobs(bd):
    # obmc_jobs_fn has static geometry: one call per (ww, hh, lap_h)
    # group, the top laps of a plane before its left laps
    case = kc.obmc_case(bd, seed=bd)
    got = _port_obmc(case, bd)
    for pi, p in enumerate(case["planes"]):
        want = p["plane"].copy()
        for top, key in ((1, "top"), (0, "left")):
            mine = case[key][case[key][:, 1] == pi]
            for (ww, hh, lap_h), sub in _obmc_jobs_groups(mine).items():
                run = mc_jobs.obmc_jobs_fn(len(sub), ww, hh, lap_h, bd,
                                           top, p["rh"], p["rw"])
                want = np.asarray(run(p["refs"], sub, want))
        assert not np.array_equal(want, p["plane"])
        assert np.array_equal(got[pi], want), pi


def _obmc_ref(case, bd):
    """The laps with mc_ref.put_8tap over the emu-edge window and
    blend_h (top) / blend_v (left), top laps first, on planes padded
    past their right and bottom edges."""
    out = []
    for pi, p in enumerate(case["planes"]):
        H, W = p["plane"].shape
        P = np.zeros((H + 64, W + 64), np.int32)
        P[:H, :W] = p["plane"]
        for key, blend in (("top", jref.blend_h), ("left", jref.blend_v)):
            for j in case[key][case[key][:, 1] == pi].tolist():
                _, _, ww, hh, lap_h, py, px, slot, dy, dx, amx, amy, ft = j
                win = jref.emu_edge(ww + 7, lap_h + 7, p["rw"], p["rh"],
                                    dx - 3, dy - 3, p["refs"][slot])
                lap = jref.put_8tap(win, 3, 3, ww, lap_h, amx, amy, ft, bd)
                P[py:py + hh, px:px + ww] = blend(P[py:py + hh, px:px + ww],
                                                  lap, ww, hh)
        out.append(P[:H, :W])
    return out


@pytest.mark.parametrize("bd,ss", [(8, (1, 1)), (10, (1, 1)), (12, (1, 1)),
                                   (8, (1, 0)), (10, (0, 0))],
                         ids=["8bit-420", "10bit-420", "12bit-420",
                              "8bit-422", "10bit-444"])
def test_obmc_plain_vs_mc_ref(bd, ss):
    case = kc.obmc_case(bd, seed=30 + bd + ss[0] + ss[1], ss_hor=ss[0],
                        ss_ver=ss[1])
    for pi in range(3):
        h_mul = 4 >> (ss[0] if pi else 0)
        v_mul = 4 >> (ss[1] if pi else 0)
        for top, key in ((1, "top"), (0, "left")):
            mine = case[key][case[key][:, 1] == pi]
            # every geometry the emitter writes, every filter type, and
            # laps whose blend crosses the plane's right and bottom edges
            assert {tuple(g) for g in mine[:, 2:5].tolist()} == \
                set(kc.obmc_geometries(top, h_mul, v_mul))
            assert set(mine[:, 12]) == set(kc.OBMC_FT)
            rows, cols = mc_obmc.blend_dims(mine, top)
            H, W = case["planes"][pi]["plane"].shape
            assert (mine[:, 5] + rows > H).any()
            assert (mine[:, 6] + cols > W).any()
    got = _port_obmc(case, bd)
    for pi, want in enumerate(_obmc_ref(case, bd)):
        assert np.array_equal(got[pi], want), pi


def test_obmc_laps_of_one_direction_are_disjoint():
    case = kc.obmc_case(8, seed=1)
    for top, key in ((1, "top"), (0, "left")):
        for pi, p in enumerate(case["planes"]):
            j = case[key][case[key][:, 1] == pi]
            rows, cols = mc_obmc.blend_dims(j, top)
            assert kc.overlaps(j[:, 5], j[:, 6], rows, cols,
                               p["plane"].shape) == 0


def test_warp_obmc_wrappers_route_by_device(monkeypatch):
    # a CUDA wrapper given CPU tensors raises; the dispatchers take the
    # plain versions for CPU tensors only (no silent fallback)
    case = kc.obmc_case(8, seed=2)
    planes = kc.case_planes(case, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc_obmc.obmc_cuda(planes, T(case["top"]), T(case["left"]), 8)
    wcase = kc.warp_case(8, seed=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc_warp.warp_cuda(kc.case_planes(wcase, "cpu"),
                                 T(wcase["jobs"]), 8)
    calls = []
    for mod, name in ((mc_obmc, "obmc_planes_plain"),
                      (mc_warp, "warp_planes_plain")):
        monkeypatch.setattr(mod, name, lambda *a, name=name:
                            calls.append(name))
    mc_obmc.obmc_planes(planes, T(case["top"]), None, 8)
    mc_warp.warp_planes(kc.case_planes(wcase, "cpu"), T(wcase["jobs"]), 8)
    assert calls == ["obmc_planes_plain", "warp_planes_plain"]
    with pytest.raises(ValueError, match="direction"):
        mc_obmc.check_geometry(case["left"], 1)
    big = case["top"].copy()
    big[0, 2] = 128
    with pytest.raises(ValueError, match="geometry"):
        mc_obmc.check_geometry(big, 1)
    # a top lap of more than 24 blended rows, a left lap of more than 24
    # blended columns: larger than the kernel's shared buffers
    for key, top, col in (("top", 1, 3), ("left", 0, 2)):
        big = case[key].copy()
        big[0, col] = 64
        with pytest.raises(ValueError, match="geometry"):
            mc_obmc.check_geometry(big, top)


@pytest.mark.parametrize("bd", [8, 12])
def test_obmc_lap_assignment_equals_top_then_left(bd):
    """csrc/mc_obmc.cu's assignment of laps (a warp per lap, 3 to a
    block, the grid's warps striding over the top laps, a grid-wide
    barrier, then over the left laps; torch_port_cases.
    obmc_assigned_plain) equals obmc_frame_plain, all top laps then all
    left laps, on the OBMC case: grids of one block (3 warps, 20
    rounds), of 7 blocks (21 warps: the 60 laps end in a ragged round)
    and as large as the card holds (132 SMs x 5 blocks: one round), on
    the whole tables and on tables cut to counts that are not multiples
    of 3 (59 top, 58 left laps)."""
    from torch_port_cases import obmc_assigned_plain
    tb = device_tables("cpu")
    case = kc.obmc_case(bd, seed=40 + bd)
    for cut in ((None, None), (-1, -2)):
        top, left = (T(case[k][:c]) for k, c in zip(("top", "left"), cut))
        want = kc.case_planes(case, "cpu")
        mc_obmc.obmc_frame_plain(want, top, left, bd, tb["mc_filter_banks"],
                                 tb["mc_obmc_masks"])
        for blocks in (1, 7, 132 * 5):
            got = kc.case_planes(case, "cpu")
            obmc_assigned_plain(got, top, left, bd, tb["mc_filter_banks"],
                                tb["mc_obmc_masks"], blocks)
            for (_, g, _, _), (_, w, _, _), p in zip(got, want,
                                                     case["planes"]):
                assert not torch.equal(w, T(p["plane"]))
                assert torch.equal(g, w)
