"""The host side of the put, compound and residual kernels' class
binning (ops/mc.py put_blocks, comp_blocks, ops/itx.py res_blocks,
called once per kind for every plane by ops/mc_fused.py _plane_tables),
on the CPU. Inputs: the frame-2 tables of
bench_streams/1920x1080_8b_flt_s7.ivf as the port's emitter writes them
(decoded with device="cpu"), and the seeded tables of
ops/kernel_cases.py. Shown:

- the block tables cover every job exactly once (a job larger than
  32x32 once per 32-wide tile), every block is class-uniform (puts:
  copy jobs, amx = amy = 0, apart) and holds no more jobs than a kernel
  block takes, and the sort is stable;
- the plain versions, run on the class-sorted tables, give the same
  planes (and seg plane) as on the emitter's order;
- no two jobs of one put, residual or compound table write the same
  pixel, which is what makes the reordering exact.

The same decode's deblock (planes and maps of frame 2) checks the
deblock kernel's tiling on a real frame."""
from functools import lru_cache
import os

import numpy as np
import pytest
import torch

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.entropy import levels as lv
from dav1d_tpu_torch.ops import itx, lf, mc, mc_fused
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops.device import device_tables

from torch_port_cases import deblock_tiled_plain

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TW = np.array([4 * t.w for t in lv.TXFM_INFO])
TH = np.array([4 * t.h for t in lv.TXFM_INFO])


@lru_cache(maxsize=None)
def _s7_frame2():
    """The s7 inter frame's per-plane tables in the emitter's order
    ({(kind, plane): rows}, kind put / comp / res), the put, compound
    and residual calls of its Stage B, each with its inputs as they
    were before the call, and the deblock calls' inputs."""
    emitted = {}
    calls = {"put": [], "comp": [], "res": [], "tables": [], "deblock": []}
    orig = (mc.comp_blocks, itx.res_blocks, mc.comp, itx.itx_add,
            mc_fused._plane_tables, mc.put_blocks, mc.put_planes,
            lf.deblock_frame)

    def plane_tables(*args):
        out = orig[4](*args)
        calls["tables"].append(out)
        return out

    def comp_blocks(jobs, group=None):
        for pi in np.unique(group):
            emitted["comp", int(pi)] = jobs[group == pi].copy()
        return orig[0](jobs, group)

    def put_blocks(jobs, group=None):
        for pi in np.unique(group):
            emitted["put", int(pi)] = jobs[group == pi].copy()
        return orig[5](jobs, group)

    def put_planes(planes, jobs, bd, blocks=None):
        calls["put"].append(([(r, p.clone(), rh, rw)
                              for r, p, rh, rw in planes], jobs.clone(), bd))
        return orig[6](planes, jobs, bd, blocks)

    def deblock_frame(entries, lut_e, lut_i, bd):
        calls["deblock"].append((entries, lut_e, lut_i, bd))
        return orig[7](entries, lut_e, lut_i, bd)

    def res_blocks(rows, group=None):
        for pi in np.unique(group):
            emitted["res", int(pi)] = rows[group == pi].copy()
        return orig[1](rows, group)

    def comp(refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor, ss_ver,
             blocks=None):
        calls["comp"].append((refs, jobs.clone(), plane.clone(),
                              seg.clone(), rh, rw, bd, luma, ss_hor, ss_ver))
        return orig[2](refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor,
                       ss_ver, blocks)

    def itx_add(pool, jobs, plane, bd, wht=False, blocks=None):
        calls["res"].append((pool, jobs.clone(), plane.clone(), bd, wht))
        return orig[3](pool, jobs, plane, bd, wht, blocks)

    mc.comp_blocks, itx.res_blocks, mc.comp, itx.itx_add, \
        mc_fused._plane_tables, mc.put_blocks, mc.put_planes, \
        lf.deblock_frame = (comp_blocks, res_blocks, comp, itx_add,
                            plane_tables, put_blocks, put_planes,
                            deblock_frame)
    try:
        path = os.path.join(ROOT, "bench_streams", "1920x1080_8b_flt_s7.ivf")
        dec = Decoder(Settings(device="cpu"))
        for i, fr in enumerate(IvfReader(open(path, "rb").read())):
            if i >= 2:
                break
            dec.send_data(fr.data)
            list(dec.pictures())
    finally:
        mc.comp_blocks, itx.res_blocks, mc.comp, itx.itx_add, \
            mc_fused._plane_tables, mc.put_blocks, mc.put_planes, \
            lf.deblock_frame = orig
    return emitted, calls


def _tables():
    """{name: (kind, rows in the emitter's order)}: the s7 frame-2
    tables and the kernel cases."""
    emitted, _ = _s7_frame2()
    out = {f"s7-{k}{pi}": (k, v) for (k, pi), v in emitted.items()}
    cc = kc.comp_case(8, 5, 1, 1, sizes=kc.ragged_comp_sizes())
    out["cases-comp-ragged-y"] = ("comp", cc["jobs_y"])
    out["cases-comp-ragged-c"] = ("comp", cc["jobs_c"])
    cc = kc.comp_case(10, 6, 1, 0)
    out["cases-comp-422-y"] = ("comp", cc["jobs_y"])
    out["cases-comp-422-c"] = ("comp", cc["jobs_c"])
    out["cases-put"] = ("put", kc.put_case(8, 3)["jobs"])
    out["cases-put-ragged"] = ("put", kc.put_case(
        10, 4, sizes=kc.ragged_put_sizes())["jobs"])
    sc = kc.itx_stress_case(8, 7)
    out["cases-res-extreme"] = ("res", sc["extreme"])
    out["cases-res-ragged"] = ("res", sc["ragged"])
    out["cases-res-all"] = ("res", kc.itx_case(8, 8)["jobs"])
    return out


NAMES = ["s7-put0", "s7-put1", "s7-put2", "s7-comp0", "s7-comp1",
         "s7-comp2", "s7-res0", "s7-res1", "s7-res2", "cases-put",
         "cases-put-ragged", "cases-comp-ragged-y", "cases-comp-ragged-c",
         "cases-comp-422-y", "cases-comp-422-c", "cases-res-extreme",
         "cases-res-ragged", "cases-res-all"]


def _res_key(rows):
    return (rows[:, 0].astype(np.int64) << 4) | (rows[:, 1] << 2) | \
        rows[:, 2]


def _check_res(rows, sorted_rows, blocks):
    key = _res_key(rows)
    assert np.array_equal(sorted_rows, rows[np.argsort(key, kind="stable")])
    skey = _res_key(sorted_rows)
    seen = np.zeros(len(rows), np.int64)
    for cls, first, count in blocks.tolist():
        assert 1 <= count <= itx.jobs_per_block(cls >> 4)
        assert (skey[first:first + count] == cls).all()
        seen[first:first + count] += 1
    assert (seen == 1).all()
    # a class's blocks are full but for its last one
    for cls in np.unique(blocks[:, 0]):
        counts = blocks[blocks[:, 0] == cls, 2]
        assert (counts[:-1] == itx.jobs_per_block(cls >> 4)).all()


def _check_tiled(jobs, sorted_jobs, blocks, kind):
    """The comp_blocks / put_blocks contract: class-uniform blocks (put
    copy jobs apart), at most a kernel block's jobs, jobs above 32x32
    once per 32-wide tile, large-job tiles first."""
    h, w = sorted_jobs[:, 1], sorted_jobs[:, 2]
    copy = (sorted_jobs[:, 8] == 0) & (sorted_jobs[:, 9] == 0)
    assert sorted(map(tuple, jobs.tolist())) == \
        sorted(map(tuple, sorted_jobs.tolist()))
    tiles = {}
    seen_small = False
    for cls, first, count, ty0, tx0 in blocks.tolist():
        if kind == "put":
            c, cp = cls % mc.PUT_CLASSES, cls >= mc.PUT_CLASSES
            th, tw = 2 << (c // 5), 2 << (c % 5)
            assert 1 <= count <= mc.put_jobs_per_block(th, tw, cp)
        else:
            th, tw = 4 << (cls >> 2), 4 << (cls & 3)
            assert 1 <= count <= mc.comp_jobs_per_block(th, tw)
        for s in range(first, first + count):
            assert (min(h[s], 32), min(w[s], 32)) == (th, tw)
            if kind == "put":
                assert copy[s] == cp
            tiles.setdefault(s, []).append((ty0, tx0))
        large = max(h[first], w[first]) > 32
        assert count == 1 if large else (ty0, tx0) == (0, 0)
        assert not (large and seen_small)       # tiles of large jobs first
        seen_small |= not large
    assert sorted(tiles) == list(range(len(jobs)))
    for s, got in tiles.items():
        th, tw = min(h[s], 32), min(w[s], 32)
        want = [(y, x) for y in range(0, h[s], th) for x in range(0, w[s], tw)]
        assert sorted(got) == want


@pytest.mark.parametrize("name", NAMES)
def test_blocks_cover_every_job_once(name):
    kind, rows = _tables()[name]
    assert len(rows)
    if kind == "res":
        _check_res(rows, *itx.res_blocks(rows))
    else:
        fn = mc.put_blocks if kind == "put" else mc.comp_blocks
        _check_tiled(rows, *fn(rows), kind)


@pytest.mark.parametrize("pi", range(3))
def test_plane_tables_bin_every_plane(pi):
    # one binning call per kind covers all planes; each plane's slice and
    # block rows must be those of binning the plane alone
    emitted, calls = _s7_frame2()
    (tables,) = calls["tables"]
    _check_res(emitted["res", pi], tables["res", pi],
               tables["res_blocks", pi])
    _check_tiled(emitted["comp", pi], tables["comp", pi],
                 tables["comp_blocks", pi], "comp")
    for kind, fn in (("res", itx.res_blocks), ("comp", mc.comp_blocks)):
        rows, blk = fn(emitted[kind, pi])
        assert np.array_equal(tables[kind, pi], rows)
        assert np.array_equal(tables[kind + "_blocks", pi], blk)
    # the puts of every plane share one table and one launch: plane pi's
    # rows and block rows are those of binning the plane alone, its
    # blocks' first jobs offset by the planes before it
    puts, blk = tables["put"], tables["put_blocks"]
    a, b = np.searchsorted(puts[:, 0], [pi, pi + 1])
    mine = blk[(blk[:, 1] >= a) & (blk[:, 1] < b)]
    assert (puts[blk[:, 1], 0][(blk[:, 1] >= a) & (blk[:, 1] < b)] ==
            pi).all()
    mine[:, 1] -= a
    rows, want = mc.put_blocks(emitted["put", pi])
    assert np.array_equal(puts[a:b], rows)
    assert np.array_equal(mine, want)
    _check_tiled(emitted["put", pi], puts[a:b], mine, "put")


def test_s7_tables_use_many_classes():
    emitted, _ = _s7_frame2()
    res = np.concatenate([emitted["res", pi] for pi in range(3)])
    assert len(np.unique(res[:, 0])) == 19          # every transform size
    comp = emitted["comp", 0]
    _, blk = mc.comp_blocks(comp)
    assert (blk[:, 3] + blk[:, 4] > 0).any()        # tiles of large jobs
    assert len(np.unique(blk[:, 0])) > 5
    for pi in range(3):
        _, blk = mc.put_blocks(emitted["put", pi])
        copy = blk[:, 0] >= mc.PUT_CLASSES
        assert copy.any() and (~copy).any()         # copy and subpel
        assert len(np.unique(blk[:, 0])) > 10
    _, blk = mc.put_blocks(emitted["put", 0])
    assert (blk[:, 3] + blk[:, 4] > 0).any()


def test_plain_sorted_order_matches_emitter_order_s7():
    emitted, calls = _s7_frame2()
    tb = device_tables("cpu")
    assert len(calls["comp"]) == 3 and len(calls["res"]) == 3
    (planes, jobs, bd), = calls["put"]
    fb = tb["mc_filter_banks"]
    outs = []
    for order in (np.concatenate([emitted["put", pi] for pi in range(3)]),
                  jobs.numpy()):
        args = [(r, p.clone(), rh, rw) for r, p, rh, rw in planes]
        outs.append(mc.put_planes_plain(args, torch.from_numpy(order), bd,
                                        fb))
    for (_, p, _, _), a, b in zip(planes, *outs):
        assert not torch.equal(a, p)
        assert torch.equal(a, b)
    for refs, jobs, before, seg, rh, rw, bd, luma, sh, sv in calls["comp"]:
        pi = int(jobs[0, 0])
        outs = []
        for order in (torch.from_numpy(emitted["comp", pi]), jobs):
            p, s = before.clone(), seg.clone()
            mc.comp_plain(refs, order, p, s, rh, rw, bd,
                          tb["mc_filter_banks"], tb["mc_wedge_lut16"],
                          tb["mc_wedge_lut32"], luma, sh, sv)
            outs.append((p, s))
        assert not torch.equal(outs[0][0], before)
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    for pi, (pool, jobs, before, bd, wht) in enumerate(calls["res"]):
        assert not wht
        a, b = before.clone(), before.clone()
        itx.itx_add_plain(pool, torch.from_numpy(emitted["res", pi]), a, bd)
        itx.itx_add_plain(pool, jobs, b, bd)
        assert not torch.equal(a, before)
        assert torch.equal(a, b)


@pytest.mark.parametrize("bd,ss", [(8, (1, 1)), (12, (0, 0))])
def test_plain_sorted_order_matches_case_order_comp(bd, ss):
    case = kc.comp_case(bd, 9, *ss, sizes=kc.ragged_comp_sizes())
    tb = device_tables("cpu")
    outs = []
    for sort in (False, True):
        seg = torch.zeros(case["seg_shape"], dtype=torch.int32)
        planes = []
        for sfx, luma in (("y", True), ("c", False)):
            jobs = case[f"jobs_{sfx}"]
            if sort:
                jobs = mc.comp_blocks(jobs)[0]
            plane = torch.zeros(case[f"dst_{sfx}"], dtype=torch.int32)
            mc.comp_plain([torch.from_numpy(r) for r in case[f"refs_{sfx}"]],
                          torch.from_numpy(jobs), plane, seg,
                          *case[f"bounds_{sfx}"], bd, tb["mc_filter_banks"],
                          tb["mc_wedge_lut16"], tb["mc_wedge_lut32"], luma,
                          *ss)
            planes.append(plane)
        outs.append(planes + [seg])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table", ["extreme", "ragged"])
def test_plain_sorted_order_matches_case_order_res(table):
    case = kc.itx_stress_case(10, 11)
    pool = torch.from_numpy(case["pool"])
    rows = case[table]
    a = torch.from_numpy(case["plane"].copy())
    b = a.clone()
    itx.itx_add_plain(pool, torch.from_numpy(rows), a, 10)
    itx.itx_add_plain(pool, torch.from_numpy(itx.res_blocks(rows)[0]), b,
                      10)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_tables_write_disjoint_pixels(name):
    kind, rows = _tables()[name]
    emitted, calls = _s7_frame2()
    if name.startswith("s7"):
        shape = tuple(calls["res"][int(name[-1])][2].shape)
    else:
        shape = (4096, 4096)
    if kind == "res":
        h, w = TH[rows[:, 0]], TW[rows[:, 0]]
    else:
        h, w = rows[:, 1], rows[:, 2]
    assert kc.overlaps(rows[:, 3], rows[:, 4], h, w, shape) == 0


@pytest.mark.parametrize("bd,seed", [(8, 12), (12, 13)])
def test_plain_sorted_order_matches_case_order_put(bd, seed):
    case = kc.put_case(bd, seed, sizes=kc.ragged_put_sizes())
    refs = [torch.from_numpy(r) for r in case["refs"]]
    fb = device_tables("cpu")["mc_filter_banks"]
    outs = []
    for jobs in (case["jobs"], mc.put_blocks(case["jobs"])[0]):
        plane = torch.zeros(case["dst_shape"], dtype=torch.int32)
        mc.put_plain(refs, torch.from_numpy(jobs), plane, case["rh"],
                     case["rw"], bd, fb)
        outs.append(plane)
    assert torch.equal(*outs)


def test_deblock_tiles_equal_whole_planes_s7():
    """The deblock kernel's 64x64 tiles with a halo of 12, stitched, on
    the s7 inter frame's own planes and maps (24-31% of the positions
    active), equal its whole-plane plain deblock."""
    _, calls = _s7_frame2()
    entries, lut_e, lut_i, bd = calls["deblock"][-1]
    want = lf.deblock_frame_plain(entries, lut_e, lut_i, bd)
    got = deblock_tiled_plain(entries, lut_e, lut_i, bd)
    for g, w, e in zip(got, want, entries):
        assert not torch.equal(w, e[0])
        assert torch.equal(g, w)
