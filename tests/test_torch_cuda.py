"""The CUDA kernels against their plain torch versions on the card,
bit-exact (torch.equal): deblock on the tests/test_lf_pallas.py input
recipe, one direction at a time (the other direction's edges all
inactive) and whole frames of up to three planes in one launch, with planes that end in ragged tiles; the put, compound
and residual kernels on the seeded cases of
dav1d_tpu_torch/ops/kernel_cases.py at bd 8/10/12, including residuals
at the full coefficient range, and put (filtered and copy), residual
and compound tables whose classes end in ragged kernel blocks or split
into 32-wide tiles; the warp and OBMC kernels on their seeded cases
(every plane in one launch, 4:2:0, 4:2:2 and 4:4:4, bd 8/10/12,
extreme shears, every lap geometry, laps cut at the plane edges, top
before left in one launch, ragged lap counts); the CDEF, Wiener and SGR kernels on their seeded cases
(bd 8/10/12, every layout, every unit size and stripe height; CDEF
also on tiles wholly outside the crop and on exact direction-cost
ties; Wiener and SGR also in one launch over the items of every plane
of a frame); the super-res kernel on its seeded cases (every plane and
the pre-CDEF snapshot in one launch, odd widths, the 2x step, 8192
columns, the zero padding written; planes padded to 4 columns, whose
last tile the plane cuts, and sources narrower than a staged span) and
the film grain kernel on its (every layout at bd 8/10/12, odd sizes,
overlap on and off, chroma scaling from luma, the restricted range with
and without is_id, copied planes; planes padded to 4 columns); both
wrappers refuse rows that are not whole 16-byte vectors. Marked
`cuda`: it
skips without a card. On the card it runs without JAX (this file
imports only the port):

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from dav1d_tpu_torch.ops import lf
from dav1d_tpu_torch.ops.lf_ref import calc_eih

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(bd, luma, h4, w4, device, seed=0):
    rng = np.random.default_rng(bd * 100 + h4 + w4 + luma + 1000 * seed)
    px_max = (1 << bd) - 1
    plane = rng.integers(0, px_max + 1, (4 * h4, 4 * w4)).astype(np.int32)
    flat = rng.integers(0, px_max + 1, (h4, w4))
    sel = rng.random((h4, w4)) < 0.5
    f4 = np.repeat(np.repeat(np.where(sel, flat, -1), 4, 0), 4, 1)
    plane = np.where(f4 >= 0,
                     np.clip(f4 + rng.integers(-2, 3, plane.shape),
                             0, px_max),
                     plane).astype(np.int32)
    maps = [(rng.integers(-1, 3, (h4, w4)).astype(np.int8),
             rng.integers(0, 64, (h4, w4)).astype(np.uint8))
            for _ in range(2)]
    lut_e, lut_i = calc_eih(3)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (T(plane), [tuple(map(T, m)) for m in maps],
            T(lut_e.astype(np.int32)), T(lut_i.astype(np.int32)))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("h4,w4", [(16, 64), (8, 8), (20, 36)],
                         ids=["wide", "tiny", "odd"])
@pytest.mark.parametrize("vertical", [True, False], ids=["v", "h"])
def test_kernel_vs_plain(cuda, bd, luma, h4, w4, vertical):
    # one direction's pass: the frame kernel with the other direction's
    # edges all inactive, against the plain pass alone
    P, maps, le, li = _inputs(bd, luma, h4, w4, cuda)
    cls, L = maps[0 if vertical else 1]
    off = (torch.full_like(cls, -1), L)
    before = lf.LAUNCHES["deblock"]
    got = lf.deblock_frame_cuda(
        [(P, luma, (cls, L) if vertical else off,
          off if vertical else (cls, L))], le, li, bd)[0]
    assert lf.LAUNCHES["deblock"] == before + 1
    ref = lf.deblock_pass_plain(P, cls, L, le, li, bd, luma, vertical)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_wrapper_checks(cuda):
    P, maps, le, li = _inputs(8, True, 8, 8, cuda)
    cls, L = maps[0]

    def run(plane, vmaps=maps[0]):
        return lf.deblock_frame_cuda([(plane, True, vmaps, maps[1])], le, li,
                                     8)
    with pytest.raises(TypeError):
        run(P.to(torch.int64))
    with pytest.raises(ValueError):
        run(P, (cls[:4], L))
    with pytest.raises(ValueError):
        run(P.t())
    # a contiguous plane 4 bytes off a 16-byte boundary
    unaligned = torch.empty(P.numel() + 1, dtype=torch.int32,
                            device=cuda)[1:].view(P.shape)
    unaligned.copy_(P)
    with pytest.raises(ValueError, match="aligned"):
        run(unaligned)


def _frame_entries(bd, shapes, device, seed=0):
    """(entries, lut_e, lut_i) of a frame's planes: (h4, w4, luma) per
    plane, random maps in both directions."""
    entries = []
    for n, (h4, w4, luma) in enumerate(shapes):
        P, maps, le, li = _inputs(bd, luma, h4, w4, device, seed + n)
        entries.append((P, luma, maps[0], maps[1]))
    return entries, le, li


# 4:2:0 and 4:4:4 frames whose planes end in ragged 64x64 tiles, one
# plane of exactly 64x64, and planes smaller than a tile
FRAMES = {"420": [(36, 52, True), (18, 26, False), (18, 26, False)],
          "444": [(20, 36, False)] * 3, "tile": [(16, 16, True)],
          "tiny": [(8, 8, True), (2, 2, False)]}


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frame_kernel_vs_plain(cuda, bd, frame):
    # one launch deblocks every plane in both directions
    entries, le, li = _frame_entries(bd, FRAMES[frame], cuda, seed=bd)
    before = lf.LAUNCHES["deblock"]
    got = lf.deblock_frame_cuda(entries, le, li, bd)
    assert lf.LAUNCHES["deblock"] == before + 1
    want = lf.deblock_frame_plain(entries, le, li, bd)
    torch.cuda.synchronize()
    assert any(not torch.equal(w, e[0]) for w, e in zip(want, entries))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_frame_wrapper_checks(cuda):
    entries, le, li = _frame_entries(8, FRAMES["420"], cuda)
    with pytest.raises(ValueError):
        lf.deblock_frame_cuda(entries + entries[:1], le, li, 8)
    P, luma, vm, hm = entries[1]
    with pytest.raises(ValueError):
        lf.deblock_frame_cuda([(P, luma, vm, entries[0][3])], le, li, 8)
    with pytest.raises(TypeError):
        lf.deblock_frame_cuda([(P, luma, (vm[0], vm[1].to(torch.int8)),
                                hm)], le, li, 8)
    with pytest.raises(ValueError):
        lf.deblock_frame_cuda([(P[:, :-2], luma, vm, hm)], le, li, 8)
    with pytest.raises(ValueError):
        lf.deblock_frame_cuda(entries, le, li, 9)


# --- inter Stage B: put, compound and residual kernels -------------------

def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_mc_put_kernel_vs_plain(cuda, bd):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    case = kc.put_case(bd, seed=bd)
    refs = [_t(r, cuda) for r in case["refs"]]
    jobs = _t(case["jobs"], cuda)
    got = torch.zeros(case["dst_shape"], dtype=torch.int32, device=cuda)
    want = got.clone()
    before = mc.LAUNCHES["mc_put"]
    mc.put_cuda(refs, jobs, got, case["rh"], case["rw"], bd)
    assert mc.LAUNCHES["mc_put"] == before + 1
    mc.put_plain(refs, jobs, want, case["rh"], case["rw"], bd,
                 device_tables(cuda)["mc_filter_banks"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("table", ["host", "wrapper"])
def test_mc_put_ragged_blocks_kernel_vs_plain(cuda, bd, table):
    # every class, filtered and copy, ends in a ragged block; jobs above
    # 32x32 are tiled. "host": the put_blocks table built beforehand, as
    # the decode path sends it; "wrapper": put_cuda bins by itself
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    case = kc.put_case(bd, seed=30 + bd, sizes=kc.ragged_put_sizes())
    refs = [_t(r, cuda) for r in case["refs"]]
    rows, blk = mc.put_blocks(case["jobs"])
    blocks = _t(blk, cuda) if table == "host" else None
    jobs = _t(rows if table == "host" else case["jobs"], cuda)
    got = torch.zeros(case["dst_shape"], dtype=torch.int32, device=cuda)
    want = got.clone()
    mc.put_cuda(refs, jobs, got, case["rh"], case["rw"], bd, blocks)
    mc.put_plain(refs, jobs, want, case["rh"], case["rw"], bd,
                 device_tables(cuda)["mc_filter_banks"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_mc_put_planes_one_launch_vs_plain(cuda, bd):
    # three tables of different reference and destination shapes as the
    # planes of one launch, binned with the plane as the group
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    cases = [kc.put_case(bd, seed=40 + bd),
             kc.put_case(bd, seed=50 + bd, sizes=kc.ragged_put_sizes()),
             kc.put_case(bd, seed=60 + bd, width=256)]
    jobs = np.concatenate([c["jobs"] for c in cases])
    jobs[:, 0] = np.repeat(np.arange(3), [len(c["jobs"]) for c in cases])
    rows, blk = mc.put_blocks(jobs, group=jobs[:, 0])
    args = {k: [([_t(r, cuda) for r in c["refs"]],
                 torch.zeros(c["dst_shape"], dtype=torch.int32,
                             device=cuda), c["rh"], c["rw"])
                for c in cases] for k in ("kernel", "plain")}
    before = mc.LAUNCHES["mc_put"]
    mc.put_planes_cuda(args["kernel"], _t(rows, cuda), bd, _t(blk, cuda))
    assert mc.LAUNCHES["mc_put"] == before + 1
    mc.put_planes_plain(args["plain"], _t(jobs, cuda), bd,
                        device_tables(cuda)["mc_filter_banks"])
    torch.cuda.synchronize()
    for a, b in zip(args["kernel"], args["plain"]):
        assert torch.equal(a[1], b[1])


def _comp_kernel_vs_plain(cuda, bd, ss, case):
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    tb = device_tables(cuda)
    outs = {}
    for name in ("kernel", "plain"):
        seg = torch.zeros(case["seg_shape"], dtype=torch.int32, device=cuda)
        planes = []
        for sfx, luma in (("y", True), ("c", False)):
            refs = [_t(r, cuda) for r in case[f"refs_{sfx}"]]
            jobs = _t(case[f"jobs_{sfx}"], cuda)
            plane = torch.zeros(case[f"dst_{sfx}"], dtype=torch.int32,
                                device=cuda)
            rh, rw = case[f"bounds_{sfx}"]
            if name == "kernel":
                mc.comp_cuda(refs, jobs, plane, seg, rh, rw, bd,
                             tb["mc_wedge_lut16"], tb["mc_wedge_lut32"],
                             luma, *ss)
            else:
                mc.comp_plain(refs, jobs, plane, seg, rh, rw, bd,
                              tb["mc_filter_banks"], tb["mc_wedge_lut16"],
                              tb["mc_wedge_lut32"], luma, *ss)
            planes.append(plane)
        outs[name] = planes + [seg]
    torch.cuda.synchronize()
    for a, b in zip(outs["kernel"], outs["plain"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)],
                         ids=["420", "422", "444"])
def test_mc_comp_kernel_vs_plain(cuda, bd, ss):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _comp_kernel_vs_plain(cuda, bd, ss, kc.comp_case(
        bd, seed=bd + 3 * ss[0] + ss[1], ss_hor=ss[0], ss_ver=ss[1]))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)],
                         ids=["420", "422", "444"])
def test_mc_comp_ragged_blocks_kernel_vs_plain(cuda, bd, ss):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _comp_kernel_vs_plain(cuda, bd, ss, kc.comp_case(
        bd, seed=50 + bd + 3 * ss[0] + ss[1], ss_hor=ss[0], ss_ver=ss[1],
        sizes=kc.ragged_comp_sizes()))


@pytest.mark.parametrize("bd", [8, 10])
def test_mc_comp_unaligned_rows_kernel_vs_plain(cuda, bd):
    # reference rows of 222 / 111 pixels: no row is 16-byte aligned, so
    # the kernel copies every window 4 bytes at a time
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _comp_kernel_vs_plain(cuda, bd, (1, 1), kc.comp_case(
        bd, seed=70 + bd, ss_hor=1, ss_ver=1, ref_shape=(160, 222)))


def _itx_kernel_vs_plain(cuda, case, table, bd, wht=False):
    from dav1d_tpu_torch.ops import itx
    pool = _t(case["pool"], cuda)
    jobs = _t(case[table], cuda)
    got = _t(case["plane"], cuda)
    want = got.clone()
    before = itx.LAUNCHES["itx_add"]
    itx.itx_add_cuda(pool, jobs, got, bd, wht=wht)
    assert itx.LAUNCHES["itx_add"] == before + 1
    itx.itx_add_plain(pool, jobs, want, bd, wht=wht)
    torch.cuda.synchronize()
    assert not torch.equal(want, _t(case["plane"], cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("wht", [False, True], ids=["itx", "wht"])
def test_itx_add_kernel_vs_plain(cuda, bd, wht):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _itx_kernel_vs_plain(cuda, kc.itx_case(bd, seed=bd),
                         "wht" if wht else "jobs", bd, wht)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("table", ["extreme", "ragged"])
def test_itx_add_stress_kernel_vs_plain(cuda, bd, table):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _itx_kernel_vs_plain(cuda, kc.itx_stress_case(bd, seed=20 + bd), table,
                         bd)


def test_inter_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import itx, mc
    ref = torch.zeros((16, 16), dtype=torch.int32, device=cuda)
    jobs = torch.zeros((1, 11), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        mc.put_cuda([ref], jobs.long(), ref.clone(), 16, 16, 8)
    with pytest.raises(ValueError):
        mc.put_cuda([ref], jobs, ref.clone(), 17, 16, 8)
    with pytest.raises(ValueError):
        mc.put_cuda([ref] * 9, jobs, ref.clone(), 16, 16, 8)
    with pytest.raises(ValueError):
        itx.itx_add_cuda(ref.view(-1), jobs[:, :6], ref.t(), 8)
    with pytest.raises(ValueError):
        mc.put_cuda([ref], jobs, ref.clone(), 16, 16, 8,
                    blocks=jobs[:, :4].contiguous())
    with pytest.raises(TypeError):
        mc.put_cuda([ref], jobs, ref.clone(), 16, 16, 8,
                    blocks=jobs[:, :5].long())


LAYOUTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("cut", [None, -5], ids=["whole", "ragged"])
def test_mc_warp_kernel_vs_plain(cuda, bd, layout, cut):
    # every plane in one launch: random and extreme shears (filter rows
    # 0 and 192), windows inside, across every frame edge and wholly
    # outside it; a tile count that fills its last block of 8 warps and
    # one that ends it ragged
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc, mc_warp
    from dav1d_tpu_torch.ops.device import device_tables
    case = kc.warp_case(bd, seed=bd, ss_hor=LAYOUTS[layout][0],
                        ss_ver=LAYOUTS[layout][1])
    jobs = _t(case["jobs"][:cut], cuda)
    got, want = (kc.case_planes(case, cuda) for _ in range(2))
    before = mc.LAUNCHES["mc_warp"]
    mc_warp.warp_cuda(got, jobs, bd)
    assert mc.LAUNCHES["mc_warp"] == before + 1
    mc_warp.warp_planes_plain(want, jobs, bd,
                              device_tables(cuda)["mc_warp_filter"])
    torch.cuda.synchronize()
    for (_, g, _, _), (_, w, _, _) in zip(got, want):
        assert w.count_nonzero() > w.numel() // 2
        assert torch.equal(g, w)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("cut", [(None, None), (-1, -2), (5, None),
                                 (None, 7)],
                         ids=["whole", "ragged", "top-only-5", "left-only-7"])
def test_mc_obmc_kernel_vs_plain(cuda, bd, layout, cut):
    # every lap geometry the emitter writes, every filter type, top and
    # left laps on the same blocks (one launch, the top laps before the
    # left laps), laps cut at the plane's right and bottom edges; lap
    # counts that are not multiples of the 3 laps of a block, and one
    # direction alone (the other None)
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc, mc_obmc
    from dav1d_tpu_torch.ops.device import device_tables
    tb = device_tables(cuda)
    case = kc.obmc_case(bd, seed=bd, ss_hor=LAYOUTS[layout][0],
                        ss_ver=LAYOUTS[layout][1])
    if cut[0] == 5:
        top, left = _t(case["top"][:5], cuda), None
    elif cut[1] == 7:
        top, left = None, _t(case["left"][:7], cuda)
    else:
        top, left = (_t(case[k][:c], cuda)
                     for k, c in zip(("top", "left"), cut))
    got, want = (kc.case_planes(case, cuda) for _ in range(2))
    before = mc.LAUNCHES["mc_obmc"]
    mc_obmc.obmc_cuda(got, top, left, bd)
    assert mc.LAUNCHES["mc_obmc"] == before + 1
    mc_obmc.obmc_frame_plain(want, top, left, bd, tb["mc_filter_banks"],
                             tb["mc_obmc_masks"])
    torch.cuda.synchronize()
    changed = [not torch.equal(w, _t(p["plane"], cuda))
               for p, (_, w, _, _) in zip(case["planes"], want)]
    # every plane has laps in the whole and ragged tables; a few laps of
    # one direction may leave a plane untouched
    assert all(changed) if cut[0] != 5 and cut[1] != 7 else any(changed)
    for (_, g, _, _), (_, w, _, _) in zip(got, want):
        assert torch.equal(g, w)


def test_warp_obmc_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import mc_obmc, mc_warp
    ref = torch.zeros((16, 16), dtype=torch.int32, device=cuda)
    planes = [([ref], ref.clone(), 16, 16)]
    with pytest.raises(TypeError):
        mc_warp.warp_cuda(planes, torch.zeros(
            (1, 12), dtype=torch.int64, device=cuda), 8)
    with pytest.raises(ValueError):
        mc_warp.warp_cuda(planes, torch.zeros(
            (1, 11), dtype=torch.int32, device=cuda), 8)
    with pytest.raises(ValueError):
        mc_obmc.obmc_cuda([([ref], ref.clone(), 17, 16)], torch.zeros(
            (1, 13), dtype=torch.int32, device=cuda), None, 8)
    with pytest.raises(ValueError):
        mc_obmc.obmc_cuda(planes, torch.zeros(
            (1, 13), dtype=torch.int32, device=cuda), None, 9)
    with pytest.raises(ValueError):         # the left table's width
        mc_obmc.obmc_cuda(planes, torch.zeros(
            (1, 13), dtype=torch.int32, device=cuda), torch.zeros(
            (1, 12), dtype=torch.int32, device=cuda), 8)
    with pytest.raises(ValueError):         # no laps at all
        mc_obmc.obmc_cuda(planes, None, None, 8)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["400", "420", "422", "444"])
@pytest.mark.parametrize("geo", [0, 1, 2, "tie"],
                         ids=["70x50", "196x130", "100x60-copy", "ties"])
def test_cdef_kernel_vs_plain(cuda, bd, layout, geo):
    # every plane in one launch: block kinds at the direction search's
    # extremes, every strength, blocks off, the crop ending inside the
    # tiles and the padded planes (copied through outside it), whole
    # tiles outside the crop, exact cost ties between directions
    from dav1d_tpu_torch.ops import cdef
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops.device import device_tables
    case = kc.cdef_tie_case(bd, layout) if geo == "tie" else \
        kc.cdef_case_at(bd, layout, geo)
    args = kc.cdef_args(case, cuda)
    before = cdef.LAUNCHES["cdef"]
    got = cdef.cdef_cuda(*args)
    assert cdef.LAUNCHES["cdef"] == before + 1
    want = cdef.cdef_planes_plain(*args, device_tables(cuda)["cdef_proj"])
    torch.cuda.synchronize()
    for p, g, w in zip(args[0], got, want):
        assert not torch.equal(w, p)
        assert torch.equal(g, w)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("kind", ["wiener", "sgr"])
@pytest.mark.parametrize("us_log2", [5, 6, 7, 8],
                         ids=["wmax48", "wmax96", "wmax192", "wmax384"])
@pytest.mark.parametrize("hmax", [64, 32])
def test_lr_kernel_vs_plain(cuda, bd, kind, us_log2, hmax):
    # one launch over a plane's items, through the frame entry: all 16
    # edge-flag combinations, every stripe height, Wiener taps at their
    # limits, every SGR parameter row (s0 = 0 and s1 = 0 among them),
    # SGR's int32 overflows at 12 bit
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import lr
    planes, tables, bd = kc.frame_args(kc.lr_frame_case(kc.lr_case_at(
        bd, kind, us_log2, hmax)), cuda, kind)
    want = [p[2].clone() for p in planes]
    (lr.wiener_frame_plain if kind == "wiener" else lr.sgr_frame_plain)(
        [(s, q, d, w, h) for (s, q, _, w, h), d in zip(planes, want)],
        tables, bd)
    name = "lr_" + kind
    before = lr.LAUNCHES[name]
    (lr.wiener_frame_cuda if kind == "wiener" else lr.sgr_frame_cuda)(
        planes, tables, bd)
    assert lr.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    assert not torch.equal(want[0], planes[0][0])
    assert torch.equal(planes[0][2], want[0])


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["400", "420", "422", "444"])
def test_wiener_frame_kernel_vs_plain(cuda, bd, layout):
    # every plane's Wiener items in exactly one launch, reading the
    # unpadded planes: planes of different shapes, every edge flag at
    # both plane edges, items of two column tiles
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import lr
    planes, tables, bd = kc.frame_args(kc.frame_case(bd, layout, "wiener"),
                                       cuda, "wiener")
    want = [p[2].clone() for p in planes]
    lr.wiener_frame_plain([(s, q, d, w, h) for (s, q, _, w, h), d
                           in zip(planes, want)], tables, bd)
    before = lr.LAUNCHES["lr_wiener"]
    lr.wiener_frame(planes, tables, bd)
    assert lr.LAUNCHES["lr_wiener"] == before + 1
    torch.cuda.synchronize()
    for (src, _, got, _, _), w in zip(planes, want):
        assert not torch.equal(w, src)
        assert torch.equal(got, w)


def test_wiener_frame_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import lr
    planes, (items, rowt), bd = kc.frame_args(kc.frame_case(8, 1, "wiener"),
                                              cuda, "wiener")
    before = lr.LAUNCHES["lr_wiener"]
    with pytest.raises(TypeError):          # a plane of the wrong dtype
        lr.wiener_frame_cuda([(planes[0][0].long(), *planes[0][1:])] +
                             planes[1:], (items, rowt), bd)
    with pytest.raises(TypeError):          # a table of the wrong dtype
        lr.wiener_frame_cuda(planes, (items.astype(np.int64), rowt), bd)
    with pytest.raises(ValueError):         # a CPU tensor
        lr.wiener_frame_cuda([tuple(t.cpu() if isinstance(t, torch.Tensor)
                                    else t for t in p) for p in planes],
                             (items, rowt), bd)
    with pytest.raises(ValueError):         # a table of the wrong width
        lr.wiener_frame_cuda(planes, (items[:, :-1].copy(), rowt), bd)
    with pytest.raises(ValueError):         # row tables too narrow
        lr.wiener_frame_cuda(planes, (items, rowt[:, :-1].copy()), bd)
    with pytest.raises(ValueError):         # a plane index past the list
        lr.wiener_frame_cuda(planes[:2], (items, rowt), bd)
    with pytest.raises(ValueError):         # bit depth
        lr.wiener_frame_cuda(planes, (items, rowt), 9)
    assert lr.LAUNCHES["lr_wiener"] == before


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3, "lr_cases"],
                         ids=["400", "420", "422", "444", "lr_cases"])
def test_sgr_frame_kernel_vs_plain(cuda, bd, layout):
    # every plane's SGR items in exactly one launch, reading the
    # unpadded planes: planes of different shapes, every edge flag at
    # both plane edges, every parameter row, items of two column tiles;
    # and every SGR case of lr_cases as a frame of one plane (every unit
    # size and stripe height, SGR's int32 overflows at 12 bit)
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import lr
    cases = [kc.lr_frame_case(c) for c in kc.lr_cases((bd,))
             if c["kind"] == "sgr"] if layout == "lr_cases" else \
        [kc.frame_case(bd, layout, "sgr")]
    for case in cases:
        planes, tables, bd = kc.frame_args(case, cuda, "sgr")
        want = [p[2].clone() for p in planes]
        lr.sgr_frame_plain([(s, q, d, w, h) for (s, q, _, w, h), d
                            in zip(planes, want)], tables, bd)
        before = lr.LAUNCHES["lr_sgr"]
        lr.sgr_frame(planes, tables, bd)
        assert lr.LAUNCHES["lr_sgr"] == before + 1
        torch.cuda.synchronize()
        for (src, _, got, _, _), w in zip(planes, want):
            assert not torch.equal(w, src)
            assert torch.equal(got, w)


def test_sgr_frame_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import lr
    planes, (items, rowt), bd = kc.frame_args(kc.frame_case(8, 1, "sgr"),
                                              cuda, "sgr")
    before = lr.LAUNCHES["lr_sgr"]
    with pytest.raises(TypeError):          # a table of the wrong dtype
        lr.sgr_frame_cuda(planes, (items.astype(np.int64), rowt), bd)
    with pytest.raises(ValueError):         # Wiener's table width
        lr.sgr_frame_cuda(planes, kc.frame_args(
            kc.frame_case(8, 1, "wiener"), cuda, "wiener")[1], bd)
    with pytest.raises(ValueError):         # row tables too narrow
        lr.sgr_frame_cuda(planes, (items, rowt[:, :-1].copy()), bd)
    with pytest.raises(ValueError):         # a plane index past the list
        lr.sgr_frame_cuda(planes[:2], (items, rowt), bd)
    with pytest.raises(ValueError):         # bit depth
        lr.sgr_frame_cuda(planes, (items, rowt), 9)
    assert lr.LAUNCHES["lr_sgr"] == before


def test_filter_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import cdef, lr
    from dav1d_tpu_torch.ops import kernel_cases as kc
    planes, maps, Hy, Wy, layout, bd, damping = kc.cdef_args(
        kc.cdef_case_at(8, 1, 0), cuda)
    with pytest.raises(TypeError):
        cdef.cdef_cuda([p.long() for p in planes], maps, Hy, Wy, layout, bd,
                       damping)
    with pytest.raises(ValueError):
        cdef.cdef_cuda([p.cpu() for p in planes], maps, Hy, Wy, layout, bd,
                       damping)
    with pytest.raises(ValueError):
        cdef.cdef_cuda(planes, maps[:, :-1], Hy, Wy, layout, bd, damping)
    with pytest.raises(ValueError):
        cdef.cdef_cuda(planes[:2], maps, Hy, Wy, layout, bd, damping)
    with pytest.raises(ValueError):
        cdef.cdef_cuda(planes, maps, Hy + 4, Wy, layout, bd, damping)
    with pytest.raises(ValueError):         # rows not 16-byte vectors
        cdef.cdef_cuda([p[:, 2:].contiguous() for p in planes], maps, Hy,
                       Wy, layout, bd, damping)
    planes, (items, rowt), bd = kc.frame_args(kc.lr_frame_case(
        kc.lr_case_at(8, "wiener", 5, 64)), cuda, "wiener")
    with pytest.raises(TypeError):          # a row table of int64
        lr.wiener_frame_cuda(planes, (items, rowt.astype(np.int64)), bd)
    with pytest.raises(ValueError):         # a CPU plane
        lr.wiener_frame_cuda([(planes[0][0].cpu(), *planes[0][1:])],
                             (items, rowt), bd)
    with pytest.raises(ValueError):         # rows past the plane's hmax
        lr.wiener_frame_cuda([(*planes[0][:4], 30)], (items, rowt), bd)
    planes, (items, rowt), bd = kc.frame_args(kc.lr_frame_case(
        kc.lr_case_at(8, "sgr", 5, 32)), cuda, "sgr")
    with pytest.raises(ValueError):         # one row table short
        lr.sgr_frame_cuda(planes, (items, rowt[:-1].copy()), bd)
    with pytest.raises(ValueError):         # bit depth
        lr.sgr_frame_cuda(planes, (items, rowt), 9)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["400", "420", "422", "444"])
def test_superres_kernel_vs_plain(cuda, bd, layout):
    # every geometry of the super-res cases (odd widths, the 2x step,
    # 8192 columns), every plane and the pre-CDEF snapshot in one launch;
    # the destinations start at -1: the kernel writes the zero padding
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import superres
    cases = [c for c in kc.superres_cases()
             if (c["bd"], c["layout"]) == (bd, layout)]
    assert len(cases) == len(kc.SUPERRES_GEOMETRIES)
    for case in cases:
        jobs = kc.superres_args(case, cuda)
        want = superres.resize_frame_plain(
            [(s, sw, h, d.clone(), dw, st, m)
             for s, sw, h, d, dw, st, m in jobs], bd)
        before = superres.LAUNCHES["superres"]
        got = superres.resize_frame(jobs, bd)
        assert superres.LAUNCHES["superres"] == before + 1
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_superres_edge_kernel_vs_plain(cuda, bd):
    # planes padded to 4 columns only: a last tile cut by the output
    # width and the plane's, a tile of one row, a source narrower than a
    # tile's staged span (clamped at both edges)
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import superres
    for case in kc.superres_edge_cases():
        if case["bd"] != bd:
            continue
        jobs = kc.superres_args(case, cuda)
        want = superres.resize_frame_plain(
            [(s, sw, h, d.clone(), dw, st, m)
             for s, sw, h, d, dw, st, m in jobs], bd)
        got = superres.resize_frame(jobs, bd)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_superres_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import superres
    jobs = kc.superres_args(kc.superres_case(8, 1, 53, 70, 21), cuda)
    src, src_w, h, dst, dst_w, step, mx0 = jobs[0]
    before = superres.LAUNCHES["superres"]
    with pytest.raises(ValueError):         # dst is src
        superres.resize_frame_cuda([(src, src_w, h, src, dst_w, step, mx0)],
                                   8)
    with pytest.raises(ValueError):         # not contiguous
        superres.resize_frame_cuda([(src[:, 1:], src_w, h, dst, dst_w, step,
                                     mx0)], 8)
    with pytest.raises(ValueError):         # a CPU destination
        superres.resize_frame_cuda([(src, src_w, h, dst.cpu(), dst_w, step,
                                     mx0)], 8)
    with pytest.raises(ValueError):         # bit depth
        superres.resize_frame_cuda(jobs, 9)
    # rows that are not whole 16-byte vectors: a stride of 70 columns,
    # and a plane starting 4 bytes into its buffer
    odd = torch.zeros((h, 70), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        superres.resize_frame_cuda([(odd, src_w, h, dst, dst_w, step, mx0)],
                                   8)
    flat = torch.zeros(dst.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(dst.shape)
    with pytest.raises(ValueError, match="16-byte"):
        superres.resize_frame_cuda([(src, src_w, h, shifted, dst_w, step,
                                     mx0)], 8)
    assert superres.LAUNCHES["superres"] == before


def _grain_kernel_vs_plain(cuda, case):
    from dav1d_tpu_torch.ops import fg
    from dav1d_tpu_torch.ops import kernel_cases as kc
    args = kc.grain_args(case, cuda)
    want = fg.film_grain_plain(*args)
    before = fg.LAUNCHES["film_grain"]
    got = fg.film_grain(*args)
    assert fg.LAUNCHES["film_grain"] == before + 1
    torch.cuda.synchronize()
    for g, w, s in zip(got, want, args[0]):
        assert g is not s
        assert torch.equal(g, w)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["400", "420", "422", "444"])
@pytest.mark.parametrize("geo", range(3), ids=["71x49", "128x64", "130x97"])
def test_film_grain_kernel_vs_plain(cuda, bd, layout, geo):
    # every plane in one launch with overlap; odd sizes whose chroma
    # reads the luma one column past its width, blocks cut at both edges
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _grain_kernel_vs_plain(cuda, kc.grain_case(
        bd, layout, *kc.GRAIN_GEOMETRIES[geo], seed=geo))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_film_grain_edge_kernel_vs_plain(cuda, bd):
    # planes padded to 4 columns only: units cut by the plane's width,
    # the chroma's luma read past an odd width in the last int4
    from dav1d_tpu_torch.ops import kernel_cases as kc
    for case in kc.grain_edge_cases():
        if case["params"]["bd"] == bd:
            _grain_kernel_vs_plain(cuda, case)


@pytest.mark.parametrize("name", ["mono-clip", "420-csfl-clip",
                                  "422-csfl-clip-id", "444-clip-id-copy"])
def test_film_grain_flags_kernel_vs_plain(cuda, name):
    # overlap off, chroma scaling from luma, the restricted range with and
    # without is_id, copied planes
    from dav1d_tpu_torch.ops import kernel_cases as kc
    _grain_kernel_vs_plain(cuda, kc.grain_variant(name))


def test_film_grain_wrapper_checks(cuda):
    from dav1d_tpu_torch.ops import fg
    from dav1d_tpu_torch.ops import kernel_cases as kc
    planes, fr, luts, scal, off = kc.grain_args(kc.grain_case(8, 1, 71, 49),
                                                cuda)
    before = fg.LAUNCHES["film_grain"]
    with pytest.raises(ValueError):         # a CPU plane
        fg.film_grain_cuda([planes[0].cpu(), *planes[1:]], fr, luts, scal,
                           off)
    with pytest.raises(ValueError):         # not contiguous
        fg.film_grain_cuda([planes[0][:, 1:], *planes[1:]], fr, luts, scal,
                           off)
    with pytest.raises(ValueError):         # scaling LUTs of int32
        fg.film_grain_cuda(planes, fr, luts, scal.int(), off)
    with pytest.raises(ValueError):         # offsets of another frame
        fg.film_grain_cuda(planes, fr, luts, scal, off[:1])
    # rows that are not whole 16-byte vectors
    odd = torch.zeros((planes[0].shape[0], 130), dtype=torch.int32,
                      device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fg.film_grain_cuda([odd, *planes[1:]], fr, luts, scal, off)
    assert fg.LAUNCHES["film_grain"] == before
