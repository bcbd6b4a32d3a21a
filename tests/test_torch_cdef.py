"""CDEF parity: the port's cdef_planes_device (plain torch on the CPU)
against dav1d_tpu's (XLA on the CPU) on deblocked planes of small
decoded intra streams (4:2:0 at 8/10/12 bit, 4:2:2, 4:4:4,
monochrome), and its plain version against dav1d_tpu's _cdef_fn on the
CUDA kernel's seeded cases (exact direction-cost ties among them); the
kernel's 64x64 tiling with a 2-pixel apron and its tiles outside the
crop, and its search's pairwise tie reduction, in plain torch.
Tolerance 0: bit-exact."""
import numpy as np
import pytest
import torch

from dav1d_tpu.ops.cdef import _cdef_fn
from dav1d_tpu.ops.cdef import cdef_planes_device as jax_cdef
from dav1d_tpu_torch.ops import cdef
from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.ops.cdef import cdef_planes_device, cdef_planes_plain

from torch_port_cases import STREAMS, cdef_tiled_plain, frame_planes

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cdef_matches_dav1d_tpu(name):
    n_active = 0
    for pj, pt, bd, _planes, dbk in frame_planes(name):
        cd = pj.f.frame_hdr.cdef
        n_active += any(cd.y_strength[i] or cd.uv_strength[i]
                        for i in range(1 << cd.n_bits))
        ref = [np.asarray(a) for a in jax_cdef(dbk, pj, bd)]
        inp = [torch.from_numpy(p.copy()) for p in dbk]
        got = cdef_planes_device(inp, pt, bd)
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), r), f"plane {i}"
        # the inputs (LR's pre-CDEF snapshot) stay as they were
        for a, p in zip(inp, dbk):
            assert np.array_equal(a.numpy(), p)
    assert n_active


# --- the kernel cases and the CUDA kernel's tiling, on the CPU ----------

def _proj():
    from dav1d_tpu_torch.ops.device import device_tables
    return device_tables("cpu")["cdef_proj"]


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("layout", kc.CDEF_LAYOUTS,
                         ids=["400", "420", "422", "444"])
def test_cdef_plain_matches_dav1d_tpu_on_kernel_cases(bd, layout):
    """cdef_planes_plain, which the CUDA kernel is held to on the card,
    against dav1d_tpu's _cdef_fn on the kernel cases (the 70x50
    geometry; 10 bit is test_cdef_matches_dav1d_tpu's 10bit-420 stream):
    direction-search extremes, every strength, blocks off."""
    case = kc.cdef_case_at(bd, layout, 0)
    args = kc.cdef_args(case, "cpu")
    planes, maps, Hy, Wy = args[:4]
    got = cdef_planes_plain(*args, _proj())
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    crops = [(Hy, Wy)] + [(Hy >> ss_ver, Wy >> ss_hor)] * (len(planes) - 1)
    ins = [p[:h, :w].numpy() for p, (h, w) in zip(planes, crops)]
    if not layout:
        ins += [np.zeros((Hy // 2, Wy // 2), np.int32)] * 2
    ref = _cdef_fn(Hy // 4, Wy // 4, layout, bd, case["damping"],
                   bool(layout))(*ins, *case["maps"])
    for g, r, p, (h, w) in zip(got, ref, planes, crops):
        assert np.array_equal(g[:h, :w].numpy(), np.asarray(r))
        assert torch.equal(g[h:], p[h:]) and torch.equal(g[:, w:], p[:, w:])
    assert not torch.equal(got[0], planes[0])


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("layout", kc.CDEF_LAYOUTS,
                         ids=["400", "420", "422", "444"])
def test_cdef_tiles_with_apron_equal_the_whole_frame(bd, layout):
    """csrc/cdef.cu filters each 64x64 luma tile (and its chroma tiles)
    from a window with a 2-pixel apron, FILL outside the crop, the
    directions searched in the tile alone: stitched, the tiles equal the
    whole frame (the 196x130 geometry, its tiles ragged at the crop). A
    1-pixel apron does not: the taps reach 2 pixels."""
    args = kc.cdef_args(kc.cdef_case_at(bd, layout, 1), "cpu")
    want = cdef_planes_plain(*args, _proj())
    got = cdef_tiled_plain(*args, _proj())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    short = cdef_tiled_plain(*args, _proj(), apron=1)
    assert not all(torch.equal(g, w) for g, w in zip(short, want))


@pytest.mark.parametrize("layout", kc.CDEF_LAYOUTS,
                         ids=["400", "420", "422", "444"])
def test_cdef_tiles_outside_the_crop_are_copies(layout):
    """The kernel copies a tile wholly outside the crop through without
    staging or searching it: on the 100x60 geometry (its 64 x 104 crop
    in 192 x 256 padded planes) the tiles of the crop, stitched, equal
    the whole frame, and every pixel outside the crop is the input's."""
    args = kc.cdef_args(kc.cdef_case_at(10, layout, 2), "cpu")
    planes, _, Hy, Wy = args[:4]
    assert planes[0].shape[0] >= Hy + 128 and planes[0].shape[1] >= Wy + 128
    want = cdef_planes_plain(*args, _proj())
    for g, w in zip(cdef_tiled_plain(*args, _proj()), want):
        assert torch.equal(g, w)
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    for i, (w, p) in enumerate(zip(want, planes)):
        h, wd = (Hy, Wy) if i == 0 else (Hy >> ss_ver, Wy >> ss_hor)
        assert torch.equal(w[h:], p[h:]) and torch.equal(w[:, wd:], p[:, wd:])
        assert not torch.equal(w[:h, :wd], p[:h, :wd])


def _tie_costs(bd, layout):
    case = kc.cdef_tie_case(bd, layout)
    y = torch.from_numpy(case["planes"][0][:case["Hy"], :case["Wy"]].copy())
    return y, cdef.dir_costs_plain(y, bd, _proj())


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cdef_tie_case_ties(bd):
    """Every 8x8 block of the tie case's luma crop is not flat and has
    its largest direction cost at exactly the two directions of one of
    kernel_cases.TIE_PAIRS, each pair on about a sixth of the blocks;
    the costs recomputed from find_dirs_plain's projection."""
    y, costs = _tie_costs(bd, 1)
    costs = costs.numpy()
    top = costs == costs.max(1, keepdims=True)
    pairs = [tuple(np.flatnonzero(r)) for r in top]
    assert set(pairs) == set(kc.TIE_PAIRS)
    assert min(pairs.count(p) for p in kc.TIE_PAIRS) >= len(pairs) // 6
    blocks = y.reshape(y.shape[0] // 8, 8, -1, 8).permute(0, 2, 1, 3)
    assert (blocks.reshape(-1, 64).float().std(1) > 0).all()


def _lane_reduce(costs, prefer_lower=True):
    """csrc/cdef.cu's arg-max: the 8 lanes of a block (lane j holds
    direction j's cost) reduced pairwise by xor 1, 2, 4, a lane taking
    its partner's (cost, direction) where the partner's cost is larger
    or, on equal costs, its direction lower (prefer_lower=False: higher,
    the last maximum). Returns every lane's direction, (n, 8)."""
    c = costs.clone()
    d = torch.arange(8).expand_as(c).clone()
    for m in (1, 2, 4):
        perm = torch.arange(8) ^ m
        oc, od = c[:, perm], d[:, perm]
        tie = od < d if prefer_lower else od > d
        take = (oc > c) | ((oc == c) & tie)
        c, d = torch.where(take, oc, c), torch.where(take, od, d)
    return d


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("layout", [1, 2], ids=["420", "422"])
def test_cdef_tie_reduction_matches_find_dirs(bd, layout):
    """The kernel's pairwise lane reduction of the 8 costs agrees on
    every lane with find_dirs_plain's first maximum on the tie case
    (and so gives the variance from the same opposite direction); the
    reduction that keeps the last maximum differs on it."""
    y, costs = _tie_costs(bd, layout)
    want, _ = cdef.find_dirs_plain(y, bd, _proj())
    lanes = _lane_reduce(costs)
    assert (lanes == want.reshape(-1, 1).long()).all()
    assert not (_lane_reduce(costs, False)[:, 0] ==
                want.reshape(-1).long()).all()


@pytest.mark.parametrize("bd,layout", [(12, 0), (8, 1), (12, 2), (10, 3)],
                         ids=["400-12", "420-8", "422-12", "444-10"])
def test_cdef_plain_matches_dav1d_tpu_on_ties(bd, layout):
    """cdef_planes_plain against dav1d_tpu's _cdef_fn on the tie case
    (each layout once: a compile of _cdef_fn each)."""
    case = kc.cdef_tie_case(bd, layout)
    args = kc.cdef_args(case, "cpu")
    planes, maps, Hy, Wy = args[:4]
    got = cdef_planes_plain(*args, _proj())
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    crops = [(Hy, Wy)] + [(Hy >> ss_ver, Wy >> ss_hor)] * (len(planes) - 1)
    ins = [p[:h, :w].numpy() for p, (h, w) in zip(planes, crops)]
    if not layout:
        ins += [np.zeros((Hy // 2, Wy // 2), np.int32)] * 2
    ref = _cdef_fn(Hy // 4, Wy // 4, layout, bd, case["damping"],
                   bool(layout))(*ins, *case["maps"])
    for g, r, (h, w) in zip(got, ref, crops):
        assert np.array_equal(g[:h, :w].numpy(), np.asarray(r))


def test_cdef_planes_device_on_cpu_launches_no_kernel():
    pj, pt, bd, _planes, dbk = frame_planes("8bit-420")[0]
    before = dict(cdef.LAUNCHES)
    cdef.cdef_planes_device([torch.from_numpy(p.copy()) for p in dbk], pt,
                            bd)
    assert cdef.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        cdef.cdef_cuda(*kc.cdef_args(kc.cdef_case_at(8, 1, 0), "cpu"))
