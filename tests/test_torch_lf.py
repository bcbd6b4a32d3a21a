"""Deblock parity: the port's plain torch deblock (dav1d_tpu_torch.ops.lf)
against dav1d_tpu's XLA whole-plane formulation (lf._plane_fn) and its
Pallas kernel in interpret mode (lf_pallas.plane_fn), on the same
seeded inputs (the tests/test_lf_pallas.py recipe: flat-biased content,
random per-edge class and level). Tolerance 0: bit-exact.

The CUDA kernel has no CPU mode: tests/test_torch_cuda.py (marked
`cuda`) and chip_smoke.py compare it with the plain version on the
card."""
import numpy as np
import pytest
import torch

from dav1d_tpu.ops import lf as jlf
from dav1d_tpu.ops import lf_pallas
from dav1d_tpu.ops.lf_ref import calc_eih
from dav1d_tpu_torch.ops import lf
from dav1d_tpu_torch.ops.lf import deblock_planes_device

from torch_port_cases import STREAMS, deblock_tiled_plain, frame_planes

torch.set_num_threads(2)


def _inputs(bd, luma, h4, w4):
    rng = np.random.default_rng(bd * 100 + h4 + w4 + luma)
    px_max = (1 << bd) - 1
    plane = rng.integers(0, px_max + 1, (4 * h4, 4 * w4)).astype(np.int32)
    flat = rng.integers(0, px_max + 1, (h4, w4))
    sel = rng.random((h4, w4)) < 0.5
    f4 = np.repeat(np.repeat(np.where(sel, flat, -1), 4, 0), 4, 1)
    plane = np.where(f4 >= 0,
                     np.clip(f4 + rng.integers(-2, 3, plane.shape),
                             0, px_max),
                     plane).astype(np.int32)
    vmaps = (rng.integers(-1, 3, (h4, w4)).astype(np.int8),
             rng.integers(0, 64, (h4, w4)).astype(np.uint8))
    hmaps = (rng.integers(-1, 3, (h4, w4)).astype(np.int8),
             rng.integers(0, 64, (h4, w4)).astype(np.uint8))
    lut_e, lut_i = calc_eih(3)
    return plane, vmaps, hmaps, lut_e.astype(np.int32), \
        lut_i.astype(np.int32)


def _port(plane, vmaps, hmaps, lut_e, lut_i, bd, luma):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return lf.deblock_frame([(T(plane), luma, tuple(map(T, vmaps)),
                              tuple(map(T, hmaps)))], T(lut_e), T(lut_i),
                            bd)[0].numpy()


def _jax_hmaps(hmaps):
    # dav1d_tpu's _plane_fn takes the horizontal maps transposed
    return tuple(np.ascontiguousarray(a.T) for a in hmaps)


BDS = [8, 10, 12]
SHAPES = [(16, 64), (8, 8), (20, 36)]
SHAPE_IDS = ["wide", "tiny", "odd"]


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("h4,w4", SHAPES, ids=SHAPE_IDS)
def test_plain_vs_xla(bd, luma, h4, w4):
    plane, vm, hm, le, li = _inputs(bd, luma, h4, w4)
    ref = np.asarray(jlf._plane_fn(h4, w4, bd, luma)(
        plane, vm, _jax_hmaps(hm), le, li))
    got = _port(plane, vm, hm, le, li, bd, luma)
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("h4,w4", SHAPES, ids=SHAPE_IDS)
def test_plain_vs_pallas_interpret(bd, luma, h4, w4):
    plane, vm, hm, le, li = _inputs(bd, luma, h4, w4)
    ref = np.asarray(lf_pallas.plane_fn(h4, w4, bd, luma)(
        plane, vm, _jax_hmaps(hm), le, li))
    got = _port(plane, vm, hm, le, li, bd, luma)
    assert np.array_equal(got, ref)


def test_cpu_tensors_take_the_plain_version():
    plane, vm, hm, le, li = _inputs(8, True, 8, 8)
    before = dict(lf.LAUNCHES)
    _port(plane, vm, hm, le, li, 8, True)
    assert lf.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    plane, vm, hm, le, li = _inputs(8, True, 8, 8)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        lf.deblock_frame_cuda([(T(plane), True, (T(vm[0]), T(vm[1])),
                                (T(hm[0]), T(hm[1])))], T(le), T(li), 8)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_deblock_planes_matches_dav1d_tpu(name):
    """The whole-frame deblock (host map build + both passes on every
    plane) on reconstructed planes of small decoded intra streams."""
    for _pj, pt, bd, planes, dbk in frame_planes(name):
        got = deblock_planes_device(
            [torch.from_numpy(p.copy()) for p in planes], pt, bd)
        assert len(got) == len(dbk)
        for i, (g, r) in enumerate(zip(got, dbk)):
            assert np.array_equal(g.numpy(), r), f"plane {i}"
        assert any(not np.array_equal(g.numpy(), p)
                   for g, p in zip(got, planes))


# --- the CUDA kernel's tiling, checked on the CPU ------------------------

def _entry(bd, luma, h4, w4):
    plane, vm, hm, le, li = _inputs(bd, luma, h4, w4)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (T(plane), luma, tuple(map(T, vm)), tuple(map(T, hm))), T(le), \
        T(li)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("h4,w4", [(20, 36), (41, 23), (16, 16)],
                         ids=["ragged", "odd", "one-tile"])
def test_tiles_with_halo_equal_the_whole_plane(bd, luma, h4, w4):
    """csrc/deblock.cu deblocks each 64x64 tile from a crop with a halo
    of 12 pixels (zeros outside the plane); stitched, the tiles equal
    the whole-plane vertical-then-horizontal result, including tiles
    that end ragged at the plane's right and bottom."""
    ent, le, li = _entry(bd, luma, h4, w4)
    want = lf.deblock_frame_plain([ent], le, li, bd)[0]
    assert not torch.equal(want, ent[0])
    assert torch.equal(deblock_tiled_plain([ent], le, li, bd)[0], want)


def _flat_entry(bd, luma, h4, w4, seed):
    """A plane flat within F = 1 << (bd - 8) everywhere, so that most
    active edges take the widest filter, which reads the farthest taps;
    random maps."""
    rng = np.random.default_rng(seed)
    F = 1 << (bd - 8)
    base = int(rng.integers(16 * F, (1 << bd) - 16 * F))
    plane = base + rng.integers(0, F + 1, (4 * h4, 4 * w4))
    maps = [(rng.integers(-1, 3, (h4, w4)).astype(np.int8),
             rng.integers(1, 64, (h4, w4)).astype(np.uint8))
            for _ in range(2)]
    lut_e, lut_i = calc_eih(3)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (T(plane.astype(np.int32)), luma, *[tuple(map(T, m))
                                              for m in maps]), \
        T(lut_e.astype(np.int32)), T(lut_i.astype(np.int32))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
def test_halo_premise(bd, luma):
    """The halo a tile needs. Every pixel farther than k from a 64x64
    tile is replaced by noise; the tile's vertical-then-horizontal
    result must not change. A pixel at row r is written by horizontal
    edges at rows 4y in [r-5, r+6] (luma offsets -6..5), whose taps
    reach rows 4y-7 .. 4y+6, and by vertical edges of its own row alike:
    so luma needs 11 pixels on each side and chroma (offsets -2..1, taps
    -3..2) 3. Found here, on random content (the _inputs recipe) and on
    content flat enough for the widest filters: k = 11 (luma) and 3
    (chroma) are exact, 10 and 2 are not. The kernel stages a halo of 12
    for both, the next multiple of 4, which keeps its edges and 16-byte
    chunks aligned."""
    need = 11 if luma else 3
    rng = np.random.default_rng(bd + luma)
    exact = {}
    for k in (need - 1, need, 12):
        exact[k] = True
        for seed in range(2):
            for ent, le, li in (_entry(bd, luma, 40 + seed, 40),
                                _flat_entry(bd, luma, 40, 40 + seed, seed)):
                P = ent[0]
                want = lf.deblock_frame_plain([ent], le, li, bd)[0]
                for r0, c0 in ((64, 64), (64, 0), (0, 96)):
                    keep = torch.zeros(P.shape, dtype=torch.bool)
                    keep[max(r0 - k, 0):r0 + 64 + k,
                         max(c0 - k, 0):c0 + 64 + k] = True
                    noise = torch.from_numpy(rng.integers(
                        0, 1 << bd, P.shape).astype(np.int32))
                    got = lf.deblock_frame_plain(
                        [(torch.where(keep, P, noise), *ent[1:])], le, li,
                        bd)[0]
                    tile = (slice(r0, r0 + 64), slice(c0, c0 + 64))
                    exact[k] &= torch.equal(got[tile], want[tile])
    assert exact == {need - 1: False, need: True, 12: True}


def test_map_upload_is_one_buffer():
    """deblock_planes_device's maps cross to the device as one buffer:
    the unpacked views equal the per-plane maps frame_maps builds."""
    for _pj, pt, bd, planes, _dbk in frame_planes("8bit-420"):
        maps = lf.frame_maps(pt, [p.shape for p in planes])
        assert [m[:2] for m in maps] == [(0, True), (1, False), (2, False)]
        dev = lf.upload_maps(maps, torch.device("cpu"))
        ptrs = set()
        for (pi, luma, vm, hm), (dpi, dluma, dvm, dhm) in zip(maps, dev):
            assert (pi, luma) == (dpi, dluma)
            for (c, L), (dc, dL) in ((vm, dvm), (hm, dhm)):
                assert dc.dtype == torch.int8 and dL.dtype == torch.uint8
                assert np.array_equal(dc.numpy(), c)
                assert np.array_equal(dL.numpy(), L)
                assert dc.shape == (planes[pi].shape[0] // 4,
                                    planes[pi].shape[1] // 4)
                ptrs |= {dc.untyped_storage().data_ptr(),
                         dL.untyped_storage().data_ptr()}
        assert len(ptrs) == 1
