"""CDEF parity: the port's cdef_planes_device (plain torch on the CPU)
against dav1d_tpu's (XLA on the CPU) on deblocked planes of small
decoded intra streams (4:2:0 at 8/10/12 bit, 4:2:2, 4:4:4,
monochrome), and its plain version against dav1d_tpu's _cdef_fn on the
CUDA kernel's seeded cases; the kernel's 64x64 tiling with a 2-pixel
apron, in plain torch. Tolerance 0: bit-exact."""
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


def test_cdef_planes_device_on_cpu_launches_no_kernel():
    pj, pt, bd, _planes, dbk = frame_planes("8bit-420")[0]
    before = dict(cdef.LAUNCHES)
    cdef.cdef_planes_device([torch.from_numpy(p.copy()) for p in dbk], pt,
                            bd)
    assert cdef.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        cdef.cdef_cuda(*kc.cdef_args(kc.cdef_case_at(8, 1, 0), "cpu"))
