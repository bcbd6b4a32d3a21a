"""The CUDA kernels against their plain torch versions on the card,
bit-exact (torch.equal): deblock on the tests/test_lf_pallas.py input
recipe; the put, compound and residual kernels on the seeded cases of
dav1d_tpu_torch/ops/kernel_cases.py at bd 8/10/12, including residuals
at the full coefficient range, and residual and compound tables whose
classes end in ragged kernel blocks or split into 32-wide tiles. Marked
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


def _inputs(bd, luma, h4, w4, device):
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
    P, maps, le, li = _inputs(bd, luma, h4, w4, cuda)
    cls, L = maps[0 if vertical else 1]
    before = lf.LAUNCHES["deblock"]
    got = lf.deblock_pass_cuda(P, cls, L, le, li, bd, luma, vertical)
    assert lf.LAUNCHES["deblock"] == before + 1
    ref = lf.deblock_pass_plain(P, cls, L, le, li, bd, luma, vertical)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_wrapper_checks(cuda):
    P, maps, le, li = _inputs(8, True, 8, 8, cuda)
    cls, L = maps[0]
    with pytest.raises(TypeError):
        lf.deblock_pass_cuda(P.to(torch.int64), cls, L, le, li, 8, True,
                             True)
    with pytest.raises(ValueError):
        lf.deblock_pass_cuda(P, cls[:4], L, le, li, 8, True, True)
    with pytest.raises(ValueError):
        lf.deblock_pass_cuda(P.t(), cls, L, le, li, 8, True, True)


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
