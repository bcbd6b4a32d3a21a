"""The port's plain residual pass (ops/itx.py itx_add_plain) against
dav1d_tpu's XLA job kernels: ops/mc_jobs.py res_tx_fn for every one of
the 19 transform sizes with every valid (row kind, column kind) pair,
and res_jobs_fn for the lossless WHT. Bit-exact (tolerance 0) at bd 8
and 10, on seeded coefficients from ops/kernel_cases.py (dense small,
sparse at the decoder's full range, DC only) added into a random
plane."""
from functools import lru_cache

import numpy as np
import pytest
import torch

from dav1d_tpu.entropy import levels as jlv
from dav1d_tpu.ops import mc_fused as jfused
from dav1d_tpu.ops import mc_jobs
from dav1d_tpu_torch.ops import itx
from dav1d_tpu_torch.ops import kernel_cases as kc

torch.set_num_threads(2)
N_TX = 19


@lru_cache(maxsize=None)
def _case(bd):
    return kc.itx_case(bd, seed=bd)


def _port(case, jobs, bd, wht=False):
    plane = torch.from_numpy(case["plane"].copy())
    itx.itx_add(torch.from_numpy(case["pool"]), torch.from_numpy(jobs),
                plane, bd, wht=wht)
    return plane.numpy()


def test_kind_maps_match_dav1d_tpu():
    for tx in range(N_TX):
        assert itx.res_tx_kinds(tx) == mc_jobs.res_tx_kinds(tx)
    assert np.array_equal(itx._txtp_kidx_map(), jfused._txtp_kidx_map())


@pytest.mark.parametrize("tx", range(N_TX))
@pytest.mark.parametrize("bd", [8, 10])
def test_itx_plain_vs_res_tx_fn(bd, tx):
    case = _case(bd)
    jobs = case["jobs"][case["jobs"][:, 0] == tx]
    rk, ck = itx.res_tx_kinds(tx)
    assert len(jobs) == len(rk) * len(ck)
    fn = mc_jobs.res_tx_fn(1, tx, bd)
    ref = case["plane"].copy()
    for j in jobs:
        row = np.array([[0, tx, 0, j[3], j[4], j[5]]], np.int32)
        ref = np.asarray(fn(case["pool"], row, j[1:3].astype(np.int32),
                            ref))
    got = _port(case, jobs, bd)
    assert not np.array_equal(ref, case["plane"])
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("bd", [8, 10])
def test_wht_plain_vs_res_jobs_fn(bd):
    case = _case(bd)
    wht = case["wht"]
    rows = wht.copy()
    rows[:, 1], rows[:, 2] = 0, jlv.WHT_WHT
    fn = mc_jobs.res_jobs_fn(len(wht), 0, jlv.WHT_WHT, bd)
    ref = np.asarray(fn(case["pool"], rows, case["plane"].copy()))
    got = _port(case, wht, bd, wht=True)
    assert not np.array_equal(ref, case["plane"])
    assert np.array_equal(got, ref)


def test_job_rows_from_emitter_rows():
    # emitter RES rows [plane, tx, txtp, py, px, off, tile] + pool bases
    res = np.array([[0, 3, 0, 8, 16, 5, 0], [1, 0, jlv.WHT_WHT, 4, 4, 9, 1],
                    [2, 12, 9, 0, 64, 0, 1]], np.int32)
    cfoff = np.array([5, 109, 100], np.int64)
    rows, is_wht = itx.job_rows(res, cfoff)
    kmap = jfused._txtp_kidx_map()
    assert rows.dtype == np.int32
    assert is_wht.tolist() == [False, True, False]
    for r, e, off in zip(rows, res, cfoff):
        assert r.tolist() == [e[1], *kmap[e[1], e[2]], e[3], e[4], off]
