"""The port's plain residual pass (ops/itx.py itx_add_plain) against
dav1d_tpu's XLA job kernels: ops/mc_jobs.py res_tx_fn for every one of
the 19 transform sizes with every valid (row kind, column kind) pair,
and res_jobs_fn for the lossless WHT. Bit-exact (tolerance 0) at bd 8
and 10, on seeded coefficients from ops/kernel_cases.py (dense small,
sparse at the decoder's full range, DC only) added into a random
plane. dav1d_tpu's programs run op by op (jax.disable_jit: the same
integer operations without XLA's compile of each size's program, most
of these tests' time).

Also the premise of the CUDA kernel's int32 arithmetic at bd 8 and 10:
ops/itx.py `residual` (the ops/itx_core.py butterflies with the rect2
scale, the row clamp, the inter-pass shift and clamp and the column
pass) gives the same residuals on int32 tensors as on int64 ones, for
every size and kind pair, on coefficients at the decoder's full range
(kernel_cases._extreme_coefs: all max, all min, alternating signs, DC
only, random signs, random values). At bd 12 it does not: with the
same recipe (27 blocks per class), 1747 of the 5211 blocks differ, in
129 of the 148 (tx, kind pair) classes (a 2^19 coefficient times a 4091
rotation constant passes 2^31), which is why the kernel keeps int64 at
bd 12."""
from functools import lru_cache

import jax
import jax.numpy as jnp
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
    ref = jnp.asarray(case["plane"])
    pool = jnp.asarray(case["pool"])
    with jax.disable_jit():
        for j in jobs:
            row = np.array([[0, tx, 0, j[3], j[4], j[5]]], np.int32)
            ref = fn(pool, jnp.asarray(row),
                     jnp.asarray(j[1:3].astype(np.int32)), ref)
    ref = np.asarray(ref)
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
    with jax.disable_jit():
        ref = np.asarray(fn(jnp.asarray(case["pool"]), jnp.asarray(rows),
                            jnp.asarray(case["plane"])))
    got = _port(case, wht, bd, wht=True)
    assert not np.array_equal(ref, case["plane"])
    assert np.array_equal(got, ref)


def _extreme_blocks(tx, bd, n=27):
    """(n, sw * sh) int64 coefficient blocks at the full range, the
    kernel_cases._extreme_coefs patterns in turn."""
    rng = np.random.default_rng(tx + 100 * bd)
    return torch.from_numpy(np.stack(
        [kc._extreme_coefs(rng, tx, bd, k) for k in range(n)]))


def _int32_mismatches(tx, bd):
    """Blocks whose int32 residual differs from the int64 one, summed
    over every kind pair of tx; and the pairs with any."""
    cf = _extreme_blocks(tx, bd)
    rk, ck = itx.res_tx_kinds(tx)
    bad, pairs = 0, 0
    for r in range(len(rk)):
        for c in range(len(ck)):
            a = itx.residual(cf.int(), tx, r, c, bd)
            b = itx.residual(cf, tx, r, c, bd)
            assert a.dtype == torch.int32 and b.dtype == torch.int64
            n = int((a.long() != b).flatten(1).any(1).sum())
            bad, pairs = bad + n, pairs + bool(n)
    return bad, pairs


@pytest.mark.parametrize("tx", range(N_TX))
@pytest.mark.parametrize("bd", [8, 10])
def test_int32_residual_equals_int64(bd, tx):
    assert _int32_mismatches(tx, bd) == (0, 0)


def test_int32_residual_overflows_at_bd12():
    # int32 products wrap here; the docstring records the counts
    bad = [_int32_mismatches(tx, 12) for tx in range(N_TX)]
    assert sum(b for b, _ in bad) > 1000
    assert sum(p for _, p in bad) > 100


def test_residual_is_the_plain_pass():
    # itx_add_plain adds exactly `residual` (int64), clipped
    case = _case(10)
    jobs = case["jobs"][case["jobs"][:, 0] == 9][:1]
    tx, r, c, py, px, off = (int(v) for v in jobs[0])
    cf = torch.from_numpy(case["pool"][off:off + int(itx.CF_LEN[tx])])
    res = itx.residual(cf[None].long(), tx, r, c, 10)[0].numpy()
    want = case["plane"].copy()
    h, w = res.shape
    want[py:py + h, px:px + w] = np.clip(want[py:py + h, px:px + w] + res,
                                         0, 1023)
    assert np.array_equal(_port(case, jobs, 10), want)


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
