"""The port's constant tables equal dav1d_tpu's, array for array, and its
device-side LUTs (tables_from_numpy) equal what dav1d_tpu derives from
the same tables."""
import numpy as np
import torch

from dav1d_tpu import tables as jt
from dav1d_tpu.ops.cdef import _proj_matrix
from dav1d_tpu.ops.lf_ref import calc_eih
from dav1d_tpu_torch import tables as tt
from dav1d_tpu_torch.ops.device import device_tables, tables_from_numpy

torch.set_num_threads(2)


def test_same_table_keys():
    assert sorted(jt._data().files) == sorted(tt._data().files)


def test_tables_equal():
    for k in sorted(jt._data().files):
        a, b = jt.get(k), tt.get(k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_tables_from_numpy_matches_dav1d_tpu():
    d = {k: jt.get(k) for k in jt._data().files}
    lut = tables_from_numpy(d)
    for s in range(8):
        e, i = calc_eih(s)
        assert np.array_equal(lut["lf_lut_e"][s].numpy(), e)
        assert np.array_equal(lut["lf_lut_i"][s].numpy(), i)
    assert np.array_equal(lut["cdef_proj"].numpy(),
                          _proj_matrix().astype(np.float64))
    assert np.array_equal(lut["sgr_x_by_x"].numpy(),
                          jt.get("dav1d_sgr_x_by_x").astype(np.int64))
    assert np.array_equal(lut["sgr_params"].numpy(),
                          jt.get("dav1d_sgr_params"))
    assert lut["lf_lut_e"].dtype == torch.int32
    assert lut["sgr_x_by_x"].dtype == torch.int64


def test_device_tables_are_the_port_tables():
    a = device_tables("cpu")
    b = tables_from_numpy({k: tt.get(k) for k in tt._data().files})
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_tables_from_numpy_mc_keys_match_dav1d_tpu():
    from dav1d_tpu.ops.mc import filter_banks
    from dav1d_tpu.ops.mc_fused import _wedge_lut
    d = {k: jt.get(k) for k in jt._data().files}
    lut = tables_from_numpy(d)
    assert lut["mc_filter_banks"].dtype == torch.int32
    assert np.array_equal(lut["mc_filter_banks"].numpy(),
                          np.asarray(filter_banks()))
    for c in (16, 32):
        t = lut[f"mc_wedge_lut{c}"]
        assert t.dtype == torch.int8 and t.shape == (1056, c, c)
        assert np.array_equal(t.numpy(), _wedge_lut(c))


def test_warp_filter_and_obmc_masks_match_dav1d_tpu():
    from dav1d_tpu.ops.mc_ref import _warp_filter, obmc_masks
    for lut in (device_tables("cpu"),
                tables_from_numpy({k: jt.get(k) for k in jt._data().files})):
        wf, om = lut["mc_warp_filter"], lut["mc_obmc_masks"]
        assert wf.dtype == om.dtype == torch.int32
        assert wf.shape == (193, 8) and om.shape == (64,)
        assert np.array_equal(wf.numpy(), _warp_filter())
        assert np.array_equal(om.numpy(), obmc_masks())
