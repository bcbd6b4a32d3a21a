"""Keyframe / intra-frame reconstruction: the native host engine
(native/intrarec.cpp), one C++ call per tile straight off the native
Stage-A records; a frame the engine cannot serve (forced off by
DAV1D_TPU_INTRA=numpy, no native Stage-A records, exotic plane views)
falls back to the golden walk of recon/intra_ref.py, as in dav1d_tpu."""
from __future__ import annotations

from ..entropy import native_tile
from ..ops import itx_ref
from . import intra_native
from .intra_ref import IntraReconstructor


def reconstruct_intra_frame(plan, pool=None):
    """The reconstructed host Picture of an intra frame's plan; the
    native engine's tile calls run on `pool` when given. The golden
    walk reads the Python Block and CoefBlock objects, which a
    lazy plan builds here first."""
    pic = intra_native.reconstruct_intra_frame_native(plan, pool)
    if pic is not None:
        return pic
    native_tile.materialize_pending(plan)
    r = IntraReconstructor(plan)
    itx_ref.precompute_residuals_plan(plan, r.bitdepth)
    return r.run()
