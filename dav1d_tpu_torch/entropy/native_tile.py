"""ctypes binding for the native per-tile Stage-A parser
(native/tileparse.cpp): the full decode_sb/decode_b symbol walk runs in
C++ — one FFI call per tile, msac state never crosses per symbol
(VERDICT r1 item 2). The Python parser in decode.py stays the golden
model (and the trace/generator path); this module materializes the C++
output pools into the same FramePlan the Python path produces.

Validated by the full oracle e2e suite (md5-bit-exact vs the reference
binary) running with the native path default-on.
"""
from __future__ import annotations

import ctypes as ct
import dataclasses

import numpy as np

from .. import tables
from ..bitstream.headers import (FilterMode, WarpedMotionParams,
                                 WarpedMotionType)
from ..utils import timing
from . import levels as lv
from . import native
from .intra_edge import INTRA_EDGE_TREE
from .msac import MsacDecoder

u8p = ct.POINTER(ct.c_uint8)
i8p = ct.POINTER(ct.c_int8)
u16p = ct.POINTER(ct.c_uint16)
i32p = ct.POINTER(ct.c_int32)

# block record fields (must match native/tileparse.cpp BlockField)
(BF_BX, BF_BY, BF_BS, BF_BL, BF_BP, BF_INTRA, BF_SKIP, BF_SEG_ID,
 BF_Y_MODE, BF_Y_ANGLE, BF_UV_MODE, BF_UV_ANGLE, BF_CFL0, BF_CFL1,
 BF_PAL_SZ0, BF_PAL_SZ1, BF_TX, BF_UVTX, BF_EDGE_FLAGS, BF_HAS_CHROMA,
 BF_SM_FL, BF_SM_UV_FL, BF_REF0, BF_REF1, BF_MV00, BF_MV01, BF_MV10,
 BF_MV11, BF_INTER_MODE, BF_DRL_IDX, BF_COMP_TYPE, BF_SKIP_MODE,
 BF_INTERINTRA_TYPE, BF_INTERINTRA_MODE, BF_WEDGE_IDX, BF_MASK_SIGN,
 BF_MOTION_MODE, BF_FILTER0, BF_FILTER1, BF_FILTER2D, BF_MAX_YTX,
 BF_TX_SPLIT0, BF_TX_SPLIT1, BF_COEF_START, BF_COEF_END,
 BF_LF_HAS, BF_LF0, BF_LF1, BF_LF2, BF_LF3,
 BF_WARP_VALID, BF_WMAT0, BF_WMAT1, BF_WMAT2, BF_WMAT3, BF_WMAT4,
 BF_WMAT5, BF_ALPHA, BF_BETA, BF_GAMMA, BF_DELTA, BF_WARP_TYPE,
 BF_PAL_IDX, BF_PALIDX_Y_OFF, BF_PALIDX_UV_OFF,
 BF_N_FIELDS) = range(66)

(CF_PLANE, CF_X4, CF_Y4, CF_TX, CF_TXTP, CF_EOB, CF_OFF,
 CF_N_FIELDS) = range(8)

(LR_PLANE, LR_ROW, LR_X64, LR_TYPE, LR_FV0, LR_FV1, LR_FV2,
 LR_FH0, LR_FH1, LR_FH2, LR_W0, LR_W1, LR_N_FIELDS) = range(13)

MM_WARP = 2


class _ModeCdfs(ct.Structure):
    _fields_ = [(n, u16p) for n in (
        "partition", "uv_mode", "cfl_alpha", "cfl_sign", "angle_delta",
        "filter_intra", "use_filter_intra", "seg_id", "seg_pred", "pal_sz",
        "pal_y", "pal_uv", "color_map", "txsz", "txpart", "delta_q",
        "delta_lf", "restore_switchable", "restore_wiener",
        "restore_sgrproj", "skip", "skip_mode", "intra", "intrabc",
        "y_mode", "kfym", "comp", "comp_dir", "ref", "comp_fwd_ref",
        "comp_bwd_ref", "comp_uni_ref", "comp_inter_mode", "newmv_mode",
        "globalmv_mode", "refmv_mode", "drl_bit", "interintra",
        "interintra_mode", "interintra_wedge", "wedge_comp", "wedge_idx",
        "mask_comp", "jnt_comp", "motion_mode", "obmc", "filter",
        "mv_joint")] + [
        ("mv_classes", u16p * 2), ("mv_sign", u16p * 2),
        ("mv_class0", u16p * 2), ("mv_class0_fp", u16p * 2),
        ("mv_class0_hp", u16p * 2), ("mv_classN", u16p * 2),
        ("mv_classN_fp", u16p * 2), ("mv_classN_hp", u16p * 2)]


class _TileCtx(ct.Structure):
    _fields_ = [
        ("coef", native._CoefCtx),
        ("m", _ModeCdfs),
        ("bw", ct.c_int32), ("bh", ct.c_int32),
        ("w4f", ct.c_int32), ("h4f", ct.c_int32),
        ("sb128", ct.c_int32), ("sb_shift", ct.c_int32),
        ("sb_step", ct.c_int32),
        ("key_or_intra", ct.c_int32), ("layout", ct.c_int32),
        ("col_start", ct.c_int32), ("col_end", ct.c_int32),
        ("row_start", ct.c_int32), ("row_end", ct.c_int32),
        ("hbd", ct.c_int32),
        ("seg_enabled", ct.c_int32), ("seg_update_map", ct.c_int32),
        ("seg_temporal", ct.c_int32), ("seg_preskip", ct.c_int32),
        ("seg_last_active", ct.c_int32),
        ("seg_delta_q", ct.c_int32 * 8), ("seg_ref", ct.c_int32 * 8),
        ("seg_skip", ct.c_int32 * 8), ("seg_globalmv", ct.c_int32 * 8),
        ("seg_delta_lf", (ct.c_int32 * 4) * 8),
        ("delta_q_present", ct.c_int32), ("delta_q_res_log2", ct.c_int32),
        ("delta_lf_present", ct.c_int32), ("delta_lf_multi", ct.c_int32),
        ("delta_lf_res_log2", ct.c_int32),
        ("base_qidx", ct.c_int32), ("ydc_delta", ct.c_int32),
        ("uac_delta", ct.c_int32), ("udc_delta", ct.c_int32),
        ("vac_delta", ct.c_int32), ("vdc_delta", ct.c_int32),
        ("dq_tbl", i32p),
        ("skip_mode_enabled", ct.c_int32),
        ("skip_mode_refs", ct.c_int32 * 2),
        ("switchable_comp_refs", ct.c_int32),
        ("subpel_filter_mode", ct.c_int32), ("dual_filter", ct.c_int32),
        ("txfm_mode", ct.c_int32),
        ("allow_screen_content_tools", ct.c_int32),
        ("force_integer_mv", ct.c_int32), ("hp", ct.c_int32),
        ("use_ref_frame_mvs_hdr", ct.c_int32),
        ("warp_motion", ct.c_int32),
        ("switchable_motion_mode", ct.c_int32),
        ("frame_offset", ct.c_int32), ("order_hint_n_bits", ct.c_int32),
        ("refpoc", ct.c_int32 * 7), ("svc_scale", ct.c_int32 * 7),
        ("gmv_type", ct.c_int32 * 7),
        ("gmv_matrix", (ct.c_int32 * 6) * 7),
        ("cdef_nbits", ct.c_int32),
        ("lf_level_y", ct.c_int32 * 2), ("lf_level_u", ct.c_int32),
        ("lf_level_v", ct.c_int32),
        ("lf_mode_ref_delta_enabled", ct.c_int32),
        ("lf_ref_delta", ct.c_int32 * 8), ("lf_mode_delta", ct.c_int32 * 2),
        ("rst_type", ct.c_int32 * 3), ("rst_unit_size", ct.c_int32 * 2),
        ("frame_w0", ct.c_int32), ("frame_w1", ct.c_int32),
        ("frame_h", ct.c_int32),
        ("superres_denom", ct.c_int32),
        ("seq_filter_intra", ct.c_int32), ("seq_inter_intra", ct.c_int32),
        ("seq_masked_compound", ct.c_int32),
        ("seq_jnt_comp", ct.c_int32), ("seq_order_hint", ct.c_int32),
        ("reduced_txtp_set", ct.c_int32),
        # static tables
        ("block_dimensions", i32p),
        ("txfm_dim", u8p),
        ("block_sizes", u8p),
        ("al_part_ctx", u8p),
        ("max_txfm_size_for_bs", u8p),
        ("partition_type_count", u8p),
        ("ymode_size_context", u8p),
        ("intra_mode_context", u8p),
        ("wedge_ctx_lut", u8p),
        ("filter_2d", u8p),
        ("comp_inter_pred_modes", u8p),
        ("edge_tree", i32p),
        ("tree_root", ct.c_int32 * 2),
        ("sgr_params", i32p),
        # neighbour context arrays
        ("aw", ct.c_int32),
        ("a_mode", u8p), ("l_mode", u8p),
        ("a_lcoef", u8p), ("l_lcoef", u8p),
        ("a_ccoef0", u8p), ("a_ccoef1", u8p),
        ("l_ccoef0", u8p), ("l_ccoef1", u8p),
        ("a_seg_pred", u8p), ("l_seg_pred", u8p),
        ("a_skip", u8p), ("l_skip", u8p),
        ("a_skip_mode", u8p), ("l_skip_mode", u8p),
        ("a_intra", u8p), ("l_intra", u8p),
        ("a_comp_type", u8p), ("l_comp_type", u8p),
        ("a_ref0", i8p), ("a_ref1", i8p), ("l_ref0", i8p), ("l_ref1", i8p),
        ("a_filter0", u8p), ("a_filter1", u8p),
        ("l_filter0", u8p), ("l_filter1", u8p),
        ("a_tx_intra", i8p), ("l_tx_intra", i8p),
        ("a_tx", i8p), ("l_tx", i8p),
        ("a_partition", u8p), ("l_partition", u8p),
        ("a_uvmode", u8p), ("l_uvmode", u8p),
        ("a_pal_sz", u8p), ("l_pal_sz", u8p),
        ("pal_sz_uv", u8p),
        ("al_pal", i32p),
        ("txtp_map", u8p),
        # plan grids
        ("b4_bs", u8p), ("b4_intra", u8p), ("b4_skip", u8p),
        ("b4_ymode", u8p), ("b4_uvmode", u8p), ("b4_seg", u8p),
        ("b4_filter0", u8p), ("b4_filter1", u8p),
        ("cdef_idx", i8p),
        ("n64h", ct.c_int32), ("n64w", ct.c_int32),
        ("prev_segmap", u8p),
        # refmvs frame state
        ("have_rf", ct.c_int32),
        ("r_mv", i32p), ("r_ref", i32p), ("r_bs", i32p), ("r_mf", i32p),
        ("rf_w4a", ct.c_int32),
        ("proj_mv", i32p), ("proj_ref", i32p),
        ("rf_stride8", ct.c_int32), ("rf_iw4", ct.c_int32),
        ("rf_ih4", ct.c_int32), ("rf_iw8", ct.c_int32),
        ("rf_ih8", ct.c_int32),
        ("rf_sign_bias", ct.c_int32 * 7), ("rf_pocdiff", ct.c_int32 * 7),
        ("rf_use_ref_frame_mvs", ct.c_int32),
        ("rt_col_start", ct.c_int32), ("rt_col_end", ct.c_int32),
        ("rt_row_start", ct.c_int32), ("rt_row_end", ct.c_int32),
        # outputs
        ("out_blocks", i32p),
        ("max_blocks", ct.c_int64), ("n_blocks", ct.c_int64),
        ("out_coefs", i32p),
        ("max_coefs", ct.c_int64), ("n_coefs", ct.c_int64),
        ("cf_pool", i32p),
        ("cf_cap", ct.c_int64), ("cf_used", ct.c_int64),
        ("pal_pool", i32p),
        ("pal_cap", ct.c_int64), ("pal_used", ct.c_int64),
        ("palidx_pool", u8p),
        ("palidx_cap", ct.c_int64), ("palidx_used", ct.c_int64),
        ("out_lr", i32p),
        ("max_lr", ct.c_int64), ("n_lr", ct.c_int64),
        # mutable per-tile state
        ("bx", ct.c_int32), ("by", ct.c_int32),
        ("last_qidx", ct.c_int32), ("last_delta_lf", ct.c_int32 * 4),
        ("dq_scratch", ct.c_int32 * (8 * 3 * 2)),
        ("lr_ref", (ct.c_int32 * 12) * 3),
        ("err", ct.c_int32),
        ("frame_dq", i32p),
        ("allow_intrabc", ct.c_int32),
        ("strict", ct.c_int32),
        ("txfm_mode_pad", ct.c_int32),
    ]


def _load():
    if not native.available():
        return None
    lib = native._lib
    try:
        fn = lib.tile_parse
    except AttributeError:
        return None
    fn.restype = ct.c_int64
    fn.argtypes = [ct.c_void_p]
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


# --- static tables (module-level, converted once) ---------------------------

_ST = {}


def _flatten_edge_tree():
    nodes = []

    def walk(n):
        idx = len(nodes)
        rec = [n.o, n.h[0], n.h[1], n.v[0], n.v[1],
               n.split[0], n.split[1], n.split[2], n.h4, n.v4,
               -1, -1, -1, -1]
        nodes.append(rec)
        if n.children:
            for k, c in enumerate(n.children):
                rec[10 + k] = walk(c)
        return idx

    root128 = walk(INTRA_EDGE_TREE[0])
    root64 = walk(INTRA_EDGE_TREE[1])
    return np.ascontiguousarray(np.asarray(nodes, np.int32)), root128, root64


def _static():
    if _ST:
        return _ST
    _ST["edge_tree"], _ST["root128"], _ST["root64"] = _flatten_edge_tree()
    _ST["block_sizes"] = np.ascontiguousarray(lv.block_sizes, np.uint8)
    _ST["al_part_ctx"] = np.ascontiguousarray(lv.al_part_ctx, np.uint8)
    _ST["max_txfm_size_for_bs"] = np.ascontiguousarray(
        lv.max_txfm_size_for_bs, np.uint8)
    _ST["partition_type_count"] = np.ascontiguousarray(
        lv.partition_type_count, np.uint8)
    _ST["ymode_size_context"] = np.ascontiguousarray(
        lv.ymode_size_context, np.uint8)
    _ST["intra_mode_context"] = np.ascontiguousarray(
        lv.intra_mode_context, np.uint8)
    _ST["wedge_ctx_lut"] = np.ascontiguousarray(lv.wedge_ctx_lut, np.uint8)
    _ST["filter_2d"] = np.ascontiguousarray(lv.filter_2d, np.uint8)
    _ST["comp_inter_pred_modes"] = np.ascontiguousarray(
        lv.comp_inter_pred_modes, np.uint8)
    _ST["sgr_params"] = np.ascontiguousarray(
        tables.get("dav1d_sgr_params"), np.int32)
    _ST["dq_tbl"] = np.ascontiguousarray(tables.dq_tbl(), np.int32)
    # cf pool lengths per tx
    _ST["cf_len"] = [min(lv.TXFM_INFO[t].w, 8) *
                     min(lv.TXFM_INFO[t].h, 8) * 16 for t in range(19)]
    return _ST


def _p(arr, ptr_t):
    return arr.ctypes.data_as(ptr_t)


# Block dataclass construction order (positional, for speed); guarded
# against drift at import time.
_EXPECTED_BLOCK_FIELDS = (
    "bx", "by", "bs", "bl", "bp", "intra", "skip", "seg_id", "y_mode",
    "y_angle", "uv_mode", "uv_angle", "cfl_alpha", "pal_sz", "tx", "uvtx",
    "edge_flags", "has_chroma", "sm_fl", "sm_uv_fl", "ref", "mv",
    "inter_mode", "drl_idx", "comp_type", "skip_mode", "interintra_type",
    "interintra_mode", "wedge_idx", "mask_sign", "motion_mode", "filter",
    "filter2d", "max_ytx", "tx_split", "warpmv", "coef_start", "coef_end",
    "lf_lvl", "pal", "pal_idx_y", "pal_idx_uv")


class NativeTileRun:
    """A prepared native tile parse, split in phases so independent
    tiles can run concurrently (the FFI call releases the GIL; plan
    materialization is serialized by the caller in tile order —
    reference thread_task.c runs tiles on its worker pool the same
    way, src/decode.c:2425-2509)."""

    __slots__ = ("tp", "t", "keep", "blocks_np", "coefs_np", "cf_pool",
                 "pal_pool", "palidx_pool", "lr_np", "err")

    def run(self):
        """FFI into native/tileparse.cpp — thread-safe, GIL-released."""
        with timing.phase("stage_a.tile_parse"):
            self.err = _lib.tile_parse(ct.addressof(self.t))

    def materialize(self):
        """Write back msac state, check errors, fill the FramePlan.
        Must be called in tile order (single thread)."""
        _materialize(self)


def parse_tile_native(tp) -> bool:
    """Run the native tile parser for TileParser `tp`; returns True on
    success (plan populated), False if the native path is unavailable."""
    r = prepare_tile_native(tp)
    if r is None:
        return False
    r.run()
    with timing.phase("stage_a.materialize"):
        r.materialize()
    return True


def prepare_tile_native(tp):
    """Build the native call context for one tile; returns a
    NativeTileRun or None when the native path is unavailable."""
    if _lib is None or type(tp.msac) is not MsacDecoder or tp.dbg:
        return None
    from .decode import Block
    assert tuple(f.name for f in dataclasses.fields(Block)) == \
        _EXPECTED_BLOCK_FIELDS, "Block dataclass drifted vs native binding"

    st = _static()
    f = tp.f
    fh = f.frame_hdr
    seq = f.seq_hdr
    keep = []   # keep converted arrays alive for the call
    t = _TileCtx()

    # --- CoefCtx: reuse the per-block binding's fully-populated struct
    nct = tp.coef_native
    if nct is None:
        return None
    t.coef = nct.ctx
    m = tp.msac
    t.coef.msac.buf = ct.cast(ct.c_char_p(nct._buf), ct.c_void_p)
    t.coef.msac.pos = m.pos
    t.coef.msac.end = m.end
    t.coef.msac.dif = m.dif
    t.coef.msac.rng = m.rng
    t.coef.msac.cnt = m.cnt
    t.coef.msac.allow_update = m.allow_update_cdf
    frame_dq = np.ascontiguousarray(f.dq, np.int32)
    keep.append(frame_dq)
    t.coef.dq = _p(frame_dq, i32p)
    t.frame_dq = _p(frame_dq, i32p)

    # --- mode CDFs
    cm = tp.cdf.m
    mc = t.m
    for name, _typ in _ModeCdfs._fields_[:48]:
        if name == "kfym":
            mc.kfym = _p(tp.cdf.kfym, u16p)
        elif name == "mv_joint":
            mc.mv_joint = _p(tp.cdf.mv_joint, u16p)
        else:
            mc.__setattr__(name, _p(getattr(cm, name), u16p))
    for ci in range(2):
        comp = tp.cdf.mv_comp[ci]
        mc.mv_classes[ci] = _p(comp.classes, u16p)
        mc.mv_sign[ci] = _p(comp.sign, u16p)
        mc.mv_class0[ci] = _p(comp.class0, u16p)
        mc.mv_class0_fp[ci] = _p(comp.class0_fp, u16p)
        mc.mv_class0_hp[ci] = _p(comp.class0_hp, u16p)
        mc.mv_classN[ci] = _p(comp.classN, u16p)
        mc.mv_classN_fp[ci] = _p(comp.classN_fp, u16p)
        mc.mv_classN_hp[ci] = _p(comp.classN_hp, u16p)

    # --- geometry / frame constants
    t.bw, t.bh = f.bw, f.bh
    t.w4f, t.h4f = f.w4, f.h4
    t.sb128 = int(f.sb128)
    t.sb_shift = f.sb_shift
    t.sb_step = f.sb_step
    t.key_or_intra = int(f.key_or_intra)
    t.layout = int(f.layout)
    t.col_start, t.col_end = tp.col_start, tp.col_end
    t.row_start, t.row_end = tp.row_start, tp.row_end
    t.hbd = int(seq.hbd)

    # --- frame header scalars
    sg = fh.segmentation
    t.seg_enabled = int(sg.enabled)
    t.seg_update_map = int(sg.update_map)
    t.seg_temporal = int(sg.temporal)
    t.seg_preskip = int(sg.seg_data.preskip) if sg.enabled else 0
    t.seg_last_active = int(sg.seg_data.last_active_segid) \
        if sg.enabled else 0
    for i in range(8):
        d = sg.seg_data.d[i] if sg.enabled else None
        t.seg_delta_q[i] = int(d.delta_q) if d else 0
        t.seg_ref[i] = int(d.ref) if d else -1
        t.seg_skip[i] = int(d.skip) if d else 0
        t.seg_globalmv[i] = int(d.globalmv) if d else 0
        if d:
            t.seg_delta_lf[i][0] = int(d.delta_lf_y_v)
            t.seg_delta_lf[i][1] = int(d.delta_lf_y_h)
            t.seg_delta_lf[i][2] = int(d.delta_lf_u)
            t.seg_delta_lf[i][3] = int(d.delta_lf_v)
    t.delta_q_present = int(fh.delta.q_present)
    t.delta_q_res_log2 = int(fh.delta.q_res_log2)
    t.delta_lf_present = int(fh.delta.lf_present)
    t.delta_lf_multi = int(fh.delta.lf_multi)
    t.delta_lf_res_log2 = int(fh.delta.lf_res_log2)
    t.base_qidx = int(fh.quant.yac)
    t.ydc_delta = int(fh.quant.ydc_delta)
    t.uac_delta = int(fh.quant.uac_delta)
    t.udc_delta = int(fh.quant.udc_delta)
    t.vac_delta = int(fh.quant.vac_delta)
    t.vdc_delta = int(fh.quant.vdc_delta)
    t.dq_tbl = _p(st["dq_tbl"], i32p)
    t.skip_mode_enabled = int(fh.skip_mode_enabled)
    t.skip_mode_refs[0] = int(fh.skip_mode_refs[0])
    t.skip_mode_refs[1] = int(fh.skip_mode_refs[1])
    t.switchable_comp_refs = int(fh.switchable_comp_refs)
    t.subpel_filter_mode = int(fh.subpel_filter_mode)
    t.dual_filter = int(seq.dual_filter)
    t.txfm_mode = int(fh.txfm_mode)
    t.allow_screen_content_tools = int(fh.allow_screen_content_tools)
    t.force_integer_mv = int(fh.force_integer_mv)
    t.hp = int(fh.hp)
    t.use_ref_frame_mvs_hdr = int(fh.use_ref_frame_mvs)
    t.warp_motion = int(fh.warp_motion)
    t.switchable_motion_mode = int(fh.switchable_motion_mode)
    t.frame_offset = int(fh.frame_offset)
    t.order_hint_n_bits = int(seq.order_hint_n_bits)
    for i in range(7):
        t.refpoc[i] = int(f.refpoc[i])
        t.svc_scale[i] = int(f.svc_scale[i])
        g = fh.gmv[i]
        t.gmv_type[i] = int(g.type)
        for k in range(6):
            t.gmv_matrix[i][k] = int(g.matrix[k])
    t.cdef_nbits = int(fh.cdef.n_bits)
    lf = fh.loopfilter
    t.lf_level_y[0] = int(lf.level_y[0])
    t.lf_level_y[1] = int(lf.level_y[1])
    t.lf_level_u = int(lf.level_u)
    t.lf_level_v = int(lf.level_v)
    t.lf_mode_ref_delta_enabled = int(lf.mode_ref_delta_enabled)
    mrd = lf.mode_ref_deltas
    for i in range(8):
        t.lf_ref_delta[i] = int(mrd.ref_delta[i])
    t.lf_mode_delta[0] = int(mrd.mode_delta[0])
    t.lf_mode_delta[1] = int(mrd.mode_delta[1])
    rst = fh.restoration
    for i in range(3):
        t.rst_type[i] = int(rst.type[i])
    t.rst_unit_size[0] = int(rst.unit_size[0])
    t.rst_unit_size[1] = int(rst.unit_size[1])
    t.frame_w0 = int(fh.width[0])
    t.frame_w1 = int(fh.width[1])
    t.frame_h = int(fh.height)
    t.superres_denom = int(fh.super_res_width_scale_denominator)
    t.seq_filter_intra = int(seq.filter_intra)
    t.seq_inter_intra = int(seq.inter_intra)
    t.seq_masked_compound = int(seq.masked_compound)
    t.seq_jnt_comp = int(seq.jnt_comp)
    t.seq_order_hint = int(seq.order_hint)
    t.reduced_txtp_set = int(fh.reduced_txtp_set)
    t.allow_intrabc = int(fh.allow_intrabc)
    t.strict = int(bool(getattr(f, "strict", False)))

    # --- static tables
    nst = native._static_tables()
    t.block_dimensions = _p(nst["block_dimensions"], i32p)
    t.txfm_dim = _p(nst["txfm_dim"], u8p)
    t.block_sizes = _p(st["block_sizes"], u8p)
    t.al_part_ctx = _p(st["al_part_ctx"], u8p)
    t.max_txfm_size_for_bs = _p(st["max_txfm_size_for_bs"], u8p)
    t.partition_type_count = _p(st["partition_type_count"], u8p)
    t.ymode_size_context = _p(st["ymode_size_context"], u8p)
    t.intra_mode_context = _p(st["intra_mode_context"], u8p)
    t.wedge_ctx_lut = _p(st["wedge_ctx_lut"], u8p)
    t.filter_2d = _p(st["filter_2d"], u8p)
    t.comp_inter_pred_modes = _p(st["comp_inter_pred_modes"], u8p)
    t.edge_tree = _p(st["edge_tree"], i32p)
    t.tree_root[0] = st["root128"]
    t.tree_root[1] = st["root64"]
    t.sgr_params = _p(st["sgr_params"], i32p)

    # --- neighbour context arrays (the Python-side arrays are reused so
    # state remains inspectable; the native parser resets them itself)
    a, l = tp.a, tp.l
    aw = a.mode.shape[0]
    t.aw = aw
    t.a_mode, t.l_mode = _p(a.mode, u8p), _p(l.mode, u8p)
    t.a_lcoef, t.l_lcoef = _p(a.lcoef, u8p), _p(l.lcoef, u8p)
    t.a_ccoef0, t.a_ccoef1 = _p(a.ccoef[0], u8p), _p(a.ccoef[1], u8p)
    t.l_ccoef0, t.l_ccoef1 = _p(l.ccoef[0], u8p), _p(l.ccoef[1], u8p)
    t.a_seg_pred, t.l_seg_pred = _p(a.seg_pred, u8p), _p(l.seg_pred, u8p)
    t.a_skip, t.l_skip = _p(a.skip, u8p), _p(l.skip, u8p)
    t.a_skip_mode = _p(a.skip_mode, u8p)
    t.l_skip_mode = _p(l.skip_mode, u8p)
    t.a_intra, t.l_intra = _p(a.intra, u8p), _p(l.intra, u8p)
    t.a_comp_type = _p(a.comp_type, u8p)
    t.l_comp_type = _p(l.comp_type, u8p)
    t.a_ref0, t.a_ref1 = _p(a.ref[0], i8p), _p(a.ref[1], i8p)
    t.l_ref0, t.l_ref1 = _p(l.ref[0], i8p), _p(l.ref[1], i8p)
    t.a_filter0, t.a_filter1 = _p(a.filter[0], u8p), _p(a.filter[1], u8p)
    t.l_filter0, t.l_filter1 = _p(l.filter[0], u8p), _p(l.filter[1], u8p)
    t.a_tx_intra, t.l_tx_intra = _p(a.tx_intra, i8p), _p(l.tx_intra, i8p)
    t.a_tx, t.l_tx = _p(a.tx, i8p), _p(l.tx, i8p)
    t.a_partition, t.l_partition = _p(a.partition, u8p), _p(l.partition, u8p)
    t.a_uvmode, t.l_uvmode = _p(a.uvmode, u8p), _p(l.uvmode, u8p)
    t.a_pal_sz, t.l_pal_sz = _p(a.pal_sz, u8p), _p(l.pal_sz, u8p)
    t.pal_sz_uv = _p(tp.pal_sz_uv, u8p)
    t.al_pal = _p(tp.al_pal, i32p)
    t.txtp_map = _p(tp.txtp_map, u8p)

    # --- plan grids
    plan = tp.plan
    t.b4_bs = _p(plan.b4_bs, u8p)
    t.b4_intra = _p(plan.b4_intra, u8p)
    t.b4_skip = _p(plan.b4_skip, u8p)
    t.b4_ymode = _p(plan.b4_ymode, u8p)
    t.b4_uvmode = _p(plan.b4_uvmode, u8p)
    t.b4_seg = _p(plan.b4_seg, u8p)
    t.b4_filter0 = _p(plan.b4_filter[0], u8p)
    t.b4_filter1 = _p(plan.b4_filter[1], u8p)
    t.cdef_idx = _p(plan.cdef_idx, i8p)
    t.n64h, t.n64w = plan.cdef_idx.shape
    if f.prev_segmap is not None:
        psm = np.ascontiguousarray(f.prev_segmap, np.uint8)
        keep.append(psm)
        t.prev_segmap = _p(psm, u8p)

    # --- refmvs frame state
    rt = tp.rt
    if rt is not None:
        rf = rt.rf
        t.have_rf = 1
        t.r_mv = _p(rf.r_mv, i32p)
        t.r_ref = _p(rf.r_ref, i32p)
        t.r_bs = _p(rf.r_bs, i32p)
        t.r_mf = _p(rf.r_mf, i32p)
        t.rf_w4a = rf.r_mv.shape[1]
        t.proj_mv = _p(rf.proj_mv, i32p)
        t.proj_ref = _p(rf.proj_ref, i32p)
        t.rf_stride8 = rf.stride8
        t.rf_iw4, t.rf_ih4 = rf.iw4, rf.ih4
        t.rf_iw8, t.rf_ih8 = rf.iw8, rf.ih8
        for i in range(7):
            t.rf_sign_bias[i] = int(rf.sign_bias[i])
            t.rf_pocdiff[i] = int(rf.pocdiff[i])
        t.rf_use_ref_frame_mvs = int(rf.use_ref_frame_mvs)
        t.rt_col_start, t.rt_col_end = rt.col_start, rt.col_end
        t.rt_row_start, t.rt_row_end = rt.row_start, rt.row_end

    # --- output pools
    tw4 = tp.col_end - tp.col_start
    th4 = tp.row_end - tp.row_start
    tw4p = (tw4 + f.sb_step - 1) // f.sb_step * f.sb_step
    th4p = (th4 + f.sb_step - 1) // f.sb_step * f.sb_step
    cells = tw4p * th4p
    max_blocks = cells + 64
    max_coefs = cells * 3 + 64
    cf_cap = cells * 16 * 3 + 4096
    pal_cap = max_blocks
    palidx_cap = cells * 16 * 2 + 16384
    max_lr = ((th4p >> 4) + 2) * ((tw4p >> 4) + 3) * 3 + 16

    blocks_np = np.empty((max_blocks, BF_N_FIELDS), np.int32)
    coefs_np = np.empty((max_coefs, CF_N_FIELDS), np.int32)
    cf_pool = np.zeros(cf_cap, np.int32)
    pal_pool = np.zeros((pal_cap, 3, 8), np.int32)
    palidx_pool = np.zeros(palidx_cap, np.uint8)
    lr_np = np.empty((max_lr, LR_N_FIELDS), np.int32)
    t.out_blocks = _p(blocks_np.reshape(-1), i32p)
    t.max_blocks = max_blocks
    t.out_coefs = _p(coefs_np.reshape(-1), i32p)
    t.max_coefs = max_coefs
    t.cf_pool = _p(cf_pool, i32p)
    t.cf_cap = cf_cap
    t.pal_pool = _p(pal_pool.reshape(-1), i32p)
    t.pal_cap = pal_cap
    t.palidx_pool = _p(palidx_pool, u8p)
    t.palidx_cap = palidx_cap
    t.out_lr = _p(lr_np.reshape(-1), i32p)
    t.max_lr = max_lr

    r = NativeTileRun()
    r.tp = tp
    r.t = t
    r.keep = keep
    r.blocks_np = blocks_np
    r.coefs_np = coefs_np
    r.cf_pool = cf_pool
    r.pal_pool = pal_pool
    r.palidx_pool = palidx_pool
    r.lr_np = lr_np
    r.err = None
    return r


def _materialize(run):
    tp, t = run.tp, run.t
    blocks_np, coefs_np = run.blocks_np, run.coefs_np
    cf_pool, pal_pool = run.cf_pool, run.pal_pool
    palidx_pool = run.palidx_pool
    lr_np = run.lr_np
    err = run.err
    st = _static()
    f = tp.f
    plan = tp.plan
    m = tp.msac
    # write back msac state (the Python-side parser may inspect it)
    m.pos = t.coef.msac.pos
    m.dif = t.coef.msac.dif
    m.rng = t.coef.msac.rng
    m.cnt = t.coef.msac.cnt
    if err == -2:
        raise ValueError("msac overread at end of sbrow")
    if err == -4:
        raise ValueError("4:2:2 forbidden vertical partition")
    if err == -5:
        raise ValueError("intrabc mv overlaps current superblock")
    if err == -6:
        raise ValueError("trailing bits after symbol coder")
    if err:
        raise RuntimeError(f"native tile parse failed: {err}")

    # --- materialize outputs into the FramePlan
    lazy = bool(getattr(plan, "want_lazy", False))
    if lazy:
        coef_base = plan.n_coefs_lazy
        block_base = plan.n_blocks_lazy
    else:
        coef_base = len(plan.coefs)
        block_base = len(plan.blocks)
    # stash the raw record views for native Stage-B consumers (the
    # native itx batch, intra recon, lf masks and the inter-job
    # emitter read these directly, no Python-object walk)
    tile_rec = dict(
        blocks=blocks_np[:t.n_blocks], coefs=coefs_np[:t.n_coefs],
        cf_pool=cf_pool, cf_used=int(t.cf_used), pal_pool=pal_pool,
        palidx_pool=palidx_pool,
        coef_base=coef_base, block_base=block_base,
        tile_idx=len(plan.native_tiles),
        col_start=tp.col_start, col_end=tp.col_end,
        row_start=tp.row_start, row_end=tp.row_end)
    plan.native_tiles.append(tile_rec)
    if lazy:
        # Python Block/CoefBlock objects are built on demand only
        # (leftover replay, golden fallbacks) — the hot decode path
        # consumes the dense pools directly
        plan.lazy_blocks = True
        plan.n_blocks_lazy += int(t.n_blocks)
        plan.n_coefs_lazy += int(t.n_coefs)
        timing.count("stage_a.objects", 0)
    else:
        _append_tile_objects(plan, tile_rec)

    for p, row, x64, typ, fv0, fv1, fv2, fh0, fh1, fh2, w0, w1 in \
            lr_np[:t.n_lr].tolist():
        plan.lr_units[p][row][x64] = dict(
            type=typ, filter_v=[fv0, fv1, fv2], filter_h=[fh0, fh1, fh2],
            sgr_weights=[w0, w1])


def _block_from_rec(f, tile_rec, r, coef_base):
    """Build one Block dataclass from a dense record row (list)."""
    from .decode import Block
    warpmv = None
    if r[BF_MOTION_MODE] == MM_WARP:
        warpmv = WarpedMotionParams(
            type=WarpedMotionType(r[BF_WARP_TYPE]),
            matrix=[r[BF_WMAT0], r[BF_WMAT1], r[BF_WMAT2],
                    r[BF_WMAT3], r[BF_WMAT4], r[BF_WMAT5]],
            alpha=r[BF_ALPHA], beta=r[BF_BETA], gamma=r[BF_GAMMA],
            delta=r[BF_DELTA])
    pal = None
    if r[BF_PAL_IDX] >= 0:
        prow = tile_rec["pal_pool"][r[BF_PAL_IDX]]
        pal = [prow[0], prow[1], prow[2]]
    pal_idx_y = pal_idx_uv = None
    ss_ver, ss_hor = f.ss_ver, f.ss_hor
    palidx_pool = tile_rec["palidx_pool"]
    bd = lv.block_dimensions[r[BF_BS]]
    if r[BF_PALIDX_Y_OFF] >= 0:
        bw4, bh4 = int(bd[0]), int(bd[1])
        off = r[BF_PALIDX_Y_OFF]
        pal_idx_y = palidx_pool[off:off + bh4 * 4 * bw4 * 4].reshape(
            bh4 * 4, bw4 * 4)
    if r[BF_PALIDX_UV_OFF] >= 0:
        cbw4 = (int(bd[0]) + ss_hor) >> ss_hor
        cbh4 = (int(bd[1]) + ss_ver) >> ss_ver
        off = r[BF_PALIDX_UV_OFF]
        pal_idx_uv = palidx_pool[off:off + cbh4 * 4 * cbw4 * 4].reshape(
            cbh4 * 4, cbw4 * 4)
    lf_lvl = (r[BF_LF0], r[BF_LF1], r[BF_LF2], r[BF_LF3]) \
        if r[BF_LF_HAS] else None
    return Block(
        r[BF_BX], r[BF_BY], r[BF_BS], r[BF_BL], r[BF_BP],
        r[BF_INTRA], r[BF_SKIP], r[BF_SEG_ID], r[BF_Y_MODE],
        r[BF_Y_ANGLE], r[BF_UV_MODE], r[BF_UV_ANGLE],
        (r[BF_CFL0], r[BF_CFL1]), (r[BF_PAL_SZ0], r[BF_PAL_SZ1]),
        r[BF_TX], r[BF_UVTX], r[BF_EDGE_FLAGS], bool(r[BF_HAS_CHROMA]),
        r[BF_SM_FL], r[BF_SM_UV_FL], (r[BF_REF0], r[BF_REF1]),
        ((r[BF_MV00], r[BF_MV01]), (r[BF_MV10], r[BF_MV11])),
        r[BF_INTER_MODE], r[BF_DRL_IDX], r[BF_COMP_TYPE],
        r[BF_SKIP_MODE], r[BF_INTERINTRA_TYPE], r[BF_INTERINTRA_MODE],
        r[BF_WEDGE_IDX], r[BF_MASK_SIGN], r[BF_MOTION_MODE],
        (r[BF_FILTER0], r[BF_FILTER1]), r[BF_FILTER2D], r[BF_MAX_YTX],
        (r[BF_TX_SPLIT0], r[BF_TX_SPLIT1]), warpmv,
        coef_base + r[BF_COEF_START], coef_base + r[BF_COEF_END],
        lf_lvl, pal, pal_idx_y, pal_idx_uv)


def _append_tile_objects(plan, tile_rec):
    """Build the Python Block/CoefBlock objects for one native tile
    and append them to the FramePlan (the pre-lazy materialize)."""
    from .decode import CoefBlock
    f = plan.f
    coef_base = tile_rec["coef_base"]
    coefs = plan.coefs
    # cf/res stay lazy views into the tile pools (CoefBlock properties)
    for i, (plane, x4, y4, tx, txtp, eob, _off) in \
            enumerate(tile_rec["coefs"].tolist()):
        coefs.append(CoefBlock(plane, x4, y4, tx, txtp, eob,
                               tile=tile_rec, idx=i))
    blocks = plan.blocks
    for r in tile_rec["blocks"].tolist():
        blocks.append(_block_from_rec(f, tile_rec, r, coef_base))
    timing.count("stage_a.objects",
                 len(tile_rec["coefs"]) + len(tile_rec["blocks"]))


def native_complete(plan) -> bool:
    """Whether the native tile records hold the whole frame, so a native
    Stage-B consumer may read them in place of the Python objects: a
    lazy plan, or one whose Block and CoefBlock lists hold no more than
    the records (a Python tile parse adds objects of its own)."""
    tiles = plan.native_tiles
    if not tiles:
        return False
    return plan.lazy_blocks or (
        sum(len(t["blocks"]) for t in tiles) == len(plan.blocks) and
        sum(len(t["coefs"]) for t in tiles) == len(plan.coefs))


def materialize_pending(plan):
    """Late materialization of a lazily-parsed plan: builds every
    Block/CoefBlock that the lazy fast path skipped, in decode order.
    Called by consumers that genuinely need the Python objects (golden
    fallbacks, a Python tile-parse fallback mid-frame)."""
    if not getattr(plan, "lazy_blocks", False):
        plan.want_lazy = False
        return
    for tile_rec in plan.native_tiles:
        _append_tile_objects(plan, tile_rec)
    plan.lazy_blocks = False
    plan.want_lazy = False


def materialize_block(plan, tile_rec, local_idx):
    """Build ONE Block (plus its CoefBlocks) from a lazy plan's pools.
    The block's coef range is attached as `b._cbs` (absolute
    plan.coefs indices don't exist on a lazy plan)."""
    from .decode import CoefBlock as _CB
    r = tile_rec["blocks"][local_idx].tolist()
    b = _block_from_rec(plan.f, tile_rec, r, 0)
    cbs = []
    crecs = tile_rec["coefs"]
    for i in range(r[BF_COEF_START], r[BF_COEF_END]):
        plane, x4, y4, tx, txtp, eob, _off = crecs[i].tolist()
        cbs.append(_CB(plane, x4, y4, tx, txtp, eob,
                       tile=tile_rec, idx=i))
    b.coef_start = 0
    b.coef_end = len(cbs)
    b._cbs = cbs
    timing.count("stage_a.objects", 1 + len(cbs))
    return b
