"""Stage A: tile symbol decoding → dense frame plan.

This is the host-side serial half of the decoder (SURVEY.md §7 stage A).
It walks the superblock partition tree of a tile, decoding every msac
symbol (modes, transform sizes/types, coefficients) with behavioral
parity to the reference pass-1 path (reference src/decode.c decode_sb/
decode_b, src/recon_tmpl.c decode_coefs/read_coef_blocks), and emits a
FramePlan: numpy grids of per-4x4 modes plus dequantized coefficient
blocks. The plan is exactly the tensor program input for the vectorized
TPU reconstruction (dav1d_tpu.recon).

Current coverage: intra frames (KEY/INTRA) — partition, segmentation
(spatial), skip, cdef idx, delta q/lf, intra modes incl. CFL +
filter-intra + angle deltas, tx-size tree, full coefficient decode
(2D/H/V classes, quant matrices, golomb). Inter and palette land next.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import tables
from ..bitstream.headers import (FrameType, PixelLayout, TxfmMode,
                                 PRIMARY_REF_NONE)
from . import levels as lv
from . import env
from .cdf import CdfContext
from .decode_inter import InterParserMixin
from .intra_edge import INTRA_EDGE_TREE
from .msac import MsacDecoder


def iclip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def iclip_u8(v):
    return iclip(v, 0, 255)


# cf pool span per tx (decoder rc layout caps each axis at 8*4 px;
# mirrors native_tile._static()["cf_len"])
_CF_LEN = [min(lv.TXFM_INFO[t].w, 8) * min(lv.TXFM_INFO[t].h, 8) * 16
           for t in range(19)]


class CoefBlock:
    """Stage-A coefficient record. The pure-Python parser passes
    concrete `cf` arrays; the native materializer passes the tile
    record dict + local index instead, and `cf`/`res` become lazy
    views into the tile's cf/residual pools — the per-record slice
    construction was a measurable share of Stage A at 1080p."""

    __slots__ = ("plane", "x4", "y4", "tx", "txtp", "eob",
                 "_cf", "_res", "_tile", "_idx")

    def __init__(self, plane, x4, y4, tx, txtp, eob, cf=None,
                 res=None, tile=None, idx=0):
        self.plane = plane
        self.x4 = x4
        self.y4 = y4
        self.tx = tx
        self.txtp = txtp
        self.eob = eob
        self._cf = cf
        self._res = res
        self._tile = tile
        self._idx = idx

    @property
    def cf(self):
        cf = self._cf
        if cf is None and self.eob >= 0 and self._tile is not None:
            t = self._tile
            off = int(t["coefs"][self._idx, 6])        # CF_OFF
            cf = self._cf = t["cf_pool"][off:off + _CF_LEN[self.tx]]
        return cf

    @cf.setter
    def cf(self, v):
        self._cf = v

    @property
    def res(self):
        r = self._res
        if r is None and self._tile is not None:
            ro = self._tile.get("res_off")
            if ro is not None:
                off = int(ro[self._idx])
                if off >= 0:
                    ti = lv.TXFM_INFO[self.tx]
                    h, w = ti.h * 4, ti.w * 4
                    r = self._res = self._tile["res_pool"][
                        off:off + h * w].reshape(h, w)
        return r

    @res.setter
    def res(self, v):
        self._res = v


@dataclass
class Block:
    bx: int
    by: int
    bs: int
    bl: int
    bp: int
    intra: int = 1
    skip: int = 0
    seg_id: int = 0
    y_mode: int = 0
    y_angle: int = 0
    uv_mode: int = 0
    uv_angle: int = 0
    cfl_alpha: tuple = (0, 0)
    pal_sz: tuple = (0, 0)
    tx: int = 0
    uvtx: int = 0
    edge_flags: int = 0
    has_chroma: bool = True
    # smooth-neighbor prediction flags captured at parse time from the
    # live a/l contexts (reference ipred_prepare.h sm_flag/sm_uv_flag,
    # read by recon_b_intra before the block's own ctx update)
    sm_fl: int = 0
    sm_uv_fl: int = 0
    # inter fields (filled by the inter path)
    ref: tuple = (-1, -1)
    mv: tuple = ((0, 0), (0, 0))
    inter_mode: int = 0
    drl_idx: int = 0
    comp_type: int = 0
    skip_mode: int = 0
    interintra_type: int = 0
    interintra_mode: int = 0
    wedge_idx: int = 0
    mask_sign: int = 0
    motion_mode: int = 0
    filter: tuple = (0, 0)
    filter2d: int = 0
    max_ytx: int = 0
    tx_split: tuple = (0, 0)
    warpmv: object = None
    coef_start: int = 0
    coef_end: int = 0
    lf_lvl: tuple = None      # (y_v, y_h, u, v) filter levels at parse
    pal: object = None        # [3][8] palette colours
    pal_idx_y: object = None  # (bh4*4, bw4*4) index map
    pal_idx_uv: object = None


class FrameContext:
    """Per-frame geometry + quant state (subset of Dav1dFrameContext)."""

    def __init__(self, seq_hdr, frame_hdr):
        self.seq_hdr = seq_hdr
        self.frame_hdr = frame_hdr
        self.layout = seq_hdr.layout
        self.ss_ver = 1 if seq_hdr.layout == PixelLayout.I420 else 0
        self.ss_hor = 0 if seq_hdr.layout == PixelLayout.I444 else 1
        # true 4x4 extents and the even-rounded block grid
        # (reference decode.c:3552-3555)
        self.w4 = (frame_hdr.width[0] + 3) >> 2
        self.h4 = (frame_hdr.height + 3) >> 2
        self.bw = ((frame_hdr.width[0] + 7) >> 3) << 1
        self.bh = ((frame_hdr.height + 7) >> 3) << 1
        self.sb128 = seq_hdr.sb128
        self.sb_shift = 4 + seq_hdr.sb128
        self.sb_step = 16 << seq_hdr.sb128
        self.sb128w = (self.bw + 31) >> 5
        self.sb128h = (self.bh + 31) >> 5
        self.key_or_intra = not (frame_hdr.frame_type & 1)

        # inter-frame reference state, filled by the stage-C decoder
        # (reference decode.c:3444-3489): refpoc[i] = frame_offset of
        # ref i; svc_scale nonzero when the ref is scaled (SVC)
        self.refpoc = [0] * 7
        self.svc_scale = [0] * 7
        self.svc = [((0, 0), (0, 0))] * 7    # ((xscale,xstep),(yscale,ystep))
        self.gmv_warp_allowed = [0] * 7
        self.rf = None            # RefMvsFrame for inter frames
        self.prev_segmap = None   # (bh, bw) uint8 from the primary ref

        # dequant tables per segment (reference decode.c:54-75)
        self.dq = self._init_quant_tables(frame_hdr.quant.yac)

        # quant matrices per rect-tx/plane (reference decode.c:3078-3085)
        self.qm = [[None] * 3 for _ in range(lv.N_RECT_TX_SIZES)]
        if frame_hdr.quant.qm:
            for i in range(lv.N_RECT_TX_SIZES):
                self.qm[i][0] = tables.qm(frame_hdr.quant.qm_y, 0, i)
                self.qm[i][1] = tables.qm(frame_hdr.quant.qm_u, 1, i)
                self.qm[i][2] = tables.qm(frame_hdr.quant.qm_v, 1, i)

    def _init_quant_tables(self, qidx):
        fh = self.frame_hdr
        dq_tbl = tables.dq_tbl()
        hbd = self.seq_hdr.hbd
        n_seg = 8 if fh.segmentation.enabled else 1
        dq = np.zeros((8, 3, 2), np.int32)
        for i in range(n_seg):
            yac = iclip_u8(qidx + fh.segmentation.seg_data.d[i].delta_q) \
                if fh.segmentation.enabled else qidx
            ydc = iclip_u8(yac + fh.quant.ydc_delta)
            uac = iclip_u8(yac + fh.quant.uac_delta)
            udc = iclip_u8(yac + fh.quant.udc_delta)
            vac = iclip_u8(yac + fh.quant.vac_delta)
            vdc = iclip_u8(yac + fh.quant.vdc_delta)
            dq[i, 0] = (dq_tbl[hbd][ydc][0], dq_tbl[hbd][yac][1])
            dq[i, 1] = (dq_tbl[hbd][udc][0], dq_tbl[hbd][uac][1])
            dq[i, 2] = (dq_tbl[hbd][vdc][0], dq_tbl[hbd][vac][1])
        return dq


@dataclass
class FramePlan:
    """Stage-A output: everything reconstruction needs, as dense data."""
    f: FrameContext
    blocks: list = field(default_factory=list)
    coefs: list = field(default_factory=list)
    # per-4x4 grids (filled during parse)
    b4_bs: np.ndarray = None        # block size at each 4x4
    b4_intra: np.ndarray = None
    b4_skip: np.ndarray = None
    b4_ymode: np.ndarray = None
    b4_uvmode: np.ndarray = None
    b4_seg: np.ndarray = None
    b4_filter: np.ndarray = None    # (2, bh, bw) h/v filter per 4x4
    cdef_idx: np.ndarray = None     # per 64x64
    lr_units: list = None           # [plane][y64][x64] -> unit dict
    # native Stage-A record views per tile (blocks/coefs/pools), kept so
    # native Stage-B consumers (itx, intra recon) skip the Python objects
    native_tiles: list = field(default_factory=list)
    # lazy-block mode: the hot decode path of key, intra and inter
    # frames (native Stage A -> the native intra engine or job emitter
    # -> device Stage B) never builds Python Block/CoefBlock objects;
    # consumers that need them call native_tile.materialize_pending(plan)
    # first
    want_lazy: bool = False
    lazy_blocks: bool = False
    n_blocks_lazy: int = 0
    n_coefs_lazy: int = 0

    def __post_init__(self):
        f = self.f
        self.b4_bs = np.zeros((f.bh, f.bw), np.uint8)
        self.b4_intra = np.ones((f.bh, f.bw), np.uint8)
        self.b4_skip = np.zeros((f.bh, f.bw), np.uint8)
        self.b4_ymode = np.zeros((f.bh, f.bw), np.uint8)
        self.b4_uvmode = np.zeros((f.bh, f.bw), np.uint8)
        self.b4_seg = np.zeros((f.bh, f.bw), np.uint8)
        self.b4_filter = np.full((2, f.bh, f.bw), 4, np.uint8)  # 4 = N_SWITCHABLE
        self.cdef_idx = np.full(((f.bh + 15) >> 4, (f.bw + 15) >> 4), -1,
                                np.int8)
        n64h = (f.bh + 15) >> 4
        # LR units live in post-super-res coords (>= coded width)
        n64w = ((f.frame_hdr.width[1] + 63) >> 6) + 1
        self.lr_units = [[[None] * n64w for _ in range(n64h)]
                         for _ in range(3)]


class TileParser(InterParserMixin):
    """Symbol decoder for one tile (maps to Dav1dTileState + task ctx)."""

    def __init__(self, f: FrameContext, plan: FramePlan, data: bytes,
                 tile_row: int, tile_col: int, cdf: CdfContext):
        self.f = f
        self.plan = plan
        fh = f.frame_hdr
        self.tile_row = tile_row
        self.tile_col = tile_col
        self.col_start = fh.tiling.col_start_sb[tile_col] << f.sb_shift
        self.col_end = min(fh.tiling.col_start_sb[tile_col + 1] << f.sb_shift, f.bw)
        self.row_start = fh.tiling.row_start_sb[tile_row] << f.sb_shift
        self.row_end = min(fh.tiling.row_start_sb[tile_row + 1] << f.sb_shift, f.bh)
        self.msac = MsacDecoder(data, disable_cdf_update=fh.disable_cdf_update)
        self.cdf = cdf
        self.last_qidx = fh.quant.yac
        self.last_delta_lf = [0, 0, 0, 0]
        self.dq = f.dq                       # may be swapped for sb-local
        # palette above/left state (reference internal.h:401-402, 352)
        self.al_pal = np.zeros((2, 32, 3, 8), np.int32)
        self.pal_sz_uv = np.zeros((2, 32), np.uint8)
        # position state
        self.bx = 0
        self.by = 0
        # neighbor ctx: full-width above, per-sbrow left (32/sb... use full)
        aw = (f.bw + 31) & ~31
        self.a = env.BlockContext()
        self._alloc_wide_ctx(self.a, aw)
        self.l = env.BlockContext()
        self.a.reset(f.key_or_intra)
        self.levels_buf = np.zeros(36 * 36, np.uint8)
        self.coef_native = None
        if type(self.msac) is MsacDecoder:
            from . import native
            if native.available():
                self.coef_native = native.NativeCoefTile(self)
        self.cur_sb_cdef_idx = None
        # symbol trace (mirror of the reference's DEBUG_BLOCK_INFO;
        # tools/trace_diff.py diffs this against an instrumented dav1d)
        import os as _os
        self.dbg = bool(_os.environ.get("DAV1D_TPU_TRACE"))
        # inter-frame state: refmvs tile view + per-sb luma txtp scratch
        self.rt = None
        if not f.key_or_intra or fh.allow_intrabc:
            from .refmvs import RefMvsTile
            if f.rf is not None:
                self.rt = RefMvsTile(f.rf, self.col_start, self.col_end,
                                     self.row_start, self.row_end)
        self.txtp_map = np.zeros((32, aw), np.uint8)

    @staticmethod
    def _alloc_wide_ctx(ctx: env.BlockContext, w: int) -> None:
        ctx.mode = np.zeros(w, np.uint8)
        ctx.lcoef = np.zeros(w, np.uint8)
        ctx.ccoef = np.zeros((2, w), np.uint8)
        ctx.seg_pred = np.zeros(w, np.uint8)
        ctx.skip = np.zeros(w, np.uint8)
        ctx.skip_mode = np.zeros(w, np.uint8)
        ctx.intra = np.zeros(w, np.uint8)
        ctx.comp_type = np.zeros(w, np.uint8)
        ctx.ref = np.zeros((2, w), np.int8)
        ctx.filter = np.zeros((2, w), np.uint8)
        ctx.tx_intra = np.zeros(w, np.int8)
        ctx.tx = np.zeros(w, np.int8)
        ctx.tx_lpf_y = np.zeros(w, np.uint8)
        ctx.tx_lpf_uv = np.zeros(w, np.uint8)
        ctx.partition = np.zeros(w >> 1, np.uint8)
        ctx.uvmode = np.zeros(w, np.uint8)
        ctx.pal_sz = np.zeros(w, np.uint8)

    # -- top-level ------------------------------------------------------
    def parse_tile(self) -> None:
        f = self.f
        if self.coef_native is not None:
            # full native Stage-A walk (native/tileparse.cpp): one FFI
            # call per tile; falls through to the Python golden path
            # when unavailable (trace mode, generator coders)
            from . import native_tile
            if native_tile.parse_tile_native(self):
                return
        if getattr(self.plan, "lazy_blocks", False) or \
                getattr(self.plan, "want_lazy", False):
            # mixed native/Python Stage A: the Python walk appends
            # Block objects directly, so any lazily-parsed native
            # tiles must materialize first to keep decode order
            from . import native_tile
            native_tile.materialize_pending(self.plan)
        root_bl = lv.BL_128X128 if f.sb128 else lv.BL_64X64
        root_node = INTRA_EDGE_TREE[0 if f.sb128 else 1]
        # per-tile LR prediction refs (reference decode.c:2483-2503)
        self.lr_ref = [dict(type=0, filter_v=[3, -7, 15],
                            filter_h=[3, -7, 15], sgr_weights=[-32, 31])
                       for _ in range(3)]
        for by in range(self.row_start, self.row_end, f.sb_step):
            self.by = by
            self.l.reset(f.key_or_intra)
            self.pal_sz_uv[1][:] = 0
            for bx in range(self.col_start, self.col_end, f.sb_step):
                self.bx = bx
                # cdef idx storage for this sb (reference decode.c:2649-2661)
                sb64y, sb64x = by >> 4, bx >> 4
                self.cur_sb_cdef_idx = (sb64y, sb64x)
                self._read_lr_units()
                self.decode_sb(root_bl, root_node)
            if self.msac.cnt <= -15:
                raise ValueError("msac overread at end of sbrow")
        # strict conformance: payload must end in marker-bit + zeros
        # (reference decode.c:2745-2747)
        if getattr(f, "strict", False) and type(self.msac) is MsacDecoder:
            from .msac import check_trailing_bits
            if not check_trailing_bits(self.msac):
                raise ValueError("trailing bits after symbol coder")

    # -- loop restoration units (reference decode.c:2662-2714) ----------
    def _read_lr_units(self):
        f = self.f
        fh = f.frame_hdr
        rst = fh.restoration
        for p in range(3):
            if rst.type[p] == 0:        # RESTORATION_NONE
                continue
            ss_ver = 1 if (p and f.layout == PixelLayout.I420) else 0
            ss_hor = 1 if (p and f.layout != PixelLayout.I444) else 0
            unit_size_log2 = rst.unit_size[1 if p else 0]
            y = self.by * 4 >> ss_ver
            h = (fh.height + ss_ver) >> ss_ver
            unit_size = 1 << unit_size_log2
            mask = unit_size - 1
            if y & mask:
                continue
            half_unit = unit_size >> 1
            if y and y + half_unit > h:
                continue
            if fh.width[0] != fh.width[1]:
                # super-res: units live in upscaled coords; the sb's
                # coverage maps back via the scale denominator
                # (reference decode.c:2683-2699)
                w = (fh.width[1] + ss_hor) >> ss_hor
                n_units = max(1, (w + half_unit) >> unit_size_log2)
                d = fh.super_res_width_scale_denominator
                rnd = unit_size * 8 - 1
                shift = unit_size_log2 + 3
                x0 = ((4 * self.bx * d >> ss_hor) + rnd) >> shift
                x1 = ((4 * (self.bx + f.sb_step) * d >> ss_hor) + rnd) \
                    >> shift
                for x in range(x0, min(x1, n_units)):
                    px_x = x << (unit_size_log2 + ss_hor)
                    self._read_restoration_info(p, rst.type[p],
                                                x64=px_x >> 6)
            else:
                x = 4 * self.bx >> ss_hor
                if x & mask:
                    continue
                w = (fh.width[0] + ss_hor) >> ss_hor
                if x and x + half_unit > w:
                    continue
                self._read_restoration_info(p, rst.type[p])

    def _read_restoration_info(self, p, frame_type, x64=None):
        """reference decode.c:2511-2576."""
        from .. import tables
        msac = self.msac
        cdf = self.cdf
        ref = self.lr_ref[p]
        lr = dict(type=0, filter_v=[0, 0, 0], filter_h=[0, 0, 0],
                  sgr_weights=[0, 0])
        # types: 0=NONE 1=SWITCHABLE 2=WIENER 3+=SGRPROJ+idx
        RESTORATION_WIENER, RESTORATION_SGRPROJ = 2, 3
        if frame_type == 1:             # SWITCHABLE
            flt = msac.decode_symbol_adapt(cdf.m.restore_switchable, 2)
            lr["type"] = flt + (1 if flt else 0)
        else:
            typ = msac.decode_bool_adapt(
                cdf.m.restore_wiener if frame_type == RESTORATION_WIENER
                else cdf.m.restore_sgrproj)
            lr["type"] = frame_type if typ else 0
        if lr["type"] == RESTORATION_WIENER:
            lr["filter_v"][0] = 0 if p else                 msac.decode_subexp(ref["filter_v"][0] + 5, 16, 1) - 5
            lr["filter_v"][1] =                 msac.decode_subexp(ref["filter_v"][1] + 23, 32, 2) - 23
            lr["filter_v"][2] =                 msac.decode_subexp(ref["filter_v"][2] + 17, 64, 3) - 17
            lr["filter_h"][0] = 0 if p else                 msac.decode_subexp(ref["filter_h"][0] + 5, 16, 1) - 5
            lr["filter_h"][1] =                 msac.decode_subexp(ref["filter_h"][1] + 23, 32, 2) - 23
            lr["filter_h"][2] =                 msac.decode_subexp(ref["filter_h"][2] + 17, 64, 3) - 17
            lr["sgr_weights"] = list(ref["sgr_weights"])
            self.lr_ref[p] = lr
            if self.dbg:
                print(f"Post-lr_wiener[pl={p},v[{lr['filter_v'][0]},"
                      f"{lr['filter_v'][1]},{lr['filter_v'][2]}],"
                      f"h[{lr['filter_h'][0]},{lr['filter_h'][1]},"
                      f"{lr['filter_h'][2]}]]: r={msac.rng}")
        elif lr["type"] == RESTORATION_SGRPROJ:
            idx = msac.decode_bools(4)
            sgr_params = tables.get("dav1d_sgr_params")[idx]
            lr["type"] += idx
            lr["sgr_weights"][0] = (
                msac.decode_subexp(ref["sgr_weights"][0] + 96, 128, 4) - 96
                if sgr_params[0] else 0)
            lr["sgr_weights"][1] = (
                msac.decode_subexp(ref["sgr_weights"][1] + 32, 128, 4) - 32
                if sgr_params[1] else 95)
            lr["filter_v"] = list(ref["filter_v"])
            lr["filter_h"] = list(ref["filter_h"])
            self.lr_ref[p] = lr
            if self.dbg:
                print(f"Post-lr_sgrproj[pl={p},idx={idx},"
                      f"w[{lr['sgr_weights'][0]},{lr['sgr_weights'][1]}]]:"
                      f" r={msac.rng}")
        if x64 is None:
            x64 = self.bx >> 4
        self.plan.lr_units[p][self.by >> 4][x64] = lr

    # -- partition walk -------------------------------------------------
    def decode_sb(self, bl: int, node) -> None:
        f = self.f
        hsz = 16 >> bl
        have_h_split = f.bw > self.bx + hsz
        have_v_split = f.bh > self.by + hsz

        if not have_h_split and not have_v_split:
            assert bl < lv.BL_8X8
            return self.decode_sb(bl + 1, node.children[0])

        bx8 = self.bx >> 1
        by8 = (self.by & 31) >> 1
        ctx = ((int(self.a.partition[bx8]) >> (4 - bl)) & 1) + \
            (((int(self.l.partition[by8]) >> (4 - bl)) & 1) << 1)
        pc = self.cdf.m.partition[bl][ctx]

        if have_h_split and have_v_split:
            bp = self.msac.decode_symbol_adapt(
                pc, int(lv.partition_type_count[bl]))
            if self.dbg:
                print(f"y={self.by},x={self.bx},bl={bl},ctx={ctx},bp={bp}: r={self.msac.rng}")
            if (f.layout == PixelLayout.I422 and
                    bp in (lv.PARTITION_V, lv.PARTITION_V4,
                           lv.PARTITION_T_LEFT_SPLIT, lv.PARTITION_T_RIGHT_SPLIT)):
                raise ValueError("4:2:2 forbidden vertical partition")
            b = lv.block_sizes[bl][bp]
            self._dispatch_partition(bl, bp, b, hsz, node)
        elif have_h_split:
            is_split = self.msac.decode_bool(
                env.gather_top_partition_prob(pc, bl))
            if self.dbg:
                bpd = lv.PARTITION_SPLIT if is_split else lv.PARTITION_H
                print(f"y={self.by},x={self.bx},bl={bl},ctx={ctx},"
                      f"bp={bpd}: r={self.msac.rng}")
            assert bl < lv.BL_8X8
            if is_split:
                bp = lv.PARTITION_SPLIT
                self.decode_sb(bl + 1, node.children[0])
                self.bx += hsz
                self.decode_sb(bl + 1, node.children[1])
                self.bx -= hsz
            else:
                bp = lv.PARTITION_H
                self.decode_b(bl, int(lv.block_sizes[bl][lv.PARTITION_H][0]),
                              lv.PARTITION_H, node.h[0])
        else:
            is_split = self.msac.decode_bool(
                env.gather_left_partition_prob(pc, bl))
            if f.layout == PixelLayout.I422 and not is_split:
                raise ValueError("4:2:2 forbidden vertical partition")
            if self.dbg:
                bpd = lv.PARTITION_SPLIT if is_split else lv.PARTITION_V
                print(f"y={self.by},x={self.bx},bl={bl},ctx={ctx},"
                      f"bp={bpd}: r={self.msac.rng}")
            assert bl < lv.BL_8X8
            if is_split:
                bp = lv.PARTITION_SPLIT
                self.decode_sb(bl + 1, node.children[0])
                self.by += hsz
                self.decode_sb(bl + 1, node.children[2])
                self.by -= hsz
            else:
                bp = lv.PARTITION_V
                self.decode_b(bl, int(lv.block_sizes[bl][lv.PARTITION_V][0]),
                              lv.PARTITION_V, node.v[0])

        if bp != lv.PARTITION_SPLIT or bl == lv.BL_8X8:
            # covers hsz entries in 8px units (reference decode.c:2382-2386
            # case_set_upto16(ulog2(hsz)))
            self.a.partition[bx8:bx8 + hsz] = lv.al_part_ctx[0][bl][bp]
            self.l.partition[by8:by8 + hsz] = lv.al_part_ctx[1][bl][bp]

    def _dispatch_partition(self, bl, bp, b, hsz, node) -> None:
        from .intra_edge import (EDGE_ALL_TR_AND_BL, EDGE_ALL_LEFT_HAS_BOTTOM,
                                 EDGE_ALL_TOP_HAS_RIGHT, EDGE_I444_TOP_HAS_RIGHT)
        P = lv
        if bp == P.PARTITION_NONE:
            self.decode_b(bl, int(b[0]), bp, node.o)
        elif bp == P.PARTITION_H:
            self.decode_b(bl, int(b[0]), bp, node.h[0])
            self.by += hsz
            self.decode_b(bl, int(b[0]), bp, node.h[1])
            self.by -= hsz
        elif bp == P.PARTITION_V:
            self.decode_b(bl, int(b[0]), bp, node.v[0])
            self.bx += hsz
            self.decode_b(bl, int(b[0]), bp, node.v[1])
            self.bx -= hsz
        elif bp == P.PARTITION_SPLIT:
            if bl == P.BL_8X8:
                assert hsz == 1
                self.decode_b(bl, P.BS_4x4, bp, EDGE_ALL_TR_AND_BL)
                self.bx += 1
                self.decode_b(bl, P.BS_4x4, bp, node.split[0])
                self.bx -= 1
                self.by += 1
                self.decode_b(bl, P.BS_4x4, bp, node.split[1])
                self.bx += 1
                self.decode_b(bl, P.BS_4x4, bp, node.split[2])
                self.bx -= 1
                self.by -= 1
            else:
                self.decode_sb(bl + 1, node.children[0])
                self.bx += hsz
                self.decode_sb(bl + 1, node.children[1])
                self.bx -= hsz
                self.by += hsz
                self.decode_sb(bl + 1, node.children[2])
                self.bx += hsz
                self.decode_sb(bl + 1, node.children[3])
                self.bx -= hsz
                self.by -= hsz
        elif bp == P.PARTITION_T_TOP_SPLIT:
            self.decode_b(bl, int(b[0]), bp, EDGE_ALL_TR_AND_BL)
            self.bx += hsz
            self.decode_b(bl, int(b[0]), bp, node.v[1])
            self.bx -= hsz
            self.by += hsz
            self.decode_b(bl, int(b[1]), bp, node.h[1])
            self.by -= hsz
        elif bp == P.PARTITION_T_BOTTOM_SPLIT:
            self.decode_b(bl, int(b[0]), bp, node.h[0])
            self.by += hsz
            self.decode_b(bl, int(b[1]), bp, node.v[0])
            self.bx += hsz
            self.decode_b(bl, int(b[1]), bp, 0)
            self.bx -= hsz
            self.by -= hsz
        elif bp == P.PARTITION_T_LEFT_SPLIT:
            self.decode_b(bl, int(b[0]), bp, EDGE_ALL_TR_AND_BL)
            self.by += hsz
            self.decode_b(bl, int(b[0]), bp, node.h[1])
            self.by -= hsz
            self.bx += hsz
            self.decode_b(bl, int(b[1]), bp, node.v[1])
            self.bx -= hsz
        elif bp == P.PARTITION_T_RIGHT_SPLIT:
            self.decode_b(bl, int(b[0]), bp, node.v[0])
            self.bx += hsz
            self.decode_b(bl, int(b[1]), bp, node.h[0])
            self.by += hsz
            self.decode_b(bl, int(b[1]), bp, 0)
            self.by -= hsz
            self.bx -= hsz
        elif bp == P.PARTITION_H4:
            self.decode_b(bl, int(b[0]), bp, node.h[0])
            self.by += hsz >> 1
            self.decode_b(bl, int(b[0]), bp, node.h4)
            self.by += hsz >> 1
            self.decode_b(bl, int(b[0]), bp, EDGE_ALL_LEFT_HAS_BOTTOM)
            self.by += hsz >> 1
            if self.by < self.f.bh:
                self.decode_b(bl, int(b[0]), bp, node.h[1])
            self.by -= hsz * 3 >> 1
        elif bp == P.PARTITION_V4:
            self.decode_b(bl, int(b[0]), bp, node.v[0])
            self.bx += hsz >> 1
            self.decode_b(bl, int(b[0]), bp, node.v4)
            self.bx += hsz >> 1
            self.decode_b(bl, int(b[0]), bp, EDGE_ALL_TOP_HAS_RIGHT)
            self.bx += hsz >> 1
            if self.bx < self.f.bw:
                self.decode_b(bl, int(b[0]), bp, node.v[1])
            self.bx -= hsz * 3 >> 1
        else:
            raise AssertionError(f"bad partition {bp}")

    # -- block ----------------------------------------------------------
    def decode_b(self, bl: int, bs: int, bp: int, edge_flags: int) -> None:
        f = self.f
        fh = f.frame_hdr
        msac = self.msac
        cdf = self.cdf
        b = Block(bx=self.bx, by=self.by, bs=bs, bl=bl, bp=bp,
                  edge_flags=edge_flags)
        b.coef_start = len(self.plan.coefs)   # coef range for recon
        b_dim = lv.block_dimensions[bs]
        bx4 = self.bx
        by4 = self.by & 31
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        cbx4 = bx4 >> ss_hor
        cby4 = by4 >> ss_ver
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        w4 = min(bw4, f.bw - self.bx)
        h4 = min(bh4, f.bh - self.by)
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        have_left = self.bx > self.col_start
        have_top = self.by > self.row_start
        has_chroma = (f.layout != PixelLayout.I400 and
                      (bw4 > ss_hor or self.bx & 1) and
                      (bh4 > ss_ver or self.by & 1))
        b.has_chroma = has_chroma

        seg = None
        seg_pred = 0
        if fh.segmentation.enabled:
            if not fh.segmentation.update_map:
                # inherit from the previous frame's map
                b.seg_id = self._prev_frame_segid(w4, h4)
                seg = fh.segmentation.seg_data.d[b.seg_id]
            elif fh.segmentation.seg_data.preskip:
                b.seg_id, seg_pred = self._read_seg_id(
                    bx4, by4, w4, h4, have_top, have_left, skip=False)
                if self.dbg:
                    print(f"Post-segid[preskip;{b.seg_id}]: r={msac.rng}")
                seg = fh.segmentation.seg_data.d[b.seg_id]
        else:
            b.seg_id = 0

        # skip_mode (inter only; intra frames: 0)
        b_skip_mode = 0
        if ((seg is None or (not seg.globalmv and seg.ref == -1 and not seg.skip))
                and fh.skip_mode_enabled and min(bw4, bh4) > 1):
            smctx = int(self.a.skip_mode[bx4]) + int(self.l.skip_mode[by4])
            b_skip_mode = msac.decode_bool_adapt(cdf.m.skip_mode[smctx])

        # skip
        b.skip_mode = b_skip_mode
        if b_skip_mode or (seg is not None and seg.skip):
            b.skip = 1
        else:
            sctx = int(self.a.skip[bx4]) + int(self.l.skip[by4])
            b.skip = msac.decode_bool_adapt(cdf.m.skip[sctx])
            if self.dbg:
                print(f"Post-skip[{b.skip}]: r={msac.rng}")

        # postskip segment id
        if (fh.segmentation.enabled and fh.segmentation.update_map and
                not fh.segmentation.seg_data.preskip):
            b.seg_id, seg_pred = self._read_seg_id(
                bx4, by4, w4, h4, have_top, have_left, skip=b.skip)
            if self.dbg:
                print(f"Post-segid[postskip;{b.seg_id}]: r={msac.rng}")
            seg = fh.segmentation.seg_data.d[b.seg_id]

        # cdef index
        if not b.skip:
            self._read_cdef_idx(bw4, bh4)

        # delta q / lf
        if not ((self.bx | self.by) & (31 >> (not f.sb128))):
            self._read_delta_q_lf(bs, b.skip)

        # intra/inter flag
        if b_skip_mode:
            b.intra = 0
        elif not f.key_or_intra:
            if seg is not None and (seg.ref >= 0 or seg.globalmv):
                b.intra = int(not seg.ref)
            else:
                ictx = env.get_intra_ctx(self.a, self.l, by4, bx4,
                                         have_top, have_left)
                b.intra = int(not msac.decode_bool_adapt(cdf.m.intra[ictx]))
        elif fh.allow_intrabc:
            if hasattr(msac, "force"):
                # stream generator: intrabc has no valid source in the
                # first superblock of a tile (decode.c:1340 errors out)
                ib = cdf.m.intrabc
                root = ib.base if ib.base is not None else ib
                if (self.bx < self.col_start + f.sb_step and
                        self.by < self.row_start + f.sb_step):
                    msac.force[id(root)] = 0
                else:
                    msac.force.pop(id(root), None)
            b.intra = int(not msac.decode_bool_adapt(cdf.m.intrabc))
            if self.dbg:
                print(f"Post-intrabcflag[{b.intra}]: r={msac.rng}")
        else:
            b.intra = 1

        if b.intra:
            self._decode_b_intra(b, bl, bs, bp, b_dim, bx4, by4, cbx4, cby4,
                                 bw4, bh4, w4, h4, cbw4, cbh4,
                                 have_top, have_left, has_chroma, seg,
                                 seg_pred)
            if (not f.key_or_intra or fh.allow_intrabc) and \
                    self.rt is not None:
                # splat_intraref (reference decode.c:563-576)
                from .refmvs import INVALID_MV
                self.rt.rf.splat_mv(self.bx, self.by, bw4, bh4,
                                    ((INVALID_MV, INVALID_MV), (0, 0)),
                                    (0, -1), bs, 0)
        elif f.key_or_intra:
            self._decode_b_intrabc(b, bs, b_dim, bx4, by4, bw4, bh4,
                                   has_chroma, seg_pred, edge_flags,
                                   cbx4, cby4, cbw4, cbh4, w4, h4)
        else:
            self._decode_b_inter(b, bl, bs, bp, b_dim, bx4, by4, cbx4, cby4,
                                 bw4, bh4, w4, h4, cbw4, cbh4,
                                 have_top, have_left, has_chroma, seg,
                                 seg_pred, edge_flags)

        lf = fh.loopfilter
        if lf.level_y[0] or lf.level_y[1]:
            b.lf_lvl = self._calc_lf_lvl(b, fh)
        b.coef_end = len(self.plan.coefs)
        self.plan.blocks.append(b)

    # -- palette (reference recon_tmpl.c:2172-2268, decode.c:330-444) ---
    def _read_pal_plane(self, b, pl, sz_ctx, bx4, by4):
        msac = self.msac
        f = self.f
        bpc = 8 + 2 * f.seq_hdr.hbd
        pal_sz = msac.decode_symbol_adapt(
            self.cdf.m.pal_sz[pl][sz_ctx], 6) + 2
        cache = []
        l_cache = int(self.pal_sz_uv[1][by4]) if pl else \
            int(self.l.pal_sz[by4])
        # don't reuse above palette outside SB64 boundaries; the above
        # caches are 32-entry rings indexed bx4 & 31 (reference
        # internal.h:401-404 al_pal[2][32], decode.c:125 bx4 = t->bx & 31)
        a_cache = (int(self.pal_sz_uv[0][bx4 & 31]) if pl else
                   int(self.a.pal_sz[bx4])) if (by4 & 15) else 0
        lpal = self.al_pal[1, by4, pl]
        apal = self.al_pal[0, bx4 & 31, pl]
        li = ai = 0
        while l_cache and a_cache:
            lv_, av = int(lpal[li]), int(apal[ai])
            if lv_ < av:
                if not cache or cache[-1] != lv_:
                    cache.append(lv_)
                li += 1
                l_cache -= 1
            else:
                if av == lv_:
                    li += 1
                    l_cache -= 1
                if not cache or cache[-1] != av:
                    cache.append(av)
                ai += 1
                a_cache -= 1
        while l_cache:
            v = int(lpal[li])
            if not cache or cache[-1] != v:
                cache.append(v)
            li += 1
            l_cache -= 1
        while a_cache:
            v = int(apal[ai])
            if not cache or cache[-1] != v:
                cache.append(v)
            ai += 1
            a_cache -= 1
        used_cache = []
        for v in cache:
            if len(used_cache) >= pal_sz:
                break
            if msac.decode_bool_equi():
                used_cache.append(v)
        if b.pal is None:
            b.pal = [np.zeros(8, np.int32) for _ in range(3)]
        pal = b.pal[pl]
        i = len(used_cache)
        if i < pal_sz:
            new = []
            prev = msac.decode_bools(bpc)
            new.append(prev)
            i += 1
            if i < pal_sz:
                bits = bpc - 3 + msac.decode_bools(2)
                mx = (1 << bpc) - 1
                while i < pal_sz:
                    delta = msac.decode_bools(bits)
                    prev = min(prev + delta + (0 if pl else 1), mx)
                    new.append(prev)
                    i += 1
                    if prev + (0 if pl else 1) >= mx:
                        while i < pal_sz:
                            new.append(mx)
                            i += 1
                        break
                    bits = min(bits, 1 + (mx - prev -
                                          (0 if pl else 1)).bit_length() - 1)
            # merge sorted cache + new entries
            n = m = 0
            merged = []
            for _ in range(pal_sz):
                if n < len(used_cache) and (m >= len(new) or
                                            used_cache[n] <= new[m]):
                    merged.append(used_cache[n])
                    n += 1
                else:
                    merged.append(new[m])
                    m += 1
            pal[:pal_sz] = merged
        else:
            pal[:pal_sz] = used_cache[:pal_sz]
        if self.dbg:
            print(f"Post-pal[pl={pl},sz={pal_sz}]: r={msac.rng}, " +
                  " ".join(f"{int(v):02x}" for v in pal[:pal_sz]))
        return pal_sz

    def _read_pal_uv(self, b, sz_ctx, bx4, by4):
        msac = self.msac
        pal_sz = self._read_pal_plane(b, 1, sz_ctx, bx4, by4)
        bpc = 8 + 2 * self.f.seq_hdr.hbd
        pal = b.pal[2]
        if msac.decode_bool_equi():
            bits = bpc - 4 + msac.decode_bools(2)
            prev = msac.decode_bools(bpc)
            pal[0] = prev
            mx = (1 << bpc) - 1
            for i in range(1, pal_sz):
                delta = msac.decode_bools(bits)
                if delta and msac.decode_bool_equi():
                    delta = -delta
                prev = (prev + delta) & mx
                pal[i] = prev
        else:
            for i in range(pal_sz):
                pal[i] = msac.decode_bools(bpc)
        if self.dbg:
            print(f"Post-pal[pl=2]: r={msac.rng} " +
                  " ".join(f"{int(v):02x}" for v in pal[:pal_sz]))
        return pal_sz

    def _read_pal_indices(self, pal_sz, pl, w4, h4, bw4, bh4):
        """reference decode.c:353-444 order_palette + read_pal_indices;
        returns the (bh4*4, bw4*4) unpacked index map with the
        pal_idx_finish edge replication applied."""
        msac = self.msac
        stride = bw4 * 4
        m = np.zeros((bh4 * 4, stride), np.uint8)
        m[0, 0] = msac.decode_uniform(pal_sz)
        cmap_cdf = self.cdf.m.color_map[pl][pal_sz - 2]
        W, H = w4 * 4, h4 * 4
        for i in range(1, 4 * (w4 + h4) - 1):
            first = min(i, W - 1)
            last = max(0, i - H + 1)
            for j in range(first, last - 1, -1):
                y, x = i - j, j
                have_left = x > 0
                have_top = y > 0
                order = []
                mask = 0

                def add(v):
                    nonlocal mask
                    order.append(v)
                    mask |= 1 << v
                if not have_left:
                    ctx = 0
                    add(int(m[y - 1, x]))
                elif not have_top:
                    ctx = 0
                    add(int(m[y, x - 1]))
                else:
                    l_ = int(m[y, x - 1])
                    t_ = int(m[y - 1, x])
                    tl = int(m[y - 1, x - 1])
                    same_t_l = t_ == l_
                    same_t_tl = t_ == tl
                    same_l_tl = l_ == tl
                    if same_t_l and same_t_tl and same_l_tl:
                        ctx = 4
                        add(t_)
                    elif same_t_l:
                        ctx = 3
                        add(t_)
                        add(tl)
                    elif same_t_tl or same_l_tl:
                        ctx = 2
                        add(tl)
                        add(l_ if same_t_tl else t_)
                    else:
                        ctx = 1
                        add(min(t_, l_))
                        add(max(t_, l_))
                        add(tl)
                for bit in range(8):
                    if not (mask & (1 << bit)):
                        order.append(bit)
                color_idx = msac.decode_symbol_adapt(
                    cmap_cdf[ctx], pal_sz - 1)
                m[y, x] = order[color_idx]
        # pal_idx_finish edge replication (reference pal.c:33-70)
        if W < stride:
            m[:, W:] = m[:, W - 1:W]
        if H < bh4 * 4:
            m[H:, :] = m[H - 1:H, :]
        return m

    def _copy_pal_block(self, b, bx4, by4, bw4, bh4, uv):
        """reference recon_tmpl.c:2136-2170 copy_pal_block_y/uv.
        The above cache is a 32-entry ring (bx4 & 31)."""
        planes = (1, 2) if uv else (0,)
        ax = bx4 & 31
        for pl in planes:
            self.al_pal[0, ax:min(ax + bw4, 32), pl] = b.pal[pl]
            self.al_pal[1, by4:by4 + bh4, pl] = b.pal[pl]

    # ------------------------------------------------------------------
    def _calc_lf_lvl(self, b, fh):
        """Per-block filter levels (reference lf_mask.c:404-460
        calc_lf_value + decode.c:1884-1887 ref/mode selection)."""
        lf = fh.loopfilter
        dlf = self.last_delta_lf
        segd = (fh.segmentation.seg_data.d[b.seg_id]
                if fh.segmentation.enabled else None)
        if b.intra:
            r, m = 0, 0
        else:
            is_gmv = b.inter_mode == (
                lv.GLOBALMV_GLOBALMV if b.comp_type else lv.GLOBALMV)
            r, m = b.ref[0] + 1, int(not is_gmv)
        mrd = lf.mode_ref_deltas if lf.mode_ref_delta_enabled else None
        out = []
        for i in range(4):
            base_lvl = (lf.level_y[0], lf.level_y[1],
                        lf.level_u, lf.level_v)[i]
            if i >= 2 and not base_lvl:
                out.append(0)
                continue
            lfd = dlf[i if fh.delta.lf_multi else 0]
            seg_delta = 0
            if segd is not None:
                seg_delta = (segd.delta_lf_y_v, segd.delta_lf_y_h,
                             segd.delta_lf_u, segd.delta_lf_v)[i]
            base = iclip(iclip(base_lvl + lfd, 0, 63) + seg_delta, 0, 63)
            if mrd is None:
                out.append(base)
            else:
                sh = int(base >= 32)
                delta = mrd.ref_delta[r] + (mrd.mode_delta[m] if r else 0)
                out.append(iclip(base + delta * (1 << sh), 0, 63))
        return tuple(out)

    # ------------------------------------------------------------------
    def _prev_frame_segid(self, w4, h4):
        """reference decode.c:494-512 get_prev_frame_segid."""
        prev = self.f.prev_segmap
        if prev is None:
            return 0
        blk = prev[self.by:self.by + h4, self.bx:self.bx + w4]
        return int(blk.min())

    def _read_seg_id(self, bx4, by4, w4, h4, have_top, have_left, skip):
        """reference decode.c:817-945 (temporal + spatial paths)."""
        fh = self.f.frame_hdr
        msac = self.msac
        if not skip and fh.segmentation.temporal:
            spctx = int(self.a.seg_pred[bx4]) + int(self.l.seg_pred[by4])
            seg_pred = msac.decode_bool_adapt(self.cdf.m.seg_pred[spctx])
            if seg_pred:
                return self._prev_frame_segid(w4, h4), 1
        pred_seg_id, seg_ctx = self._get_cur_frame_segid(have_top, have_left)
        if skip:
            return pred_seg_id, 0
        diff = self.msac.decode_symbol_adapt(self.cdf.m.seg_id[seg_ctx], 7)
        last_active = fh.segmentation.seg_data.last_active_segid
        seg_id = env.neg_deinterleave(diff, pred_seg_id, last_active + 1)
        if seg_id > last_active or seg_id >= 8:
            seg_id = 0
        return seg_id, 0

    def _get_cur_frame_segid(self, have_top, have_left):
        """reference env.h:439-460."""
        seg = self.plan.b4_seg
        bx, by = self.bx, self.by
        if have_left and have_top:
            l = int(seg[by, bx - 1])
            a = int(seg[by - 1, bx])
            al = int(seg[by - 1, bx - 1])
            if l == a and al == l:
                ctx = 2
            elif l == a or al == l or a == al:
                ctx = 1
            else:
                ctx = 0
            return (a if a == al else l), ctx
        if have_left:
            return int(seg[by, bx - 1]), 0
        if have_top:
            return int(seg[by - 1, bx]), 0
        return 0, 0

    def _read_cdef_idx(self, bw4, bh4):
        f = self.f
        fh = f.frame_hdr
        grid = self.plan.cdef_idx
        # 64x64 granularity; within an sb128 there are 4 slots
        y64 = self.by >> 4
        x64 = self.bx >> 4
        if grid[y64, x64] == -1:
            v = self.msac.decode_bools(fh.cdef.n_bits)
            grid[y64, x64] = v
            if bw4 > 16 and x64 + 1 < grid.shape[1]:
                grid[y64, x64 + 1] = v
            if bh4 > 16 and y64 + 1 < grid.shape[0]:
                grid[y64 + 1, x64] = v
            if bw4 == 32 and bh4 == 32 and \
                    y64 + 1 < grid.shape[0] and x64 + 1 < grid.shape[1]:
                grid[y64 + 1, x64 + 1] = v

    def _read_delta_q_lf(self, bs, skip):
        f = self.f
        fh = f.frame_hdr
        msac = self.msac
        cdf = self.cdf
        prev_qidx = self.last_qidx
        max_bs = lv.BS_128x128 if f.sb128 else lv.BS_64x64
        have_delta_q = fh.delta.q_present and (bs != max_bs or not skip)
        if have_delta_q:
            delta_q = msac.decode_symbol_adapt(cdf.m.delta_q, 3)
            if delta_q == 3:
                n_bits = 1 + msac.decode_bools(3)
                delta_q = msac.decode_bools(n_bits) + 1 + (1 << n_bits)
            if delta_q:
                if msac.decode_bool_equi():
                    delta_q = -delta_q
                delta_q *= 1 << fh.delta.q_res_log2
            self.last_qidx = iclip(self.last_qidx + delta_q, 1, 255)
            if self.dbg:
                print(f"Post-delta_q[{delta_q}->{self.last_qidx}]: r={msac.rng}")
            if fh.delta.lf_present:
                n_lfs = (4 if f.layout != PixelLayout.I400 else 2) \
                    if fh.delta.lf_multi else 1
                for i in range(n_lfs):
                    delta_lf = msac.decode_symbol_adapt(
                        cdf.m.delta_lf[i + fh.delta.lf_multi], 3)
                    if delta_lf == 3:
                        n_bits = 1 + msac.decode_bools(3)
                        delta_lf = msac.decode_bools(n_bits) + 1 + (1 << n_bits)
                    if delta_lf:
                        if msac.decode_bool_equi():
                            delta_lf = -delta_lf
                        delta_lf *= 1 << fh.delta.lf_res_log2
                    self.last_delta_lf[i] = iclip(
                        self.last_delta_lf[i] + delta_lf, -63, 63)
                    if self.dbg:
                        print(f"Post-delta_lf[{i}:{delta_lf}]: r={msac.rng}")
        if self.last_qidx == fh.quant.yac:
            self.dq = f.dq
        elif self.last_qidx != prev_qidx:
            self.dq = f._init_quant_tables(self.last_qidx)

    # ------------------------------------------------------------------
    def _decode_b_intra(self, b, bl, bs, bp, b_dim, bx4, by4, cbx4, cby4,
                        bw4, bh4, w4, h4, cbw4, cbh4, have_top, have_left,
                        has_chroma, seg, seg_pred):
        f = self.f
        fh = f.frame_hdr
        msac = self.msac
        cdf = self.cdf

        # capture smooth-neighbor flags for recon (pre-ctx-update state)
        SM = (lv.SMOOTH_PRED, lv.SMOOTH_V_PRED, lv.SMOOTH_H_PRED)

        def _sm(edge_ctx, off):
            return (512 if (edge_ctx.intra[off] and
                            edge_ctx.mode[off] in SM) else 0)

        def _sm_uv(edge_ctx, off):
            return 512 if edge_ctx.uvmode[off] in SM else 0

        b.sm_fl = _sm(self.a, bx4) | _sm(self.l, by4)
        b.sm_uv_fl = _sm_uv(self.a, cbx4) | _sm_uv(self.l, cby4)

        if not f.key_or_intra:
            ymode_cdf = cdf.m.y_mode[lv.ymode_size_context[bs]]
        else:
            ymode_cdf = cdf.kfym[lv.intra_mode_context[self.a.mode[bx4]]][
                lv.intra_mode_context[self.l.mode[by4]]]
        b.y_mode = msac.decode_symbol_adapt(ymode_cdf,
                                            lv.N_INTRA_PRED_MODES - 1)
        if self.dbg:
            print(f"Post-ymode[{b.y_mode}]: r={msac.rng}")

        if (b_dim[2] + b_dim[3] >= 2 and
                lv.VERT_PRED <= b.y_mode <= lv.VERT_LEFT_PRED):
            acdf = cdf.m.angle_delta[b.y_mode - lv.VERT_PRED]
            b.y_angle = msac.decode_symbol_adapt(acdf, 6) - 3
        else:
            b.y_angle = 0

        if has_chroma:
            lossless = fh.segmentation.lossless[b.seg_id]
            cfl_allowed = (cbw4 == 1 and cbh4 == 1) if lossless else \
                bool(lv.CFL_ALLOWED_MASK & (1 << bs))
            uvmode_cdf = cdf.m.uv_mode[int(cfl_allowed)][b.y_mode]
            b.uv_mode = msac.decode_symbol_adapt(
                uvmode_cdf, lv.N_UV_INTRA_PRED_MODES - 1 - (not cfl_allowed))
            if self.dbg:
                print(f"Post-uvmode[{b.uv_mode}]: r={msac.rng}")
            b.uv_angle = 0
            if b.uv_mode == lv.CFL_PRED:
                sign = msac.decode_symbol_adapt(cdf.m.cfl_sign, 7) + 1
                sign_u = sign * 0x56 >> 8
                sign_v = sign - sign_u * 3
                alpha_u = alpha_v = 0
                if sign_u:
                    ctx = (sign_u == 2) * 3 + sign_v
                    alpha_u = msac.decode_symbol_adapt(
                        cdf.m.cfl_alpha[ctx], 15) + 1
                    if sign_u == 1:
                        alpha_u = -alpha_u
                if sign_v:
                    ctx = (sign_v == 2) * 3 + sign_u
                    alpha_v = msac.decode_symbol_adapt(
                        cdf.m.cfl_alpha[ctx], 15) + 1
                    if sign_v == 1:
                        alpha_v = -alpha_v
                b.cfl_alpha = (alpha_u, alpha_v)
            elif (b_dim[2] + b_dim[3] >= 2 and
                  lv.VERT_PRED <= b.uv_mode <= lv.VERT_LEFT_PRED):
                acdf = cdf.m.angle_delta[b.uv_mode - lv.VERT_PRED]
                b.uv_angle = msac.decode_symbol_adapt(acdf, 6) - 3

        b.pal_sz = (0, 0)
        pal_sz0 = pal_sz1 = 0
        if (fh.allow_screen_content_tools and max(bw4, bh4) <= 16 and
                bw4 + bh4 >= 4):
            sz_ctx = int(b_dim[2]) + int(b_dim[3]) - 2
            if b.y_mode == lv.DC_PRED:
                pal_ctx = int(self.a.pal_sz[bx4] > 0) + \
                    int(self.l.pal_sz[by4] > 0)
                use_y_pal = msac.decode_bool_adapt(
                    cdf.m.pal_y[sz_ctx][pal_ctx])
                if self.dbg:
                    print(f"Post-y_pal[{use_y_pal}]: r={msac.rng}")
                if use_y_pal:
                    pal_sz0 = self._read_pal_plane(b, 0, sz_ctx, bx4, by4)
            if has_chroma and b.uv_mode == lv.DC_PRED:
                pal_ctx = int(pal_sz0 > 0)
                use_uv_pal = msac.decode_bool_adapt(cdf.m.pal_uv[pal_ctx])
                if self.dbg:
                    print(f"Post-uv_pal[{use_uv_pal}]: r={msac.rng}")
                if use_uv_pal:
                    pal_sz1 = self._read_pal_uv(b, sz_ctx, bx4, by4)
            b.pal_sz = (pal_sz0, pal_sz1)

        if (b.y_mode == lv.DC_PRED and not b.pal_sz[0] and
                max(b_dim[2], b_dim[3]) <= 3 and f.seq_hdr.filter_intra):
            is_filter = msac.decode_bool_adapt(cdf.m.use_filter_intra[bs])
            if is_filter:
                b.y_mode = lv.FILTER_PRED
                b.y_angle = msac.decode_symbol_adapt(cdf.m.filter_intra, 4)

        if b.pal_sz[0]:
            b.pal_idx_y = self._read_pal_indices(b.pal_sz[0], 0, w4, h4,
                                                 bw4, bh4)
            if self.dbg:
                print(f"Post-y-pal-indices: r={msac.rng}")
        if has_chroma and b.pal_sz[1]:
            ss_v, ss_h = f.ss_ver, f.ss_hor
            b.pal_idx_uv = self._read_pal_indices(
                b.pal_sz[1], 1, (w4 + ss_h) >> ss_h, (h4 + ss_v) >> ss_v,
                cbw4, cbh4)
            if self.dbg:
                print(f"Post-uv-pal-indices: r={msac.rng}")

        # tx size
        lossless = fh.segmentation.lossless[b.seg_id]
        if lossless:
            b.tx = b.uvtx = lv.TX_4X4
            t_dim = lv.TXFM_INFO[lv.TX_4X4]
        else:
            b.tx = int(lv.max_txfm_size_for_bs[bs][0])
            b.uvtx = int(lv.max_txfm_size_for_bs[bs][f.layout])
            t_dim = lv.TXFM_INFO[b.tx]
            if fh.txfm_mode == TxfmMode.SWITCHABLE and t_dim.max > lv.TX_4X4:
                tctx = env.get_tx_ctx(self.a, self.l, t_dim, by4, bx4)
                tx_cdf = cdf.m.txsz[t_dim.max - 1][tctx]
                depth = msac.decode_symbol_adapt(tx_cdf, min(t_dim.max, 2))
                while depth:
                    b.tx = t_dim.sub
                    t_dim = lv.TXFM_INFO[b.tx]
                    depth -= 1
            if self.dbg:
                print(f"Post-tx[{b.tx}]: r={msac.rng}")

        # coefficients (pass-1 order, reference read_coef_blocks)
        self._read_coef_blocks(b, bs, bx4, by4, cbx4, cby4, bw4, bh4,
                               w4, h4, has_chroma)

        # update contexts (reference decode.c:1240-1271)
        y_mode_nofilt = lv.DC_PRED if b.y_mode == lv.FILTER_PRED else b.y_mode
        t_dim_f = lv.TXFM_INFO[b.tx]
        a, l = self.a, self.l
        a.tx_intra[bx4:bx4 + bw4] = t_dim_f.lw
        a.tx[bx4:bx4 + bw4] = t_dim_f.lw
        a.mode[bx4:bx4 + bw4] = y_mode_nofilt
        a.pal_sz[bx4:bx4 + bw4] = b.pal_sz[0]
        self.pal_sz_uv[0][bx4 & 31:min((bx4 & 31) + bw4, 32)] = \
            b.pal_sz[1] if has_chroma else 0
        a.seg_pred[bx4:bx4 + bw4] = seg_pred
        a.skip_mode[bx4:bx4 + bw4] = 0
        a.intra[bx4:bx4 + bw4] = 1
        a.skip[bx4:bx4 + bw4] = b.skip
        l.tx_intra[by4:by4 + bh4] = t_dim_f.lh
        l.tx[by4:by4 + bh4] = t_dim_f.lh
        l.mode[by4:by4 + bh4] = y_mode_nofilt
        l.pal_sz[by4:by4 + bh4] = b.pal_sz[0]
        self.pal_sz_uv[1][by4:by4 + bh4] = \
            b.pal_sz[1] if has_chroma else 0
        l.seg_pred[by4:by4 + bh4] = seg_pred
        if b.pal_sz[0]:
            self._copy_pal_block(b, bx4, by4, bw4, bh4, uv=False)
        if b.pal_sz[1]:
            self._copy_pal_block(b, bx4, by4, bw4, bh4, uv=True)
        l.skip_mode[by4:by4 + bh4] = 0
        l.intra[by4:by4 + bh4] = 1
        l.skip[by4:by4 + bh4] = b.skip
        if not f.key_or_intra:
            a.comp_type[bx4:bx4 + bw4] = lv.COMP_INTER_NONE
            a.ref[0][bx4:bx4 + bw4] = -1
            a.ref[1][bx4:bx4 + bw4] = -1
            a.filter[0][bx4:bx4 + bw4] = lv.N_SWITCHABLE_FILTERS
            a.filter[1][bx4:bx4 + bw4] = lv.N_SWITCHABLE_FILTERS
            l.comp_type[by4:by4 + bh4] = lv.COMP_INTER_NONE
            l.ref[0][by4:by4 + bh4] = -1
            l.ref[1][by4:by4 + bh4] = -1
            l.filter[0][by4:by4 + bh4] = lv.N_SWITCHABLE_FILTERS
            l.filter[1][by4:by4 + bh4] = lv.N_SWITCHABLE_FILTERS
        if has_chroma:
            a.uvmode[cbx4:cbx4 + cbw4] = b.uv_mode
            l.uvmode[cby4:cby4 + cbh4] = b.uv_mode

        # fill plan grids
        p = self.plan
        y0, x0 = self.by, self.bx
        p.b4_bs[y0:y0 + h4, x0:x0 + w4] = bs
        p.b4_intra[y0:y0 + h4, x0:x0 + w4] = 1
        p.b4_skip[y0:y0 + h4, x0:x0 + w4] = b.skip
        p.b4_ymode[y0:y0 + h4, x0:x0 + w4] = \
            b.y_mode if b.y_mode != lv.FILTER_PRED else lv.FILTER_PRED
        p.b4_uvmode[y0:y0 + h4, x0:x0 + w4] = b.uv_mode
        p.b4_seg[y0:y0 + h4, x0:x0 + w4] = b.seg_id

    # ------------------------------------------------------------------
    def _read_coef_blocks(self, b, bs, bx4, by4, cbx4, cby4, bw4, bh4,
                          w4, h4, has_chroma):
        """Pass-1 coefficient read order (reference recon_tmpl.c:824-936)."""
        f = self.f
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        a, l = self.a, self.l

        if b.skip:
            a.lcoef[bx4:bx4 + bw4] = 0x40
            l.lcoef[by4:by4 + bh4] = 0x40
            if has_chroma:
                cbw4 = (bw4 + ss_hor) >> ss_hor
                cbh4 = (bh4 + ss_ver) >> ss_ver
                a.ccoef[0][cbx4:cbx4 + cbw4] = 0x40
                a.ccoef[1][cbx4:cbx4 + cbw4] = 0x40
                l.ccoef[0][cby4:cby4 + cbh4] = 0x40
                l.ccoef[1][cby4:cby4 + cbh4] = 0x40
            return

        cw4 = (w4 + ss_hor) >> ss_hor
        ch4 = (h4 + ss_ver) >> ss_ver
        uv_t_dim = lv.TXFM_INFO[b.uvtx]
        t_dim = lv.TXFM_INFO[b.tx]

        bx_outer, by_outer = self.bx, self.by
        for init_y in range(0, h4, 16):
            sub_h4 = min(h4, 16 + init_y)
            for init_x in range(0, w4, 16):
                sub_w4 = min(w4, init_x + 16)
                y = init_y
                self.by = by_outer + init_y
                while y < sub_h4:
                    x = init_x
                    self.bx = bx_outer + init_x
                    while x < sub_w4:
                        txtp, eob, cf, cf_ctx = self._decode_coefs(
                            a.lcoef[bx4 + x:], l.lcoef[by4 + y:],
                            b.tx, bs, b, True, 0)
                        self.plan.coefs.append(CoefBlock(
                            0, self.bx, self.by, b.tx, txtp, eob, cf))
                        if self.dbg:
                            print(f"Post-y-cf-blk[tx={b.tx},txtp={txtp},"
                                  f"eob={eob}]: r={self.msac.rng}")
                        nw = min(t_dim.w, f.bw - self.bx)
                        nh = min(t_dim.h, f.bh - self.by)
                        a.lcoef[bx4 + x:bx4 + x + nw] = cf_ctx
                        l.lcoef[by4 + y:by4 + y + nh] = cf_ctx
                        x += t_dim.w
                        self.bx += t_dim.w
                    y += t_dim.h
                    self.by += t_dim.h
                self.by = by_outer
                self.bx = bx_outer

                if not has_chroma:
                    continue
                sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                for pl in range(2):
                    y = init_y >> ss_ver
                    self.by = by_outer + init_y
                    while y < sub_ch4:
                        x = init_x >> ss_hor
                        self.bx = bx_outer + init_x
                        while x < sub_cw4:
                            txtp, eob, cf, cf_ctx = self._decode_coefs(
                                a.ccoef[pl][cbx4 + x:], l.ccoef[pl][cby4 + y:],
                                b.uvtx, bs, b, bool(b.intra), 1 + pl)
                            self.plan.coefs.append(CoefBlock(
                                1 + pl, (self.bx >> ss_hor),
                                (self.by >> ss_ver), b.uvtx, txtp, eob, cf))
                            if self.dbg:
                                print(f"Post-uv-cf-blk[pl={pl},tx={b.uvtx},"
                                      f"txtp={txtp},eob={eob}]: "
                                      f"r={self.msac.rng}")
                            ctw = min(uv_t_dim.w,
                                      (f.bw - self.bx + ss_hor) >> ss_hor)
                            cth = min(uv_t_dim.h,
                                      (f.bh - self.by + ss_ver) >> ss_ver)
                            a.ccoef[pl][cbx4 + x:cbx4 + x + ctw] = cf_ctx
                            l.ccoef[pl][cby4 + y:cby4 + y + cth] = cf_ctx
                            x += uv_t_dim.w
                            self.bx += uv_t_dim.w << ss_hor
                        y += uv_t_dim.h
                        self.by += uv_t_dim.h << ss_ver
                    self.by = by_outer
                    self.bx = bx_outer

    # ------------------------------------------------------------------
    def _decode_coefs(self, a_slice, l_slice, tx, bs, b, intra, plane,
                      ytxtp=lv.DCT_DCT):
        """reference recon_tmpl.c decode_coefs:321-737.
        Returns (txtp, eob, cf int32 array, cf_ctx byte).
        eob == -1 means all-skip (cf empty)."""
        if self.coef_native is not None and type(self.msac) is MsacDecoder:
            return self.coef_native.decode(a_slice, l_slice, tx, bs, b,
                                           intra, plane, ytxtp)
        f = self.f
        fh = f.frame_hdr
        msac = self.msac
        cdf = self.cdf
        chroma = 1 if plane else 0
        lossless = fh.segmentation.lossless[b.seg_id]
        t_dim = lv.TXFM_INFO[tx]

        sctx = env.get_skip_ctx(t_dim, bs, a_slice, l_slice, chroma,
                                f.ss_hor, f.ss_ver)
        all_skip = msac.decode_bool_adapt(cdf.coef.skip[t_dim.ctx][sctx])
        if all_skip:
            txtp = lv.WHT_WHT if lossless else lv.DCT_DCT
            return txtp, -1, None, 0x40

        # transform type
        if lossless:
            txtp = lv.WHT_WHT
        elif t_dim.max + intra >= lv.TX_64X64:
            txtp = lv.DCT_DCT
        elif chroma:
            txtp = (int(lv.txtp_from_uvmode[b.uv_mode]) if intra
                    else env.get_uv_inter_txtp(t_dim, ytxtp))
        elif not fh.segmentation.qidx[b.seg_id]:
            txtp = lv.DCT_DCT
        else:
            if intra:
                y_mode_nofilt = (int(lv.filter_mode_to_y_mode[b.y_angle])
                                 if b.y_mode == lv.FILTER_PRED else b.y_mode)
                if fh.reduced_txtp_set or t_dim.min == lv.TX_16X16:
                    idx = msac.decode_symbol_adapt(
                        cdf.m.txtp_intra2[t_dim.min][y_mode_nofilt], 4)
                    txtp = int(lv.tx_types_per_set[idx + 0])
                else:
                    idx = msac.decode_symbol_adapt(
                        cdf.m.txtp_intra1[t_dim.min][y_mode_nofilt], 6)
                    txtp = int(lv.tx_types_per_set[idx + 5])
            else:
                if fh.reduced_txtp_set or t_dim.max == lv.TX_32X32:
                    idx = msac.decode_bool_adapt(cdf.m.txtp_inter3[t_dim.min])
                    txtp = lv.DCT_DCT if idx else lv.IDTX
                elif t_dim.min == lv.TX_16X16:
                    idx = msac.decode_symbol_adapt(cdf.m.txtp_inter2, 11)
                    txtp = int(lv.tx_types_per_set[idx + 12])
                else:
                    idx = msac.decode_symbol_adapt(
                        cdf.m.txtp_inter1[t_dim.min], 15)
                    txtp = int(lv.tx_types_per_set[idx + 24])

        # eob
        slw = min(t_dim.lw, lv.TX_32X32)
        slh = min(t_dim.lh, lv.TX_32X32)
        tx2dszctx = slw + slh
        tx_class = int(lv.tx_type_class[txtp])
        is_1d = int(tx_class != lv.TX_CLASS_2D)
        eob_bin_cdfs = (cdf.coef.eob_bin_16, cdf.coef.eob_bin_32,
                        cdf.coef.eob_bin_64, cdf.coef.eob_bin_128,
                        cdf.coef.eob_bin_256, cdf.coef.eob_bin_512,
                        cdf.coef.eob_bin_1024)
        if tx2dszctx < 5:
            eob_bin_cdf = eob_bin_cdfs[tx2dszctx][chroma][is_1d]
        else:
            eob_bin_cdf = eob_bin_cdfs[tx2dszctx][chroma]
        eob = msac.decode_symbol_adapt(eob_bin_cdf, 4 + tx2dszctx)
        if eob > 1:
            eob_bin = eob - 2
            eob_hi_bit = msac.decode_bool_adapt(
                cdf.coef.eob_hi_bit[t_dim.ctx][chroma][eob_bin])
            eob = ((eob_hi_bit | 2) << eob_bin) | msac.decode_bools(eob_bin)

        eob_cdf = cdf.coef.eob_base_tok[t_dim.ctx][chroma]
        hi_cdf = cdf.coef.br_tok[min(t_dim.ctx, 3)][chroma]

        sw = min(t_dim.w, 8) * 4   # coded coef width (<=32)
        sh = min(t_dim.h, 8) * 4
        cf = np.zeros(sw * sh, np.int32)
        toks = np.zeros(sw * sh, np.int32)   # raw token values per rc

        if eob:
            lo_cdf = cdf.coef.base_tok[t_dim.ctx][chroma]
            levels_buf = self.levels_buf
            nz_rcs = []   # ascending scan order list of nonzero rc

            ctx = 1 + (eob > 2 << tx2dszctx) + (eob > 4 << tx2dszctx)
            eob_tok = msac.decode_symbol_adapt(eob_cdf[ctx], 2)
            tok = eob_tok + 1
            level_tok = tok * 0x41

            if tx_class == lv.TX_CLASS_2D:
                nonsquare_tx = tx >= lv.RTX_4X8
                ctx_offsets = lv.lo_ctx_offsets[
                    nonsquare_tx + (tx & nonsquare_tx)]
                scan = tables.scan(tx)
                stride = 4 << slh
                shift, shift2 = slh + 2, 0
                mask = (4 << slh) - 1
                levels_buf[:stride * ((4 << slw) + 2)] = 0
            elif tx_class == lv.TX_CLASS_H:
                ctx_offsets = None
                scan = None
                stride = 16
                shift, shift2 = slh + 2, 0
                mask = (4 << slh) - 1
                levels_buf[:stride * ((4 << slh) + 2)] = 0
            else:
                ctx_offsets = None
                scan = None
                stride = 16
                shift, shift2 = slw + 2, 0
                shift2 = slh + 2
                mask = (4 << slw) - 1
                levels_buf[:stride * ((4 << slw) + 2)] = 0

            def rc_xy(i):
                if tx_class == lv.TX_CLASS_2D:
                    rc_ = int(scan[i])
                    return rc_, rc_ >> shift, rc_ & mask
                if tx_class == lv.TX_CLASS_H:
                    return i, i & mask, i >> shift
                x_ = i & mask
                y_ = i >> shift
                return (x_ << shift2) | y_, x_, y_

            rc, x, y = rc_xy(eob)
            if eob_tok == 2:
                hctx = 14 if ((x | y) > 1 if tx_class == lv.TX_CLASS_2D
                              else y != 0) else 7
                tok = msac.decode_hi_tok(hi_cdf[hctx])
                level_tok = tok + (3 << 6)
            toks[rc] = tok
            nz_rcs.append(rc)
            pos = rc if tx_class == lv.TX_CLASS_2D else x * stride + y
            levels_buf[pos] = level_tok & 0xFF

            for i in range(eob - 1, 0, -1):
                rc_i, x, y = rc_xy(i)
                pos = rc_i if tx_class == lv.TX_CLASS_2D else x * stride + y
                ctx, mag = env.get_lo_ctx(levels_buf, tx_class, ctx_offsets,
                                          x, y, stride, pos)
                if tx_class == lv.TX_CLASS_2D:
                    y |= x
                tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
                if tok == 3:
                    mag &= 63
                    hctx = (14 if y > (tx_class == lv.TX_CLASS_2D) else 7) + \
                        (6 if mag > 12 else (mag + 1) >> 1)
                    tok = msac.decode_hi_tok(hi_cdf[hctx])
                    levels_buf[pos] = (tok + (3 << 6)) & 0xFF
                    toks[rc_i] = tok
                    nz_rcs.append(rc_i)
                else:
                    levels_buf[pos] = tok * 0x41
                    if tok:
                        toks[rc_i] = tok
                        nz_rcs.append(rc_i)

            # dc
            if tx_class == lv.TX_CLASS_2D:
                ctx = 0
                mag = 0
            else:
                ctx, mag = env.get_lo_ctx(levels_buf, tx_class, ctx_offsets,
                                          0, 0, stride, 0)
            dc_tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
            if dc_tok == 3:
                if tx_class == lv.TX_CLASS_2D:
                    mag = int(levels_buf[1]) + int(levels_buf[stride]) + \
                        int(levels_buf[stride + 1])
                mag &= 63
                ctx = 6 if mag > 12 else (mag + 1) >> 1
                dc_tok = msac.decode_hi_tok(hi_cdf[ctx])
            nz_rcs.reverse()   # ascending scan order for the sign pass
        else:
            tok_br = msac.decode_symbol_adapt(eob_cdf[0], 2)
            dc_tok = 1 + tok_br
            if tok_br == 2:
                dc_tok = msac.decode_hi_tok(hi_cdf[0])
            nz_rcs = []

        # residual / sign pass
        dq_tbl = self.dq[b.seg_id][plane]
        qm_tbl = self.f.qm[tx][plane] if txtp < lv.IDTX else None
        dq_shift = max(0, t_dim.ctx - 2)
        # cf_max = ~(~127U << (8bpc ? 8 : bpc)): 0x7FFF / 0x1FFFF / 0x7FFFF
        bitdepth = 8 + 2 * f.seq_hdr.hbd if f.seq_hdr.hbd < 2 else 12
        cf_max = (1 << (7 + (8 if bitdepth == 8 else bitdepth))) - 1

        cul_level = 0
        if not dc_tok:
            dc_sign_level = 1 << 6
        else:
            dc_sign_ctx = env.get_dc_sign_ctx(tx, a_slice, l_slice)
            dc_sign = msac.decode_bool_adapt(
                cdf.coef.dc_sign[chroma][dc_sign_ctx])
            dc_sign_level = (dc_sign - 1) & (2 << 6)
            dc_dq = int(dq_tbl[0])
            if qm_tbl is not None:
                dc_dq = (dc_dq * int(qm_tbl[0]) + 16) >> 5
            if dc_tok == 15:
                dc_tok = (self._read_golomb() + 15) & 0xFFFFF
                dc_dq = (dc_dq * dc_tok) & 0xFFFFFF
            else:
                dc_dq *= dc_tok
            cul_level = dc_tok
            dc_dq >>= dq_shift
            dc_dq = min(dc_dq, cf_max + dc_sign)
            cf[0] = -dc_dq if dc_sign else dc_dq

        ac_dq = int(dq_tbl[1])
        for rc in nz_rcs:
            sign = msac.decode_bool_equi()
            tok = int(toks[rc])
            dq = (ac_dq * int(qm_tbl[rc]) + 16) >> 5 if qm_tbl is not None \
                else ac_dq
            if tok == 15:
                tok = (self._read_golomb() + 15) & 0xFFFFF
                dq = (dq * tok) & 0xFFFFFF
            else:
                dq = dq * tok
            cul_level += tok
            dq >>= dq_shift
            dq = min(dq, cf_max + sign)
            cf[rc] = -dq if sign else dq

        cf_ctx = min(cul_level, 63) | dc_sign_level
        return txtp, eob, cf, cf_ctx

    def _read_golomb(self):
        msac = self.msac
        length = 0
        val = 1
        while not msac.decode_bool_equi() and length < 32:
            length += 1
        while length:
            val = (val << 1) + msac.decode_bool_equi()
            length -= 1
        return val - 1


def parse_frame(seq_hdr, frame_hdr, tile_data: list) -> tuple:
    """Parse all tiles of a frame; returns (FramePlan, out_cdf or None).

    tile_data: list of (tile_row, tile_col, bytes) — one entry per tile,
    in tile order. CDF handoff between tiles matches the reference: each
    tile starts from the frame's input CDF copy; the tiling.update tile's
    adapted state feeds refresh_context.
    """
    f = FrameContext(seq_hdr, frame_hdr)
    plan = FramePlan(f)
    in_cdf = CdfContext.default(frame_hdr.quant.yac) \
        if frame_hdr.primary_ref_frame == PRIMARY_REF_NONE else None
    if in_cdf is None:
        raise NotImplementedError("primary-ref CDF inheritance (stage C)")
    out_cdf = None
    for (tile_row, tile_col, data) in tile_data:
        cdf = in_cdf.copy()
        tp = TileParser(f, plan, data, tile_row, tile_col, cdf)
        tp.parse_tile()
        tile_idx = tile_row * frame_hdr.tiling.cols + tile_col
        if frame_hdr.refresh_context and tile_idx == frame_hdr.tiling.update:
            out_cdf = in_cdf.copy()
            out_cdf.update_from(cdf, key_or_intra=f.key_or_intra)
    return plan, out_cdf
