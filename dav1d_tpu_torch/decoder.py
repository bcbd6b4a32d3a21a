"""Stage C: OBU stream → frames, with the 8-slot reference state machine.

Mirrors the reference's dav1d_parse_obus / dav1d_submit_frame control
flow (reference obu.c:1169-1695, decode.c:3327-3712): ref-slot pictures
+ headers + CDFs + temporal MVs + segmaps, primary-ref CDF inheritance,
refresh_frame_flags, refmvs frame init, and show_existing_frame.

PyTorch port of dav1d_tpu's decoder.py: key and intra frames
reconstruct on the host (native engine), inter frames run Stage B on
the settings' device (recon/inter_device.py), intrabc frames on the
host (recon/inter_ref.py), and every frame runs the in-loop filter
chain (super-res among it) and film grain there, with that device made
current (device_scope). With a sharding mesh (Settings.sharding_mesh, a
parallel/sharded.py Mesh) inter Stage B and the filter chain run
column-sharded over its shards (recon/sharded_stageb.py).

Under DAV1D_TPU_BACKEND=numpy, ref or off (ops/device.device_enabled,
read once when the decoder is built) every frame takes the golden host
route instead, as dav1d_tpu's does under the same switch: the host
golden models of every stage, no device, no mesh, no tensor.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

from .bitstream.getbits import GetBits
from .bitstream import obu as obu_mod
from .bitstream.headers import FrameHeader, ObuType, PRIMARY_REF_NONE
from .entropy.cdf import CdfContext
from .entropy.decode import FrameContext, FramePlan, TileParser
from .entropy import warpmv as wmv
from .bitstream.headers import WarpedMotionType
from .utils import timing


# Stage-B frames in flight on the device route. chip_smoke.py `pipeline`
# on one NVIDIA H100 80GB HBM3, 700.00 W, s31's 8 frames with every unit
# sent before the pictures are drained, median of 3 untimed walls (spread
# max - min), two sweeps in one call: depth 1 821.6 (215.1) and 963.6
# (285.1) ms, 2 786.3 (99.0) and 864.0 (187.7), 3 677.1 (197.4) and
# 926.7 (275.2), 4 901.4 (232.2) and 884.9 (283.7). No depth beat 1 by
# more than the spread, so 1. dav1d_tpu's 3 was measured on a TPU and
# does not carry over.
DEFAULT_STAGEB_DEPTH = 1


def stageb_depth(max_frame_delay: int, golden: bool) -> int:
    """The Stage-B pipeline depth of a threaded decode, by dav1d_tpu's
    rule (its decoder.py): DEFAULT_STAGEB_DEPTH on the device route and
    one in-order worker on the golden host route; Settings.max_frame_delay
    > 0 caps it like the reference's n_fc derivation (lib.c:109-126); a
    set DAV1D_TPU_STAGEB_DEPTH overrides both."""
    import os
    depth = 1 if golden else DEFAULT_STAGEB_DEPTH
    if max_frame_delay and max_frame_delay > 0:
        depth = max(1, min(depth, max_frame_delay))
    if os.environ.get("DAV1D_TPU_STAGEB_DEPTH"):
        depth = max(1, int(os.environ["DAV1D_TPU_STAGEB_DEPTH"]))
    return depth


def scale_fac(ref_sz: int, this_sz: int) -> int:
    """Reference-scaling step in 1/16384 units (copy of dav1d_tpu's
    mc_ref.scale_fac; reference decode.c reference setup)."""
    return ((ref_sz << 14) + (this_sz >> 1)) // this_sz


@dataclass
class TileGroupData:
    start: int
    end: int
    data: bytes


@dataclass
class RefSlot:
    """One of the 8 reference slots (reference Dav1dContext refs[] +
    cdf[]; internal.h:166-175)."""
    pic: object = None            # recon Picture
    frame_hdr: object = None
    poc: int = 0
    refpoc: list = field(default_factory=lambda: [0] * 7)
    cdf: object = None            # CdfContext
    rp: object = None             # temporal mvs {mv, ref} or None
    segmap: object = None


class ObuStreamDecoder:
    """Parses temporal units into frames; runs Stage A (+ recon when
    enabled) on each."""

    def __init__(self, do_recon: bool = True, settings=None):
        from .api import Settings
        # a bare ObuStreamDecoder() (tests/tools) decodes synchronously;
        # the public api.Decoder passes Settings and gets the reference
        # threading default (n_threads=0 -> logical cores, lib.c:109-126)
        self._threaded_default = settings is not None
        self.settings = settings or Settings()
        self.state = obu_mod.ParserState()
        self.state.strict = self.settings.strict_std_compliance
        self.tile_groups: list[TileGroupData] = []
        self.n_tiles = 0
        self.do_recon = do_recon
        self.refs = [RefSlot() for _ in range(8)]
        # keep parser-visible ref headers in sync
        self.state.refs = [obu_mod.RefSlot() for _ in range(8)]
        self.operating_point_idc = 0
        self.event_flags = 0            # reference dav1d.h:268-295
        self.error_data = None          # failing input (lib.c:716-725)
        # frame pipeline: Stage A (submitting thread) overlaps Stage B
        # (stageb_depth workers) when threading is requested. n_threads=0
        # means "pick for me" like the reference (lib.c:109-126:
        # default to the logical core count).
        import os as _os
        if self.settings.n_threads:
            self.n_threads = self.settings.n_threads
        elif self._threaded_default:
            self.n_threads = min(_os.cpu_count() or 1, 256)
        else:
            self.n_threads = 1
        self.pipeline = None
        self._tile_pool = None        # lazy Stage-A tile thread pool
        # lazy Stage-B pool of the native intra engine's tile calls (a
        # keyframe, an inter frame's leftover runs); its own, so a frame's
        # tiles never queue behind the next frames' Stage-A parse
        self._recon_pool = None
        self.device = None
        self.shard_devices = None       # the mesh's shards, when sharded
        # the golden host route: read here, not at each frame as
        # dav1d_tpu does, so a decode keeps one route throughout
        from .ops.device import device_enabled
        self.golden = not device_enabled()
        if do_recon and not self.golden:
            from .ops.device import resolve_device
            self.device = resolve_device(self.settings.device)
            if self.settings.sharding_mesh is not None:
                from .parallel.sharded import resolve_mesh
                self.shard_devices = resolve_mesh(
                    self.settings.sharding_mesh, self.device)
        if do_recon and self.n_threads > 1:
            from .parallel.executor import ReconPipeline
            self.pipeline = ReconPipeline(stageb_depth(
                self.settings.max_frame_delay, self.golden))

    def close(self) -> None:
        """Shut the lazy Stage-A tile and Stage-B recon pools: their
        threads end once their queued calls have run (the pipeline's
        frames still in flight are dropped with this decoder)."""
        for pool in (self._tile_pool, self._recon_pool):
            if pool is not None:
                pool.shutdown(wait=False)

    def _split_tiles(self, fh) -> list:
        tiles = []
        n_bytes = fh.tiling.n_bytes
        for tg in self.tile_groups:
            data = tg.data
            pos = 0
            for j in range(tg.start, tg.end + 1):
                if j == tg.end:
                    tile_sz = len(data) - pos
                else:
                    if pos + n_bytes > len(data):
                        raise obu_mod.ParseError("truncated tile size field")
                    tile_sz = int.from_bytes(data[pos:pos + n_bytes],
                                             "little") + 1
                    pos += n_bytes
                # reference decode.c:3167: tile_sz > remaining is an error
                if tile_sz < 0 or pos + tile_sz > len(data):
                    raise obu_mod.ParseError("tile size exceeds tile group")
                tiles.append(data[pos:pos + tile_sz])
                pos += tile_sz
        return tiles

    def decode_temporal_unit(self, data: bytes) -> list:
        """Feed one temporal unit; returns list of results — FramePlan
        when do_recon is off, else (FramePlan|None, Picture)."""
        out = []
        pos = 0
        try:
            while pos < len(data):
                consumed, res = self._parse_obu(data[pos:])
                if res is not None:
                    out.append(res)
                pos += consumed
        except Exception:
            self.error_data = data      # reference lib.c cached_error_props
            raise
        return out

    def recover(self) -> None:
        """Error containment (reference thread_task.c:459-469
        abort_frame semantics): drop the in-flight frame's transient
        state but keep the 8 ref slots and sequence header consistent,
        so decode resumes at the next frame that only needs surviving
        refs (at worst the next keyframe)."""
        self.state.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0

    def snapshot(self):
        """Resumable ref-state tuple (SURVEY §5: 8 ref slots + CDFs).
        Pictures/arrays are immutable-by-convention post-frame, so
        slots are shared, with CDF copies (they adapt in place)."""
        from .parallel.executor import resolve
        slots = []
        for s in self.refs:
            slots.append(RefSlot(
                pic=resolve(s.pic) if s.pic is not None else None,
                frame_hdr=s.frame_hdr, poc=s.poc,
                refpoc=list(s.refpoc) if s.refpoc else s.refpoc,
                cdf=s.cdf.copy() if s.cdf is not None else None,
                rp=s.rp, segmap=s.segmap))
        hdrs = [s.frame_hdr for s in self.state.refs]
        return (self.state.seq_hdr, slots, hdrs)

    def restore(self, snap) -> None:
        seq, slots, hdrs = snap
        self.state.seq_hdr = seq
        self.refs = [RefSlot(
            pic=s.pic, frame_hdr=s.frame_hdr, poc=s.poc,
            refpoc=list(s.refpoc) if s.refpoc else s.refpoc,
            cdf=s.cdf.copy() if s.cdf is not None else None,
            rp=s.rp, segmap=s.segmap) for s in slots]
        for i, h in enumerate(hdrs):
            self.state.refs[i].frame_hdr = h
        self.state.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0

    def _parse_obu(self, data: bytes):
        st = self.state
        gb = GetBits(data)
        gb.get_bit()
        obu_type = gb.get_bits(4)
        has_extension = gb.get_bit()
        has_length = gb.get_bit()
        gb.get_bit()
        temporal_id = spatial_id = 0
        if has_extension:
            temporal_id = gb.get_bits(3)
            spatial_id = gb.get_bits(2)
            gb.get_bits(3)
        if has_length:
            ln = gb.get_uleb128()
            payload_start = gb.byte_pos()
            end = payload_start + ln
        else:
            payload_start = gb.byte_pos()
            end = len(data)
        if gb.error or end > len(data):
            raise obu_mod.ParseError("truncated OBU")

        # operating-point layer filtering (reference obu.c:1203-1210)
        if has_extension and self.operating_point_idc and \
                obu_type not in (ObuType.SEQ_HDR, ObuType.TD):
            in_t = (self.operating_point_idc >> temporal_id) & 1
            in_s = (self.operating_point_idc >> (spatial_id + 8)) & 1
            if not (in_t and in_s):
                return end, None

        res = None
        if obu_type == ObuType.SEQ_HDR:
            prev = st.seq_hdr
            st.seq_hdr = obu_mod.parse_seq_hdr(
                GetBits(data[payload_start:end]), st.strict)
            opi = min(self.settings.operating_point,
                      st.seq_hdr.num_operating_points - 1)
            self.operating_point_idc = st.seq_hdr.operating_points[opi].idc
            # event flags (reference obu.c seq-change detection)
            if prev is None or not self._seq_hdr_op_equal(prev, st.seq_hdr):
                self.event_flags |= 1   # NEW_SEQUENCE
                if prev is not None:
                    # a genuinely different sequence invalidates all ref
                    # state (reference obu.c:1239-1252: frame_hdr + all 8
                    # ref slots cleared on header change)
                    self._reset_ref_state()
            if prev is None or \
                    prev.num_operating_points != \
                    st.seq_hdr.num_operating_points:
                self.event_flags |= 2   # NEW_OP_PARAMS_INFO
        elif obu_type in (ObuType.FRAME_HDR, ObuType.FRAME,
                          ObuType.REDUNDANT_FRAME_HDR):
            if obu_type == ObuType.REDUNDANT_FRAME_HDR and st.frame_hdr:
                return end, None
            if st.seq_hdr is None:
                raise obu_mod.ParseError("frame header before sequence header")
            st.frame_hdr = FrameHeader()
            st.frame_hdr.temporal_id = temporal_id
            st.frame_hdr.spatial_id = spatial_id
            fgb = GetBits(data[payload_start:end])
            obu_mod.parse_frame_hdr(st, fgb)
            self.tile_groups = []
            self.n_tiles = 0
            if st.frame_hdr.show_existing_frame:
                if obu_type == ObuType.FRAME:
                    # reference obu.c:1312-1315: OBU_FRAMEs shouldn't be
                    # signaled with show_existing_frame
                    st.frame_hdr = None
                    raise obu_mod.ParseError(
                        "OBU_FRAME with show_existing_frame")
                if self._frame_type_skipped(
                        self.refs[st.frame_hdr.existing_frame_idx]
                        .frame_hdr, show_existing=True):
                    st.frame_hdr = None
                    return end, None
                res = self._show_existing()
                st.frame_hdr = None
                return end, res
            if obu_type == ObuType.FRAME:
                fgb.bytealign()
                res = self._handle_tile_group(
                    data[payload_start + fgb.byte_pos():end])
        elif obu_type == ObuType.TILE_GRP:
            res = self._handle_tile_group(data[payload_start:end])
        elif obu_type == ObuType.METADATA:
            obu_mod.parse_metadata(self.state, data[payload_start:end])
        elif obu_type in (ObuType.TD, ObuType.PADDING):
            pass
        if isinstance(res, tuple) and res[1] is not None:
            self._attach_metadata(res[1])
        return end, res

    @staticmethod
    def _seq_hdr_op_equal(a, b) -> bool:
        """Full-field comparison up to the operating-point parameter
        block (reference obu.c offsetof memcmp on Dav1dSequenceHeader)."""
        skip = ("operating_points",)
        for k in a.__dataclass_fields__:
            if k in skip:
                continue
            if getattr(a, k) != getattr(b, k):
                return False
        # operating-point layer structure matters for filtering
        idcs_a = [op.idc for op in a.operating_points]
        idcs_b = [op.idc for op in b.operating_points]
        return idcs_a == idcs_b

    def _reset_ref_state(self) -> None:
        """Drop the pending frame and every ref slot (new sequence)."""
        self.state.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0
        self.refs = [RefSlot() for _ in range(8)]
        self.state.refs = [obu_mod.RefSlot() for _ in range(8)]

    def _attach_metadata(self, pic):
        """HDR metadata + accumulated T.35 travel on the next output
        picture (reference obu.c:1559-1583, picture.c metadata refs).
        For pipelined frames the parse-time state is snapshotted and
        applied when the promise resolves."""
        st = self.state
        cl, md = st.content_light, st.mastering_display
        t35, st.itut_t35 = st.itut_t35, []
        seq = st.seq_hdr

        def apply(p):
            if p is None:
                return
            if p.seq_hdr is None:
                p.seq_hdr = seq
            p.content_light = cl
            p.mastering_display = md
            if t35:
                p.itut_t35 = t35

        if hasattr(pic, "add_hook"):
            pic.add_hook(apply)
        else:
            apply(pic)

    def _show_existing(self):
        from .parallel.executor import resolve
        slot = self.refs[self.state.frame_hdr.existing_frame_idx]
        if slot.pic is None:
            raise obu_mod.ParseError("show_existing of empty slot")
        if hasattr(slot.pic, "result"):
            slot.pic = resolve(slot.pic)
        # key frames shown via show_existing reset state like a shown key
        if slot.frame_hdr is not None and slot.frame_hdr.frame_type == 0:
            self._refresh_slots_for_key_show_existing(slot)
        out_pic = slot.pic
        if out_pic is not None and out_pic.frame_hdr is None:
            out_pic.seq_hdr = self.state.seq_hdr
            out_pic.frame_hdr = slot.frame_hdr
        if slot.frame_hdr is not None and \
                slot.frame_hdr.film_grain_present and \
                self.settings.apply_grain:
            out_pic = self._apply_grain(slot.pic, slot.frame_hdr,
                                        self.state.seq_hdr)
        return (None, out_pic)

    def _refresh_slots_for_key_show_existing(self, slot):
        """reference obu.c:1593-1617: showing an existing KEY frame
        refreshes all other slots from it."""
        for i, s in enumerate(self.refs):
            if s is slot:
                continue
            self.refs[i] = RefSlot(pic=slot.pic, frame_hdr=slot.frame_hdr,
                                   poc=slot.poc,
                                   refpoc=list(slot.refpoc),
                                   cdf=slot.cdf, rp=slot.rp,
                                   segmap=slot.segmap)
            self.state.refs[i].frame_hdr = slot.frame_hdr

    def _handle_tile_group(self, payload: bytes):
        st = self.state
        if st.frame_hdr is None:
            raise obu_mod.ParseError("tile group without frame header")
        gb = GetBits(payload)
        start, end = obu_mod.parse_tile_hdr(st, gb)
        gb.bytealign()
        n_expected = st.frame_hdr.tiling.cols * st.frame_hdr.tiling.rows
        # spec 6.10.1 sanity (reference obu.c:1343-1352): tile groups must
        # be contiguous, in order, and within the frame's tile count
        if start > end or start != self.n_tiles or end >= n_expected:
            self.tile_groups = []
            self.n_tiles = 0
            raise obu_mod.ParseError("invalid tile group range")
        self.tile_groups.append(
            TileGroupData(start, end, payload[gb.byte_pos():]))
        self.n_tiles += end - start + 1
        if self.n_tiles == n_expected:
            if self._frame_type_skipped(st.frame_hdr):
                self._skip_frame_headers_only()
                return None
            return self._decode_frame()
        return None

    def _frame_type_skipped(self, fh, show_existing=False):
        """decode_frame_type filtering (reference obu.c:1528-1658,
        dav1d.h:71-76). 0=all 1=reference 2=intra 3=key."""
        dft = self.settings.decode_frame_type
        if dft == 0 or fh is None:
            return False
        ft = fh.frame_type
        if ft in (1, 3):                      # INTER / SWITCH
            return dft > 1 or (dft == 1 and not show_existing and
                               not fh.refresh_frame_flags)
        if ft == 2:                           # INTRA (non-key)
            return dft > 2 or (dft == 1 and not show_existing and
                               not fh.refresh_frame_flags)
        return False                          # KEY always decoded

    def _skip_frame_headers_only(self):
        """Header-only slot refresh for filtered frames (reference
        obu.c:1670-1682)."""
        st = self.state
        fh = st.frame_hdr
        for i in range(8):
            if fh.refresh_frame_flags & (1 << i):
                self.refs[i] = RefSlot(frame_hdr=fh, poc=fh.frame_offset)
                self.state.refs[i].frame_hdr = fh
        st.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0

    # ------------------------------------------------------------------
    def _decode_frame(self, coder_factory=None):
        """Decode the pending frame. When coder_factory is given (the
        stream generator), tile payloads are synthesized instead of
        parsed: coder_factory(tile_idx) must return a GenCoder that
        TileParser drives; the finalized payloads are stored in
        self.last_tile_payloads."""
        from .entropy.refmvs import RefMvsFrame

        st = self.state
        fh = st.frame_hdr
        seq = st.seq_hdr
        if self.settings.frame_size_limit and \
                fh.width[1] * fh.height > self.settings.frame_size_limit:
            raise obu_mod.ParseError("frame size exceeds frame_size_limit")
        tiles = self._split_tiles(fh) if coder_factory is None else None
        f = FrameContext(seq, fh)
        f.strict = self.settings.strict_std_compliance
        key_or_intra = not (fh.frame_type & 1)

        # reference setup (reference decode.c:3444-3489)
        refp = [None] * 7
        if not key_or_intra:
            for i in range(7):
                slot = self.refs[fh.refidx[i]]
                if slot.frame_hdr is None or \
                        (self.do_recon and coder_factory is None and
                         slot.pic is None):
                    raise obu_mod.ParseError("missing reference picture")
                refp[i] = slot
                f.refpoc[i] = slot.poc
                # stored pictures are post-super-res (width[1])
                ref_w = slot.frame_hdr.width[1]
                ref_h = slot.frame_hdr.height
                if (fh.width[0] * 2 < ref_w or fh.height * 2 < ref_h or
                        fh.width[0] > ref_w * 16 or
                        fh.height > ref_h * 16):
                    raise obu_mod.ParseError("ref scale out of range")
                if ref_w != fh.width[0] or ref_h != fh.height:
                    sx = scale_fac(ref_w, fh.width[0])
                    sy = scale_fac(ref_h, fh.height)
                    f.svc[i] = ((sx, (sx + 8) >> 4), (sy, (sy + 8) >> 4))
                    f.svc_scale[i] = sx
                else:
                    f.svc[i] = ((0, 0), (0, 0))
                    f.svc_scale[i] = 0
                g = fh.gmv[i]
                f.gmv_warp_allowed[i] = int(
                    g.type > WarpedMotionType.TRANSLATION and
                    not fh.force_integer_mv and
                    not wmv.get_shear_params(g) and not f.svc_scale[i])
        f.refp = refp

        # refmvs frame state
        if not key_or_intra or fh.allow_intrabc:
            if not fh.allow_intrabc:
                ref_poc = [self.refs[fh.refidx[i]].poc for i in range(7)]
            else:
                ref_poc = [0] * 7
            ref_ref_poc = [[0] * 7 for _ in range(7)]
            rp_ref = [None] * 7
            if fh.use_ref_frame_mvs:
                for i in range(7):
                    slot = self.refs[fh.refidx[i]]
                    if slot.frame_hdr is not None:
                        ref_w = ((slot.frame_hdr.width[0] + 7) >> 3) << 1
                        ref_h = ((slot.frame_hdr.height + 7) >> 3) << 1
                    else:
                        ref_w = ref_h = 0
                    if slot.rp is not None and ref_w == f.bw and \
                            ref_h == f.bh:
                        rp_ref[i] = slot.rp
                    ref_ref_poc[i] = list(slot.refpoc)
            f.rf = RefMvsFrame(seq, fh, ref_poc, ref_ref_poc, rp_ref)
            if f.rf.use_ref_frame_mvs:
                f.rf.load_tmvs(0, f.rf.iw8, 0, f.rf.ih8)

        # segmentation maps (reference decode.c:3611-3666)
        cur_segmap = None
        if fh.segmentation.enabled:
            if fh.segmentation.temporal or not fh.segmentation.update_map:
                pri = fh.refidx[fh.primary_ref_frame]
                slot = self.refs[pri]
                if slot.frame_hdr is not None and slot.segmap is not None:
                    ref_w = ((slot.frame_hdr.width[0] + 7) >> 3) << 1
                    ref_h = ((slot.frame_hdr.height + 7) >> 3) << 1
                    if ref_w == f.bw and ref_h == f.bh:
                        f.prev_segmap = slot.segmap

        # CDF lifecycle (reference decode.c:3492-3501)
        if fh.primary_ref_frame == PRIMARY_REF_NONE:
            in_cdf = CdfContext.default(fh.quant.yac)
        else:
            pri = fh.refidx[fh.primary_ref_frame]
            if self.refs[pri].cdf is None:
                raise obu_mod.ParseError("primary ref without CDF")
            in_cdf = self.refs[pri].cdf

        plan = FramePlan(f)
        if self.do_recon and coder_factory is None and not self.golden \
                and not fh.allow_intrabc:
            # lazy-block fast path: native Stage A -> the native intra
            # engine (key and intra frames) or inter-job emitter ->
            # device Stage B, with Python Block objects built only on
            # demand (leftover replay; every golden fallback materializes
            # first); the golden route's walks and the intrabc walk need
            # every Block
            plan.want_lazy = True
        out_cdf = None
        n_cols = fh.tiling.cols
        n_tiles_f = fh.tiling.rows * n_cols
        self.last_tile_payloads = []

        def finish_tile(tile_idx, tp):
            nonlocal out_cdf
            if coder_factory is not None:
                self.last_tile_payloads.append(tp.msac.enc.finalize())
            if fh.refresh_context and tile_idx == fh.tiling.update:
                out_cdf = in_cdf.copy()
                out_cdf.update_from(tp.cdf, key_or_intra=key_or_intra)

        # tile-parallel Stage A: tiles are self-contained entropy units
        # (reference decode.c:2425-2509, run on worker threads by
        # thread_task.c:556-915); the native per-tile parse releases
        # the GIL, so independent tiles run on a thread pool and
        # materialize into the FramePlan in tile order.
        with timing.phase("stage_a"):
            threaded = (coder_factory is None and n_tiles_f > 1 and
                        self.n_threads > 1)
            runs = None
            if threaded:
                from .entropy import native_tile
                tps = []
                for tile_idx in range(n_tiles_f):
                    tr, tc = divmod(tile_idx, n_cols)
                    tps.append(TileParser(f, plan, tiles[tile_idx], tr, tc,
                                          in_cdf.copy()))
                runs = [native_tile.prepare_tile_native(tp) for tp in tps]
                if any(r is None for r in runs):
                    runs = None          # fall back to the sequential walk
            if runs is not None:
                from concurrent.futures import ThreadPoolExecutor
                if self._tile_pool is None:
                    self._tile_pool = ThreadPoolExecutor(
                        max_workers=min(self.n_threads, 16),
                        thread_name_prefix="tile")
                with timing.phase("stage_a.tiles_wait"):
                    for _ in self._tile_pool.map(lambda r: r.run(), runs):
                        pass
                with timing.phase("stage_a.materialize"):
                    for tile_idx, r in enumerate(runs):
                        r.materialize()
                        finish_tile(tile_idx, tps[tile_idx])
            else:
                for tile_idx in range(n_tiles_f):
                    tr, tc = divmod(tile_idx, n_cols)
                    cdf = in_cdf.copy()
                    data = b"" if coder_factory else tiles[tile_idx]
                    tp = TileParser(f, plan, data, tr, tc, cdf)
                    if coder_factory is not None:
                        tp.msac = coder_factory(tile_idx, cdf)
                    tp.parse_tile()
                    finish_tile(tile_idx, tp)
            if plan.lazy_blocks:
                timing.count("stage_a.lazy_frames")

        # temporal mv save for future frames
        rp = None
        if f.rf is not None and not fh.allow_intrabc:
            f.rf.save_tmvs(0, f.rf.iw8, 0, f.rf.ih8)
            rp = {"mv": f.rf.rp_mv, "ref": f.rf.rp_ref_idx}

        # reconstruction: inline, or submitted to the Stage-B pipeline
        pic = out_view = out_pic = None
        if self.do_recon and coder_factory is None:
            if self.pipeline is not None:
                if self._recon_pool is None:
                    # the Stage-B thread runs one tile call itself
                    from concurrent.futures import ThreadPoolExecutor
                    self._recon_pool = ThreadPoolExecutor(
                        max_workers=min(self.n_threads, 16) - 1,
                        thread_name_prefix="recon")
                # split submit: the ref promise resolves when the
                # reconstruction+filter chain is enqueued, so the next
                # frame's Stage B overlaps this frame's output fetch /
                # film grain (reference n_fc>1 frame threading,
                # coarsened to whole frames)
                pic, out_view = self.pipeline.submit_split(
                    lambda: self._recon_split(plan, refp, fh, seq,
                                              key_or_intra))
            else:
                pic, out_pic = self._recon_and_finish(plan, refp, fh, seq,
                                                      key_or_intra)

        # slot refresh (reference decode.c:3669-3695)
        if fh.segmentation.enabled:
            cur_segmap = plan.b4_seg.copy()
        final_cdf = out_cdf if fh.refresh_context else in_cdf
        replaced = []
        for i in range(8):
            if fh.refresh_frame_flags & (1 << i):
                replaced.append(self.refs[i].pic)
                self.refs[i] = RefSlot(
                    pic=pic, frame_hdr=fh, poc=fh.frame_offset,
                    refpoc=list(f.refpoc), cdf=final_cdf, rp=rp,
                    segmap=cur_segmap)
                self.state.refs[i].frame_hdr = fh
        for old in replaced:
            self.release_device_planes(old)

        st.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0
        if self.do_recon:
            return (plan, out_view if out_view is not None else out_pic)
        return plan

    def _recon_and_finish(self, plan, refp, fh, seq, key_or_intra):
        """Stage B for one frame: reconstruction, in-loop filters,
        super-res, film grain, output gating. Runs inline or on the
        pipeline worker; returns (reference_pic, output_pic_or_None)."""
        pic, finish = self._recon_split(plan, refp, fh, seq,
                                        key_or_intra)
        return pic, finish()

    def _recon_split(self, plan, refp, fh, seq, key_or_intra):
        """Two-phase Stage B: phase 1 (run here) produces the
        reference picture — after it, dependent frames may start;
        the returned finish() computes the output picture (invisible
        gating + out-of-loop film grain)."""
        from .recon import picture as picture_mod
        alloc_token = None
        if self.settings.allocator is not None:
            # decode lands in caller-provided buffers (reference
            # picture.h:107-146: dav1d decodes directly into the
            # allocator's pictures, references included)
            alloc_token = picture_mod.set_picture_allocator(
                self.settings.allocator)
        try:
            with self.device_scope():
                pic = self._recon_and_finish_inner(plan, refp, fh, seq,
                                                   key_or_intra)
        except BaseException:
            if alloc_token is not None:
                picture_mod.reset_picture_allocator(alloc_token)
            raise

        def finish():
            try:
                out_pic = pic
                if not fh.show_frame and \
                        not self.settings.output_invisible_frames:
                    out_pic = None   # invisible: decode, don't emit
                if out_pic is not None and fh.film_grain_present and \
                        self.settings.apply_grain:
                    # grain is out-of-loop: output copy, refs stay clean
                    out_pic = self._apply_grain(pic, fh, seq)
                return out_pic
            finally:
                if alloc_token is not None:
                    picture_mod.reset_picture_allocator(alloc_token)

        return pic, finish

    def device_scope(self):
        """The context of this decoder's device work, on whichever
        thread runs it: its CUDA device made current (the kernel
        libraries launch on the current device), nothing for the CPU or
        the golden host route."""
        from .ops import cuda_build
        if self.device is None:
            return contextlib.nullcontext()
        return cuda_build.device_guard(self.device)

    def release_device_planes(self, pic):
        """Drop the device planes of a picture that no ref slot holds
        once its host planes are current (it was output). A frame still
        waiting for Stage B that references it uploads it again: the
        Stage-B readers of a reference's planes keep one snapshot of
        them (ops/device.py planes_on_device). A frame still in Stage B
        is skipped: its promise is pending, so peek gives None."""
        from .parallel.executor import peek
        pic = peek(pic)
        if pic is None or pic.dev is None or pic.host_stale:
            return
        if any(peek(s.pic) is pic for s in self.refs):
            return
        pic.dev = None
        pic.dev_rep = None

    def _recon_and_finish_inner(self, plan, refp, fh, seq, key_or_intra):
        from .parallel.executor import resolve
        if refp is not None:
            for slot in refp:
                if slot is not None and hasattr(slot.pic, "result"):
                    with timing.phase("pipeline.ref_wait"):
                        slot.pic = resolve(slot.pic)
        shards = self.shard_devices
        if key_or_intra and not fh.allow_intrabc:
            from .recon.intra import reconstruct_intra_frame
            with timing.phase("intra.frame_recon"):
                pic = reconstruct_intra_frame(plan, self._recon_pool)
        elif not key_or_intra and not self.golden:
            with timing.phase("inter.frame_recon"):
                if shards is not None:
                    from .recon.sharded_stageb import \
                        reconstruct_inter_frame_sharded
                    pic = reconstruct_inter_frame_sharded(
                        plan, refp, self.device, shards, self._recon_pool)
                else:
                    from .recon.inter_device import \
                        reconstruct_inter_frame_device
                    pic = reconstruct_inter_frame_device(
                        plan, refp, self.device, self._recon_pool)
        else:
            # intrabc frames copy from the picture being decoded: an
            # inherently sequential walk (reference recon_tmpl.c:1583),
            # on the host; the filter chain uploads its planes. On the
            # golden route every inter frame takes this walk.
            from .recon.inter_ref import reconstruct_inter_frame
            with timing.phase("golden.frame_recon" if self.golden else
                              "intrabc.frame_recon"):
                pic = reconstruct_inter_frame(plan, refp)
        ilf = self.settings.inloop_filters
        if self.golden:
            pic = self._filters_golden(pic, plan, fh)
        elif shards is not None:
            # multi-device: the whole Stage-B pipeline column-sharded
            from .recon.sharded_stageb import run_filter_chain_sharded
            pic = run_filter_chain_sharded(pic, plan, ilf, self.device,
                                           shards)
        else:
            from .recon.filters import run_filter_chain_device
            pic = run_filter_chain_device(pic, plan, ilf, self.device)
        if self.pipeline is None:
            # synchronous decode (bare ObuStreamDecoder): callers read
            # host planes right away. Pipelined decode defers the
            # output transfer to the consumer (api.get_picture). A
            # no-op on host planes (the golden route).
            from .ops.device import fetch_pic_host
            with timing.phase("fetch"):
                fetch_pic_host(pic)
        pic.seq_hdr = seq
        pic.frame_hdr = fh
        return pic

    def _filters_golden(self, pic, plan, fh):
        """The in-loop filter chain of the golden host route (dav1d_tpu's
        decoder.py under DAV1D_TPU_BACKEND=numpy): the golden models in
        the reference's order, on the host planes. Returns the filtered
        picture (a new one after super-res)."""
        ilf = self.settings.inloop_filters
        with timing.phase("golden.filters"):
            if ilf & 1:          # DAV1D_INLOOPFILTER_DEBLOCK
                from .ops.lf_ref import apply_deblock
                apply_deblock(pic, plan)
            need_lr = (ilf & 4) and \
                any(t != 0 for t in fh.restoration.type)
            pre_cdef = [pl.astype("int32") for pl in pic.planes] \
                if need_lr else None
            if ilf & 2:          # DAV1D_INLOOPFILTER_CDEF
                from .ops.cdef_ref import apply_cdef
                apply_cdef(pic, plan)
            if fh.width[0] != fh.width[1]:
                from .ops.superres import apply_superres
                pic, pre_cdef = apply_superres(pic, pre_cdef, plan)
            if need_lr:          # DAV1D_INLOOPFILTER_RESTORATION
                from .ops.restore_ref import apply_lr
                apply_lr(pic, pre_cdef, plan)
        return pic

    def _apply_grain(self, pic, fh, seq):
        """The grained output copy of a shown picture, made on the
        decode's device (on the host on the golden route); the
        reference picture stays clean."""
        if self.golden:
            from .ops.fg_ref import apply_film_grain
            return apply_film_grain(pic, fh, seq)
        from .ops.fg import apply_film_grain_device
        with self.device_scope():
            return apply_film_grain_device(pic, fh, seq, self.device)
