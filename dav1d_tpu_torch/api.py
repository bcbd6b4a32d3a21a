"""Public decoder API: the push/pull contract of the reference's
include/dav1d/dav1d.h (dav1d_open / dav1d_send_data /
dav1d_get_picture / dav1d_flush / dav1d_close,
dav1d_parse_sequence_header), with Dav1dSettings equivalents
(dav1d.h:78-99) honored by the pipeline:

- apply_grain            -> out-of-loop film grain on output pictures
- operating_point        -> OBU temporal/spatial layer filtering
                            (reference obu.c:1203-1210)
- all_layers             -> emit every spatial layer vs highest only
- frame_size_limit       -> reject frames above the pixel budget
- inloop_filters         -> mask of deblock(1)/cdef(2)/restoration(4)
- decode_frame_type      -> all/reference/intra/key frame filtering
                            (reference obu.c:1528-1658)
- output_invisible_frames-> emit show_frame=0 frames as they decode
- strict_std_compliance  -> strict header validation

PyTorch port: Settings.device picks the torch device the pixel
pipeline runs on ("cuda" by default; tests pass "cpu").
DAV1D_TPU_BACKEND=numpy (or ref, off) decodes on the host golden
models instead, with no device: Settings.device and sharding_mesh are
then not read.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .utils import timing

INLOOPFILTER_NONE = 0
INLOOPFILTER_DEBLOCK = 1
INLOOPFILTER_CDEF = 2
INLOOPFILTER_RESTORATION = 4
INLOOPFILTER_ALL = 7

DECODEFRAMETYPE_ALL = 0
DECODEFRAMETYPE_REFERENCE = 1
DECODEFRAMETYPE_INTRA = 2
DECODEFRAMETYPE_KEY = 3

# event flags (reference dav1d.h:268-295)
EVENT_FLAG_NEW_SEQUENCE = 1
EVENT_FLAG_NEW_OP_PARAMS_INFO = 2


@dataclass
class Settings:
    """Mirrors Dav1dSettings (reference dav1d.h:78-99). Threading
    fields are accepted for API parity; the Python golden path decodes
    synchronously (the TPU pipeline parallelizes per-frame instead)."""
    n_threads: int = 0
    max_frame_delay: int = 0
    apply_grain: bool = True
    operating_point: int = 0
    all_layers: bool = True
    frame_size_limit: int = 0
    strict_std_compliance: bool = False
    output_invisible_frames: bool = False
    inloop_filters: int = INLOOPFILTER_ALL
    decode_frame_type: int = DECODEFRAMETYPE_ALL
    logger: object = None      # callable(str); None = stderr; False = off
    allocator: object = None   # Dav1dPicAllocator equivalent — see
                               # recon/picture.py for the contract
    sharding_mesh: object = None  # parallel.sharded.Mesh: column-shard
                               # inter Stage B and the filter chain over
                               # its shards (devices of `device`'s type)
    device: str = "cuda"       # torch device of the pixel pipeline;
                               # "cuda" raises when no card is usable


@dataclass
class DataProps:
    """Dav1dDataProps (reference include/dav1d/data.h:35-43):
    caller-set input metadata carried through to output pictures."""
    timestamp: int = -9223372036854775808    # INT64_MIN like the reference
    duration: int = 0
    offset: int = -1
    user_data: object = None


class DecodeError(Exception):
    pass


class Decoder:
    """dav1d_open/send_data/get_picture/flush/close equivalent.

    send_data() accepts raw OBU data (a temporal unit, or any
    concatenation of OBUs); get_picture() returns the next decoded
    Picture or None when more input is needed."""

    def __init__(self, settings: Settings | None = None):
        from .decoder import ObuStreamDecoder
        self.settings = settings or Settings()
        with timing.phase("api.open"):
            self._dec = ObuStreamDecoder(settings=self.settings)
        self._pending: deque = deque()
        self._out: deque = deque()
        # decode-stat counters (SURVEY §5 observability)
        self.stats = {"bytes_in": 0, "temporal_units": 0,
                      "pictures_out": 0, "decode_errors": 0,
                      "decode_time_s": 0.0}

    # -- dav1d_send_data ------------------------------------------------
    def send_data(self, data: bytes, props: DataProps | None = None) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError("data must be bytes-like")
        if data:
            self.stats["bytes_in"] += len(data)
            self._pending.append((bytes(data), props))

    # -- dav1d_get_picture ----------------------------------------------
    def get_picture(self):
        from .parallel.executor import resolve
        # keep the Stage-B worker fed: parse ahead up to the frame
        # delay window before blocking on the oldest frame's promise
        depth = max(2, self.settings.max_frame_delay) \
            if self._dec.n_threads > 1 else 1
        while True:
            while self._pending and len(self._out) < depth:
                chunk, props = self._pending.popleft()
                self.stats["temporal_units"] += 1
                import time as _time
                _t0 = _time.perf_counter()
                try:
                    results = self._dec.decode_temporal_unit(chunk)
                except Exception as e:
                    self.stats["decode_errors"] += 1
                    self.stats["decode_time_s"] += \
                        _time.perf_counter() - _t0
                    # error containment (reference thread_task.c:459-469
                    # + lib.c:716-725): poison this temporal unit, keep
                    # ref state consistent, surface the error once, and
                    # keep decoding the remaining input on later calls
                    from .utils.log import log
                    self._dec.recover()
                    log(self.settings, f"frame decode error: {e}")
                    err = DecodeError(str(e))
                    err.__cause__ = e
                    err.props = props
                    raise err
                self.stats["decode_time_s"] += _time.perf_counter() - _t0
                for res in results:
                    pic = res[1] if isinstance(res, tuple) else None
                    if pic is not None:
                        self._out.append((pic, props))
            if not self._out:
                return None
            entry, props = self._out.popleft()
            try:
                with timing.phase("api.wait"):
                    pic = resolve(entry)
            except Exception as e:
                # a pipelined Stage-B failure surfaces here; frames
                # referencing the poisoned picture cascade the same way
                # until a keyframe, exactly like the reference's
                # abort_frame chain (thread_task.c:459-469)
                self.stats["decode_errors"] += 1
                from .utils.log import log
                self._dec.recover()
                log(self.settings, f"frame recon error: {e}")
                err = DecodeError(str(e))
                err.__cause__ = e
                err.props = props
                raise err
            if pic is not None:         # else: pipelined invisible frame
                # materialize a deferred device->host output transfer
                # (queued by the Stage-B worker; see recon/filters.py),
                # with the decode's device current; nothing to do for
                # a picture of the golden host route
                from .ops.device import fetch_pic_host
                with timing.phase("fetch"), self._dec.device_scope():
                    fetch_pic_host(pic)
                self._dec.release_device_planes(pic)
                pic.props = props or DataProps()
                self.stats["pictures_out"] += 1
                return pic

    def pictures(self):
        """Drain every picture currently decodable."""
        while True:
            pic = self.get_picture()
            if pic is None:
                return
            yield pic

    # -- dav1d_flush ----------------------------------------------------
    def flush(self) -> None:
        """Drop in-flight data and output; reference state is reset
        like dav1d_flush (lib.c)."""
        from .decoder import ObuStreamDecoder
        self._pending.clear()
        self._out.clear()
        self._dec.close()
        self._dec = ObuStreamDecoder(settings=self.settings)

    # -- dav1d_close ----------------------------------------------------
    def close(self) -> None:
        with timing.phase("api.close"):
            self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection --------------------------------------------------
    @property
    def seq_hdr(self):
        return self._dec.state.seq_hdr

    def get_frame_delay(self) -> int:
        """dav1d_get_frame_delay equivalent (reference dav1d.h:310-323,
        lib.c:109-138): frames in flight before output is available."""
        if self._dec.n_threads > 1:
            return max(2, self.settings.max_frame_delay)
        return 1

    def get_event_flags(self) -> int:
        """dav1d_get_event_flags equivalent (reference dav1d.h:268-295,
        lib.c): returns and clears the accumulated event mask."""
        flags = self._dec.event_flags
        self._dec.event_flags = 0
        return flags

    def get_decode_error_data_props(self):
        """dav1d_get_decode_error_data_props equivalent (reference
        lib.c:716-725): the input buffer whose decode failed last."""
        return self._dec.error_data

    # -- ref-state snapshot (SURVEY §5: checkpoint unit) ---------------
    def snapshot(self):
        """Capture the decoder's resumable state: the 8 ref slots
        (picture/segmap/refmvs/CDF/poc). Restoring this tuple after
        seeking past its point resumes decode without a keyframe."""
        return self._dec.snapshot()

    def restore(self, snap) -> None:
        self._dec.restore(snap)


def parse_sequence_header(data: bytes):
    """dav1d_parse_sequence_header equivalent (reference obu.c:302-339)."""
    from .bitstream.obu import parse_sequence_header_standalone
    return parse_sequence_header_standalone(data)
