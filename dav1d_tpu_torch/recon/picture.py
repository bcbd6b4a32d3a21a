"""Output picture container (reference src/picture.c buffer geometry:
planes padded to 128-aligned dimensions; we keep exact-size numpy planes
plus the visible-geometry metadata the muxers need).

Custom allocator contract (reference include/dav1d/picture.h:107-146
Dav1dPicAllocator): a Settings.allocator object with

    alloc_picture_data(pic) -> list[np.ndarray] | None
    release_picture_data(pic)            (optional)

`alloc_picture_data` receives the Picture (w/h/layout/bpc set, planes
not yet) and returns one 2-D array per plane with the padded geometry
from `Picture.plane_shapes()` and dtype `Picture.dtype()` — e.g. views
into one caller-owned buffer, pinned host memory for a zero-copy
device download, or a recycling pool. Returning None falls back to the
default allocator for that picture (reference picture.h:117: the
callback may fail; dav1d then errors — we soften to fallback).
Buffers may be dirty; the decoder writes every pixel it reads back.
"""
from __future__ import annotations

import contextvars
import threading

import numpy as np

# active allocator for pictures created inside the decode call stack
# (set by the Stage-B code from Settings.allocator; a context var so
# the pipeline worker thread and the caller thread stay independent)
_ALLOCATOR = contextvars.ContextVar("dav1d_tpu_allocator", default=None)


def set_picture_allocator(alloc):
    """Install `alloc` as the allocator for Pictures created in this
    context; returns a token for `reset_picture_allocator`."""
    return _ALLOCATOR.set(alloc)


def reset_picture_allocator(token) -> None:
    _ALLOCATOR.reset(token)


class Picture:
    __slots__ = ("planes", "w", "h", "bpc", "layout", "layout_name",
                 "ss_hor", "ss_ver", "content_light", "mastering_display",
                 "itut_t35", "seq_hdr", "frame_hdr", "props",
                 "allocator", "allocator_data", "dev", "host_stale",
                 "pending_fetch", "dev_grid", "dev_c", "dev_mcpad",
                 "dev_rep", "lock")

    _NAMES = {0: "I400", 1: "I420", 2: "I422", 3: "I444"}

    def __init__(self, w, h, layout, bpc):
        self.w = w
        self.h = h
        self.bpc = bpc
        self.layout = layout
        self.layout_name = self._NAMES[int(layout)]
        self.ss_hor = 0 if layout == 3 else 1
        self.ss_ver = 1 if layout == 1 else 0
        self.content_light = None       # HDR CLL metadata OBU
        self.mastering_display = None   # HDR MDCV metadata OBU
        self.itut_t35 = []              # ITU-T T.35 metadata OBUs
        self.seq_hdr = None             # set by the decoder on output
        self.frame_hdr = None
        self.props = None               # DataProps of the source input
        self.allocator = _ALLOCATOR.get()
        self.allocator_data = None      # reference picture.h:84 cookie
        # device-resident plane cache: when set, `dev` holds one int32
        # jax array per plane with exactly the host planes' pixel
        # values (the TPU-side analog of the reference's ref-picture
        # buffers staying in place across frames). `host_stale` marks
        # the window where only the device copy is current (between
        # recon and the output fetch).
        self.dev = None
        self.host_stale = False
        # sharded decode: dev holds, per plane, the column-sharded
        # shard-width planes (recon/sharded_stageb.py) rather than
        # plane-shaped tensors; dev_rep the reference planes' copies on
        # the mesh's other devices ({torch.device: planes})
        self.dev_grid = False
        self.dev_rep = None
        self.dev_c = None
        self.dev_mcpad = None
        # in-flight device->host transfer (down-cast device arrays with
        # copy_to_host_async issued); materialized by fetch_pic_host at
        # the first host consumer — the Stage-B worker never blocks on
        # the output transfer
        self.pending_fetch = None
        # serialises the output fetch and the reference upload of this
        # picture, which several Stage-B workers and the caller's thread
        # may reach at once (ops/device.py)
        self.lock = threading.RLock()
        planes = None
        if self.allocator is not None:
            planes = self.allocator.alloc_picture_data(self)
        if planes is None:
            dtype = self.dtype()
            planes = [np.zeros(s, dtype) for s in self.plane_shapes()]
        else:
            self._check_planes(planes)
            for p in planes:
                p.fill(0)   # padding must start deterministic (edge
                            # blocks overshoot the visible area)
        self.planes = list(planes)

    # -- allocator-facing geometry (reference picture.c:46-49: padded to
    # 128-aligned dimensions so edge tx/pred blocks can overshoot) -----
    def dtype(self):
        return np.uint8 if self.bpc == 8 else np.uint16

    def plane_shapes(self):
        aw = (self.w + 127) & ~127
        ah = (self.h + 127) & ~127
        shapes = [(ah, aw)]
        if self.layout != 0:
            cw = (aw + self.ss_hor) >> self.ss_hor
            chh = (ah + self.ss_ver) >> self.ss_ver
            shapes += [(chh, cw), (chh, cw)]
        return shapes

    def _check_planes(self, planes):
        shapes = self.plane_shapes()
        if len(planes) != len(shapes):
            raise ValueError("allocator returned wrong plane count")
        for p, s in zip(planes, shapes):
            if p.shape != s or p.dtype != self.dtype():
                raise ValueError(
                    f"allocator plane {p.shape}/{p.dtype} != {s}/"
                    f"{self.dtype().__name__}")
            # any strided layout is fine (e.g. --negstride bottom-up
            # views); only writability is required
            if not p.flags["WRITEABLE"]:
                raise ValueError("allocator planes must be writable")

    def release(self) -> None:
        """Return allocator-owned buffers (reference
        dav1d_picture_unref -> release_picture_callback)."""
        if self.allocator is not None and \
                hasattr(self.allocator, "release_picture_data"):
            self.allocator.release_picture_data(self)
        self.planes = []
        self.dev = None
        self.dev_rep = None
        self.dev_c = None
        self.dev_mcpad = None


class PicturePool:
    """Recycling picture allocator (the reference's internal buffer
    pool, src/mem.c dav1d_mem_pool + picture.c pooled path): released
    picture buffers are reused for later pictures of the same geometry
    instead of reallocated. Install via Settings(allocator=PicturePool()).
    Thread-safe; an optional max_size bounds retained buffer sets."""

    def __init__(self, max_size: int = 16):
        self._free = {}          # (shape-tuple, dtype) -> [plane lists]
        self._lock = threading.Lock()
        self.max_size = max_size
        self.hits = 0
        self.misses = 0

    def _key(self, pic):
        return (tuple(pic.plane_shapes()), pic.dtype().__name__)

    def alloc_picture_data(self, pic):
        key = self._key(pic)
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                self.hits += 1
                planes = bucket.pop()
                pic.allocator_data = key
                return planes
            self.misses += 1
        planes = [np.empty(s, pic.dtype()) for s in pic.plane_shapes()]
        pic.allocator_data = key
        return planes

    def release_picture_data(self, pic):
        key = pic.allocator_data
        if key is None or not pic.planes:
            return
        with self._lock:
            bucket = self._free.setdefault(key, [])
            if sum(len(b) for b in self._free.values()) < self.max_size:
                bucket.append(list(pic.planes))
