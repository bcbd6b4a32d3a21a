"""In-loop filter chain on the device.

Runs deblock -> CDEF -> super-res -> loop restoration as one
device-resident sequence (port of dav1d_tpu's recon/filters.py
run_filter_chain_device): the chain starts from the picture's device
planes (`pic.dev`, an inter frame's Stage B output) or uploads the host
planes once, every filter consumes the previous filter's tensors (the
pre-CDEF snapshot for LR is the deblock output kept alive, resized with
the planes on a super-res frame), the final planes stay on the device
as `pic.dev` of the final picture (a new, output-width one on a
super-res frame) for later frames' references, and pixels download
once at the end, queued on the current stream and materialized by
ops.device.fetch_pic_host.

A stage's utils.timing phase holds its host work and its launches'
enqueue, not its device time.
"""
from __future__ import annotations

from ..ops.device import queue_plane_fetch, upload_planes
from ..utils import timing


def enabled_stages(plan, inloop_filters):
    """(deblock, CDEF, super-res, LR): whether each stage runs on this
    frame under the Settings' inloop_filters mask."""
    f = plan.f
    fh = f.frame_hdr
    lflf = fh.loopfilter
    do_deblock = bool(inloop_filters & 1) and \
        bool(lflf.level_y[0] or lflf.level_y[1])
    cd = fh.cdef
    do_cdef = bool(inloop_filters & 2) and bool(f.seq_hdr.cdef) and \
        any(cd.y_strength[i] or cd.uv_strength[i]
            for i in range(1 << cd.n_bits))
    do_sr = fh.width[0] != fh.width[1]
    do_lr = bool(inloop_filters & 4) and \
        any(t != 0 for t in fh.restoration.type)
    return do_deblock, do_cdef, do_sr, do_lr


def run_filter_chain_device(pic, plan, inloop_filters, device):
    """Apply the enabled in-loop filters on `device`; the final
    picture's host planes become current at its first host consumer.
    Returns the final Picture: on a super-res frame a new one of the
    output width (pic's device planes are dropped), else pic."""
    do_deblock, do_cdef, do_sr, do_lr = enabled_stages(plan, inloop_filters)
    if not (do_deblock or do_cdef or do_sr or do_lr):
        if pic.dev is not None:     # an inter frame: fetch its planes
            _keep_and_fetch(pic, pic.dev)
        return pic              # else the host planes from recon are final

    if pic.dev is not None:
        planes = pic.dev
    else:
        with timing.phase("filters.upload"):
            planes = upload_planes(pic.planes, device)

    if do_deblock:
        from ..ops.lf import deblock_planes_device
        with timing.phase("filters.deblock"):
            planes = deblock_planes_device(planes, plan, pic.bpc)

    pre_cdef = planes if do_lr else None   # post-deblock lpf snapshot

    if do_cdef:
        from ..ops.cdef import cdef_planes_device
        with timing.phase("filters.cdef"):
            planes = cdef_planes_device(planes, plan, pic.bpc)

    out_pic = pic
    if do_sr:
        from ..ops.superres import superres_planes_device
        with timing.phase("filters.superres"):
            out_pic, planes, pre_cdef = superres_planes_device(
                planes, pre_cdef, plan, pic)
        pic.dev = None          # the coded-width picture is dropped
        pic.dev_c = None

    if do_lr:
        from ..ops.lr import lr_planes_device
        with timing.phase("filters.lr"):
            planes = lr_planes_device(planes, pre_cdef, plan, pic.bpc)

    _keep_and_fetch(out_pic, planes)
    return out_pic


def _keep_and_fetch(pic, planes):
    """Keep the final planes on the device for later frames'
    references, cast them down and queue the device->host copy; the
    first host consumer (output boundary, muxer) waits for it."""
    pic.dev = planes
    pic.dev_c = None
    with timing.phase("filters.fetch_queue"):
        pic.pending_fetch = queue_plane_fetch(planes, pic.bpc)
    pic.host_stale = True
