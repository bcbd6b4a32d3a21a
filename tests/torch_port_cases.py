"""Shared inputs of the PyTorch-port parity tests: small synthetic intra
streams with every in-loop filter on, parsed by both packages."""
import numpy as np

from tools.streamgen.gen import generate_intra_stream

# the tests/test_e2e_big.py filter set: deblock, CDEF, LR (luma
# switchable Wiener/SGR, chroma Wiener)
FILTERS = dict(lf_levels=(28, 28, 16, 16),
               cdef_params=(2, 1, [9, 25], [5, 13]), lr_types=(1, 2, 2))

STREAMS = {
    "8bit-420": dict(w=160, h=96, n_frames=2, seed=31),
    "10bit-420": dict(w=128, h=96, n_frames=2, seed=32, hbd=1),
    "8bit-444-tiles": dict(w=192, h=128, n_frames=2, seed=33, layout=3,
                           tile_log2_cols=1),
}


def stream(name):
    cfg = dict(STREAMS[name])
    w, h = cfg.pop("w"), cfg.pop("h")
    data, _ = generate_intra_stream(w, h, **cfg, **FILTERS)
    return data


def frame_planes(name):
    """Per frame: (dav1d_tpu plan, port plan, bitdepth, reconstructed
    int32 planes, dav1d_tpu-deblocked int32 planes)."""
    from dav1d_tpu.bitstream.ivf import IvfReader
    from dav1d_tpu.decoder import ObuStreamDecoder
    from dav1d_tpu.ops.lf import deblock_planes_device
    from dav1d_tpu.recon.intra_ref import reconstruct_intra_frame
    from dav1d_tpu_torch.decoder import ObuStreamDecoder as PortDecoder

    dj, dt = ObuStreamDecoder(do_recon=False), PortDecoder(do_recon=False)
    out = []
    for fr in IvfReader(stream(name)):
        for pj, pt in zip(dj.decode_temporal_unit(fr.data),
                          dt.decode_temporal_unit(fr.data)):
            pic = reconstruct_intra_frame(pj)
            planes = [np.asarray(p, np.int32) for p in pic.planes]
            dbk = [np.asarray(a) for a in
                   deblock_planes_device(planes, pj, pic.bpc)]
            out.append((pj, pt, pic.bpc, planes, dbk))
    assert out
    return out


def deblock_tiled_plain(entries, lut_e, lut_i, bd, tile=64, halo=12):
    """csrc/deblock.cu's decomposition of a frame's deblock, in plain
    torch: every tile x tile output tile of every plane deblocked (both
    directions, ops/lf.py deblock_frame_plain) on its own crop with a
    halo of `halo` pixels, zeros and inactive maps outside the plane,
    and the crop's interior kept. Equal to deblocking the whole planes
    exactly when the halo covers every edge that writes into a tile."""
    import torch
    from dav1d_tpu_torch.ops.lf import deblock_frame_plain
    out = []
    for plane, luma, vmaps, hmaps in entries:
        H, W = plane.shape
        res = torch.empty_like(plane)
        n = tile + 2 * halo
        for r0 in range(0, H, tile):
            for c0 in range(0, W, tile):
                y0, x0 = r0 - halo, c0 - halo
                ys, xs = max(y0, 0), max(x0, 0)
                ye, xe = min(y0 + n, H), min(x0 + n, W)
                crop = torch.zeros((n, n), dtype=plane.dtype)
                crop[ys - y0:ye - y0, xs - x0:xe - x0] = plane[ys:ye, xs:xe]
                maps = []
                for m in (vmaps, hmaps):
                    cls = torch.full((n // 4, n // 4), -1, dtype=torch.int8)
                    L = torch.zeros((n // 4, n // 4), dtype=torch.uint8)
                    sl = (slice((ys - y0) // 4, (ye - y0) // 4),
                          slice((xs - x0) // 4, (xe - x0) // 4))
                    cls[sl] = m[0][ys // 4:ye // 4, xs // 4:xe // 4]
                    L[sl] = m[1][ys // 4:ye // 4, xs // 4:xe // 4]
                    maps.append((cls, L))
                got = deblock_frame_plain([(crop, luma, *maps)], lut_e, lut_i,
                                          bd)[0]
                ih, iw = min(tile, H - r0), min(tile, W - c0)
                res[r0:r0 + ih, c0:c0 + iw] = got[halo:halo + ih,
                                                  halo:halo + iw]
        out.append(res)
    return out
