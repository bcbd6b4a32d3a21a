"""Shared inputs of the PyTorch-port parity tests: small synthetic intra
streams with every in-loop filter on (4:2:0 at 8, 10 and 12 bit, 4:2:2,
4:4:4 and monochrome), parsed by both packages; and the kernels'
decompositions (deblock and CDEF tiles) in plain torch."""
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
    "8bit-422": dict(w=96, h=64, n_frames=2, seed=34, layout=2),
    "12bit-420": dict(w=96, h=64, n_frames=2, seed=35, hbd=2),
    "8bit-mono": dict(w=96, h=64, n_frames=2, seed=36, monochrome=1),
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



def cdef_tiled_plain(planes, maps, Hy, Wy, layout, bd, damping, proj,
                     tile=64, apron=2, seed=0):
    """csrc/cdef.cu's decomposition of a frame's CDEF, in plain torch:
    per tile x tile luma tile (and its co-located chroma tiles), the
    8x8 blocks' directions searched in the tile alone
    (ops/cdef.py block_params_plain), and each plane's tile filtered
    (filter_plane_plain) from a window that holds the plane only within
    `apron` pixels of the tile (FILL outside the crop, as the kernel
    stages it), and random pixels and block parameters beyond; the
    crop's pixels kept, the rest copied through. Equal to
    cdef_planes_plain exactly when no tap of a tile's pixels reaches
    past the apron and no pixel depends on another tile's directions."""
    import torch
    from dav1d_tpu_torch.ops.cdef import (FILL, block_params_plain,
                                          filter_plane_plain)
    rng = np.random.default_rng(seed)
    ss_ver, ss_hor = int(layout == 1), int(layout != 3)
    out = [p.clone() for p in planes]
    for ty in range(0, Hy, tile):
        for tx in range(0, Wy, tile):
            by0, bx0 = ty // 8, tx // 8
            by1, bx1 = min(Hy, ty + tile) // 8, min(Wy, tx + tile) // 8
            sub = maps[:, by0:by1, bx0:bx1]
            adj, y_dir, uv_dir = block_params_plain(
                planes[0][ty:by1 * 8, tx:bx1 * 8], sub, layout, bd, proj)
            for p, plane in enumerate(planes):
                sv, sh = (ss_ver, ss_hor) if p else (0, 0)
                bv, bh = 8 >> sv, 8 >> sh
                ch, cw = Hy >> sv, Wy >> sh
                th, tw = (by1 - by0) * bv, (bx1 - bx0) * bh
                y0, x0 = ty >> sv, tx >> sh
                # the window: one block of junk around the tile, the plane
                # (or FILL outside the crop) within the apron
                wh, ww = th + 2 * bv, tw + 2 * bh
                win = rng.integers(0, 1 << bd, (wh, ww)).astype(np.int32)
                yy = np.arange(y0 - apron, y0 + th + apron)[:, None]
                xx = np.arange(x0 - apron, x0 + tw + apron)[None, :]
                inside = (yy >= 0) & (yy < ch) & (xx >= 0) & (xx < cw)
                src = plane.numpy()[np.clip(yy, 0, ch - 1),
                                    np.clip(xx, 0, cw - 1)]
                win[bv - apron:bv + th + apron, bh - apron:bh + tw + apron] = \
                    np.where(inside, src, FILL)
                own = (adj, sub[1], y_dir, sub[4]) if p == 0 else \
                    (sub[2], sub[3], uv_dir, sub[5])
                grid = []
                for m in own:
                    g = torch.from_numpy(rng.integers(
                        0, 8, (by1 - by0 + 2, bx1 - bx0 + 2)).astype(
                            np.int32))
                    g[1:-1, 1:-1] = m
                    grid.append(g)
                got = filter_plane_plain(torch.from_numpy(win), grid[0],
                                         grid[1], grid[2],
                                         damping - (p > 0), wh, ww, bv, bh,
                                         grid[3], bd)
                out[p][y0:y0 + th, x0:x0 + tw] = got[bv:bv + th, bh:bh + tw]
    return out


def wiener_frame_tiled_plain(planes, tables, bd, tw=64):
    """csrc/lr_wiener.cu's addressing of a frame's Wiener pass, in plain
    torch: per block (item, first output column c0) of lr.wiener_blocks,
    the window's rows from the item's row table (a row r >= Hp from row
    r - Hp of pre) and its columns clamp(colbase + c0 + c, 0, w - 1) of
    the unpadded planes, the item's taps over tw output columns
    (lr._wiener_math), written under the item's rows and the tile's
    columns into each plane's dst in place. planes and tables as
    lr.wiener_frame takes them."""
    import torch
    from dav1d_tpu_torch.ops import lr
    items, rowt = tables
    blocks = lr.wiener_blocks(items)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64))
    for p, (src, pre, dst, w, _hmax) in enumerate(planes):
        blk = blocks[items[blocks[:, 0], 0] == p]
        if not len(blk):
            continue
        it, c0 = items[blk[:, 0]].astype(np.int64), blk[:, 1]
        cols = np.clip(it[:, 1, None] + c0[:, None] +
                       np.arange(tw + 6)[None, :], 0, w - 1)
        S = torch.cat([src, pre])[T(rowt[blk[:, 0]])[:, :, None],
                                  T(cols)[:, None, :]]
        vals = lr._wiener_math(S, T(it[:, 6:13]).int(), T(it[:, 13:20]).int(),
                               rowt.shape[1] - 6, tw, bd)
        lr._write_back(dst, vals, T(it[:, 2]), T(it[:, 3] + c0), T(it[:, 4]),
                       T(np.minimum(tw, it[:, 5] - c0)))
