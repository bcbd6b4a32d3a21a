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


def _frame_tiled_plain(kind, planes, tables, bd, tw):
    """csrc/lr_wiener.cu's or csrc/lr_sgr.cu's addressing of a frame's
    Wiener or SGR pass (kind), in plain torch: per block (item, first
    output column c0) of lr.item_blocks, the window's rows from the
    item's row table (a row r >= Hp from row r - Hp of pre) and its
    columns clamp(colbase + c0 + c, 0, w - 1) of the unpadded planes,
    the item's filter over tw output columns (lr._wiener_math or
    lr._sgr_math), written under the item's rows and the tile's columns
    into each plane's dst in place. planes and tables as lr.wiener_frame
    / lr.sgr_frame take them."""
    import torch
    from dav1d_tpu_torch.ops import lr
    from dav1d_tpu_torch.ops.device import device_tables
    items, rowt = tables
    blocks = lr.item_blocks(items)
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
        hmax = rowt.shape[1] - 6
        if kind == "wiener":
            vals = lr._wiener_math(S, T(it[:, 6:13]).int(),
                                   T(it[:, 13:20]).int(), hmax, tw, bd)
        else:
            vals = lr._sgr_math(S, *(T(it[:, k]).int() for k in range(6, 10)),
                                hmax, tw, bd,
                                device_tables("cpu")["sgr_x_by_x"])
        lr._write_back(dst, vals, T(it[:, 2]), T(it[:, 3] + c0), T(it[:, 4]),
                       T(np.minimum(tw, it[:, 5] - c0)))


def wiener_frame_tiled_plain(planes, tables, bd, tw=64):
    """_frame_tiled_plain of a frame's Wiener pass."""
    _frame_tiled_plain("wiener", planes, tables, bd, tw)


def sgr_frame_tiled_plain(planes, tables, bd, tw=64):
    """_frame_tiled_plain of a frame's SGR pass."""
    _frame_tiled_plain("sgr", planes, tables, bd, tw)


def _i32(*arrays):
    """Raise unless every value fits int32 (the kernel's type there)."""
    for a in arrays:
        a = np.asarray(a)
        assert a.size == 0 or (a.min() >= -2 ** 31 and a.max() < 2 ** 31)


def sgr_separable_plain(S, s0, s1, w0, w1, bd, xbyx, threads=512):
    """csrc/lr_sgr.cu's arithmetic for one block, in numpy: S is its
    window ((ohs + 6) x (cw + 6), int64), xbyx the x_by_x table. Box
    sums separable: per strip (threads // (cw + 2) strips of an even
    number of rows), each A/B column slides down the window rows from 3
    rows before the strip's first box, the 3- and 5-wide sums of the
    last 3 / 5 rows kept, and emits the boxes that end in the strip's
    rows (each once: checked);
    then the blend per strip of threads // cw strips of row pairs, the
    3x3 weighted sums of A and B as 3 x (three rows' 3-wide sums) + the
    middle row's + the centres above and below, from a 3-row window,
    and box5's 6/5 sums one per row pair. Checks that every sum the
    kernel keeps in int32 fits it. Returns the (ohs, cw) outputs."""
    S = np.asarray(S, np.int64)
    xbyx = np.asarray(xbyx, np.int64)
    rows, cols = S.shape
    ohs, cw = rows - 6, cols - 6
    bdm8 = bd - 8
    bw = cw + 2
    nj = (ohs + 1) // 2 + 1

    def calc_ab(sq, sm, s, nn, one_by_x):
        _i32(sq, sm)
        a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
        b = (sm + ((1 << bdm8) >> 1)) >> bdm8
        _i32(a * nn, b * b)
        p = np.maximum(a * nn - b * b, 0)
        x = xbyx[np.minimum((p * s + (1 << 19)) >> 20, 255)]
        A = (x * sm * one_by_x + (1 << 11)) >> 12
        _i32(A)
        assert x.max() <= 255
        return A, x

    A3 = np.zeros((ohs + 2, bw), np.int64)
    B3 = np.zeros_like(A3)
    A5 = np.zeros((nj, bw), np.int64)
    B5 = np.zeros_like(A5)
    n3 = np.zeros(ohs + 2, int)
    n5 = np.zeros(nj, int)
    strips = threads // bw
    per = (-(-(ohs + 3) // strips) + 1) & ~1
    for q in range(strips):
        e0 = 3 + q * per
        e1 = min(ohs + 6, e0 + per)
        if e0 >= e1:
            continue
        z = np.zeros(bw, np.int64)
        h3, q3, h5, q5 = [z] * 2, [z] * 2, [z] * 4, [z] * 4
        for r in range(e0 - 3, e1):
            v = [S[r, k:k + bw] for k in range(5)]
            h3r = v[1] + v[2] + v[3]
            q3r = v[1] ** 2 + v[2] ** 2 + v[3] ** 2
            h5r, q5r = h3r + v[0] + v[4], q3r + v[0] ** 2 + v[4] ** 2
            if r >= e0:
                if w1 and r <= ohs + 4:
                    A3[r - 3], B3[r - 3] = calc_ab(
                        q3[0] + q3[1] + q3r, h3[0] + h3[1] + h3r, s1, 9, 455)
                    n3[r - 3] += 1
                if w0 and r % 2 == 0 and 4 <= r < 2 * nj + 4:
                    A5[(r - 4) // 2], B5[(r - 4) // 2] = calc_ab(
                        sum(q5) + q5r, sum(h5) + h5r, s0, 25, 164)
                    n5[(r - 4) // 2] += 1
            h3, q3 = [h3[1], h3r], [q3[1], q3r]
            h5, q5 = h5[1:] + [h5r], q5[1:] + [q5r]
    assert (n3 == (1 if w1 else 0)).all() and (n5 == (1 if w0 else 0)).all()

    def row3(M, k):
        return M[k, 0:cw] + M[k, 1:cw + 1] + M[k, 2:cw + 2], M[k, 1:cw + 1]

    def hwin(M, j):
        return 6 * M[j, 1:cw + 1] + 5 * (M[j, 0:cw] + M[j, 2:cw + 2])

    out = np.full((ohs, cw), -1, np.int64)
    strips = threads // cw
    per = ((-(-ohs // strips)) + 1) & ~1
    for q in range(strips):
        r0, r1 = q * per, min(ohs, q * per + per)
        if r0 >= r1:
            continue
        a3 = [row3(A3, r0), row3(A3, r0 + 1)]
        b3 = [row3(B3, r0), row3(B3, r0 + 1)]
        a5, b5 = hwin(A5, r0 // 2), hwin(B5, r0 // 2)
        for r in range(r0, r1, 2):
            a5n, b5n = hwin(A5, r // 2 + 1), hwin(B5, r // 2 + 1)
            for rr in range(r, min(r + 2, r1)):
                px = S[rr + 3, 3:3 + cw]
                v = np.zeros(cw, np.int64)
                if w1:
                    a3.append(row3(A3, rr + 2))
                    b3.append(row3(B3, rr + 2))
                    wa = 3 * (a3[0][0] + a3[1][0] + a3[2][0]) + a3[1][0] + \
                        a3[0][1] + a3[2][1]
                    wb = 3 * (b3[0][0] + b3[1][0] + b3[2][0]) + b3[1][0] + \
                        b3[0][1] + b3[2][1]
                    _i32(wa, wb * px)
                    v += w1 * ((wa - wb * px + (1 << 8)) >> 9)
                    a3, b3 = a3[1:], b3[1:]
                if w0:
                    if rr & 1:
                        t5 = (a5n - b5n * px + (1 << 7)) >> 8
                    else:
                        _i32(a5 + a5n, (b5 + b5n) * px)
                        t5 = (a5 + a5n - (b5 + b5n) * px + (1 << 8)) >> 9
                    v += w0 * t5
                _i32(v)
                out[rr] = np.clip(px + ((v + (1 << 10)) >> 11), 0,
                                  (1 << bd) - 1)
            a5, b5 = a5n, b5n
    assert (out >= 0).all()
    return out


def obmc_assigned_plain(planes, top, left, bd, fb, om, max_blocks,
                        warps=3):
    """csrc/mc_obmc.cu's assignment of laps to warps, in plain torch: a
    grid of min(max_blocks, ceil(max(top, left laps) / warps)) blocks of
    `warps` warps; warp g of the grid blends laps g, g + G, g + 2 G, ..
    (G the grid's warps) of the top laps, all warps meet at the
    grid-wide barrier, then the same over the left laps. The laps of a
    direction go in an order no warp would keep (each round's warps in
    reverse) through ops/mc_obmc.py obmc_plain one lap at a time.
    Checks that every lap is blended once. planes as obmc_cuda takes
    them, in place; top / left (n, 13) int32 tensors or None."""
    from dav1d_tpu_torch.ops.mc_obmc import obmc_plain
    n = [0 if t is None else len(t) for t in (top, left)]
    blocks = min(max_blocks, -(-max(n) // warps))
    G = blocks * warps
    for t, jobs, m in ((1, top, n[0]), (0, left, n[1])):
        done = np.zeros(m, int)
        for k in range(-(-m // G) if m else 0):
            for g in reversed(range(G)):
                i = g + k * G
                if i < m:
                    refs, plane, rh, rw = planes[int(jobs[i, 1])]
                    obmc_plain(refs, jobs[i:i + 1], plane, rh, rw, bd, fb,
                               om, t)
                    done[i] += 1
        assert (done == 1).all()        # the barrier: this direction ends
    return [p for _, p, _, _ in planes]
