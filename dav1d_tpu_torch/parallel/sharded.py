"""Multi-device decode sharding: the mesh, the halo exchange and the
sharded checks.

Port of dav1d_tpu's parallel/sharded.py (and, in place of its
`utils/shmap.py` shard_map shim, a loop over the shards). Decode
parallelism maps onto a ('gop', 'tile') mesh:

- 'tile': Stage-B pixel work column-shards each plane over the mesh's
  shards (recon/sharded_stageb.py). The in-loop filters couple
  neighbouring shards: a vertical deblock edge reads up to 7 and writes
  up to 6 pixels across the boundary (reference
  loopfilter_tmpl.c:37-162; boundary state per decode.c:2732-2740), so
  each shard is extended by HALO real columns of its neighbours
  (`halo_exchange`), filters the boundary edges inside that halo
  redundantly, and an ownership shift of SHIFT columns stitches the
  results back to the owned columns (`stitch`), bit-exactly.
- 'gop': batched residual work data-parallels over the whole mesh
  (`itx_sharded_check`: a frame's largest coefficient bucket split over
  every shard, its residual energy summed across them).

A Mesh is a list of logical shards, each on a torch.device, and one
device may hold several shards (one card, or "cpu" in the tests): the
decode is one process, as dav1d_tpu's single controller is. Halos move
by device-to-device copies (NVLink between cards, on the card when two
shards share it), and each shard's kernels launch on its own device
without a host sync between shards.

`sharded_decode_md5` decodes a stream with the whole Stage-B pipeline
sharded and returns its md5, which must equal `single_device_md5`'s.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

HALO = 32           # px halo each side: covers wide16 reads of every
                    # edge within 2 edge-cols of the trusted region
SHIFT = 8           # ownership shift of the deblock's stitch-back

AXES = (("tile",), ("gop", "tile"))


class Mesh:
    """A mesh of decode shards, the counterpart of jax.sharding.Mesh:
    `devices` a numpy object array of torch.device (one entry a shard;
    an entry may repeat), `axis_names` ("tile",) or ("gop", "tile"),
    one name an axis of `devices`; `shape` maps each name to its
    size."""

    def __init__(self, devices, axis_names=("tile",)):
        axis_names = tuple(axis_names)
        if axis_names not in AXES:
            raise ValueError(f"mesh axes {axis_names}: expected one of "
                             f"{AXES}")
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} for the axes "
                             f"{axis_names}")
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def norm_device(device):
    """torch.device with the CUDA index filled in (the current device
    for a bare "cuda")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def tile_devices(mesh):
    """The mesh flattened to its shards in order (dav1d_tpu's
    _flat_tile_mesh): a list of torch.device."""
    return list(mesh.devices.reshape(-1))


def resolve_mesh(mesh, device):
    """The mesh's shards (tile_devices), checked against the decode's
    device: every shard on a device of the same type, each CUDA device
    present. Raises otherwise: a sharded decode has no fallback."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"sharding_mesh: expected a "
                        f"dav1d_tpu_torch.parallel.sharded.Mesh, got "
                        f"{type(mesh).__name__}")
    out = []
    for d in tile_devices(mesh):
        if d.type != device.type:
            raise ValueError(f"mesh device {d} is not of the decode's "
                             f"device type {device.type!r}")
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: CUDA is not "
                                   "available")
            d = norm_device(d)
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh device {d} is not present "
                                   f"({torch.cuda.device_count()} CUDA "
                                   "devices)")
        out.append(d)
    return out


def distinct(devices):
    """The distinct devices of a list, in first-seen order."""
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def window(shards, s, left, right):
    """Shard s of a column-sharded plane (T (H, sw) int32 tensors, shard
    j on its device) with `left` real columns of its left neighbour and
    `right` of its right one, zeros past the mesh's edges: one new
    contiguous (H, left + sw + right) tensor on shard s's device (its
    rows 16-byte aligned when sw, left and right are multiples of 4)."""
    own = shards[s]
    H, sw = own.shape
    if left > sw or right > sw:
        raise ValueError(f"halo of {left}/{right} columns over shards of "
                         f"{sw}")
    out = torch.empty((H, left + sw + right), dtype=own.dtype,
                      device=own.device)
    out[:, left:left + sw] = own
    if left:
        if s > 0:
            out[:, :left] = shards[s - 1][:, sw - left:]
        else:
            out[:, :left] = 0
    if right:
        if s + 1 < len(shards):
            out[:, left + sw:] = shards[s + 1][:, :right]
        else:
            out[:, left + sw:] = 0
    return out


def halo_exchange(shards, halo=HALO):
    """Every shard extended by `halo` real neighbour columns on both
    sides, zeros at the mesh's edges (dav1d_tpu's _halo_exchange and its
    two ppermutes): a list of T (H, sw + 2 halo) tensors."""
    return [window(shards, s, halo, halo) for s in range(len(shards))]


def stitch(exts, sw, halo=HALO, shift=SHIFT):
    """The ownership-shifted stitch-back of a filter run on halo
    extended shards (T (H, sw + 2 halo) results): shard s keeps its own
    result for its first sw - shift owned columns and takes the last
    shift from its right neighbour's result (the last shard its own),
    as dav1d_tpu's deblock does. Returns T (H, sw) tensors."""
    out = []
    for s, e in enumerate(exts):
        o = torch.empty((e.shape[0], sw), dtype=e.dtype, device=e.device)
        o[:, :sw - shift] = e[:, halo:halo + sw - shift]
        if s + 1 < len(exts):
            o[:, sw - shift:] = exts[s + 1][:, halo - shift:halo]
        else:
            o[:, sw - shift:] = e[:, halo + sw - shift:halo + sw]
        out.append(o)
    return out


def _pad_halo(a, he, fill):
    return np.pad(a, ((0, 0), (he, he)), constant_values=fill)


def _shard_plane_deblock(mesh, plane, vmaps, hmaps, lut_e, lut_i, bd,
                         luma):
    """Column-sharded single-plane deblock over the mesh's shards.
    plane: (Hp, Wp) int32 numpy; vmaps / hmaps: (cls, L) numpy maps in
    plane orientation (ops/lf.py's convention; dav1d_tpu takes hmaps
    transposed), grown here to the shard grid; lut_e / lut_i: (64,)
    int32 numpy. Each shard runs the deblock kernel (ops/lf.py
    deblock_frame) on its halo-extended plane. Returns the filtered
    (Hp, Wp) int32 numpy plane."""
    from ..ops import lf
    from ..ops.cuda_build import device_guard
    devices = tile_devices(mesh)
    T = len(devices)
    Hp, Wp = plane.shape
    sw = max(HALO, -(-Wp // T // 32) * 32)      # shard width, 32-aligned
    swe, he, n4h = sw // 4, HALO // 4, Hp // 4
    pl = np.zeros((Hp, sw * T), np.int32)
    pl[:, :Wp] = plane
    vm = [_pad_halo(a, he, f) for a, f in
          zip(lf._pad_maps(vmaps, n4h, T * swe), (-1, 0))]
    hm = [_pad_halo(a, he, f) for a, f in
          zip(lf._pad_maps(hmaps, n4h, T * swe), (-1, 0))]
    shards = [torch.from_numpy(pl[:, s * sw:(s + 1) * sw].copy()).to(d)
              for s, d in enumerate(devices)]
    exts = halo_exchange(shards)
    outs = []
    for s, d in enumerate(devices):
        def part(a):
            return np.ascontiguousarray(a[:, s * swe:(s + 1) * swe + 2 * he])
        with device_guard(d):
            (_, _, v, h), = lf.upload_maps(
                [(0, luma, tuple(map(part, vm)), tuple(map(part, hm)))], d)
            outs.append(lf.deblock_frame(
                [(exts[s], luma, v, h)],
                torch.from_numpy(np.asarray(lut_e, np.int32)).to(d),
                torch.from_numpy(np.asarray(lut_i, np.int32)).to(d), bd)[0])
    res = stitch(outs, sw)
    return np.concatenate([r.cpu().numpy() for r in res], axis=1)[:, :Wp]


def deblock_sharded(pic, plan, mesh) -> None:
    """Sharded equivalent of ops/lf.py deblock_planes_device on a
    picture's host planes: filters pic.planes in place, each deblocked
    plane column-sharded over the mesh's shards with halo exchange."""
    from ..ops import lf
    from ..ops.lf_ref import calc_eih
    maps = lf.frame_maps(plan, [p.shape for p in pic.planes])
    lut_e, lut_i = calc_eih(plan.f.frame_hdr.loopfilter.sharpness)
    for pi, luma, vm, hm in maps:
        res = _shard_plane_deblock(mesh, pic.planes[pi].astype(np.int32),
                                   vm, hm, lut_e, lut_i, pic.bpc, luma)
        pic.planes[pi][:] = res.astype(pic.planes[pi].dtype)


def _itx_bucket(plan):
    """The frame's largest bucket of coefficient blocks of one (tx,
    txtp), WHT excluded, from its native Stage-A records: (tx, txtp,
    pool offsets (B,) int64, the frame's int32 coefficient pool), or
    None without one."""
    from ..entropy import levels as lv
    from ..entropy.native_tile import CF_EOB, CF_OFF, CF_TX, CF_TXTP
    tiles = getattr(plan, "native_tiles", None)
    if not tiles:
        raise ValueError("itx_sharded_check needs the frame's native "
                         "Stage-A records")
    recs, pools, base = [], [], 0
    for t in tiles:
        c = t["coefs"]
        keep = (c[:, CF_EOB] >= 0) & (c[:, CF_TXTP] != lv.WHT_WHT)
        recs.append(np.stack([c[keep, CF_TX], c[keep, CF_TXTP],
                              c[keep, CF_OFF].astype(np.int64) + base], 1))
        used = int(t.get("cf_used", len(t["cf_pool"])))
        pools.append(t["cf_pool"][:used])
        base += used
    recs = np.concatenate(recs)
    if not len(recs):
        return None
    keys, inv, counts = np.unique(recs[:, 0] * 64 + recs[:, 1],
                                  return_inverse=True, return_counts=True)
    k = int(np.argmax(counts))
    sel = recs[inv.reshape(-1) == k]
    return (int(sel[0, 0]), int(sel[0, 1]), sel[:, 2],
            np.concatenate(pools).astype(np.int32))


def _itx_residuals(pool, offs, tx, txtp, bd, device):
    """The residual blocks (n, h, w) int32 of the coefficient blocks at
    `offs` of `pool`, by the residual kernel (ops/itx.py itx_add) on
    `device`: the blocks laid out side by side on a plane of
    1 << (bd - 1), each residual the plane after the add less that
    base."""
    from ..entropy import levels as lv
    from ..ops import itx
    from ..ops.cuda_build import device_guard
    t = lv.TXFM_INFO[tx]
    bh, bw = 4 * t.h, 4 * t.w
    n = len(offs)
    per = max(1, 256 // bw)
    rows = max(1, -(-n // per))
    base = 1 << (bd - 1)
    i = np.arange(n)
    ridx, cidx = itx._txtp_kidx_map()[tx, txtp]
    jobs = np.stack([np.full(n, tx), np.full(n, ridx), np.full(n, cidx),
                     (i // per) * bh, (i % per) * bw, offs],
                    1).astype(np.int32)
    with device_guard(device):
        plane = torch.full((rows * bh, per * bw), base, dtype=torch.int32,
                           device=device)
        if n:
            itx.itx_add(torch.from_numpy(pool).to(device),
                        torch.from_numpy(jobs).to(device), plane, bd)
        res = plane - base
    return res.reshape(rows, bh, per, bw).permute(0, 2, 1, 3).reshape(
        rows * per, bh, bw)[:n]


def itx_sharded_check(plan, bitdepth, mesh):
    """Shard the frame's largest real coefficient bucket over every shard
    of the mesh (batch data-parallel over ('gop', 'tile')), run each
    part through the residual kernel on its shard's device, and check
    that the residuals are bit-identical to the whole bucket's on one
    device (the mesh's first); returns the residual energy (sum of
    |residual|), summed per shard and across shards in float32, as
    dav1d_tpu's psum does."""
    got = _itx_bucket(plan)
    if got is None:
        return 0.0
    tx, txtp, offs, pool = got
    devices = tile_devices(mesh)
    parts, energy = [], np.float32(0)
    for d, o in zip(devices, np.array_split(offs, len(devices))):
        r = _itx_residuals(pool, o, tx, txtp, bitdepth, d)
        energy = np.float32(energy + np.float32(
            r.abs().to(torch.float32).sum().item()))
        parts.append(r.cpu())
    ref = _itx_residuals(pool, offs, tx, txtp, bitdepth, devices[0]).cpu()
    if not torch.equal(torch.cat(parts), ref):
        raise AssertionError("sharded itx diverged from single-device itx")
    return float(energy)


def _decode_md5(data: bytes, settings) -> str:
    from ..bitstream.ivf import IvfReader
    from ..decoder import ObuStreamDecoder
    from ..utils.muxers import Md5Muxer
    dec = ObuStreamDecoder(settings=settings)
    mux = Md5Muxer()
    for fr in IvfReader(data):
        for _p, pic in dec.decode_temporal_unit(fr.data):
            if pic is not None:
                mux.write_picture(pic)
    return mux.digest()


def sharded_decode_md5(data: bytes, mesh) -> str:
    """Decode an IVF stream with the whole Stage-B pixel pipeline (MC
    passes, deblock, CDEF, super-res, loop restoration) column-sharded
    over the mesh's shards (recon/sharded_stageb.py), on the mesh's
    device type; returns the output md5."""
    from ..api import Settings
    dev = tile_devices(mesh)[0]
    return _decode_md5(data, Settings(n_threads=1, sharding_mesh=mesh,
                                      device=dev.type))


def single_device_md5(data: bytes, device="cuda") -> str:
    """The same decode on one device (the sharded decode's oracle)."""
    from ..api import Settings
    return _decode_md5(data, Settings(n_threads=1, device=device))


# the stream of tests/test_multichip.py's RICH config (256x128, 2x2
# tiles, every inter tool and the full filter chain), committed
DRYRUN_STREAM = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tests", "data", "torch_golden", "mesh-rich-256x128.ivf")


def round_robin(n, device="cuda"):
    """n shards over the devices of a type: round-robin over every CUDA
    card present, or all on the CPU."""
    if torch.device(device).type == "cuda":
        k = torch.cuda.device_count()
        if not k:
            raise RuntimeError("no CUDA device for the mesh")
        return [torch.device("cuda", i % k) for i in range(n)]
    return [torch.device("cpu")] * n


def dryrun_multichip(n_devices: int, device="cuda", path=DRYRUN_STREAM):
    """Decode a real multi-tile stream (every inter tool, the full filter
    chain) on one device and with the whole Stage-B pipeline sharded
    over an n-shard mesh (round_robin); assert md5 equality and print a
    wall-clock scaling probe, then the scaling series (the port's
    counterpart of __graft_entry__.dryrun_multichip)."""
    devs = np.array(round_robin(n_devices, device), dtype=object)
    gop = 2 if n_devices % 2 == 0 else 1
    mesh = Mesh(devs.reshape(gop, n_devices // gop), ("gop", "tile"))
    data = open(path, "rb").read()
    ref_md5 = single_device_md5(data, device)
    t0 = time.perf_counter()
    sh_md5 = sharded_decode_md5(data, mesh)
    dt = time.perf_counter() - t0
    assert sh_md5 == ref_md5, \
        f"sharded decode diverged: {sh_md5} != {ref_md5}"
    print(f"dryrun scaling probe: {n_devices} shards on "
          f"{len(distinct(tile_devices(mesh)))} {device} device(s), "
          f"{dt:.2f}s wall", flush=True)
    return _scaling_series(data, n_devices, device)


def _scaling_series(data, n_devices, device):
    """Per shard count, the warm decode's wall (the second of two) and
    fps over the stream's pictures: on one card a cost-of-sharding
    series, not a scaling result."""
    from ..bitstream.ivf import IvfReader
    n_pics = sum(1 for _ in IvfReader(data))
    out, base = [], None
    for c in (c for c in (1, 2, 4, 8) if c <= n_devices):
        mesh = Mesh(np.array(round_robin(c, device), dtype=object))
        sharded_decode_md5(data, mesh)
        t0 = time.perf_counter()
        md5 = sharded_decode_md5(data, mesh)
        dt = time.perf_counter() - t0
        fps = n_pics / dt
        base = base or fps
        out.append({"shards": c, "wall_s": dt, "fps": fps,
                    "efficiency": fps / (base * c), "md5": md5})
        print(f"scaling series: {c} shards, {fps:.3f} fps warm, "
              f"efficiency {fps / (base * c):.2f} (md5 {md5[:8]})",
              flush=True)
    return out
