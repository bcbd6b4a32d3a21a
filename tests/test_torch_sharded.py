"""The port's sharded decode (ROADMAP item 10) on the CPU: a Mesh of
"cpu" shards, each running the plain versions of the port's kernels on
its window of the planes.

- the committed mesh streams (tests/torch_port_cases.py MESH_STREAMS)
  decoded with Settings(sharding_mesh=...) at 1, 2, 4 and 8 shards, on
  ("gop", "tile") and ("tile",) meshes, to dav1d_tpu's recorded
  single_device_md5 (chip_smoke.py MESH_MD5S, tools/torch_mesh_md5s.py)
  and to the
  port's single-device decode;
- `_partition` and `_shard_widths` against dav1d_tpu's on seeded tables;
- `_shard_plane_deblock` against dav1d_tpu's on its virtual CPU mesh,
  and `deblock_sharded` against the single-device deblock;
- the CDEF and LR shard routines on the seeded kernel cases against the
  single-device plain versions, with shard counts that leave the last
  shards padding;
- `itx_sharded_check`: residuals bit-equal to one device's (checked
  inside), the energy the int64 sum of |residual| within float32
  rounding;
- the mesh's checks: axes, device type, a CUDA device not present.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dav1d_tpu_torch.ops import kernel_cases as kc
from dav1d_tpu_torch.parallel import sharded
from dav1d_tpu_torch.parallel.sharded import Mesh
from dav1d_tpu_torch.recon import sharded_stageb as sb
from chip_smoke import MESH_MD5S
from torch_port_cases import GOLDEN_DIR

CPU = torch.device("cpu")


def _data(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        return fh.read()


def _mesh(n, axes):
    devs = np.array([CPU] * n, dtype=object)
    if axes == ("tile",):
        return Mesh(devs, axes)
    gop = 2 if n % 2 == 0 else 1
    return Mesh(devs.reshape(gop, n // gop), axes)


def test_single_device_decode_md5():
    name = "mesh-rich-256x128"
    assert sharded.single_device_md5(_data(name), "cpu") == MESH_MD5S[name]


@pytest.mark.parametrize("axes", [("gop", "tile"), ("tile",)],
                         ids=["gop-tile", "tile"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_decode_rich(n, axes):
    """The RICH stream (every inter frame has intra leftovers: its planes
    come back to the host before the sharded filter chain)."""
    name = "mesh-rich-256x128"
    assert sharded.sharded_decode_md5(_data(name), _mesh(n, axes)) == \
        MESH_MD5S[name]


@pytest.mark.parametrize("n,route", [(8, "emitter"), (3, "python")])
def test_sharded_decode_on_the_shards(n, route, monkeypatch):
    """Inter frames without leftovers (frame 1; frames 2 and 3 have one
    each): the MC passes' planes stay on the shards into the filter
    chain (pic.dev_grid). At 8 shards of 64 columns its 128-wide blocks
    straddle the bands, their jobs reaching into the MC apron; at 3 the
    tables come from the Python collector walk
    (DAV1D_TPU_INTERJOBS=python)."""
    if route == "python":
        monkeypatch.setenv("DAV1D_TPU_INTERJOBS", "python")
    name = "mesh-inter-256x128"
    grid = []
    orig = sb.execute_sharded

    def spy(recon, jobs):
        orig(recon, jobs)
        grid.append(recon.pic.dev_grid)
    sb.execute_sharded = spy
    try:
        got = sharded.sharded_decode_md5(_data(name), _mesh(n, ("tile",)))
    finally:
        sb.execute_sharded = orig
    assert got == MESH_MD5S[name]
    assert grid == [True, False, False]


@pytest.mark.parametrize("n", [4])
def test_sharded_decode_superres(n):
    """Super-res gathers the coded-width planes and re-shards at the
    output width."""
    name = "mesh-superres-192x96"
    assert sharded.sharded_decode_md5(_data(name),
                                      _mesh(n, ("gop", "tile"))) == \
        MESH_MD5S[name]


def _plan(width, out_width, layout):
    return SimpleNamespace(f=SimpleNamespace(
        frame_hdr=SimpleNamespace(width=(width, out_width)),
        ss_hor=int(layout != 3)))


def test_partition_and_widths_match_dav1d_tpu():
    from dav1d_tpu.recon import sharded_stageb as ref
    rng = np.random.default_rng(14)
    for T, sw, apron in ((1, 256, 128), (3, 128, 64), (8, 64, 128),
                         (5, 192, 128)):
        n = int(rng.integers(0, 200))
        tbl = rng.integers(0, 1 << 12, (n, 9)).astype(np.int32)
        tbl[:, 4] = rng.integers(0, T * sw, n)
        for widths in (rng.integers(1, 129, n), 8):
            got = sb._partition(tbl, 4, 3, widths, T, sw, apron)
            want = ref._partition(tbl, 4, 3, widths, T, sw, apron)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for w, ow in ((256, 256), (1920, 1920), (193, 257), (960, 1920)):
        for T in (1, 2, 3, 4, 8):
            for layout in (1, 3):
                plan = _plan(w, ow, layout)
                for out in (False, True):
                    assert sb._shard_widths(plan, T, out) == \
                        ref._shard_widths(plan, T, out)


def _deblock_inputs(rng, h4, w4, bd):
    plane = rng.integers(0, 1 << bd, (4 * h4, 4 * w4)).astype(np.int32)
    flat = rng.random((h4, w4)) < 0.5
    f4 = np.repeat(np.repeat(flat, 4, 0), 4, 1)
    plane = np.where(f4, (plane >> 4) + (1 << (bd - 1)), plane)

    def maps():
        cls = rng.integers(-1, 3, (h4, w4)).astype(np.int8)
        return cls, rng.integers(0, 64, (h4, w4)).astype(np.uint8)
    return plane.astype(np.int32), maps(), maps()


def test_shard_plane_deblock_matches_dav1d_tpu():
    import jax
    from jax.sharding import Mesh as JaxMesh
    from dav1d_tpu.ops.lf import calc_eih
    from dav1d_tpu.parallel.sharded import _shard_plane_deblock as ref
    rng = np.random.default_rng(3)
    plane, vm, hm = _deblock_inputs(rng, 4, 40, 8)
    lut_e, lut_i = calc_eih(2)
    jdev = np.array(jax.devices("cpu")[:3])
    want = ref(JaxMesh(jdev, ("tile",)), plane,
               [a.astype(np.int32) for a in vm],
               [np.ascontiguousarray(a.T).astype(np.int32) for a in hm],
               lut_e, lut_i, 8, True)
    got = sharded._shard_plane_deblock(_mesh(3, ("tile",)), plane, vm, hm,
                                       lut_e, lut_i, 8, True)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def rich_frames():
    """(plan, picture) of the RICH stream's key and first inter frame,
    decoded on the CPU with every in-loop filter off."""
    from dav1d_tpu_torch.api import Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    from dav1d_tpu_torch.decoder import ObuStreamDecoder
    dec = ObuStreamDecoder(settings=Settings(n_threads=1, device="cpu",
                                             inloop_filters=0))
    out = []
    for fr in list(IvfReader(_data("mesh-rich-256x128")))[:2]:
        out += dec.decode_temporal_unit(fr.data)
    return out


@pytest.mark.parametrize("n", [3, 8])
def test_deblock_sharded_matches_one_device(rich_frames, n):
    from dav1d_tpu_torch.ops.device import upload_planes
    from dav1d_tpu_torch.ops.lf import deblock_planes_device
    plan, pic = rich_frames[1]
    want = deblock_planes_device(upload_planes(pic.planes, CPU), plan,
                                 pic.bpc)
    host = SimpleNamespace(planes=[p.copy() for p in pic.planes],
                           bpc=pic.bpc)
    sharded.deblock_sharded(host, plan, _mesh(n, ("tile",)))
    for g, w in zip(host.planes, want):
        assert np.array_equal(g.astype(np.int32), w.numpy())


@pytest.mark.parametrize("layout,geo", [(1, 1), (3, 2), (0, 0)],
                         ids=["420", "444", "mono"])
@pytest.mark.parametrize("n", [3, 8])
def test_cdef_shards_match_plain(layout, geo, n):
    from dav1d_tpu_torch.ops.cdef import cdef_planes
    case = kc.cdef_case_at(10, layout, geo)
    args = (case["maps"], case["Hy"], case["Wy"], layout, case["bd"],
            case["damping"])
    want = cdef_planes([torch.from_numpy(p) for p in case["planes"]],
                       torch.from_numpy(args[0]), *args[1:])
    planes, devs = kc.shard_planes(case["planes"], n, CPU,
                                   int(layout != 3))
    got = sb.cdef_shards(planes, *args, devs)
    assert n * planes[0][0].shape[1] - 64 >= case["planes"][0].shape[1]
    for g, w in zip(got, want):
        assert torch.equal(sb.gather(g, w.shape[1], CPU), w)


@pytest.mark.parametrize("kind", ["wiener", "sgr"])
@pytest.mark.parametrize("n", [3, 8])
def test_lr_shards_match_plain(kind, n):
    """A frame case's Wiener and SGR items (each plane's own valid width
    and units, its first stripes) through lr_shards against one wiener_frame and
    one sgr_frame call over the whole planes (lr_planes_device's
    order)."""
    from dav1d_tpu_torch.ops import lr
    from dav1d_tpu_torch.ops.restore_ref import _sgr_params_tbl
    case = kc.frame_case(12, 1, kind)
    groups = []
    for p, pl in enumerate(case["planes"]):
        # the first 4 stripes: every unit, their edge flags 0..8
        ys = sorted({it[0] for it in pl["items"]})[:4]
        items = [it for it in pl["items"] if it[0] in ys]
        groups.append((p, pl["w"], pl["hmax"], None,
                       {k: [it for it in items
                            if (it[5]["type"] == 2) == (k == "wiener")]
                        for k in ("wiener", "sgr")}))
    cur = [torch.from_numpy(pl["cur"]) for pl in case["planes"]]
    pre = [torch.from_numpy(pl["pre"]) for pl in case["planes"]]
    want = [c.clone() for c in cur]
    for k, run in (("wiener", lr.wiener_frame), ("sgr", lr.sgr_frame)):
        sel = [(p, w, hmax, kinds[k]) for p, w, hmax, _, kinds in groups
               if kinds[k]]
        run([(cur[p], pre[p], want[p], w, hmax) for p, w, hmax, _ in sel],
            lr.frame_tables(k, [(items, hmax, cur[p].shape[0])
                                for p, _, hmax, items in sel],
                            _sgr_params_tbl()), case["bd"])
    cur_s, devs = kc.shard_planes([pl["cur"] for pl in case["planes"]], n,
                                  CPU)
    pre_s, _ = kc.shard_planes([pl["pre"] for pl in case["planes"]], n, CPU)
    assert n * cur_s[0][0].shape[1] - 64 >= cur[0].shape[1]
    got = sb.lr_shards(cur_s, pre_s, groups, case["bd"], devs)
    for g, w in zip(got, want):
        assert torch.equal(sb.gather(g, w.shape[1], CPU), w)


def test_itx_sharded_check_energy(rich_frames):
    plan, _ = rich_frames[1]
    tx, txtp, offs, pool = sharded._itx_bucket(plan)
    res = sharded._itx_residuals(pool, offs, tx, txtp, 8, CPU)
    ref = int(res.abs().to(torch.int64).sum())
    assert len(offs) > 1 and ref > 0
    for mesh in (_mesh(4, ("gop", "tile")), _mesh(3, ("tile",))):
        energy = sharded.itx_sharded_check(plan, 8, mesh)
        assert abs(energy - ref) <= 1e-6 * ref


def test_mesh_checks():
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"], ("gop",))
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"], ("gop", "tile"))
    m = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
             ("gop", "tile"))
    assert m.shape == {"gop": 2, "tile": 2} and m.size == 4
    assert sharded.resolve_mesh(m, CPU) == [CPU] * 4
    with pytest.raises(TypeError):
        sharded.resolve_mesh([CPU], CPU)
    with pytest.raises(ValueError):
        sharded.resolve_mesh(Mesh(["cuda:0"]), CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharded.resolve_mesh(Mesh(["cuda:0"]), torch.device("cuda"))
    from dav1d_tpu_torch.api import Decoder, Settings
    with pytest.raises(ValueError):
        Decoder(Settings(device="cpu", sharding_mesh=Mesh(["cuda:0"])))
