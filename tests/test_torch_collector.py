"""The port's routes for inter frames the native job emitter does not
serve, and its env tiers (ROADMAP item 9b), on the CPU (device="cpu":
the kernels' plain versions run). Tolerance 0 everywhere (md5s,
np.array_equal).

- The Python collector walk (DAV1D_TPU_INTERJOBS=python) gives the
  emitter route's md5s, and dav1d_tpu's golden ones, on
  tests/test_interjobs.py's CONFIGS; the tables it collects equal
  dav1d_tpu's collector's, row for row. dav1d_tpu's tables are taken
  from its golden numpy decode of the same stream: on every inter frame
  its collector walks the plan with the device passes stubbed to record
  the five job lists (the tables depend on Stage A alone).
- The golden-walk and leftover streams committed under
  tests/data/torch_golden/ decode to their golden md5s under
  DAV1D_TPU_INTERJOBS=python, through _RetryEager's eager replays and
  the device planes that then start from the host planes.
- DAV1D_TPU_TRACE (a Python Stage A: no native tiles, every residual a
  res_fixup, the whole planes fetched) gives the golden md5s, on a
  lossless stream too (its WHT blocks among the res_fixups).
- DAV1D_TPU_FUSED and DAV1D_TPU_ITX=device change nothing in the port
  (ROADMAP section 3): tests/conftest.py sets DAV1D_TPU_FUSED=0 for
  every test here, and =1 gives the same md5s."""
import os
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.decoder import ObuStreamDecoder
from dav1d_tpu.utils.muxers import Md5Muxer as JaxMd5
from dav1d_tpu_torch.entropy import levels as lv
from dav1d_tpu_torch.recon import inter_device
from tools.streamgen.gen import generate_stream

from test_interjobs import CONFIGS, IDS
from test_torch_inter import STREAMS as INTER_STREAMS
from torch_port_cases import (COMMITTED_MD5S, FILTERS, GOLDEN_DIR,
                              GOLDEN_WALKS, LO_STREAMS, port_md5s)

torch.set_num_threads(2)
KEYS = (("puts", 11), ("warps", 12), ("obmc", 13), ("comp", 25),
        ("res", 7))
# the committed streams whose inter frames take the collector walk:
# every golden walk but the intrabc one (an intra stream), and the
# intra-leftover streams
WALK_STREAMS = sorted(n for n in GOLDEN_WALKS if not GOLDEN_WALKS[n][0]) + \
    sorted(LO_STREAMS)
# the streams whose collector walk must replay blocks eagerly, and
# those with a frame of eager replays and device jobs (its device planes
# start from the host planes)
EAGER = ("scaled-ref", "scaled-ref-bilin", "scaled-ref-compound",
         "gmv-compound")
MIXED = ("scaled-ref-bilin", "gmv-compound")


@contextmanager
def _env(**env):
    """os.environ updated inside the block, restored after."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        yield


def _config_stream(name):
    """A CONFIGS stream, or test_torch_inter.py's lossless one."""
    if name == "lossless":
        cfg = {**INTER_STREAMS[name], **FILTERS}
    else:
        cfg = dict(CONFIGS[IDS.index(name)])
        cfg.pop("name")
    w, h = cfg.pop("w"), cfg.pop("h")
    return generate_stream(w, h, **cfg)[0]


@lru_cache(maxsize=None)
def _reference(name):
    """(stream, dav1d_tpu's golden md5s, its collected tables per inter
    frame) of a _config_stream. The golden numpy path decodes it; on
    every inter frame dav1d_tpu's collector first walks the plan, its
    device passes stubbed to record the job lists."""
    from dav1d_tpu.recon import inter_device as jdev
    from dav1d_tpu.recon import inter_ref as jref
    data = _config_stream(name)
    tables = []
    golden_walk = jref.reconstruct_inter_frame

    def record(self):
        tables.append({k: np.asarray(l, np.int32).reshape(-1, K)
                       for (k, K), l in zip(KEYS, self._lists)})

    def collect_then_golden(plan, refp):
        if not plan.f.key_or_intra:
            jdev.DeviceInterReconstructor(plan, refp).run()
        return golden_walk(plan, refp)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DAV1D_TPU_BACKEND", "numpy")
        mp.setattr(jdev.DeviceInterReconstructor, "_execute", record)
        mp.setattr(jref, "reconstruct_inter_frame", collect_then_golden)
        dec = ObuStreamDecoder()
        md5s = []
        for fr in IvfReader(data):
            for _plan, pic in dec.decode_temporal_unit(fr.data):
                m = JaxMd5()
                m.write_picture(pic)
                md5s.append(m.digest())
    return data, md5s, tables


def _port(data, **env):
    """The port's md5s of `data` under env, and per frame the collector
    walk served: its tables as _execute received them (None for a frame
    with no device job), whether it replayed blocks eagerly, its
    res_fixups and the rows it fetched back."""
    frames = []
    run = inter_device.DeviceInterReconstructor.run
    execute = inter_device.DeviceInterReconstructor._execute

    def walk(self):
        frames.append({"tables": None})
        pic = run(self)
        frames[-1].update(had_eager=self.had_eager,
                          fixups=len(self.res_fixups),
                          wht=any(cb.txtp == lv.WHT_WHT
                                  for cb in self.res_fixups),
                          leftovers=len(self.leftovers),
                          spans=self._region_spans,
                          shapes=[p.shape for p in self.pic.planes])
        return pic

    def spy(self, jobs):
        if frames:
            frames[-1]["tables"] = jobs
        return execute(self, jobs)
    with _env(**env), pytest.MonkeyPatch.context() as mp:
        mp.setattr(inter_device.DeviceInterReconstructor, "run", walk)
        mp.setattr(inter_device.DeviceInterReconstructor, "_execute", spy)
        return port_md5s(data), frames


@lru_cache(maxsize=None)
def _port_collector(name):
    return _port(_reference(name)[0], DAV1D_TPU_INTERJOBS="python")


@pytest.mark.parametrize("name", IDS)
def test_collector_matches_emitter(name):
    data, golden, tables = _reference(name)
    emitter, walked = _port(data)
    assert not walked                    # the emitter served every frame
    # tests/conftest.py's DAV1D_TPU_FUSED=0 changes nothing in the port
    assert _port(data, DAV1D_TPU_FUSED="1")[0] == emitter
    collector, walked = _port_collector(name)
    assert len(walked) == len(tables) > 0
    assert collector == emitter == golden


@pytest.mark.parametrize("name", IDS)
def test_collected_tables_match_dav1d_tpu(name):
    _, _, want = _reference(name)
    _, walked = _port_collector(name)
    assert len(walked) == len(want)
    for i, (frame, ref) in enumerate(zip(walked, want)):
        got = frame["tables"]
        if got is None:                   # no device job on this frame
            assert not any(len(t) for t in ref.values()), i
            continue
        for k, _K in KEYS:
            assert np.array_equal(got[k], ref[k]), (i, k)
    kinds = {k for f in walked if f["tables"] for k, _ in KEYS
             if len(f["tables"][k])}
    assert {"puts", "comp", "res"} <= kinds
    if name == "everything":
        assert {"warps", "obmc"} <= kinds


@pytest.mark.parametrize("name", WALK_STREAMS)
def test_committed_streams_on_the_collector_walk(name):
    """The golden-walk and leftover streams under
    DAV1D_TPU_INTERJOBS=python: their golden md5s, every inter frame
    through the collector walk; the scaled-reference and warped-compound
    streams replay blocks eagerly (_RetryEager), so their device planes
    start from the host planes."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.ivf"), "rb") as fh:
        data = fh.read()
    got, walked = _port(data, DAV1D_TPU_INTERJOBS="python")
    pic_md5s, _md5 = COMMITTED_MD5S[name]
    assert got == pic_md5s
    assert len(walked) == len(pic_md5s) - 1
    assert any(f["leftovers"] for f in walked)
    eager = [f for f in walked if f["had_eager"]]
    assert bool(eager) == (name in EAGER)
    assert any(f["tables"] is not None for f in eager) == (name in MIXED)


@pytest.mark.parametrize("itx", ["native", "device"])
@pytest.mark.parametrize("name", ["sub8x8", "lossless"])
def test_trace_takes_the_python_stage_a(name, itx):
    """DAV1D_TPU_TRACE: the tile parse traces every symbol (tp.dbg), the
    native tile parse declines, so no frame has native tiles: every
    inter frame takes the collector walk, every residual is a res_fixup
    added on the host after the whole planes came down, before the
    leftover blocks that read them; on the lossless stream the WHT
    blocks among them. DAV1D_TPU_ITX=device changes nothing (the
    residuals come from the numpy pass either way)."""
    data, golden, _ = _reference(name)
    got, walked = _port(data, DAV1D_TPU_TRACE="1", DAV1D_TPU_ITX=itx)
    assert got == golden
    assert len(walked) == len(golden) - 1
    assert all(f["fixups"] for f in walked)
    assert any(f["wht"] for f in walked) == (name == "lossless")
    for f in walked:
        if f["tables"] is not None:
            assert not len(f["tables"]["res"])
            assert f["spans"] == [(0, s[0]) for s in f["shapes"]]
