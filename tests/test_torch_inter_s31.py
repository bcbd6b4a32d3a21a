"""The primary bench stream at full size on the CPU: the 1080p 8-bit
bench_streams/1920x1080_8b_flt_s31_enc.ivf (deblock, CDEF and LR on;
per inter frame ~12-18k puts, ~8-10k compounds, ~0.6-2k warp tiles,
~4-8k OBMC laps, ~7-9k residuals and a few pure-intra leftovers)
decodes through the port's API with device="cpu" (the plain versions of
the kernels) to the md5s of dav1d_tpu's golden numpy path
(DAV1D_TPU_BACKEND=numpy, Settings(n_threads=1),
dav1d_tpu.utils.muxers.Md5Muxer over the same stream): per picture,
and for one muxer over the whole stream; and its first inter frame with
the leftover blocks on the device route (DAV1D_TPU_LO=device: the plan
of recon/ipred_device.py, ops/ipred.py level_plain, no row fetched
back). Tolerance: none (md5-equal).
The file stands alone so that `--dist loadfile` gives it a worker."""
import os

import torch

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.ops import mc_fused
from dav1d_tpu_torch.recon import inter_device, ipred_device
from dav1d_tpu_torch.utils.muxers import Md5Muxer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MD5S = ["25ead3c156609f2b398c7f4f14141b23",
        "5e6a4663747fa5d3501a91cee0010cd7",
        "3d7a9af010fcf8a34b96d78bbf4a86ad",
        "b8dc2a8916f0b039443728f01a505066",
        "46e349a0177fbe27a6f1d106e05e2c5f",
        "e855a67370e045a0655dbb3173b99686",
        "12ad99c22c3d2e0abb9dcde301e9c57c",
        "3c6dd14ac8b0e14cd938132520dd9c31"]
MD5_STREAM = "2028903f9e5e69af98b0348d5e246e13"


def _decode(n_tu):
    path = os.path.join(ROOT, "bench_streams",
                        "1920x1080_8b_flt_s31_enc.ivf")
    dec = Decoder(Settings(device="cpu"))
    mux = Md5Muxer()
    md5s = []
    for i, fr in enumerate(IvfReader(open(path, "rb").read())):
        if i >= n_tu:
            break
        dec.send_data(fr.data)
        for pic in dec.pictures():
            assert pic.planes[0].shape == (1152, 1920)
            mux.write_picture(pic)
            one = Md5Muxer()
            one.write_picture(pic)
            md5s.append(one.digest())
    return md5s, mux.digest()


def test_s31_first_two_temporal_units(monkeypatch):
    seen = []
    run = mc_fused.execute

    def spy(recon, jobs):
        seen.append({k: len(v) for k, v in jobs.items()})
        return run(recon, jobs)
    monkeypatch.setattr(mc_fused, "execute", spy)
    md5s, _ = _decode(2)
    assert md5s == MD5S[:2]
    # the inter frame went through the warp and OBMC passes
    (n,) = seen
    assert n["warps"] > 500 and n["obmc"] > 3000, n


def test_s31_whole_stream():
    md5s, stream = _decode(8)
    assert md5s == MD5S
    assert stream == MD5_STREAM


def test_s31_leftovers_on_the_device_route(monkeypatch):
    fetches = []
    fetch = inter_device.fetch_rows
    monkeypatch.setattr(inter_device, "fetch_rows",
                        lambda *a: fetches.append(1) or fetch(*a))
    monkeypatch.setenv("DAV1D_TPU_LO", "device")
    before = dict(ipred_device.STATS)
    md5s, _ = _decode(2)
    assert md5s == MD5S[:2]
    assert ipred_device.STATS["frames"] == before["frames"] + 1
    assert ipred_device.STATS["units"] > before["units"]
    assert ipred_device.STATS["fallbacks"] == before["fallbacks"]
    assert not fetches
