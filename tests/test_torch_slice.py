"""The keyframe/intra slice end to end: small synthetic intra streams with
every in-loop filter on decode through dav1d_tpu's ObuStreamDecoder
(its md5s recorded in JAX_MD5S with the hash of the stream they were
recorded from; one stream also decoded live) and through the port's public API
(device="cpu", so the plain versions run), and every picture's md5 must
be equal; super-res and film grain
streams, intra and inter, to the md5s of dav1d_tpu's golden numpy path
(more of them: tests/test_torch_superres.py, tests/test_torch_fg.py;
inter frames: tests/test_torch_inter.py)."""
import hashlib

import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.decoder import ObuStreamDecoder
from dav1d_tpu.utils.muxers import Md5Muxer as JaxMd5
from dav1d_tpu_torch import cli
from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.utils.muxers import Md5Muxer

from torch_port_cases import FILTERS, STREAMS, golden_md5s, stream

torch.set_num_threads(2)


def _md5(pic, muxer_cls):
    m = muxer_cls()
    m.write_picture(pic)
    return m.digest()


def _port_md5s(data, **settings):
    dec = Decoder(Settings(device="cpu", **settings))
    out = []
    for fr in IvfReader(data):
        dec.send_data(fr.data)
        out += [_md5(p, Md5Muxer) for p in dec.pictures()]
    return out


# every picture's md5 (dav1d_tpu's Md5Muxer) of the STREAMS decoded by
# dav1d_tpu's ObuStreamDecoder() (its device path), recorded once: those
# decodes compile their filter programs for 7-13 s a stream on a CPU.
# Beside them the md5 of the stream's bytes they were recorded from: a
# change of the stream generator fails the test instead of comparing
# against stale md5s (record them again from dav1d_tpu then).
JAX_MD5S = {
    "10bit-420": ("5c504b901df0b37ce5da3f066952ce06",
                  ["34f89ac33659aede00bb0df539015a28",
                   "e74d64420cbc45a1bd84ad83de62e47a"]),
    "12bit-420": ("47722d9093b7b9865b24af8592c7ad7d",
                  ["e52a5ad228aa598374c6c3df6e7c6c80",
                   "1d332cdc6d7ac82e9c791a69c019a6f7"]),
    "8bit-420": ("5366cc8c1db64e84c43f3e368ed43589",
                 ["e0eff6abb54cc9bb2238b28f9cd34818",
                  "00e09b75284ff30381817a47fcd1b1ed"]),
    "8bit-422": ("df675c900966a1cd6ff1438d8355dff9",
                 ["3c313e6b682c47ebd8a9bb000576fa6b",
                  "8f435388bba64c1f0f4131b04e3c149e"]),
    "8bit-444-tiles": ("59e6cee3c8d3286ea73c0b7206fe1a24",
                       ["a851f3bcdc8eff03e092c2c44d62a0e0",
                        "0bf7510646ab9e8e8664409f933e40d7"]),
    "8bit-mono": ("d6dd12cdee08c181c0dcc8bc03c39013",
                  ["5556cda4c37bb7ddcd5b9a11520150d8",
                   "8e228c08ab5f4879f2e0b6d95da65b5c"])}
# the stream dav1d_tpu also decodes live, on its golden numpy path
# (compiles nothing)
LIVE = "8bit-420"


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_intra_stream_md5s_match_dav1d_tpu(name, monkeypatch):
    data = stream(name)
    data_md5, ref = JAX_MD5S[name]
    assert hashlib.md5(data).hexdigest() == data_md5
    assert len(ref) == STREAMS[name]["n_frames"]
    if name == LIVE:
        assert golden_md5s(data, monkeypatch) == ref
    assert _port_md5s(data) == ref
    # the synchronous decoder (no Stage-B worker) agrees too
    assert _port_md5s(data, n_threads=1) == ref


def test_cli_md5(tmp_path, capsys):
    data = stream("8bit-420")
    path = tmp_path / "s.ivf"
    path.write_bytes(data)
    m = JaxMd5()
    dec = ObuStreamDecoder()
    for fr in IvfReader(data):
        for _plan, pic in dec.decode_temporal_unit(fr.data):
            m.write_picture(pic)
    rc = cli.main(["-q", "-i", str(path), "--muxer", "md5",
                   "--decodeframetype", "key", "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.strip() == m.digest()


def _decode_all(data, **settings):
    dec = Decoder(Settings(device="cpu", **settings))
    pics = []
    for fr in IvfReader(data):
        dec.send_data(fr.data)
        pics += list(dec.pictures())
    return pics


def test_inter_frames_with_superres_and_grain_match_golden(monkeypatch):
    # inter frames decode since the inter slice (tests/test_torch_inter
    # .py), interintra among them since the host golden walks, and
    # inter streams with super-res or film grain since slice 10
    from tools.streamgen.gen import generate_stream
    from torch_port_cases import PYR
    data, _ = generate_stream(96, 96, n_frames=5, seed=25, inter_intra=1,
                              **PYR)
    assert len(_decode_all(data)) == 5
    grain = dict(seed=1234, y_points=[(0, 64), (255, 48)], ar_coeff_lag=0,
                 ar_coeffs_y=[], scaling_shift=9,
                 uv_points=[[(0, 32)], [(16, 48)]],
                 ar_coeffs_uv=[[5], [7]], overlap_flag=0)
    for kw in (dict(seed=80, superres_denom=12),
               dict(seed=95, film_grain=grain)):
        data, _ = generate_stream(96, 96, n_frames=3, **kw)
        want = golden_md5s(data, monkeypatch)
        assert len(want) == 3
        assert _port_md5s(data) == want


def test_key_only_skips_inter_frames():
    from tools.streamgen.gen import generate_stream
    data, _ = generate_stream(96, 64, n_frames=3, seed=4)
    assert len(_decode_all(data, decode_frame_type=3)) == 1


def test_superres_intra_matches_golden(monkeypatch):
    from tools.streamgen.gen import generate_intra_stream
    data, _ = generate_intra_stream(128, 64, seed=5, superres_denom=12,
                                    **FILTERS)
    pics = _decode_all(data)
    assert [(p.w, p.h) for p in pics] == [(128, 64)]
    assert _port_md5s(data) == golden_md5s(data, monkeypatch)


def test_film_grain_intra_matches_golden(monkeypatch):
    from tools.streamgen.gen import generate_intra_stream
    grain = dict(seed=1234, y_points=[(0, 64), (255, 48)], ar_coeff_lag=0,
                 ar_coeffs_y=[], scaling_shift=9,
                 uv_points=[[(0, 32)], [(16, 48)]],
                 ar_coeffs_uv=[[5], [7]], overlap_flag=0)
    data, _ = generate_intra_stream(64, 64, seed=6, film_grain=grain)
    grained = _port_md5s(data)
    assert grained == golden_md5s(data, monkeypatch)
    # without grain application the frame decodes to dav1d_tpu's
    # un-grained picture
    clean = _port_md5s(data, apply_grain=False)
    assert len(clean) == 1 and clean != grained
    assert clean == golden_md5s(data, monkeypatch, apply_grain=False)


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Settings())
