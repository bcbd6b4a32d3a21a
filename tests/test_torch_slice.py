"""The keyframe/intra slice end to end: small synthetic intra streams with
every in-loop filter on decode through dav1d_tpu's ObuStreamDecoder and
through the port's public API (device="cpu", so the plain versions
run), and every picture's md5 must be equal. Features the port does
not have yet (super-res, film grain) raise DecodeError naming their
ROADMAP item (inter frames: tests/test_torch_inter.py)."""
import pytest
import torch

from dav1d_tpu.bitstream.ivf import IvfReader
from dav1d_tpu.decoder import ObuStreamDecoder
from dav1d_tpu.utils.muxers import Md5Muxer as JaxMd5
from dav1d_tpu_torch import cli
from dav1d_tpu_torch.api import DecodeError, Decoder, Settings
from dav1d_tpu_torch.utils.muxers import Md5Muxer

from torch_port_cases import FILTERS, STREAMS, stream

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


def _jax_md5s(data):
    dec = ObuStreamDecoder()
    out = []
    for fr in IvfReader(data):
        for _plan, pic in dec.decode_temporal_unit(fr.data):
            if pic is not None:
                out.append(_md5(pic, JaxMd5))
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_intra_stream_md5s_match_dav1d_tpu(name):
    data = stream(name)
    ref = _jax_md5s(data)
    assert len(ref) == STREAMS[name]["n_frames"]
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


def test_inter_frame_raises_decode_error():
    # inter frames decode since the inter slice (tests/test_torch_inter
    # .py), interintra among them since the host golden walks; inter
    # streams with super-res or film grain, which are not ported yet,
    # raise naming their ROADMAP item
    from tools.streamgen.gen import generate_stream
    from torch_port_cases import PYR
    data, _ = generate_stream(96, 96, n_frames=5, seed=25, inter_intra=1,
                              **PYR)
    assert len(_decode_all(data)) == 5
    grain = dict(seed=1234, y_points=[(0, 64), (255, 48)], ar_coeff_lag=0,
                 ar_coeffs_y=[], scaling_shift=9,
                 uv_points=[[(0, 32)], [(16, 48)]],
                 ar_coeffs_uv=[[5], [7]], overlap_flag=0)
    for kw, item in ((dict(seed=80, superres_denom=12), "ROADMAP item 4"),
                     (dict(seed=95, film_grain=grain), "ROADMAP item 6")):
        data, _ = generate_stream(96, 96, n_frames=3, **kw)
        with pytest.raises(DecodeError, match=item):
            _decode_all(data)


def test_key_only_skips_inter_frames():
    from tools.streamgen.gen import generate_stream
    data, _ = generate_stream(96, 64, n_frames=3, seed=4)
    assert len(_decode_all(data, decode_frame_type=3)) == 1


def test_superres_raises_decode_error():
    from tools.streamgen.gen import generate_intra_stream
    data, _ = generate_intra_stream(128, 64, seed=5, superres_denom=12,
                                    **FILTERS)
    with pytest.raises(DecodeError, match="ROADMAP item 4"):
        _decode_all(data)


def test_film_grain_raises_decode_error():
    from tools.streamgen.gen import generate_intra_stream
    grain = dict(seed=1234, y_points=[(0, 64), (255, 48)], ar_coeff_lag=0,
                 ar_coeffs_y=[], scaling_shift=9,
                 uv_points=[[(0, 32)], [(16, 48)]],
                 ar_coeffs_uv=[[5], [7]], overlap_flag=0)
    data, _ = generate_intra_stream(64, 64, seed=6, film_grain=grain)
    with pytest.raises(DecodeError, match="ROADMAP item 6"):
        _decode_all(data)
    # without grain application the frame decodes
    assert len(_decode_all(data, apply_grain=False)) == 1


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Settings())
