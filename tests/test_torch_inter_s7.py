"""The inter slice's configuration at full size on the CPU: the 1080p
8-bit stream bench_streams/1920x1080_8b_flt_s7.ivf (2x2 tiles, deblock,
CDEF and LR on; puts, averaged compounds, residuals of all 19 transform
sizes and ~2k host-replayed intra leftovers per inter frame) decodes
through the port's API with device="cpu" (the plain versions of the
kernels) to the md5s of dav1d_tpu's golden numpy path
(DAV1D_TPU_BACKEND=numpy, Settings(n_threads=1),
dav1d_tpu.utils.muxers.Md5Muxer): per picture, and for one muxer over
the whole stream."""
import os

import torch

from dav1d_tpu_torch.api import Decoder, Settings
from dav1d_tpu_torch.bitstream.ivf import IvfReader
from dav1d_tpu_torch.utils.muxers import Md5Muxer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MD5S = ["f17212bafb21900b1d1682880fb6f167",
        "c5e7cfa0696414def0c51602b95ac49b",
        "c1e35f23c5864fc12bfdaa85d28fbfa5",
        "448e91e7d149d92fcceff90e33655305",
        "1cdd9d19b811b695889d8da7798d46c3",
        "f2bb710b4217bbb3c4ac849a422295dc",
        "6ccc53c6ed3f566c51bc42f6aabc9981",
        "812386a128296b52fd17ee0d812a3a4e"]
MD5_STREAM = "3c030b2d9bdfdd923d5eb6314e4e1c10"


def _decode(n_tu):
    path = os.path.join(ROOT, "bench_streams", "1920x1080_8b_flt_s7.ivf")
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


def test_s7_first_two_temporal_units():
    md5s, _ = _decode(2)
    assert md5s == MD5S[:2]


def test_s7_whole_stream():
    md5s, stream = _decode(8)
    assert md5s == MD5S
    assert stream == MD5_STREAM
