"""Record the golden md5s of whole bench streams on the CPU.

Decodes each stream named on the command line (default: the whole
bench_streams/3840x2160_10b_flt_s33_enc.ivf and
bench_streams/1920x1080_8b_flt_s21_realistic.ivf) through the port's
golden host route (DAV1D_TPU_BACKEND=numpy, dav1d_tpu_torch's Decoder
with Settings(n_threads=1)) and prints one JSON line a stream: the md5
of every picture and of one muxer over all of them. With --jax it
decodes through dav1d_tpu's golden numpy path instead (the same switch,
Settings(n_threads=1), dav1d_tpu.utils.muxers.Md5Muxer), the recipe of
every golden md5 on record; run both and compare the lines. chip_smoke.py
and tests/torch_port_cases.py hold the results.

    python tools/torch_golden_md5s.py [--jax] [stream.ivf ...]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STREAMS = ("bench_streams/3840x2160_10b_flt_s33_enc.ivf",
           "bench_streams/1920x1080_8b_flt_s21_realistic.ivf")


def _pictures(path, jax):
    """Every decoded picture of `path`, in output order."""
    if jax:
        from dav1d_tpu.api import Settings
        from dav1d_tpu.bitstream.ivf import IvfReader
        from dav1d_tpu.decoder import ObuStreamDecoder
        dec = ObuStreamDecoder(settings=Settings(n_threads=1))
        for fr in IvfReader(open(path, "rb").read()):
            for _plan, pic in dec.decode_temporal_unit(fr.data):
                if pic is not None:
                    yield pic
        return
    from dav1d_tpu_torch.api import Decoder, Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    dec = Decoder(Settings(n_threads=1))
    for fr in IvfReader(open(path, "rb").read()):
        dec.send_data(fr.data)
        yield from dec.pictures()


def golden_md5s(path, jax=False):
    """(per-picture md5s, stream md5) of `path` on a golden route."""
    if jax:
        from dav1d_tpu.utils.muxers import Md5Muxer
    else:
        from dav1d_tpu_torch.utils.muxers import Md5Muxer
    os.environ["DAV1D_TPU_BACKEND"] = "numpy"
    whole, md5s = Md5Muxer(), []
    for pic in _pictures(path, jax):
        one = Md5Muxer()
        one.write_picture(pic)
        whole.write_picture(pic)
        md5s.append(one.digest())
    return md5s, whole.digest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true",
                    help="dav1d_tpu's golden numpy path, not the port's")
    ap.add_argument("streams", nargs="*", default=STREAMS)
    args = ap.parse_args()
    for path in args.streams:
        t0 = time.perf_counter()
        md5s, md5 = golden_md5s(os.path.join(ROOT, path), args.jax)
        print(json.dumps({"stream": path,
                          "route": "dav1d_tpu" if args.jax else "port",
                          "md5s": md5s, "md5": md5,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
