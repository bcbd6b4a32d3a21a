"""Record the reference md5s of the mesh test streams.

For each stream of tests/torch_port_cases.py MESH_STREAMS (committed
under tests/data/torch_golden/), prints one JSON line with dav1d_tpu's
`parallel.sharded.single_device_md5` (its device path, on JAX's CPU
backend here) and the md5 of its golden numpy path
(DAV1D_TPU_BACKEND=numpy, Settings(n_threads=1)); both must be equal.
chip_smoke.py MESH_MD5S holds them, and tests/test_torch_sharded.py and
chip_smoke.py's `sharded` phase hold the port's sharded decodes to
them.

    JAX_PLATFORMS=cpu DAV1D_TPU_DEVICE=cpu DAV1D_TPU_FUSED=0 \\
        python tools/torch_mesh_md5s.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _golden_md5(data):
    from dav1d_tpu.api import Settings
    from dav1d_tpu.parallel.sharded import _decode_md5
    os.environ["DAV1D_TPU_BACKEND"] = "numpy"
    try:
        return _decode_md5(data, Settings(n_threads=1))
    finally:
        os.environ.pop("DAV1D_TPU_BACKEND")


def main():
    from dav1d_tpu.parallel.sharded import single_device_md5
    from torch_port_cases import MESH_STREAMS
    for name in MESH_STREAMS:
        data = open(os.path.join(ROOT, "tests", "data", "torch_golden",
                                 f"{name}.ivf"), "rb").read()
        print(json.dumps({"stream": name,
                          "single_device_md5": single_device_md5(data),
                          "golden_md5": _golden_md5(data)}), flush=True)


if __name__ == "__main__":
    main()
