"""The benchmark of dav1d_tpu_torch, the PyTorch and CUDA AV1 decoder.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the CUDA card of the
machine it is started on and prints one JSON result line. Each cell's
configuration (`configs/<name>.json`), traffic mix
(`traffic/<name>.json`) and per-layer metric (`metrics/<name>.py`) is a
file of its own that the harness finds by name; `reference/` holds the
recorded md5 of every picture of every stream in `streams/`.

Nothing here imports JAX or the JAX package `dav1d_tpu`, and nothing in
`reference/` imports the program.
"""
