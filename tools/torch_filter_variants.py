"""Time the CDEF and Wiener kernels (csrc/cdef.cu, csrc/lr_wiener.cu)
against variants of their own sources on one GPU, on the inputs the
decode of the s31 stream's first 2 temporal units gives the kernels for
frame 2. A variant is the source with some lines replaced: a phase
taken out (which attributes the kernel's time to its phases) or an
earlier design choice put back (which measures that choice). Each
variant is built by nvcc into build/filter_variants/ and loaded in
place of the kernel's library; its device time is the median of 30
launches in one torch.profiler trace; whether its output equals the
kernel's is printed beside it (a phase taken out changes the output).
Prints one JSON line a variant and writes them all to the JSON file
argv[1] (default build/filter_variants/variants.json).

    python tools/torch_filter_variants.py [out.json]
"""
import ctypes as ct
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from dav1d_tpu_torch.ops import cdef, cuda_build, lr  # noqa: E402
from dav1d_tpu_torch.ops.cdef_ref import UV_DIRS, cdef_dirs  # noqa: E402

OUT = os.path.join(ROOT, "build", "filter_variants")
SEARCH = """            s_cost[b * 9 + d] = dir_cost_of(
                d, s_p + (b >> 3) * 8 * PS + (b & 7) * 8);"""
NO_SEARCH = "            s_cost[b * 9 + d] = (b * 7 + d) & 7;"
NO_FILTER = ("if (prm.w) {", "if (false) {")
CDEF = {
    "kernel": [],
    # staging, search, and the output stores from the window
    "no_filter": [NO_FILTER],
    # staging and the output stores alone
    "stage_only": [NO_FILTER, (SEARCH, NO_SEARCH)],
    # a window row stride of 74 int16, an odd number of 32-bit words
    # (fewer bank conflicts on the taps), its rows written and read as
    # two words
    "stride_74": [("constexpr int WS = TILE + 2 * LEFT;",
                   "constexpr int WS = TILE + 2 * LEFT + 2;"),
                  ("*reinterpret_cast<uint2 *>(win + r * WS + 4 * v) = "
                   "pack16(q);",
                   "const uint2 pk = pack16(q);\n"
                   "            unsigned *w32 = reinterpret_cast<unsigned *>"
                   "(win + r * WS + 4 * v);\n"
                   "            w32[0] = pk.x;\n            w32[1] = pk.y;"),
                  ("const uint2 raw = *reinterpret_cast<const uint2 *>(wp);",
                   "const unsigned *w32 = reinterpret_cast<const unsigned *>"
                   "(wp);\n                const uint2 raw = "
                   "make_uint2(w32[0], w32[1]);")],
    # the taps of a strength of 0 skipped by a branch
    "branches": [("        const int thr = j < 2 ? t.pri : t.sec;",
                  "        const int thr = j < 2 ? t.pri : t.sec;\n"
                  "        if (!thr) continue;")],
}
WIENER = {
    "kernel": [],
    # one window row after another, its loads waiting on the row table
    "rows_in_turn": [("""#pragma unroll
    for (int k = 0; k < (ROWS + 7) / 8; k++) {
        const int r = warp + 8 * k;
        if (r < rows) {
            const int R = rowt[r];
            const int32_t *row = R < P.Hp ? P.src + (size_t)R * P.ss
                                          : P.pre + (size_t)(R - P.Hp) * P.ss;
#pragma unroll
            for (int m = 0; m < 3; m++) {
                const int c = lane + 32 * m;
                if (c < cols)
                    s_win[r][c] = (int16_t)row[min(max(cb + c, 0), P.w - 1)];
            }
        }
    }""", """    for (int r = warp; r < rows; r += THREADS / 32) {
        const int R = rowt[r];
        const int32_t *row = R < P.Hp ? P.src + (size_t)R * P.ss
                                      : P.pre + (size_t)(R - P.Hp) * P.ss;
        for (int c = lane; c < cols; c += 32)
            s_win[r][c] = (int16_t)row[min(max(cb + c, 0), P.w - 1)];
    }""")],
}


def variant(name, kernel, edits):
    """Build csrc/<kernel>.cu with `edits` applied; returns (library,
    ptxas lines)."""
    src = open(os.path.join(cuda_build.CSRC, f"{kernel}.cu")).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{kernel} variant {name}: pattern missing")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{kernel}_{name}.cu")
    open(path, "w").write(src)
    so = os.path.join(OUT, f"lib{kernel}_{name}.so")
    r = subprocess.run([cuda_build.nvcc(), "-gencode", cuda_build.ARCH,
                        "-std=c++17", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {path}:\n{r.stderr}")
    return ct.CDLL(so), [ln.strip() for ln in r.stderr.splitlines()
                         if "registers" in ln or "spill" in ln]


def device_us(fn, key, n=30):
    """Median device us of n calls of fn, the kernels whose name holds
    key, from one torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ts = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and
                key in e.name)
    if len(ts) < n:
        raise RuntimeError(f"the trace holds {len(ts)} {key} launches")
    return ts[len(ts) // 2]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.smi()
    rec = {}
    run_c, run_w = cdef.cdef_planes, lr.wiener_frame

    def spy_c(*a):
        rec["cdef"] = a
        return run_c(*a)

    def spy_w(planes, tables, bd):
        rec["wiener"] = ([(s, q, d.clone(), w, h)
                          for s, q, d, w, h in planes], tables, bd)
        return run_w(planes, tables, bd)
    cdef.cdef_planes, lr.wiener_frame = spy_c, spy_w
    try:
        cs._decode(cs.STREAM_1080P, timed=False, n_tu=2)
    finally:
        cdef.cdef_planes, lr.wiener_frame = run_c, run_w
    want_c = cdef.cdef_cuda(*rec["cdef"])
    planes, tables, bd = rec["wiener"]
    wmax = lr.check_frame(planes, tables)
    items, rowt, blocks = lr.upload_tables(
        [*tables, lr.wiener_blocks(tables[0])], "cuda")

    def wiener():
        dsts = [p[2].clone() for p in planes]
        lr._wiener_launch([(s, q, d, w, m) for (s, q, _, w, _), d, m
                           in zip(planes, dsts, wmax)], items, rowt,
                          blocks, bd)
        return dsts
    want_w = wiener()
    dirs = np.ascontiguousarray(cdef_dirs(), np.int32)
    uv = np.ascontiguousarray(UV_DIRS, np.int32)
    lines = []
    for name, edits in CDEF.items():
        lib, ptxas = variant(name, "cdef", edits)
        lib.cdef_set_tables.argtypes = [ct.c_void_p, ct.c_void_p]
        if lib.cdef_set_tables(dirs.ctypes.data, uv.ctypes.data):
            raise RuntimeError("cdef_set_tables failed")
        lib.cdef_frame.restype = ct.c_int
        lib.cdef_frame.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                   ct.c_void_p]
        cdef._LIB[:] = [lib]
        got = cdef.cdef_cuda(*rec["cdef"])
        torch.cuda.synchronize()
        lines.append({"kernel": "cdef", "variant": name, "us": device_us(
            lambda: cdef.cdef_cuda(*rec["cdef"]), "cdef_kernel"),
            "equal": all(torch.equal(g, w) for g, w in zip(got, want_c)),
            "ptxas": ptxas})
        print(json.dumps(lines[-1]), flush=True)
    for name, edits in WIENER.items():
        lib, ptxas = variant(name, "lr_wiener", edits)
        lib.lr_wiener.restype = ct.c_int
        lib.lr_wiener.argtypes = [ct.c_void_p] * 3
        lr._LIBS["lr_wiener"] = lib
        got = wiener()
        torch.cuda.synchronize()
        lines.append({"kernel": "lr_wiener", "variant": name,
                      "us": device_us(wiener, "lr_wiener_kernel"),
                      "equal": all(torch.equal(g, w)
                                   for g, w in zip(got, want_w)),
                      "ptxas": ptxas})
        print(json.dumps(lines[-1]), flush=True)
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        OUT, "variants.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    json.dump({"card": card, "stream": cs.STREAM_1080P, "frame": 1,
               "variants": lines}, open(out, "w"), indent=1)
    print(card)


if __name__ == "__main__":
    main()
