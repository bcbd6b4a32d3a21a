"""Time the intra-leftover frame kernel (csrc/ipred.cu) against variants
of its own source on one GPU, on the plans of the first inter frame of
the s31 and s7 streams with their leftovers forced onto the device
(chip_smoke.py _ipred_plans). A variant is the source with some lines
replaced: a step taken out (which attributes the launch's time to its
prediction steps, its residual steps, its grid barriers, a family's
arithmetic or the edges' pixel loads), another grid, registers capped
for more blocks a SM, or an earlier version of a part (serial edge and
luma loads, filter-intra taps read at every step); and the kernel on
the same plans with their units split between blocks and warps at
other block areas (`areas`). Each variant is built by nvcc into
build/ipred_variants/ and loaded in place of the kernel's library; its
device time is the median over 10 calls in one torch.profiler trace,
replayed on the captured planes; whether its output equals
plan_plain's is printed beside it (a step taken out changes the
output), with the variant's blocks a SM and ptxas lines. Prints one
JSON line a variant and stream.

    python tools/torch_ipred_variants.py [variant ... | areas]
"""
import ctypes as ct
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from dav1d_tpu_torch.ops import cuda_build, ipred  # noqa: E402

OUT = os.path.join(ROOT, "build", "ipred_variants")
# the edge expansion and CFL's luma AC one entry at a time, each
# thread's loads and stores in turn (the kernel's first version): the
# source from each start marker up to its end marker replaced
SERIAL_EXPANSION = """    // the edge span this unit can read, expanded from its runs
    const int32_t *ru = a.runs + (size_t)row * NRUN;
    const int span = 2 * max(w, h);
    for (int i = C - span + tid; i <= C + span; i += N) {
        int s = -1;                     // no run: 0
        if (i == C) {
            s = __ldg(ru + 16);
        } else {
            int q = i < C ? C - 1 - i : i - C - 1;
            const int32_t *r = ru + (i < C ? 0 : 8);
            const int first = __ldg(r + 3);
            if (q >= first) {
                q -= first;
                r += 4;
            }
            if (q < __ldg(r + 3))
                s = __ldg(r) + __ldg(r + 1) * min(q, __ldg(r + 2) - 1);
        }
        int v = 0;
        if (s >= 0 && s < nflat)
            v = plane[s];
        else if (s >= nflat && s < nflat + 3)
            v = s == nflat ? half + 1 : s == nflat + 1 ? half - 1 : half;
        e[i] = v;
    }
"""
SERIAL_CFL = """        int part = 0;
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int bi = min(k2 >> lw, nh - 1),
                      bj = min(k2 & (w - 1), nw - 1);
            const int32_t *s = Y + (size_t)(ypy + (bi << ss_ver)) * YW +
                ypx + (bj << ss_hor);
            int v = s[0];
            if (ss_hor) v += s[1];
            if (ss_ver) {
                v += s[YW];
                if (ss_hor) v += s[YW + 1];
            }
            v <<= shift;
            o[k2] = v;
            part += v;
        }
"""
# filter-intra's taps read from global memory (L1) at every wavefront
# step instead of held in registers (the kernel's first version)
F_TAPS_LOADED = [("        int tap[56];\n#pragma unroll\n"
                  "        for (int i = 0; i < 56; i++) "
                  "tap[i] = __ldg(tp + i);\n", ""),
                 ("acc += tap[fi * 7 + j] * q[j];",
                  "acc += __ldg(tp + fi * 7 + j) * q[j];")]
SERIAL_LOADS = [("    // the edge span this unit can read",
                 "    grp_sync<N>();", SERIAL_EXPANSION),
                ("        // the luma AC in batches",
                 "        const int log2sz", SERIAL_CFL)]
NO_PRED = [("predict<THREADS>(a, k, threadIdx.x, words);", ";"),
           ("predict<32>(a, k, lane, words + warp * WARP_WORDS);", ";")]
NO_RES = [("if (b1 > b0 || w1 > w0) {", "if (false) {")]
VARIANTS = {
    "kernel": [],
    # the grid barriers and the residual steps alone
    "no_prediction": NO_PRED,
    # the prediction steps and one barrier a level
    "no_residuals": NO_RES,
    # one barrier a level, nothing else
    "barriers_only": NO_PRED + NO_RES,
    # one block a SM: fewer blocks at each barrier, fewer warps a level
    "grid_one_per_sm": [("*grid = per * sms;", "*grid = sms;")],
    "serial_loads": SERIAL_LOADS,
    "f_taps_loaded": F_TAPS_LOADED,
    # the registers capped for 3 and 4 blocks of 128 threads a SM
    "three_per_sm": [("__launch_bounds__(THREADS)\nipred_frame_kernel",
                      "__launch_bounds__(THREADS, 3)\nipred_frame_kernel")],
    "four_per_sm": [("__launch_bounds__(THREADS)\nipred_frame_kernel",
                     "__launch_bounds__(THREADS, 4)\nipred_frame_kernel")],
    # the pixel loads of the edge expansion taken out (the sources
    # themselves stored)
    "no_edge_loads": [("            v = plane[s];", "            v = s;")],
}
# a family's prediction taken out (its units expand their edges and
# store nothing): what each family adds to the levels' slowest units
FAMILY_BRANCHES = {"s": "    if (fam == FAM_S) {",
                   "z1": "    } else if (fam == FAM_Z1) {",
                   "z3": "    } else if (fam == FAM_Z3) {",
                   "z2": "    } else if (fam == FAM_Z2) {",
                   "f": "    } else if (fam == FAM_F) {",
                   "cfl": "    } else if (fam == FAM_CFL) {"}
for _fam, _branch in FAMILY_BRANCHES.items():
    VARIANTS[f"no_{_fam}"] = [(_branch,
                               _branch.split("if")[0] + "if (false) {")]
# the kernel variant on tables split at each of these block areas
# (ops/ipred.py BLOCK_AREA: the units a block takes beside the 64-wide
# or 64-tall ones)
AREAS = (4096, 1024, 512, 256)


def variant(name, edits):
    """Build csrc/ipred.cu with `edits` into OUT/lib<name>.so."""
    src = open(os.path.join(cuda_build.CSRC, "ipred.cu")).read()
    for edit in edits:
        if len(edit) == 3:              # (start marker, end marker, new)
            start, end, new = edit
            a = src.index(start)
            src = src[:a] + new + src[src.index(end, a):]
            continue
        old, new = edit
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"ipred_{name}.cu")
    with open(cu, "w") as fh:
        fh.write(src.replace('#include "itx_common.cuh"',
                             f'#include "{cuda_build.CSRC}/itx_common.cuh"'))
    so = os.path.join(OUT, f"lib{name}.so")
    cmd = cuda_build._command("ipred", so)
    cmd[-1] = cu
    r = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return so, [ln.split(":", 1)[-1].strip()
                for ln in r.stderr.splitlines()
                if "registers" in ln or "spill" in ln]


def repack(tables, area):
    """The captured frame tables with each level's units split again
    with ops/ipred.py block_units at `area` (a block each first, then a
    warp each, both in class order), as pack_plan would."""
    import numpy as np
    host = {k: v.cpu().numpy() for k, v in tables.items()}
    units, runs, lv = host["units"], host["runs"], host["levels"].copy()
    for L, (u0, _, u1, *_rest) in enumerate(lv.tolist()):
        u, r = units[u0:u1], runs[u0:u1]
        big = ipred.block_units(u, area)
        order = np.lexsort((ipred.unit_class(u), ~big))
        units[u0:u1], runs[u0:u1] = u[order], r[order]
        units[u0:u1, 7] = np.arange(u0, u1)
        lv[L, 1] = u0 + int(big.sum())
    dev = tables["units"].device
    return {**tables, **{k: torch.from_numpy(v).to(dev) for k, v in
                         (("units", units), ("runs", runs), ("levels", lv))}}


def device_us(fn, n=10):
    """Median device us of the frame kernel over n calls of fn in one
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    d = [e.time_range.elapsed_us() for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         "ipred_frame_kernel" in e.name]
    return statistics.median(d) if d else None


def main():
    """Arguments: variant names, and `areas` for the kernel on tables
    split at each of AREAS (default: every variant, then areas)."""
    names = sys.argv[1:] or list(VARIANTS) + ["areas"]
    card = cs.smi()
    cs.phase_build()
    plans = {name: cs._ipred_plans(path)[0] for name, path in
             (("s31", cs.STREAM_1080P), ("s7", cs.STREAM_S7))}
    want = {}
    for stream, (planes, tables, pool, *args) in plans.items():
        w = [p.clone() for p in planes]
        ipred.plan_plain(w, tables, pool, *args)
        want[stream] = w
    kernel_lib = ipred._lib()
    for name in names:
        areas = AREAS if name == "areas" else (None,)
        so, ptxas = variant(name, VARIANTS.get(name, []))
        lib = ct.CDLL(so)
        lib.ipred_plan.restype = ct.c_int
        lib.ipred_plan.argtypes = kernel_lib.ipred_plan.argtypes
        lib.ipred_occupancy.restype = ct.c_int
        lib.ipred_occupancy.argtypes = kernel_lib.ipred_occupancy.argtypes
        ipred._LIB = lib
        try:
            per = ipred.occupancy(8)[0]
            for area in areas:
                for stream, (planes, tables, pool, *args) in plans.items():
                    if area is not None:
                        tables = repack(tables, area)
                    got = [p.clone() for p in planes]
                    ipred.plan_cuda(got, tables, pool, *args)
                    torch.cuda.synchronize()
                    equal = all(torch.equal(a, b)
                                for a, b in zip(got, want[stream]))
                    us = device_us(lambda: ipred.plan_cuda(
                        got, tables, pool, *args))
                    print(json.dumps({
                        "card": card, "variant": name, "block_area": area,
                        "stream": stream, "us": us, "equal": equal,
                        "blocks_per_sm": per, "ptxas": ptxas}), flush=True)
        finally:
            ipred._LIB = kernel_lib


if __name__ == "__main__":
    main()
