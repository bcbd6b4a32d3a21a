"""Time the CDEF, Wiener, SGR, OBMC and warp kernels (csrc/cdef.cu,
csrc/lr_wiener.cu, csrc/lr_sgr.cu, csrc/mc_obmc.cu, csrc/mc_warp.cu)
against variants of their own sources on one GPU, on the inputs the
decode of the s31 stream's first 2 temporal units gives the kernels
for frame 2. A
variant is the source with some lines replaced: a phase taken out
(which attributes the kernel's time to its phases) or an earlier or
other design choice put in (which measures that choice). Each variant
is built by nvcc into build/filter_variants/ and loaded in place of the
kernel's library; its device time is the median of 30 calls in one
torch.profiler trace (the sum of a call's kernels: OBMC's two-launch
variant counts both); whether its output equals the kernel's is printed
beside it (a phase taken out changes the output). Prints one JSON line
a variant and writes them all to the JSON file argv[1] (default
build/filter_variants/variants.json); further arguments name the
kernels to run (default: all five), each optionally followed by a colon
and the comma-separated variants to run of it (default: all).

    python tools/torch_filter_variants.py [out.json] [cdef lr_wiener
                                                      lr_sgr mc_obmc mc_warp]
    python tools/torch_filter_variants.py out.json lr_sgr:kernel,grid_mode
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
from dav1d_tpu_torch.ops import cdef, cuda_build, lr, mc_obmc, \
    mc_warp  # noqa: E402
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
# the block row, or without a block table a grid of items x tiles (the
# mode of a per-plane entry that no longer exists): what dropping the
# mode did to the Wiener and SGR kernels' code
GRID_MODE = ("""    const int item = a.blocks[2 * blockIdx.x];
    const int c0 = a.blocks[2 * blockIdx.x + 1];
""", """    int item, c0;
    if (a.blocks) {
        item = a.blocks[2 * blockIdx.x];
        c0 = a.blocks[2 * blockIdx.x + 1];
    } else {
        item = blockIdx.x;
        c0 = blockIdx.y * TW;
    }
""")
WIENER = {
    "kernel": [],
    "grid_mode": [GRID_MODE],
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

# SGR: the box sums taken directly, 9 and 25 window reads and squares a
# box (the design before the separable sums), in place of phase (2)
SGR_BOXES = ("    if (q < S && e0 < e1) {", "    __syncthreads();\n\n    // (3)")
SGR_DIRECT = """    (void)q; (void)e0; (void)e1; (void)xx;
    if (w1) {
        for (int i = tid; i < (ohs + 2) * bw; i += THREADS) {
            const int rr = i / bw, cx = i - rr * bw;
            int sum = 0, sq = 0;
#pragma unroll
            for (int dy = 1; dy <= 3; dy++)
#pragma unroll
                for (int dx = 1; dx <= 3; dx++) {
                    const int v = s_win[rr + dy][cx + dx];
                    sum += v;
                    sq += v * v;
                }
            const int2 ab = calc_ab(sq, sum, s1, 9, 455, ra, sa, rb, sb,
                                    s_xbyx);
            s_a3[rr][cx] = ab.x;
            s_b3[rr][cx] = (uint8_t)ab.y;
        }
    }
    if (w0) {
        for (int i = tid; i < nj * bw; i += THREADS) {
            const int jj = i / bw, cx = i - jj * bw;
            int sum = 0, sq = 0;
#pragma unroll
            for (int dy = 0; dy < 5; dy++)
#pragma unroll
                for (int dx = 0; dx < 5; dx++) {
                    const int v = s_win[2 * jj + dy][cx + dx];
                    sum += v;
                    sq += v * v;
                }
            const int2 ab = calc_ab(sq, sum, s0, 25, 164, ra, sa, rb, sb,
                                    s_xbyx);
            s_a5[jj][cx] = ab.x;
            s_b5[jj][cx] = (uint8_t)ab.y;
        }
    }
"""
SGR = {
    "kernel": [],
    "grid_mode": [GRID_MODE],
    # staging and the output stores (both weights 0: no boxes, no blend)
    "stage_only": [("w0 = it[I_W0], w1 = it[I_W1];", "w0 = 0, w1 = 0;")],
    "direct_boxes": [(SGR_BOXES, SGR_DIRECT)],
    # 256 threads a block (4 a SM)
    "threads256": [("constexpr int THREADS = 512;",
                    "constexpr int THREADS = 256;"),
                   ("constexpr int MIN_BLOCKS = 3;",
                    "constexpr int MIN_BLOCKS = 4;")],
    # the blend's shared reads and stores, its arithmetic taken out
    "boxes_only": [(("    int32_t *dst = P.dst + (size_t)(it[I_OY] + r0)",
                     "#undef ROW3"), """    int32_t *dst = P.dst + (size_t)(it[I_OY] + r0) * P.ds + it[I_OX] +
        c0 + x;
    for (int r = r0; r < r1; r++, dst += P.ds)
        *dst = s_win[r + 3][x + 3] + ((s_a3[r + 1][x + 1] + s_b3[r + 1][x] +
                                       s_a5[r >> 1][x + 1] +
                                       s_b5[r >> 1][x]) & 1);
    (void)ha0; (void)ha1; (void)ca0; (void)ca1; (void)hb0; (void)hb1;
    (void)cb0; (void)cb1; (void)A5; (void)B5; (void)px_max;
}

""")],
}
OBMC = {
    "kernel": [],
    # the launch, the job rows and their checks, the grid barrier
    "jobs_only": [("    if (rows <= 0 || cols <= 0) return;\n\n    // (1)",
                   "    if (rows <= 0 || cols <= 0 || rows) return;\n\n"
                   "    // (1)")],
    # the window and region staged and the region written back, no taps
    "no_slide": [(("    if (cols > 32) {",
                   "    __syncwarp();\n\n    // (3)"), "")],
    # a wide lap's two columns of a lane slid one after the other (one
    # code copy of the slide, not two)
    "one_column": [("""            slide<2>(win, ws, reg, cols, lane, 0, rows, fh, fv, ib, px_max,
                     om, top, j[J_WW], j[J_HH]);""", """        {
            slide<1>(win, ws, reg, cols, lane, 0, rows, fh, fv, ib, px_max,
                     om, top, j[J_WW], j[J_HH]);
            slide<1>(win, ws, reg, cols, lane + 32, 0, rows, fh, fv, ib,
                     px_max, om, top, j[J_WW], j[J_HH]);
        }""")],
    # cycles (clock64) of each phase of a lap (job row and checks,
    # staging, slide, write-back) summed over the laps, of the grid
    # barrier and of each warp's whole run (mc_obmc_prof)
    "phases": [
        ("__device__ int g_om[MAX_DIM];",
         "__device__ int g_om[MAX_DIM];\n"
         "__device__ unsigned long long g_prof[8];"),
        ("    int j[J_N];\n#pragma unroll\n    for (int k = 0; k < J_N; k++) "
         "j[k] = __shfl_sync",
         "    const long long t0 = clock64();\n    int j[J_N];\n"
         "#pragma unroll\n    for (int k = 0; k < J_N; k++) j[k] = "
         "__shfl_sync"),
        ("    if (rows <= 0 || cols <= 0) return;\n\n    // (1)",
         "    if (rows <= 0 || cols <= 0) return;\n"
         "    const long long t1 = clock64();\n\n    // (1)"),
        ("    cp_async_wait_all();\n    __syncwarp();\n",
         "    cp_async_wait_all();\n    __syncwarp();\n"
         "    const long long t2 = clock64();\n"),
        ("    __syncwarp();\n\n    // (3) the blended region back",
         "    __syncwarp();\n    const long long t3 = clock64();\n\n"
         "    // (3) the blended region back"),
        ("reg[s.y * cols + s.x];\n    __syncwarp();\n}",
         "reg[s.y * cols + s.x];\n    __syncwarp();\n    if (lane == 0) {\n"
         "        atomicAdd(&g_prof[0], (unsigned long long)(t1 - t0));\n"
         "        atomicAdd(&g_prof[1], (unsigned long long)(t2 - t1));\n"
         "        atomicAdd(&g_prof[2], (unsigned long long)(t3 - t2));\n"
         "        atomicAdd(&g_prof[3], (unsigned long long)(clock64() - "
         "t3));\n        atomicAdd(&g_prof[4], 1ull);\n    }\n}"),
        ("        if (dir) cg::this_grid().sync();",
         "        if (dir) {\n            const long long tb = clock64();\n"
         "            cg::this_grid().sync();\n"
         "            if (lane == 0) atomicAdd(&g_prof[5], "
         "(unsigned long long)(clock64() - tb));\n        }"),
        ("    const int stride = gridDim.x * WARPS;\n",
         "    const int stride = gridDim.x * WARPS;\n"
         "    const long long tk = clock64();\n"),
        ("            v = vn;\n        }\n    }\n}",
         "            v = vn;\n        }\n    }\n    if (lane == 0) {\n"
         "        atomicAdd(&g_prof[6], (unsigned long long)(clock64() - tk));"
         "\n        atomicAdd(&g_prof[7], 1ull);\n    }\n}\n\n"
         "}  // namespace\n\n"
         "extern \"C\" int mc_obmc_prof(unsigned long long *out) {\n"
         "    cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "    return (int)cudaGetLastError();\n}\nnamespace {"),
    ],
    # globaltimer (ns) marks of one launch, min / max over its warps:
    # start, top laps done, left laps started, left laps done
    # (mc_obmc_tl, after mc_obmc_tl_reset)
    "timeline": [
        ("__device__ int g_om[MAX_DIM];",
         "__device__ int g_om[MAX_DIM];\n"
         "__device__ unsigned long long g_tl[8];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "    unsigned long long t;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "    return t;\n}"),
        ("    const int stride = gridDim.x * WARPS;\n",
         "    const int stride = gridDim.x * WARPS;\n"
         "    if (lane == 0) {\n        const unsigned long long t = gtime();\n"
         "        atomicMin(&g_tl[0], t);\n        atomicMax(&g_tl[1], t);\n"
         "    }\n"),
        ("        if (dir) cg::this_grid().sync();",
         "        if (dir && lane == 0) atomicMax(&g_tl[2], gtime());\n"
         "        if (dir) cg::this_grid().sync();\n"
         "        if (dir && lane == 0) {\n"
         "            const unsigned long long t = gtime();\n"
         "            atomicMin(&g_tl[3], t);\n            atomicMax(&g_tl[4], t);\n"
         "        }"),
        ("            v = vn;\n        }\n    }\n}",
         "            v = vn;\n        }\n    }\n"
         "    if (lane == 0) atomicMax(&g_tl[5], gtime());\n}\n\n"
         "}  // namespace\n\n"
         "extern \"C\" int mc_obmc_tl_reset() {\n"
         "    const unsigned long long z[8] = {~0ull, 0, 0, ~0ull, 0, 0, 0, 0};\n"
         "    cudaMemcpyToSymbol(g_tl, z, sizeof(z));\n"
         "    return (int)cudaGetLastError();\n}\n"
         "extern \"C\" int mc_obmc_tl(unsigned long long *out) {\n"
         "    cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n"
         "    return (int)cudaGetLastError();\n}\nnamespace {"),
    ],
    # two ordinary launches a frame, the top laps then the left laps, a
    # block of 3 laps per 3 laps of the direction (no grid barrier)
    "two_launches": [
        ("    int n_laps[2];\n    int bd;\n};",
         "    int n_laps[2];\n    int bd;\n    int dir;\n};"),
        ("    for (int dir = 0; dir < 2; dir++) {     // top laps, then left "
         "laps\n        if (dir) cg::this_grid().sync();\n",
         "    for (int dir = a.dir; dir == a.dir; dir++) {\n"),
        ("""    void *args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void *)mc_obmc_kernel, dim3(grid), dim3(THREADS), args, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    *launches = 1;""", """    (void)grid;
    for (a.dir = 0; a.dir < 2; a.dir++) {
        if (!a.n_laps[a.dir]) continue;
        mc_obmc_kernel<<<(a.n_laps[a.dir] + WARPS - 1) / WARPS, THREADS, 0,
                         (cudaStream_t)stream>>>(a);
        ++*launches;
    }""")],
}

# the warp: its tiles' vertical sums stored as the window's centre pixel
# (the window staged and the output written, no taps)
WARP_COPY = """{
            const Plane &P = a.p[j[J_PLANE]];
            for (int k = 0; k < 2; k++) {
                const int o = lane + 32 * k, y = o >> 3, x = o & 7;
                const int oy = j[J_PY] + y, ox = j[J_PX] + x;
                if (oy < P.dst_h && ox < P.dst_w)
                    P.dst[(size_t)oy * P.dst_w + ox] =
                        win[(y + 3) * WS + x + 3];
            }
        }"""
WARP = {
    "kernel": [],
    # the launch, the bank and the job rows with their checks
    "jobs_only": [("stage_window(a, j, lane, win);", "(void)win;"),
                  ("horizontal(j, lane, wf, win, mid, ib);", ""),
                  ("vertical(a, j, lane, wf, mid, ib);", "")],
    # the windows staged and written out, no taps
    "stage_only": [("horizontal(j, lane, wf, win, mid, ib);",
                    "(void)mid;"),
                   ("vertical(a, j, lane, wf, mid, ib);", WARP_COPY)],
    # 4 and 16 warps a block (twice and half as many blocks)
    "warps4": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "warps16": [("constexpr int WARPS = 8;", "constexpr int WARPS = 16;")],
}


def variant(name, kernel, edits):
    """Build csrc/<kernel>.cu with `edits` applied (pairs (old, new);
    an old of two strings (start, end) replaces the text from start to
    end); returns (library, ptxas lines)."""
    src = open(os.path.join(cuda_build.CSRC, f"{kernel}.cu")).read()
    for old, new in edits:
        if isinstance(old, tuple):
            a, b = src.find(old[0]), src.find(old[1])
            if a < 0 or b < a:
                raise RuntimeError(f"{kernel} variant {name}: span missing")
            old = src[a:b]
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


def device_us(fn, key, n=30, per_call=1):
    """Median device us of the last n of n + 3 calls of fn, each the sum
    of its per_call kernels whose name holds key, from one torch.profiler
    trace (which may miss a call's first kernels; a trace that holds
    fewer is taken again, up to 3 times)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n + 3):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and
                      key in e.name), key=lambda e: e.time_range.start)
        if len(evs) >= n * per_call:
            break
    else:
        raise RuntimeError(f"the trace holds {len(evs)} {key} launches")
    evs = evs[len(evs) - n * per_call:]
    ts = sorted(sum(e.time_range.elapsed_us()
                    for e in evs[i * per_call:(i + 1) * per_call])
                for i in range(n))
    return ts[len(ts) // 2]


def load_as(lib, setup):
    """Run a wrapper module's own library setup (setup()) with
    cuda_build handing out `lib`, so that the module uses it."""
    load = cuda_build.load_library
    cuda_build.load_library = lambda name: lib
    try:
        setup()
    finally:
        cuda_build.load_library = load


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.smi()
    todo = sys.argv[2:] or ["cdef", "lr_wiener", "lr_sgr", "mc_obmc",
                            "mc_warp"]
    rec = {}
    run = {"cdef": cdef.cdef_planes, "wiener": lr.wiener_frame,
           "sgr": lr.sgr_frame, "obmc": mc_obmc.obmc_planes,
           "warp": mc_warp.warp_planes}

    def spy_c(*a):
        rec["cdef"] = a
        return run["cdef"](*a)

    def spy_lr(kind):
        def spy(planes, tables, bd):
            rec[kind] = ([(s, q, d.clone(), w, h)
                          for s, q, d, w, h in planes], tables, bd)
            return run[kind](planes, tables, bd)
        return spy

    def spy_w(planes, jobs, bd):
        rec["warp"] = ([(r, p.clone(), rh, rw) for r, p, rh, rw in planes],
                       jobs, bd)
        return run["warp"](planes, jobs, bd)

    def spy_o(planes, top, left, bd):
        rec["obmc"] = ([(r, p.clone(), rh, rw) for r, p, rh, rw in planes],
                       top, left, bd)
        return run["obmc"](planes, top, left, bd)
    cdef.cdef_planes, lr.wiener_frame, lr.sgr_frame = \
        spy_c, spy_lr("wiener"), spy_lr("sgr")
    mc_obmc.obmc_planes, mc_warp.warp_planes = spy_o, spy_w
    try:
        cs._decode(cs.STREAM_1080P, timed=False, n_tu=2)
    finally:
        cdef.cdef_planes, lr.wiener_frame, lr.sgr_frame = \
            run["cdef"], run["wiener"], run["sgr"]
        mc_obmc.obmc_planes, mc_warp.warp_planes = run["obmc"], run["warp"]

    def lr_frame(kind):
        planes, tables, bd = rec[kind]
        wmax = lr.check_frame(planes, tables, kind)
        items, rowt, blocks = lr.upload_tables(
            [*tables, lr.item_blocks(tables[0])], "cuda")

        def fn():
            dsts = [p[2].clone() for p in planes]
            lr._frame_launch(kind, [(s, q, d, w, m) for (s, q, _, w, _), d, m
                                    in zip(planes, dsts, wmax)], items,
                             rowt, blocks, bd)
            return dsts
        return fn

    def obmc():
        planes, top, left, bd = rec["obmc"]
        ps = [(r, p.clone(), rh, rw) for r, p, rh, rw in planes]
        mc_obmc.obmc_cuda(ps, top, left, bd)
        return [p for _, p, _, _ in ps]

    def warp():
        planes, jobs, bd = rec["warp"]
        ps = [(r, p.clone(), rh, rw) for r, p, rh, rw in planes]
        mc_warp.warp_cuda(ps, jobs, bd)
        return [p for _, p, _, _ in ps]

    def setup_warp(lib):
        mc_warp._LIB.clear()
        load_as(lib, mc_warp._lib)

    def setup_cdef(lib):
        lib.cdef_set_tables.argtypes = [ct.c_void_p, ct.c_void_p]
        if lib.cdef_set_tables(np.ascontiguousarray(cdef_dirs(),
                                                    np.int32).ctypes.data,
                               np.ascontiguousarray(UV_DIRS,
                                                    np.int32).ctypes.data):
            raise RuntimeError("cdef_set_tables failed")
        lib.cdef_frame.restype = ct.c_int
        lib.cdef_frame.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                   ct.c_void_p]
        cdef._LIB[:] = [lib]

    def setup_lr(name):
        def setup(lib):
            lr._LIBS.pop(name, None)
            load_as(lib, lambda: lr._lib(name))
        return setup

    def setup_obmc(lib):
        mc_obmc._LIB.clear()
        load_as(lib, mc_obmc._lib)

    # kernel: (variants, run on the recorded inputs, name in the trace,
    # library setup)
    kernels = {
        "cdef": (CDEF, lambda: cdef.cdef_cuda(*rec["cdef"]), "cdef_kernel",
                 setup_cdef),
        "lr_wiener": (WIENER, lr_frame("wiener"), "lr_wiener_kernel",
                      setup_lr("lr_wiener")),
        "lr_sgr": (SGR, lr_frame("sgr"), "lr_sgr_kernel",
                   setup_lr("lr_sgr")),
        "mc_obmc": (OBMC, obmc, "mc_obmc_kernel", setup_obmc),
        "mc_warp": (WARP, warp, "mc_warp_kernel", setup_warp)}
    lines = []
    for arg in todo:
        kernel, _, only = arg.partition(":")
        variants, fn, key, setup = kernels[kernel]
        want = fn()
        for name in only.split(",") if only else variants:
            edits = variants[name]
            lib, ptxas = variant(name, kernel, edits)
            setup(lib)
            timeline = None
            if hasattr(lib, "mc_obmc_tl_reset"):
                lib.mc_obmc_tl_reset()
            got = fn()
            torch.cuda.synchronize()
            if hasattr(lib, "mc_obmc_tl"):
                # ns from the first warp's start: the last warp's start,
                # the last top lap done, the first and last warp past the
                # grid barrier, the last left lap done
                tl = (ct.c_ulonglong * 8)()
                lib.mc_obmc_tl(tl)
                timeline = [tl[k] - tl[0] for k in (1, 2, 3, 4, 5)]
            us = device_us(fn, key, per_call=2 if name == "two_launches"
                           else 1)
            extra = {}
            if hasattr(lib, "mc_obmc_prof"):
                # per lap: job row and checks, staging, slide, write-back;
                # per warp: the grid barrier and its whole run; cycles
                prof = (ct.c_ulonglong * 8)()
                lib.mc_obmc_prof(prof)
                laps, warps = max(prof[4], 1), max(prof[7], 1)
                extra = {"cycles_per_lap": [prof[k] / laps for k in range(4)],
                         "barrier_cycles_per_warp": prof[5] / warps,
                         "run_cycles_per_warp": prof[6] / warps,
                         "laps_per_warp": prof[4] / warps}
            if timeline is not None:
                extra["timeline_ns"] = timeline
            per_sm = getattr(lib, f"{kernel}_blocks_per_sm", None)
            if per_sm is not None:
                extra["blocks_per_sm"] = per_sm()
            lines.append({
                "kernel": kernel, "variant": name, "us": us, **extra,
                "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
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
