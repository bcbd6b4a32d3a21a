"""Where a compound block's time goes, on one GPU.

Builds an instrumented copy of dav1d_tpu_torch/csrc/mc_comp.cu (into
build/dav1d_tpu_torch/phases/) in which thread 0 of every block reads
%globaltimer at the block's start, after each of its two barriers and
at its end, replays the compound launches of the s7 stream's frame 2
(bench_streams/1920x1080_8b_flt_s7.ivf, decoded on the card), and
prints one JSON line per launch: the launch span, the blocks' start
skew, the load / horizontal / vertical phase times (ns: median, 90th
percentile, max) and the most blocks one SM ran.

    python tools/torch_comp_phases.py
"""
import ctypes as ct
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MAX_BLOCKS = 8192

STAMP = "if (threadIdx.x == 0) g_prof[blockIdx.x][{}] = gtime();\n"
PRELUDE = f"""namespace {{
__device__ unsigned long long g_prof[{MAX_BLOCKS}][5];
__device__ __forceinline__ unsigned long long gtime() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
"""
READER = """
extern "C" int prof_read(unsigned long long *h, int n) {
    cudaMemcpyFromSymbol(h, g_prof, sizeof(unsigned long long) * 5 * n);
    return (int)cudaGetLastError();
}
"""


def instrumented_source():
    src = open(os.path.join(ROOT, "dav1d_tpu_torch", "csrc",
                            "mc_comp.cu")).read()
    src = src.replace("namespace {\n", PRELUDE, 1)
    smem = "    __shared__ __align__(16) int smem[SMEM_WORDS];\n"
    src = src.replace(smem, smem + "    " + STAMP.format(0))
    first, second, rest = src.split("    __syncthreads();\n")
    end = "    vpass_combine(a, jobs, count, ty0, tx0, cls, ib, smem);\n"
    rest = rest.replace(end, end + """    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned sm;
        asm("mov.u32 %0, %%smid;" : "=r"(sm));
        g_prof[blockIdx.x][3] = gtime();
        g_prof[blockIdx.x][4] = sm;
    }
""")
    barrier = "    __syncthreads();\n    "
    return (first + barrier + STAMP.format(1) + second + barrier +
            STAMP.format(2) + rest + READER)


def build(cuda_build):
    out_dir = os.path.join(cuda_build.BUILD, "phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "mc_comp_phases.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    so = os.path.join(out_dir, "libmc_comp_phases.so")
    r = subprocess.run([cuda_build.nvcc(), "-gencode", cuda_build.ARCH,
                        "-std=c++17", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", so, cu], capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stderr)
    return ct.CDLL(so)


def s7_comp_calls(torch, mc):
    """The compound calls of the s7 stream's first inter frame, each with
    copies of the planes it started from."""
    from dav1d_tpu_torch.api import Decoder, Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    calls = []
    orig = mc.comp

    def spy(refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor, ss_ver,
            blocks=None):
        calls.append((refs, jobs, plane.clone(), seg.clone(), rh, rw, bd,
                      luma, ss_hor, ss_ver, blocks))
        return orig(refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor,
                    ss_ver, blocks)

    mc.comp = spy
    try:
        dec = Decoder(Settings())
        path = os.path.join(ROOT, "bench_streams", "1920x1080_8b_flt_s7.ivf")
        for i, fr in enumerate(IvfReader(open(path, "rb").read())):
            if i >= 2:
                break
            dec.send_data(fr.data)
            list(dec.pictures())
    finally:
        mc.comp = orig
    return calls


def pct(a):
    return [int(np.percentile(a, q)) for q in (50, 90, 100)]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from dav1d_tpu_torch.ops import cuda_build, mc
    from dav1d_tpu_torch.ops.device import device_tables
    from dav1d_tpu_torch.ops.mc_ref import BS_32X32
    lib = build(cuda_build)
    lib.mc_comp_set_filters.argtypes = [ct.c_void_p]
    fb = np.ascontiguousarray(mc.filter_banks())
    if lib.mc_comp_set_filters(fb.ctypes.data):
        sys.exit("filter upload failed")
    lib.mc_comp.argtypes = mc._lib("mc_comp").mc_comp.argtypes
    lib.mc_comp.restype = ct.c_int
    lib.prof_read.argtypes = [ct.c_void_p, ct.c_int]
    tb = device_tables("cuda")
    for (refs, jobs, before, seg, rh, rw, bd, luma, sh, sv,
         blocks) in s7_comp_calls(torch, mc):
        n = len(blocks)
        if n > MAX_BLOCKS:
            sys.exit(f"{n} blocks, at most {MAX_BLOCKS}")
        ptrs, ref_w = mc._check_refs(refs, before.device, rh, rw)
        for _ in range(4):            # the last of 4 runs is read
            p, s = before.clone(), seg.clone()
            torch.cuda.synchronize()
            rc = lib.mc_comp(
                ptrs, len(refs), ref_w, jobs.data_ptr(), blocks.data_ptr(),
                n, p.data_ptr(), p.shape[0], p.shape[1], s.data_ptr(),
                s.shape[0], s.shape[1], tb["mc_wedge_lut16"].data_ptr(),
                tb["mc_wedge_lut32"].data_ptr(), rh, rw, bd,
                1 if luma else 2, sh, sv, BS_32X32,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                sys.exit(f"launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
        t = np.zeros((n, 5), np.uint64)
        lib.prof_read(t.ctypes.data, n)
        t = t.astype(np.int64)
        start = t[:, 0] - t[:, 0].min()
        print(json.dumps({
            "luma": luma, "blocks": n,
            "span_ns": int((t[:, 3] - t[:, 0].min()).max()),
            "start_ns": pct(start), "load_ns": pct(t[:, 1] - t[:, 0]),
            "hpass_ns": pct(t[:, 2] - t[:, 1]),
            "vpass_ns": pct(t[:, 3] - t[:, 2]),
            "blocks_per_sm_max": int(np.bincount(t[:, 4]).max())}),
            flush=True)


if __name__ == "__main__":
    main()
