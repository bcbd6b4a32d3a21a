"""The device leftover route of the checkout at argv[1] (or of this one)
on one GPU, per frame: s31, s7 and s21_realistic decoded whole on cuda
with their leftovers forced onto the device (DAV1D_TPU_LO=device, stage
syncs on), and for each inter frame with leftovers the host ms of the
plan walk and its tables (inter.lo_build), of the leftover execution
(inter.lo_device), the bytes of the plan's tables that cross in the
frame's upload, and the leftover kernels launched; then the execution
of the first inter frame's plan replayed on its captured planes: the
device us of every kernel it launches (torch.profiler, summed over the
replay; median of the replays), the span between CUDA events around it
(the launches' gaps included), its host ms with a synchronize, and the
kernels and launches of one replay. Prints one JSON line per stream.

The checkout's own package and chip_smoke.py decode (its build phase
builds every kernel first); the spies here are generic: any checkout's
recon/ipred_device.py `level_tables` (a dict of numpy tables) and
`execute` (the frame's leftover execution on recon.pic.dev). To compare
two commits on one card, in one call, in turns:

    git archive <commit> | tar -x -C build/parent
    python tools/torch_lo_frame.py build/parent
    python tools/torch_lo_frame.py .
    python tools/torch_lo_frame.py .
    python tools/torch_lo_frame.py build/parent
"""
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

REPLAYS = 20          # replays of the first plan's execution, 5 a trace
STREAMS = (("s31", cs.STREAM_1080P), ("s7", cs.STREAM_S7),
           ("s21_realistic", "bench_streams/1920x1080_8b_flt_s21_realistic"
            ".ivf"))


def _launch_counts():
    from dav1d_tpu_torch.ops import ipred, itx
    return {"ipred": ipred.LAUNCHES["ipred"],
            "itx_add": itx.LAUNCHES["itx_add"]}


def decode(path):
    """Per inter frame with leftovers: its stage ms, table bytes and
    launches; and the first plan's (recon, execute args, planes before
    it)."""
    from dav1d_tpu_torch.recon import inter_device, ipred_device
    from dav1d_tpu_torch.utils import timing
    frames, first = [], []
    orig = (inter_device.DeviceInterReconstructor.run_native,
            ipred_device.level_tables, ipred_device.execute)
    tables = []

    def run_native(self, jobs):
        before = {k: timing._T.get(k, 0.0) for k in
                  ("inter.lo_build", "inter.lo_device")}
        n0 = _launch_counts()
        tables.clear()
        out = orig[0](self, jobs)
        if len(self.leftovers):
            frames.append({
                "n_leftovers": len(self.leftovers),
                "device": self._dev_lo is not None,
                **{k.split(".")[1] + "_ms":
                   (timing._T.get(k, 0.0) - v) * 1e3
                   for k, v in before.items()},
                "lo_table_bytes": sum(t.nbytes for t in tables),
                "launches": {k: v - n0[k]
                             for k, v in _launch_counts().items()}})
        return out

    def level_tables(*a):
        out = orig[1](*a)
        tables.extend(out.values())
        return out

    def execute(recon, *a):
        if not first:
            first.append((recon, a, [p.clone() for p in recon.pic.dev]))
        return orig[2](recon, *a)
    inter_device.DeviceInterReconstructor.run_native = run_native
    ipred_device.level_tables = level_tables
    ipred_device.execute = execute
    try:
        with cs._lo_env("device"):
            _, digest, wall, _, _ = cs._decode(path, timed=True)
    finally:
        inter_device.DeviceInterReconstructor.run_native = orig[0]
        ipred_device.level_tables = orig[1]
        ipred_device.execute = orig[2]
    return frames, first[0], digest, wall


def replay(first):
    """The first plan's execution replayed on its captured planes (each
    replay rewrites what it predicts before its residuals add, so every
    replay gives the same planes)."""
    from dav1d_tpu_torch.recon import ipred_device
    from torch.profiler import ProfilerActivity, profile
    recon, args, planes = first
    recon.pic.dev = planes
    run = lambda: ipred_device.execute(recon, *args)
    run()
    torch.cuda.synchronize()
    host = []
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    span = []
    for _ in range(REPLAYS):
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b) * 1e3)
    cuda = torch.autograd.DeviceType.CUDA
    device, kernels = [], {}
    for _ in range(REPLAYS // 5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == cuda]
        if ev:
            device.append(sum(e.time_range.elapsed_us() for e in ev) / 5)
            for e in ev:
                kernels[e.name] = kernels.get(e.name, 0) + 1
    n0 = _launch_counts()
    run()
    torch.cuda.synchronize()
    return {"device_us": statistics.median(device) if device else None,
            "device_us_per_trace": device,
            "event_span_us": statistics.median(span),
            "host_ms": statistics.median(host),
            "kernels_per_replay": {k: v / (5 * len(device))
                                   for k, v in kernels.items()}
            if device else None,
            "launches": {k: v - n0[k] for k, v in _launch_counts().items()}}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = cs.smi()
    cs.phase_build()
    for name, path in STREAMS:
        frames, first, digest, wall = decode(path)
        r = replay(first)
        print(json.dumps({"checkout": root, "card": card, "stream": name,
                          "md5": digest, "synced_wall_ms": wall,
                          "frames": frames, "first_plan": r}), flush=True)


if __name__ == "__main__":
    main()
