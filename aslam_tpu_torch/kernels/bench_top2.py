"""Timers for a kernel on the card, and the times of `hamming_top2`.

`graph_us` gives a kernel's device time free of the host: K launches captured
into one CUDA graph, replayed between CUDA events.  `event_us` is the eager
per-call time (CUDA events around a run of calls, host included where it is
the slower side) and `host_us` the host's own time per unsynchronised call.
`mma_peak_ops_per_s` measures the rate that the card sustains for the 1-bit
tensor-core product the kernel scores with, for which the data sheet has no
figure: `hamming_top2_bound` divides by the constant taken from it.
`chip_smoke.py` uses all four.

    python -m aslam_tpu_torch.kernels.bench_top2

checks `hamming_top2` against its plain version and prints one JSON line: the
card's name and power limit, three readings of the 1-bit rate beside the
constant, and the kernel's device time (twice), host time and bound at 1024 x
1024 and 8192 x 8192.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import numpy as np
import torch


def graph_us(launch, launches: int = 20, replays: int = 50) -> float:
    """Device microseconds per call of `launch()`: `launches` calls captured
    into one CUDA graph, replayed `replays` times between CUDA events."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            launch()
    for _ in range(3):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (launches * replays)


def event_us(fn, iters: int = 200, warmup: int = 10) -> float:
    """Microseconds per eager call of `fn()`, CUDA events around `iters`
    after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def host_us(fn, iters: int = 1000, repeats: int = 3) -> float:
    """Host microseconds per call of `fn()`: the median of `repeats` runs of
    `iters` unsynchronised calls."""
    for _ in range(10):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / iters)
    torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def top2_inputs(rng, dev, n: int = 1024, m: int = 1024):
    """Random descriptors, a tenth masked, with tied minima among them."""
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    va, vb = rng.random(n) > 0.1, rng.random(m) > 0.1
    if n >= 96 and m >= 508:
        b[100:132] = b[100]                 # duplicated targets: tied minima
        a[:64] = b[100]
        a[64:96] = b[7] ^ np.uint32(1 << 31)
        b[500:508] = b[7]
    return [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
            .to(dev) for x in (a, va, b, vb)]


def mma_peak_ops_per_s(dev, iters: int = 2000) -> float:
    """1-bit tensor-core operations per second that the card sustains: the
    probe kernel of `csrc/hamming_top2.cu` (`mma.sync m16n8k256 .b1 .and.popc`
    alone, 8 independent chains a warp, 16 warps on every SM) between CUDA
    events, the best of three launches."""
    from aslam_tpu_torch.kernels import build

    probe = build.load("hamming_top2").hamming_top2_mma_peak_launch
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    probe.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 512, dtype=torch.int32, device=dev)
    ops = ctypes.c_longlong()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = []
    for k in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        if probe(out.data_ptr(), blocks, iters, ctypes.byref(ops), stream) != 0:
            raise RuntimeError("the mma probe did not launch")
        end.record()
        torch.cuda.synchronize()
        if k:                               # the first launch warms up
            rates.append(ops.value / (start.elapsed_time(end) * 1e-3))
    return max(rates)


def main():
    from aslam_tpu_torch.ops.hamming_top2 import (MMA_OPS_PER_S, hamming_top2,
                                                  hamming_top2_bound,
                                                  hamming_top2_plain)

    if not torch.cuda.is_available():
        raise SystemExit("bench_top2: no CUDA device")
    dev = torch.device("cuda", 0)
    result = {"card": card(),
              "mma_b1_ops_per_s": [mma_peak_ops_per_s(dev) for _ in range(3)],
              "MMA_OPS_PER_S": MMA_OPS_PER_S, "shapes": {}}
    rng = np.random.default_rng(0)
    for n, m in ((1024, 1024), (8192, 8192)):
        inputs = top2_inputs(rng, dev, n, m)
        for x, y in zip(hamming_top2(*inputs), hamming_top2_plain(*inputs)):
            if not torch.equal(x, y):
                raise AssertionError(f"the kernel differs from the plain version at {n}x{m}")
        row = {"bound_us": hamming_top2_bound(n, m)["bound_us"],
               "device_us": [graph_us(lambda: hamming_top2(*inputs)) for _ in range(2)]}
        if n == 1024:           # at the large shape the queue fills: no host time
            row["host_us"] = host_us(lambda: hamming_top2(*inputs))
        result["shapes"][f"{n}x{m}"] = row
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
