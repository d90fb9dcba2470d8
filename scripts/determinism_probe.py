#!/usr/bin/env python3
"""Find what makes two runs of the port's SLAM engine differ on a CUDA card.

    PYTHONPATH=. python scripts/determinism_probe.py

First, at the local BA's shapes, whether `index_add_` and the ordered form
(`ops/index.py::index_add_ordered`) give the same bits over repeated calls,
and what each costs (CUDA events).  Then it drives `DeviceSlam` with
`bench_config3(loop_closing=True)` over the bench walk in two chunks (the
uninterrupted run of `chip_smoke.py` phase 7(c)), in turns atomic, ordered,
ordered, atomic, and prints per mode the largest pose difference between
its two runs and the local BA's ms per run (host clock around each
`lba.local_ba` call, synchronised):
  ordered        the engine as it is: every float scatter-add ordered;
  atomic         `index_add_ordered` sent back to `index_add_`, whose CUDA
                 kernel adds with atomics.
Last, two ordered runs under `torch.use_deterministic_algorithms(True,
warn_only=True)`, printing every distinct warning raised (an operation with
no deterministic CUDA implementation warns there).
Needs a card; it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
import warnings

import numpy as np
import torch


def _run(cfg, dev, imgs, deps):
    from aslam_tpu_torch.models.device_slam import DeviceSlam

    half = len(imgs) // 2
    slam = DeviceSlam(cfg, dev, seed=0, sync_every=16)
    slam.process_chunk(imgs[:half], deps[:half],
                       ts=[0.033 * i for i in range(half)])
    slam.process_chunk(imgs[half:], deps[half:],
                       ts=[0.033 * i for i in range(half, len(imgs))])
    traj, _ = slam.finish()
    torch.cuda.synchronize()
    return traj, slam.state.m.kf_id.cpu().numpy()


@contextlib.contextmanager
def _atomic_adds():
    """`index_add_ordered` through `index_add_` (atomics on the card) over
    every row, masked ones included (they weigh 0): the engine before the
    ordered form."""
    from aslam_tpu_torch.ops import index

    saved = index._sorted_add
    index._sorted_add = lambda out, idx, src, valid=None: out.index_add_(
        0, idx, src)
    try:
        yield
    finally:
        index._sorted_add = saved


@contextlib.contextmanager
def _lba_timer(times):
    """Append the synchronised seconds of every `lba.local_ba` call."""
    from aslam_tpu_torch.ops import lba

    saved = lba.local_ba

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    timed.runs = saved.runs          # local_ba counts its runs on itself
    lba.local_ba = timed
    try:
        yield
    finally:
        saved.runs = timed.runs
        lba.local_ba = saved


def _events_ms(fn, iters=50):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def micro(dev):
    """index_add_ against the ordered form at the local BA's W / Hll shapes."""
    from aslam_tpu_torch.ops.index import index_add_ordered

    g = torch.Generator(device=dev).manual_seed(0)
    C, M, Lw = 64, 1024, 2048
    idx = torch.randint(0, Lw, (C * M,), device=dev, generator=g)
    for width, rows in ((18, C * Lw), (9, Lw), (3, Lw)):
        ix = idx if rows == Lw else idx + Lw * torch.arange(
            C, device=dev).repeat_interleave(M)
        src = torch.randn(C * M, width, device=dev, generator=g)
        outs = {"index_add_": [], "ordered": []}
        for _ in range(10):
            outs["index_add_"].append(torch.zeros(rows, width, device=dev)
                                      .index_add_(0, ix, src))
            outs["ordered"].append(index_add_ordered(
                torch.zeros(rows, width, device=dev), ix, src))
        fns = {"index_add_": lambda: torch.zeros(rows, width, device=dev)
               .index_add_(0, ix, src),
               "ordered": lambda: index_add_ordered(
                   torch.zeros(rows, width, device=dev), ix, src)}
        line = []
        for name, o in outs.items():
            same = all(torch.equal(o[0], x) for x in o[1:])
            spread = max(float((o[0] - x).abs().max()) for x in o[1:])
            ms = _events_ms(fns[name])
            line.append(f"{name}: bit-identical over 10 calls {same}, max "
                        f"spread {spread:.2e}, {ms * 1e3:.1f} us")
        diff = float((outs["index_add_"][0] - outs["ordered"][0]).abs().max())
        print(f"micro [{C * M}x{width} -> {rows} rows]: " + "; ".join(line)
              + f"; |index_add_ - ordered| {diff:.2e}", flush=True)


N_FRAMES = 64


def main():
    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    import aslam_tpu_torch  # noqa: F401  (precision policy)
    from aslam_tpu_torch.profile_slam import bench_config3, bench_walk

    cfg = bench_config3(loop_closing=True)
    imgs, deps, _ = bench_walk(cfg.camera, N_FRAMES)
    _run(cfg, dev, imgs[:8], deps[:8])                      # warm-up

    micro(dev)
    modes = {"atomic": _atomic_adds, "ordered": contextlib.nullcontext}
    runs = {m: [] for m in modes}
    lba_s = {m: [] for m in modes}
    secs = {m: [] for m in modes}
    for mode in ("atomic", "ordered", "ordered", "atomic"):
        t0 = time.perf_counter()
        with modes[mode](), _lba_timer(lba_s[mode]):
            runs[mode].append(_run(cfg, dev, imgs, deps))
        secs[mode].append(time.perf_counter() - t0)
    for mode, (a, b) in runs.items():
        d = float(np.abs(a[0] - b[0]).max())
        t = lba_s[mode]
        print(f"{mode}: 2 runs of {N_FRAMES} frames, max |dT| between runs "
              f"{d:.3e}, same keyframe ids {np.array_equal(a[1], b[1])}; "
              f"{len(t)} local BAs, {1e3 * sum(t) / len(t):.1f} ms a run "
              f"(min {1e3 * min(t):.1f}, max {1e3 * max(t):.1f}); "
              f"{np.mean(secs[mode]):.1f} s a run", flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs, seen = [], {}
        for _ in range(2):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs.append(_run(cfg, dev, imgs, deps))
            for w in caught:
                key = str(w.message).split(".")[0][:160]
                seen[key] = seen.get(key, 0) + 1
        d = max(float(np.abs(r[0] - runs[0][0]).max()) for r in runs[1:])
        print(f"deterministic: 2 runs, max |dT| between runs "
              f"{d:.3e}; {len(seen)} distinct warnings:", flush=True)
        for key, count in sorted(seen.items(), key=lambda kv: -kv[1]):
            print(f"  {count:6d} x {key}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[{smi}]", flush=True)


if __name__ == "__main__":
    main()
