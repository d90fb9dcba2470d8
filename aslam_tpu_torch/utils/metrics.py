"""Observability: stage timers, counters, series and a profiler trace.

Port of `aslam_tpu/utils/metrics.py`.  CUDA work is asynchronous: a timer
around it reads the launch time unless it waits for the device, so
`timer(sync=...)` synchronises the given device (or the device of the given
tensor) before it stops the clock.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


def _synchronize(obj) -> None:
    device = obj.device if isinstance(obj, torch.Tensor) else torch.device(obj)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Metrics:
    def __init__(self):
        self.timers = defaultdict(list)
        self.counters = defaultdict(int)
        self.series = defaultdict(list)

    @contextlib.contextmanager
    def timer(self, name: str, sync=None):
        """Time a section.  Pass a device or a tensor as `sync` (or set
        `holder["sync"]` inside the block) to include the completion of the
        device's queued work in the measurement."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            obj = holder.get("sync", sync)
            if obj is not None:
                _synchronize(obj)
            self.timers[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def record(self, name: str, value: float):
        self.series[name].append(float(value))

    def summary(self) -> dict:
        out = {"counters": dict(self.counters)}
        out["timers"] = {
            k: {
                "n": len(v),
                "mean_ms": 1e3 * sum(v) / max(len(v), 1),
                "total_s": sum(v),
                "max_ms": 1e3 * max(v) if v else 0.0,
            }
            for k, v in self.timers.items()
        }
        out["series"] = {
            k: {"n": len(v), "mean": sum(v) / max(len(v), 1)}
            for k, v in self.series.items()
        }
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a `torch.profiler` trace of the block (host, and the CUDA
    device when there is one) into `logdir` as a Chrome / TensorBoard trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


# the reference's name for the same context manager
xla_trace = profiler_trace

GLOBAL = Metrics()
