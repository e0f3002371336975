"""What every driver shares: the run's context, the device, and the profiled
slice of a traced window."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from . import measure


@dataclass
class Context:
    """One run of one cell."""
    name: str
    cell: dict            # the workload file
    cfg: dict             # the configuration file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float             # host clock at process start
    fault: str = ""       # tests only: break the timed path underneath
    notes: dict = field(default_factory=dict)

    def log(self, *parts) -> None:
        print(f"[bench {time.perf_counter() - self.t0:9.3f}s]", *parts,
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Profiled:
    """``torch.profiler`` over a slice of the traced window: ``start`` and
    ``stop`` each synchronise; ``result`` reduces the trace."""

    def __init__(self, ctx: Context, ranges=()):
        self.ctx, self.ranges = ctx, ranges
        self.prof = None
        self.wall = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.ctx.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t = time.perf_counter()

    def stop(self) -> None:
        self.ctx.sync()
        self.wall = time.perf_counter() - self._t
        self.prof.__exit__(None, None, None)

    def result(self) -> dict:
        kernels, host, ranges = measure.profile_events(self.prof, self.ranges)
        out = measure.reduce_profile(kernels, host)
        out["window_s"] = self.wall
        out["ranges"] = ranges
        out["n_kernels"] = len(kernels)
        return out
