"""Tracing and step timing (port of ``cvcs_tpu/utils/profiling.py``) on
``torch.profiler``: host operations, and the card's kernels where there
is a card."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace("/tmp/tb"):`` records a torch.profiler trace of the
    block and writes it to ``log_dir/trace.json`` (Chrome trace format,
    for Perfetto or ``chrome://tracing``), also when the block raises; a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def annotate(name: str):
    """Named trace span for host-side phases (chunk load, eval, ckpt)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall-time accumulator with percentile reporting."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
            "steps_per_s": float(arr.size / arr.sum()),
        }
