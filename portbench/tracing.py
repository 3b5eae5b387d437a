"""The benchmark's own instrumentation: host spans and CUDA-event timers
around its calls into the program (``--trace 1`` runs only), the
profiler over a traced sub-window, and the reduction of its Chrome trace
to what the per-layer readers and the ``breakdown`` need.

Nothing here is imported by the program; with tracing off every span is
a no-op, so the end-to-end runs time the program alone.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"          # the annotation that bounds a traced sub-window
NAME_CHARS = 96            # a kernel's name is cut to this in a breakdown


class Spans:
    """Host spans (``record_function`` annotations for the profiler, and
    host seconds) and device timers (CUDA events, read once the window
    has closed). Disabled, every method is a no-op."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = enabled and device.type == "cuda"
        self.host: dict[str, list[float]] = defaultdict(list)
        self._events: dict[str, list] = defaultdict(list)

    def reset(self) -> None:
        """Forget what set-up recorded: the window's spans start here."""
        self.host.clear()
        self._events.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def timed(self, name: str):
        """A span that also brackets the device work it launches with
        two CUDA events."""
        if not self.enabled:
            yield
            return
        if not self.cuda:
            with self.span(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self.span(name):
            start.record()
            yield
            end.record()
        self._events[name].append((start, end))

    def device_ms(self) -> dict[str, list[float]]:
        """Each timer's device milliseconds (synchronises)."""
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self._events.items()}


class Profile:
    """torch.profiler (host and device activity) over a sub-window that
    the caller opens with :meth:`start` and closes with :meth:`stop`,
    once the device work of the sub-window has finished. After the
    window, :meth:`reduce` writes the trace to a temporary file, reduces
    it (:func:`reduce_trace`) and deletes it. ``own_s`` is the host time
    the profiler's start and stop took, which is not the program's."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._ann = None
        self.own_s = 0.0

    def start(self) -> None:
        t0 = time.perf_counter()
        self._prof.start()
        self._ann = torch.profiler.record_function(WINDOW)
        self._ann.__enter__()
        self.own_s += time.perf_counter() - t0

    def stop(self) -> None:
        t0 = time.perf_counter()
        self._ann.__exit__(None, None, None)
        self._prof.stop()
        self.own_s += time.perf_counter() - t0

    def reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return reduce_trace(json.load(f))
        finally:
            os.unlink(path)


# -- reduction ---------------------------------------------------------------
def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


class SpanIndex:
    """Which harness span the host was in at a time: the shortest of the
    spans (name, start, end) that hold it, looked up by bisection over
    the spans' boundaries."""

    def __init__(self, spans):
        cuts = sorted({t for _, s, e in spans for t in (s, e)})
        self.cuts, self.names = cuts, []
        for a in cuts:
            best = None
            for name, s, e in spans:
                if s <= a < e and (best is None or e - s < best[2] - best[1]):
                    best = (name, s, e)
            self.names.append(None if best is None else best[0])

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.cuts, t) - 1
        return None if i < 0 else self.names[i]


def reduce_trace(trace: dict) -> dict:
    """A Chrome trace of one traced sub-window -> its summary, times in
    seconds:

    - ``window_s``: the sub-window (the ``window`` annotation's length);
    - ``busy_s``: the union of the device's kernels, copies and sets in it;
    - ``gpu``: (name, seconds, span) of each device operation in the
      sub-window, ``span`` the innermost harness span its launch was
      issued in (None: none);
    - ``idle_by_span``: the device's idle seconds by the innermost
      harness span the host was in halfway through each idle stretch
      (``other`` where none).
    """
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise ValueError("the trace holds no 'window' annotation")
    w = windows[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] != WINDOW]
    index = SpanIndex(spans)
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    gpu, ivals = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in GPU_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if t <= lo or s >= hi:
            continue
        c = (e.get("args") or {}).get("correlation")
        at = launch.get(c)
        gpu.append((e["name"], (min(t, hi) - max(s, lo)) * 1e-6,
                    None if at is None else index.at(at)))
        ivals.append((s, t))
    idle = defaultdict(float)
    for s, e in idle_gaps(ivals, lo, hi):
        idle[index.at((s + e) / 2) or "other"] += (e - s) * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": union_s(ivals, lo, hi) * 1e-6,
            "gpu": gpu, "idle_by_span": dict(idle)}


def device_seconds(summary: dict, *needles: str) -> float:
    """Seconds of the device operations whose names hold any needle."""
    return sum(s for name, s, _ in summary["gpu"]
               if any(n in name for n in needles))


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    seconds by what the host was doing, each the ``top`` largest."""
    ops = defaultdict(float)
    for name, s, _ in summary["gpu"]:
        ops[name[:NAME_CHARS]] += s
    rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in rank],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
