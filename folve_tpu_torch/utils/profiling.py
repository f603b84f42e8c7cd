"""Profiling hooks — the device-side equivalent of the reference's
tracing aids.

The reference offers ``-R`` readdir/stat dumps, ``-d`` raw FUSE traces,
and status-page render timing (SURVEY.md §5).  On the card the
interesting trace is the device timeline: :func:`device_trace` wraps a
scope in a ``torch.profiler`` capture (a Chrome trace, viewable in
Perfetto or ``chrome://tracing``), :func:`analyze_device_trace` sums
its kernels, and :class:`LatencyStats` is a small running latency
summary for per-step and per-block host latencies (status page,
scheduler counters).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from typing import Iterator, List

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed scope into
    ``log_dir/trace.json``, written whole when the scope ends: CPU ops,
    and every CUDA kernel the process launches where the build can trace
    the card.  Kineto's device tracing (CUPTI) is process-wide, so
    kernels launched from other threads (the device scheduler's) are
    captured too; CPU ops are recorded on the calling thread only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wanted = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    activities = [a for a in torch.profiler.supported_activities() if a in wanted]
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_NAME)
    # Written under another name first: a trace.json is always whole.
    prof.export_chrome_trace(path + ".part")
    os.replace(path + ".part", path)


def analyze_device_trace(log_dir: str) -> dict:
    """Sum the device kernels of the newest trace under ``log_dir``:
    ``{"device_time_ms": total, "ops": [(kernel name, ms), ...]}``, the
    ops sorted by time, from the trace events of category ``kernel``.

    Returns ``{}`` when there is no trace.  Unlike the JAX package's
    (xprof's op profile) there is no ``mem_bw_frac``: kineto's trace
    carries no memory-bandwidth figure, so none is given."""
    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", TRACE_NAME), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        return {}
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    per_kernel: dict = defaultdict(float)
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            per_kernel[ev.get("name", "?")] += float(ev.get("dur", 0.0)) / 1e3
    ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {"device_time_ms": sum(per_kernel.values(), 0.0), "ops": ops}


class LatencyStats:
    """Running latency summary (count / mean / max / recent percentiles)."""

    __slots__ = ("count", "total_s", "max_s", "_recent", "_recent_cap")

    def __init__(self, recent: int = 128):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._recent: List[float] = []
        self._recent_cap = recent

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds
        self._recent.append(seconds)
        if len(self._recent) > self._recent_cap:
            self._recent.pop(0)

    @contextlib.contextmanager
    def timer(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / self.count if self.count else 0.0

    @property
    def recent_ms(self) -> float:
        if not self._recent:
            return 0.0
        return 1000.0 * sum(self._recent) / len(self._recent)

    def percentile_ms(self, q: float) -> float:
        """q-th percentile (0..100) over the recent window, in ms."""
        if not self._recent:
            return 0.0
        data = sorted(self._recent)
        idx = min(len(data) - 1, max(0, round(q / 100.0 * (len(data) - 1))))
        return 1000.0 * data[idx]

    def summary(self) -> str:
        return (
            f"n={self.count} mean={self.mean_ms:.2f}ms "
            f"p50={self.percentile_ms(50):.2f}ms "
            f"p99={self.percentile_ms(99):.2f}ms max={self.max_s * 1000:.2f}ms"
        )
