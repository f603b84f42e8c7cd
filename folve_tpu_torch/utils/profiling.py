"""Profiling hooks: :class:`LatencyStats`, a small running latency
summary for per-step and per-block host latencies (status page,
scheduler counters)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List


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
