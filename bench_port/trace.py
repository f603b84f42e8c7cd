"""The benchmark's own reading of a ``torch.profiler`` trace.

The window's traced stretch is exported as a Chrome trace and read back
into device intervals (kernels, copies, memsets) and the benchmark's
host spans (``enqueue`` around each call into the program, ``wait``
around each wait for the card).  Per-layer metrics
(``metrics/<name>.py``) read a :class:`Trace`.  Imports nothing of the
program.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("enqueue", "wait", "tail")
LOST_GAP_S = 1e-3
# PyTorch's own device work: ATen's kernels (and the CUB/Thrust kernels
# ATen calls), copies and memsets.
_TORCH_KERNEL = re.compile(r"\b(at|c10|cub|thrust)::")


@dataclasses.dataclass
class Trace:
    """Device intervals ``(name, cat, t0, t1)`` and host spans ``(name,
    t0, t1)`` in seconds, on the trace's one clock.

    The profiler sometimes loses a run of device records.  A device idle
    longer than ``LOST_GAP_S`` cannot be real where it began while the
    host waited for a step (the host waits only while steps are queued),
    or where the host issued more than two steps inside it (the first
    would have ended a real idle), so the analysed window is the longest
    stretch between such gaps.  A host that stalls inside one call keeps
    its idle gap."""

    device: list
    spans: list

    def _stretch(self) -> tuple[float, float]:
        """From the first ``enqueue`` to the first ``tail`` span (the host
        passed a synchronize just before it), or without a tail to the
        last device or host activity."""
        t0 = min(s[1] for s in self.spans if s[0] == "enqueue")
        tails = [s[1] for s in self.spans if s[0] == "tail"]
        if tails:
            return t0, min(tails)
        return t0, max([d[3] for d in self.device] + [s[2] for s in self.spans])

    def _gaps(self, w0: float, w1: float) -> list:
        """``(label, t0, t1)`` of each device idle in ``[w0, w1]``,
        labelled by the host span open when it began."""
        busy = _union(self.device, w0, w1)
        starts = sorted((s[1], s[2], s[0]) for s in self.spans)
        keys = [s[0] for s in starts]
        gaps, prev = [], w0
        for a, b in busy + [(w1, w1)]:
            if a > prev:
                gaps.append((_span_at(starts, keys, prev), prev, a))
            prev = b
        return gaps

    @functools.cached_property
    def lost(self) -> list:
        """``(t0, t1)`` of each run of lost device records."""
        issued = sorted(s[1] for s in self.spans if s[0] == "enqueue")
        inside = lambda a, b: bisect.bisect_left(issued, b) - bisect.bisect_right(issued, a)
        return [(a, b) for label, a, b in self._gaps(*self._stretch())
                if b - a > LOST_GAP_S and (label == "wait" or inside(a, b) > 2)]

    @functools.cached_property
    def window(self) -> tuple[float, float]:
        w0, w1 = self._stretch()
        edges = [w0] + [t for gap in self.lost for t in gap] + [w1]
        return max(zip(edges[::2], edges[1::2]), key=lambda seg: seg[1] - seg[0])

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return t1 - t0

    @property
    def steps(self) -> int:
        """Steps enqueued in the analysed window (not the tail).  After a
        cut the host runs ahead of the device by the steps in flight, at
        most ``ahead`` of some hundreds."""
        w0, w1 = self.window
        return sum(1 for s in self.spans if s[0] == "enqueue" and w0 <= s[1] < w1)

    def _device_in_window(self) -> list:
        w0, w1 = self.window
        return [d for d in self.device if d[2] < w1 and d[3] > w0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device, *self.window))

    def device_s(self, torch_own: bool) -> float:
        """Device seconds in PyTorch's own work (``torch_own``) or in
        every other kernel (the program's, found by exclusion)."""
        return sum(t1 - t0 for name, cat, t0, t1 in self._device_in_window()
                   if is_torch_own(name, cat) == torch_own)

    def idle_gaps(self) -> list:
        """``(label, seconds)`` of every device idle in the window."""
        return [(label, b - a) for label, a, b in self._gaps(*self.window)]

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for name, _, t0, t1 in self._device_in_window():
            by_name[short_name(name)] += t1 - t0
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(device: list, w0: float, w1: float) -> list:
    """The union of device activity clipped to ``[w0, w1]``, as sorted
    disjoint ``(t0, t1)``."""
    out = []
    for _, _, a, b in sorted(device, key=lambda d: d[2]):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(i) for i in out]


def _span_at(starts, keys, t: float) -> str:
    """The innermost host span open at ``t`` (the latest started)."""
    i = bisect.bisect_right(keys, t) - 1
    while i >= 0:
        t0, t1, name = starts[i]
        if t0 <= t < t1:
            return name
        i -= 1
    return "host"


def is_torch_own(name: str, cat: str) -> bool:
    return cat != "kernel" or bool(_TORCH_KERNEL.search(name))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def read_chrome(path: Path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            device.append((e.get("name", ""), cat, t0, t1))
        elif cat == "user_annotation" and e.get("name") in SPANS:
            spans.append((e["name"], t0, t1))
    return Trace(device=device, spans=spans)
