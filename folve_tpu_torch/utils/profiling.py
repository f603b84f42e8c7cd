"""Profiling hooks — the device-side equivalent of the reference's
tracing aids.

The reference offers ``-R`` readdir/stat dumps, ``-d`` raw FUSE traces,
and status-page render timing (SURVEY.md §5).  On the card the
interesting trace is the device timeline: :func:`device_trace` wraps a
scope in a ``torch.profiler`` capture (a Chrome trace, viewable in
Perfetto or ``chrome://tracing``), :func:`analyze_device_trace` sums
its kernels and the program's spans, and :class:`LatencyStats` is a
small running latency summary for per-step and per-block host latencies
(status page, scheduler counters).

:func:`span` marks a phase of the program (the engine step and its
parts, each kernel launch, the scheduler, the pump, the handler), and
:func:`device_span` one that also times its device work.  They record
only while a ``torch.profiler`` runs, from every thread, on the exported
trace's clock (``time.time_ns``); :func:`span_stats` sums the latest
recording session and :func:`device_trace` merges it into its
``trace.json``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import threading
import time
from collections import defaultdict
from typing import Iterator, List

import torch
from torch.autograd import profiler as _torch_profiler

TRACE_NAME = "trace.json"
# Chrome-trace categories of device work (kineto's names).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span, a context manager: ``time.time_ns()`` at start
    and end, and for a device span on the card a CUDA event pair on the
    current stream."""

    __slots__ = ("name", "ids", "tid", "parent", "t0", "t1", "stream", "ev0", "ev1",
                 "_stack")

    def __init__(self, name, ids, tid, stack, stream, ev0, ev1):
        self.name = name
        self.ids = ids
        self.tid = tid
        self.parent = stack[-1] if stack else None
        self.t0 = self.t1 = None
        self.stream, self.ev0, self.ev1 = stream, ev0, ev1
        self._stack = stack

    def __enter__(self):
        self._stack.append(self)
        self.t0 = time.time_ns()
        if self.ev0 is not None:
            self.ev0.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.ev1 is not None:
            self.ev1.record(self.stream)
        self.t1 = time.time_ns()
        self._stack.pop()
        return False


class _Recorder:
    """The spans of the latest recording session, in memory.  A session
    starts with the first span recorded after a span call saw no
    profiler running, or with :func:`device_trace`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list = []
        self.off_seen = True
        self.local = threading.local()
        self.free_events: dict = defaultdict(list)  # per CUDA device index
        self.streams: dict = {}  # torch.cuda.Stream wrappers by stream key
        self.thread_names: dict = {}

    def start_session(self) -> None:
        with self.lock:
            self._restart()

    def _restart(self) -> None:
        old, self.spans = self.spans, []
        self.off_seen = False
        for s in old:  # a span still open keeps its events
            if s.ev0 is not None and s.t1 is not None:
                self.free_events[s.stream.device_index] += (s.ev0, s.ev1)

    def _stack(self) -> tuple:
        local = self.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid = threading.get_native_id()
            self.thread_names[local.tid] = threading.current_thread().name
        return stack, local.tid

    def _events(self) -> tuple:
        """The current stream and a pair of timing events for it, or
        Nones off the card and while the stream is captured into a graph.
        ``torch.cuda.current_stream()`` builds a new wrapper on every
        call (7 to 10 us on the H100's host), so wrappers are kept by
        the stream's key (id, device, type)."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None, None, None
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        free = self.free_events[key[1]]
        try:
            return stream, free.pop(), free.pop()
        except IndexError:
            return (stream, torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))

    def open(self, name: str, ids: dict, device: bool):
        if self.off_seen:
            with self.lock:
                if self.off_seen:
                    self._restart()
        stack, tid = self._stack()
        for s in stack:
            if s.name == name:  # a span never nests in itself
                return _OFF
        sp = _Span(name, ids, tid, stack,
                   *(self._events() if device else (None, None, None)))
        self.spans.append(sp)
        return sp


_REC = _Recorder()


def span(name: str, **ids):
    """A context manager marking one phase of the program as ``name``,
    with ``ids`` (a stream's token, a step's number) to join the spans of
    one request.  While no ``torch.profiler`` runs it is one shared no-op
    (no allocation, clock read or CUDA call); while one runs it records
    the span's host times, its thread and its parent (the innermost span
    open on that thread).  Inside a span of the same name it records
    nothing."""
    if not _torch_profiler._is_profiler_enabled:
        _REC.off_seen = True
        return _OFF
    return _REC.open(name, ids, False)


def device_span(name: str, **ids):
    """:func:`span` for a phase that enqueues its own thread's device
    work: on the card it also records a CUDA event pair on the current
    stream, whose elapsed time is the phase's device ms.  A timing event
    costs the stream about 3.4 us on the H100, and a stream shared by
    threads would time their work too, so host phases use :func:`span`."""
    if not _torch_profiler._is_profiler_enabled:
        _REC.off_seen = True
        return _OFF
    return _REC.open(name, ids, True)


def _closed_spans() -> tuple:
    """The session's finished spans, and their host and device ms by
    ``id``; waits for any end event the card has not reached."""
    spans = [s for s in _REC.spans if s.t1 is not None]
    host = {id(s): (s.t1 - s.t0) / 1e6 for s in spans}
    dev = {}
    for s in spans:
        if s.ev0 is None:
            continue
        try:
            s.ev1.synchronize()
            dev[id(s)] = s.ev0.elapsed_time(s.ev1)
        except RuntimeError:  # the span switched devices
            pass
    return spans, host, dev


def span_stats() -> dict:
    """Per span name of the latest session: ``count``, ``host_ms``,
    ``self_host_ms`` (less the time its child spans cover), for device
    spans on the card ``device_ms`` and ``self_device_ms`` (from the
    event pairs, less the device spans nested in them; else None), and
    ``parent``, the name its spans most often nest in."""
    spans, host, dev = _closed_spans()
    child_host: dict = defaultdict(float)
    child_dev: dict = defaultdict(float)
    for s in spans:
        p = s.parent
        if p is not None and id(p) in host:
            child_host[id(p)] += host[id(s)]
        if id(s) in dev:  # charged to the nearest enclosing device span
            while p is not None and id(p) in host and id(p) not in dev:
                p = p.parent
            if p is not None and id(p) in dev:
                child_dev[id(p)] += dev[id(s)]
    out: dict = {}
    parents: dict = defaultdict(collections.Counter)
    for s in spans:
        k = id(s)
        o = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                    "device_ms": None, "self_device_ms": None})
        o["count"] += 1
        o["host_ms"] += host[k]
        o["self_host_ms"] += host[k] - child_host[k]
        if k in dev:
            o["device_ms"] = (o["device_ms"] or 0.0) + dev[k]
            o["self_device_ms"] = (o["self_device_ms"] or 0.0) + dev[k] - child_dev[k]
        parents[s.name][s.parent.name if s.parent is not None else None] += 1
    for name, c in parents.items():
        out[name]["parent"] = c.most_common(1)[0][0]
    return out


def _merge_spans(path: str) -> None:
    """Add the session's spans to the Chrome trace at ``path`` as
    ``user_annotation`` events on their threads, on the trace's clock
    (``ts`` counts from ``baseTimeNanoseconds`` where kineto gives it)."""
    spans, host, dev = _closed_spans()
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = data.setdefault("traceEvents", [])
    pid = os.getpid()
    for tid in sorted({s.tid for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": _REC.thread_names.get(tid, str(tid))}})
    for s in spans:
        args = dict(s.ids, span="program",
                    parent=s.parent.name if s.parent is not None else None,
                    device_ms=dev.get(id(s)))
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name,
                       "pid": pid, "tid": s.tid, "ts": (s.t0 - base) / 1e3,
                       "dur": host[id(s)] * 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(data, f, default=str)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed scope into
    ``log_dir/trace.json``, written whole when the scope ends: CPU ops,
    and every CUDA kernel the process launches where the build can trace
    the card.  Kineto's device tracing (CUPTI) is process-wide, so
    kernels launched from other threads (the device scheduler's) are
    captured too; CPU ops are recorded on the calling thread only, and
    the program's spans (:func:`span`) from every thread, a session
    that starts with the scope."""
    from torch.profiler import ProfilerActivity, profile

    wanted = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    activities = [a for a in torch.profiler.supported_activities() if a in wanted]
    with profile(activities=activities) as prof:
        _REC.start_session()
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_NAME)
    # Written under another name first: a trace.json is always whole.
    prof.export_chrome_trace(path + ".part")
    _merge_spans(path + ".part")
    os.replace(path + ".part", path)


def _open_span_at(starts: list, keys: list, t: float) -> str:
    """The most recently started span of ``starts`` (sorted ``(t0, t1,
    name)``) still open at ``t``, else ``"host"``."""
    i = bisect.bisect_right(keys, t) - 1
    while i >= 0:
        t0, t1, name = starts[i]
        if t0 <= t < t1:
            return name
        i -= 1
    return "host"


def _idle_by_span(events: list, starts: list) -> dict:
    """Seconds of device idle within the profiler's own events' extent
    (a program span may outlast the capture), by the program span open
    (on any thread) where each idle gap began."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e
          and (e.get("args") or {}).get("span") != "program"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
                    if str(e.get("cat", "")).lower() in DEVICE_CATS)
    if not device:
        return {}
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    keys = [s[0] for s in starts]
    out: dict = defaultdict(float)
    prev = min(float(e["ts"]) for e in xs)
    for a, b in device + [(w1, w1)]:
        if a > prev:
            out[_open_span_at(starts, keys, prev)] += (a - prev) * 1e-6
        prev = max(prev, b)
    return dict(out)


def analyze_device_trace(log_dir: str) -> dict:
    """Sum the newest trace under ``log_dir``: ``{"device_time_ms":
    total, "ops": [(kernel name, ms), ...], "spans": {name: {"count",
    "host_ms", "device_ms"}}, "idle_by_span": {name: seconds}}``.  The
    ops, sorted by time, are the events of category ``kernel``; the
    spans, the program's (:func:`span`); ``idle_by_span`` sums the
    device's idle gaps by the most recently started span still open,
    on any thread, where each gap began (``host`` where none was open).

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
    spans: dict = {}
    starts = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") == "kernel":
            per_kernel[ev.get("name", "?")] += float(ev.get("dur", 0.0)) / 1e3
        args = ev.get("args") or {}
        if args.get("span") == "program":
            o = spans.setdefault(ev["name"], {"count": 0, "host_ms": 0.0,
                                              "device_ms": None})
            o["count"] += 1
            o["host_ms"] += float(ev["dur"]) / 1e3
            if args.get("device_ms") is not None:
                o["device_ms"] = (o["device_ms"] or 0.0) + float(args["device_ms"])
            starts.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                           ev["name"]))
    ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {"device_time_ms": sum(per_kernel.values(), 0.0), "ops": ops,
            "spans": spans, "idle_by_span": _idle_by_span(events, sorted(starts))}


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
