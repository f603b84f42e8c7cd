"""The port's span recorder (``folve_tpu_torch.utils.profiling``): off
without a profiler, nested spans and their self times, one session at a
time, and spans from the scheduler's thread merged into the trace that
``device_trace`` writes on another thread, on the trace's clock."""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from folve_tpu_torch.audio.flac import write_flac
from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.runtime import FolveFilesystem
from folve_tpu_torch.runtime.scheduler import DeviceScheduler
from folve_tpu_torch.server.status import StatusServer
from folve_tpu_torch.utils import profiling
from folve_tpu_torch.utils.profiling import (
    analyze_device_trace,
    device_trace,
    span,
    span_stats,
)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _loop_peak(fn, n=10000) -> int:
    """Peak bytes traced by ``tracemalloc`` above the start over ``n``
    ``with fn("engine.step")`` blocks."""
    def run(k):
        for _ in range(k):
            with fn("engine.step"):
                pass

    run(10)
    tracemalloc.start()
    try:
        run(10)
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        run(n)
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_the_profiler_flag_the_recorder_reads_flips_under_profile():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with _profiled():
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_without_a_profiler_span_is_the_shared_no_op(monkeypatch):
    before = span_stats()

    def boom(*a, **k):
        raise AssertionError("span read the clock or called CUDA while off")

    monkeypatch.setattr(profiling.time, "time_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", boom)
    assert span("engine.step") is span("sched.step", step=3) is profiling._OFF
    for _ in range(100):
        with span("engine.step"):
            with span("kernel.fdl_mac_split", stream=1):
                pass
    monkeypatch.undo()
    assert span_stats() == before
    # No allocation beyond what a loop over a bare shared no-op makes.
    shared = contextlib.nullcontext()
    assert _loop_peak(span) <= _loop_peak(lambda name: shared)


def test_nested_spans_give_parents_and_self_times():
    with _profiled():
        with span("outer", stream=7):
            time.sleep(0.02)
            with span("inner"):
                time.sleep(0.03)
                with span("inner"):  # a span never nests in itself
                    time.sleep(0.001)
            with span("leaf"):
                time.sleep(0.01)
    st = span_stats()
    assert set(st) == {"outer", "inner", "leaf"}
    outer, inner, leaf = st["outer"], st["inner"], st["leaf"]
    assert (outer["count"], inner["count"], leaf["count"]) == (1, 1, 1)
    assert (outer["parent"], inner["parent"], leaf["parent"]) == (None, "outer", "outer")
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"] - leaf["host_ms"])
    assert 18 <= outer["self_host_ms"] < outer["host_ms"]
    assert inner["self_host_ms"] == inner["host_ms"] >= 29
    assert leaf["host_ms"] >= 9
    assert outer["device_ms"] is None and outer["self_device_ms"] is None  # no card


def test_a_session_is_the_latest_profiled_stretch(tmp_path):
    with _profiled():
        for _ in range(3):
            with span("first"):
                pass
    assert span_stats()["first"]["count"] == 3
    with span("between"):  # untraced: the recorder sees the profiler off
        pass
    with _profiled():
        with span("second"):
            pass
    st = span_stats()
    assert set(st) == {"second"} and st["second"]["count"] == 1
    # With no untraced call between, two stretches make one session ...
    with _profiled():
        with span("third"):
            pass
    assert set(span_stats()) == {"second", "third"}
    # ... but device_trace starts its own.
    with device_trace(str(tmp_path)):
        with span("fourth"):
            pass
    assert set(span_stats()) == {"fourth"}


def _events(log_dir: str) -> tuple:
    with open(os.path.join(log_dir, "trace.json")) as f:
        data = json.load(f)
    spans = [e for e in data["traceEvents"]
             if e.get("ph") == "X" and (e.get("args") or {}).get("span") == "program"]
    names = {e["tid"]: e["args"]["name"] for e in data["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    return spans, names, int(data.get("baseTimeNanoseconds", 0))


def test_scheduler_spans_from_its_thread_land_in_the_trace_of_another(tmp_path, rng):
    fragm, t = 64, 2
    bank = compile_filter_bank(rng.standard_normal((2, 2, 5 * fragm - 3)).astype(np.float32),
                               fragm=fragm, device="cpu")
    sched = DeviceScheduler(max_batch=2, window_s=0.5, device="cpu")
    log_dir = str(tmp_path / "prof")
    started, done, stamps = threading.Event(), threading.Event(), {}

    def profiler_thread():
        with device_trace(log_dir):
            started.set()
            done.wait(timeout=60)
            stamps["tid"] = threading.get_native_id()
            stamps["a"] = time.time_ns()
            with span("test.probe"):
                time.sleep(0.002)
            stamps["b"] = time.time_ns()

    prof = threading.Thread(target=profiler_thread, name="test-profile")
    prof.start()
    assert started.wait(timeout=60)
    states = [ts.init_state(bank, device="cpu") for _ in range(2)]
    try:
        for _ in range(2):
            barrier = threading.Barrier(2)
            out = [None, None]

            def go(i):
                barrier.wait(timeout=30)
                x = rng.standard_normal((t, 2, fragm)).astype(np.float32)
                out[i] = sched.submit(bank, states[i], x, t * fragm,
                                      stream=100 + i).result(timeout=60)

            workers = [threading.Thread(target=go, args=(i,)) for i in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
            states = [o[0] for o in out]
        sched_tid = sched._thread.native_id
    finally:
        done.set()
        prof.join(timeout=60)
        sched.stop()
    assert not prof.is_alive()
    # The first round may run as two lone steps (the scheduler skips the
    # window while it has seen one stream); the second is one batch.
    assert sched.queue_wait.count == 4 and sched.steps in (2, 3)

    spans, names, base = _events(log_dir)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("sched.stage", "sched.step", "sched.coalesce", "engine.step",
                 "engine.prep", "kernel.conv_step_fused", "engine.monitor"):
        assert {e["tid"] for e in by_name[name]} == {sched_tid}, name
    assert names[sched_tid] == "folve-device-scheduler"
    steps = by_name["sched.step"]
    assert [e["args"]["step"] for e in steps] == list(range(sched.steps))
    assert sorted(sum((e["args"]["streams"] for e in steps), [])) == [100, 100, 101, 101]
    assert sorted(by_name["sched.stage"][-1]["args"]["streams"]) == [100, 101]
    assert all(e["args"]["parent"] == "sched.step" for e in by_name["engine.step"])
    for e in spans:
        parent = e["args"]["parent"]
        if parent is None:
            continue
        assert any(p["name"] == parent and p["tid"] == e["tid"]
                   and p["ts"] <= e["ts"] + 1e-3
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
                   for p in spans), (e["name"], parent)
    probe, = by_name["test.probe"]
    assert probe["tid"] == stamps["tid"] != sched_tid
    assert abs(probe["ts"] * 1e3 + base - stamps["a"]) < 100e3
    assert abs((probe["ts"] + probe["dur"]) * 1e3 + base - stamps["b"]) < 100e3

    trace = analyze_device_trace(log_dir)
    assert trace["spans"]["sched.step"]["count"] == sched.steps
    assert trace["spans"]["engine.step"]["count"] == sched.steps
    assert trace["spans"]["engine.step"]["device_ms"] is None  # no card
    assert trace["idle_by_span"] == {}  # no device work to be idle between


def test_idle_by_span_labels_each_gap_by_the_latest_open_span(tmp_path):
    def x(name, ts, dur, tid=1, cat="kernel", program=False):
        e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
             "ts": ts, "dur": dur}
        if program:
            e["cat"] = "user_annotation"
            e["args"] = {"span": "program", "parent": None, "device_ms": 0.5}
        return e

    events = [x("k", 0, 10), x("k", 20, 10), x("k", 50, 10), x("k", 70, 10),
              x("handler.read", 0, 55, tid=3, program=True),
              x("engine.step", 5, 20, tid=2, program=True),
              x("sched.sync", 28, 17, tid=2, program=True),
              x("enqueue", 1, 2, tid=2, cat="user_annotation")]
    os.makedirs(tmp_path / "t")
    with open(tmp_path / "t" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    out = analyze_device_trace(str(tmp_path / "t"))
    idle = out["idle_by_span"]
    assert set(idle) == {"engine.step", "sched.sync", "host"}
    assert idle["engine.step"] == pytest.approx(10e-6)
    assert idle["sched.sync"] == pytest.approx(20e-6)
    assert idle["host"] == pytest.approx(10e-6)
    assert out["spans"]["handler.read"] == {"count": 1, "host_ms": 0.055, "device_ms": 0.5}
    assert "enqueue" not in out["spans"]
    assert out["device_time_ms"] == pytest.approx(0.04)


def test_the_status_page_shows_the_queue_wait(tmp_path, rng):
    (tmp_path / "src").mkdir()
    (tmp_path / "filters").mkdir()
    fs = FolveFilesystem(device="cpu")
    fs.underlying_dir, fs.base_config_dir = str(tmp_path / "src"), str(tmp_path / "filters")
    bank = compile_filter_bank(rng.standard_normal((2, 2, 200)).astype(np.float32),
                               fragm=64, device="cpu")
    sched = fs.device_scheduler
    try:
        x = rng.standard_normal((1, 2, 64)).astype(np.float32)
        sched.submit(bank, ts.init_state(bank, device="cpu"), x, 64, stream=1).result(timeout=60)
    finally:
        sched.stop()
    assert sched.queue_wait.count == 1
    page = StatusServer(fs).create_page()
    wait = re.search(rb"queue wait p50 (\d+\.\d\d)ms / p99 (\d+\.\d\d)ms</p>", page)
    assert wait and float(wait.group(1)) == pytest.approx(
        sched.queue_wait.percentile_ms(50), abs=0.006)


def test_a_served_read_joins_handler_pump_and_scheduler_spans_by_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")
    (tmp_path / "src").mkdir()
    (tmp_path / "filters" / "echo").mkdir(parents=True)
    (tmp_path / "filters" / "echo" / "filter-44100.conf").write_text(
        "/convolver/new 2 2 64 512\n/impulse/dirac 1 1 0.7 0\n/impulse/dirac 2 2 0.7 0\n")
    x = np.random.default_rng(3).uniform(-0.4, 0.4, (20 * 512 + 219, 2))
    write_flac(str(tmp_path / "src" / "a.flac"), np.round(x * 32768) / 32768, 44100, bits=16)
    fs = FolveFilesystem(device="cpu")
    fs.underlying_dir, fs.base_config_dir = str(tmp_path / "src"), str(tmp_path / "filters")
    fs.current_config_subdir = "echo"
    log_dir = str(tmp_path / "prof")
    try:
        with device_trace(log_dir):
            h = fs.get_or_create_handler("/a.flac")
            n = 0
            while True:
                got = len(h.read(16384, n))
                if not got:
                    break
                n += got
            fs.close_handler("/a.flac", h)
    finally:
        fs.device_scheduler.stop()
    spans, _, _ = _events(log_dir)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert {"handler.read", "handler.encode", "pump.decode", "pump.dispatch", "pump.fetch",
            "pump.encode", "sched.step", "engine.step"} <= set(by_name)
    token = {e["args"]["stream"] for e in by_name["pump.dispatch"]}
    assert len(token) == 1
    for name in ("pump.decode", "pump.fetch", "pump.encode", "handler.encode"):
        assert {e["args"]["stream"] for e in by_name[name]} == token, name
    assert all(e["args"]["streams"] == list(token) for e in by_name["sched.step"])
    assert "pump.encode" in {e["args"]["parent"] for e in by_name["handler.encode"]}


def test_spans_from_many_threads_are_all_kept_with_their_parents():
    threads, each = 4 * (os.cpu_count() or 4), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            def work():
                for i in range(each):
                    with span("outer", stream=i):
                        with span("inner"):
                            pass

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    st = span_stats()
    assert st["outer"]["count"] == st["inner"]["count"] == threads * each
    inner = [sp for sp in profiling._closed_spans()[0] if sp.name == "inner"]
    assert all(sp.parent.name == "outer" and sp.parent.tid == sp.tid
               and sp.parent.t0 <= sp.t0 <= sp.t1 <= sp.parent.t1 for sp in inner)
    assert st["outer"]["self_host_ms"] >= 0
