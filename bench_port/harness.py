"""One run of one cell: set-up, the measured window, the route and output
checks, the metrics.

:func:`run_cell` takes the device it is given; ``run.py`` refuses to run
without a card, and the CPU tests call it at tiny shapes.  Everything
the program makes is judged here against ``reference.py``, which gets
the IR arrays and the input ring that this module made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_port import generator, reference, roofline
from bench_port.cells import Cell, load_entry, load_metric
from bench_port.trace import Trace, read_chrome

# The program's kernel wrappers whose ``launches`` a traffic mix may
# name, and the plain MAC that must never run on CUDA tensors.
PLAIN_MAC = "folve_tpu_torch.engine.kernels.fdl_mac.fdl_mac_plain"
TAIL_S = 0.5  # seconds of untraced steps the profiler records after the stretch

# The harness's policy, the same for every cell: the ring of distinct
# input chunks cycled step by step, how many steps the host may run
# ahead of the card, the warm-up steps of set-up, and how many streams
# (drawn from the seed) the output check compares.
RING = 8
AHEAD = 4
WARMUP_STEPS = 8
SAMPLE_STREAMS = 16


def log(msg: str) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)


def _attr(path: str):
    mod, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


def launches(traffic: dict) -> dict:
    return {k: _attr(k).launches for k in traffic["launches_per_step"]}


def route_checks(traffic: dict, before: dict, after: dict, steps: int) -> dict:
    """Each kernel wrapper the traffic mix names made exactly its
    launches per step over the window."""
    out = {}
    for k, per in traffic["launches_per_step"].items():
        n = after[k] - before[k]
        out[k.rsplit(".", 1)[1] + "_per_step"] = {"value": n / steps, "limit": per,
                                                  "ok": n == per * steps}
    return out


@dataclasses.dataclass
class Setup:
    """What an entry's ``Driver`` is built from: the program's compiled
    banks, the reference's dense responses ``[Cin, Cout, maxsize]``
    float64 (for the control, which takes nothing of the program), each
    stream's filter, and the step's shape."""
    banks: list
    dense_irs: list
    assign: list
    streams: int
    blocks: int
    device: torch.device


@dataclasses.dataclass
class Window:
    steps: int
    window_s: float
    step_ms: list
    enqueue_ms: list  # host ms in each call to the step outside the traced stretch
    y_last: torch.Tensor
    trace: Trace | None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_window(driver, ring: torch.Tensor, first: int, seconds: float,
               ahead: int, trace: bool, dev) -> Window:
    """Issue steps on ring chunks ``first, first + 1, ...`` until
    ``seconds`` have passed, at most ``ahead`` steps before the card (a
    CUDA event after each step; the host waits on step i - ahead before
    it issues step i), and close with one synchronize.  With ``trace``,
    a steady stretch of the window (from 40% of it, for a fifth of it)
    runs under ``torch.profiler`` with ``enqueue`` and ``wait`` spans."""
    cuda = dev.type == "cuda"
    n_ev = ahead + 2
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n_ev)] if cuda else []
    host_ends = []
    step_ms = []
    enqueue_ms = []
    prof = None
    traced = None
    # The traced stretch starts at 40% of the window and lasts a fifth of
    # it from the moment the profiler is running (its start-up is slow).
    # A synchronize closes it, and the profiler then records a tail of
    # steps under ``tail`` spans that no metric reads: the profiler can
    # lose the device records of its last moments before it stops.
    stretch = [0.4 * seconds, None, None] if trace else None
    label = {}
    nospan = contextlib.nullcontext()
    span = lambda name: torch.profiler.record_function(label.get(name, name)) if prof else nospan
    if trace:
        # The profiler's first start in a process takes seconds: pay it
        # here, so that the start inside the window is quick.
        with _profile(dev):
            torch.ones(1, device=dev).sum()
            _sync(dev)
    y = None
    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds and prof is None and (not stretch or traced is not None):
            break
        if stretch and prof is None and traced is None and now >= stretch[0]:
            _sync(dev)
            prof = _profile(dev)
            prof.__enter__()
            stretch[1] = time.perf_counter() - t0 + 0.2 * seconds
        elif prof is not None and stretch[2] is None and now >= stretch[1]:
            _sync(dev)
            label = {"enqueue": "tail", "wait": "tail"}
            stretch[2] = now + TAIL_S
        elif prof is not None and stretch[2] is not None and now >= stretch[2]:
            _sync(dev)
            prof.__exit__(None, None, None)
            traced, prof = prof, None
        if cuda and i >= ahead:
            j = i - ahead
            with span("wait"):
                evs[j % n_ev].synchronize()
            if j >= 1:
                step_ms.append(evs[(j - 1) % n_ev].elapsed_time(evs[j % n_ev]))
        t_enq = time.perf_counter()
        with span("enqueue"):
            y = driver.step(ring[(first + i) % ring.shape[0]])
        if prof is None:
            enqueue_ms.append(1e3 * (time.perf_counter() - t_enq))
        if cuda:
            evs[i % n_ev].record()
        else:
            host_ends.append(time.perf_counter())
        i += 1
    _sync(dev)
    window_s = time.perf_counter() - t0
    if cuda:
        for j in range(max(i - ahead, 1), i):
            step_ms.append(evs[(j - 1) % n_ev].elapsed_time(evs[j % n_ev]))
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(host_ends, host_ends[1:])]
    tr = None
    if traced is not None:
        tdir = Path(tempfile.mkdtemp(prefix="bench_port_trace_"))
        try:
            traced.export_chrome_trace(str(tdir / "trace.json"))
            tr = read_chrome(tdir / "trace.json")
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
    return Window(steps=i, window_s=window_s, step_ms=step_ms, enqueue_ms=enqueue_ms,
                  y_last=y, trace=tr)


def nvidia_smi() -> str:
    """The card's name, clocks, power draw, power limit and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({e})"


def sample_streams(assign: list, n: int, seed: int) -> list:
    """``n`` streams drawn from the seed, the same number of each filter."""
    rng = np.random.default_rng(generator.sub_seed(seed, 2))
    filters = sorted(set(assign))
    per = max(1, n // len(filters))
    out = []
    for f in filters:
        rows = [s for s, a in enumerate(assign) if a == f]
        out += rng.choice(rows, size=min(per, len(rows)), replace=False).tolist()
    return sorted(out)


def judge(dense_irs: list, assign: list, idx: list, signals: np.ndarray,
          y: np.ndarray, start: int) -> dict:
    """Worst SNR (dB) over the sampled streams of the output ``y``
    [n, Cout, N] against the float64 reference, each stream playing
    ``signals`` [n, Cin, period] from sample 0."""
    n_out = y.shape[-1]
    worst, per_stream = -np.inf, []
    for f in sorted({assign[s] for s in idx}):
        conv = reference.Convolver(dense_irs[f], n_out)
        for row, s in enumerate(idx):
            if assign[s] != f:
                continue
            snr = float(reference.snr_db(conv(signals[row], start), y[row]))
            per_stream.append((s, snr))
            worst = max(worst, snr)
    return {"snr_db": worst, "per_stream": per_stream}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict (``checks``
    last), with ``extra`` facts for the tools beside it."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from folve_tpu_torch.filters.compiler import compile_config_file

    phases = {"imports": time.perf_counter() - t_start}
    mark = lambda name: phases.__setitem__(name, time.perf_counter() - t_start)
    cfg, trf = cell.config, cell.traffic
    s_n, t_n, ring_n = trf["streams"], trf["blocks"], RING
    irs = generator.make_irs(cfg, generator.sub_seed(seed, 0), dev)
    dense = [reference.dense_ir(f, ir) for f, ir in zip(cfg["filters"], irs)]
    mark("irs")
    tmp = Path(tempfile.mkdtemp(prefix="bench_port_filters_"))
    try:
        confs = generator.write_filters(cfg, irs, tmp)
        banks = [compile_config_file(str(c), fsamp=cfg["rate"], device=dev).bank
                 for c in confs[:trf["filters"]]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("compile")
    bank = banks[0]
    fragm, cin, cout, parts = bank.fragm, bank.ninp, bank.nout, bank.partitions
    assign = [s % trf["filters"] for s in range(s_n)]
    ring, peaks = generator.make_ring(trf["signal"], ring_n, s_n, t_n, cin, fragm,
                                      cfg["rate"], generator.sub_seed(seed, 1), dev)
    mark("ring")
    driver = load_entry(trf["entry"]).Driver(
        Setup(banks=banks, dense_irs=dense, assign=assign, streams=s_n, blocks=t_n,
              device=dev))
    mark("state")
    for k in range(WARMUP_STEPS):
        driver.step(ring[k % ring_n])
    _sync(dev)
    before = launches(trf) if dev.type == "cuda" else None
    setup_s = time.perf_counter() - t_start
    phases["warmup"] = setup_s

    win = run_window(driver, ring, WARMUP_STEPS, seconds, AHEAD, trace, dev)

    step = roofline.Step(streams=s_n, blocks=t_n, partitions=parts, cin=cin, cout=cout,
                         fragm=fragm, filters=trf["filters"])
    checks = {} if before is None else route_checks(trf, before, launches(trf), win.steps)
    plain = _attr(PLAIN_MAC).cuda_calls
    checks["plain_mac_cuda_calls"] = {"value": plain, "limit": 0, "ok": plain == 0}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    smi = nvidia_smi() if dev.type == "cuda" else "not a card"

    # Output check, once the program's state is freed: the last step's
    # output for streams drawn from the seed, against the reference.
    idx = sample_streams(assign, SAMPLE_STREAMS, seed)
    idx_t = torch.as_tensor(idx, device=dev)
    y = win.y_last.index_select(0, idx_t).permute(0, 2, 1, 3).reshape(
        len(idx), cout, t_n * fragm).double().cpu().numpy()
    sig = ring.index_select(1, idx_t).permute(1, 3, 0, 2, 4).reshape(
        len(idx), cin, ring_n * t_n * fragm).cpu().numpy()
    driver.close()
    del ring, win.y_last, driver, banks, bank
    start = (WARMUP_STEPS + win.steps - 1) * t_n * fragm
    t_judge = time.perf_counter()
    verdict = judge(dense, assign, idx, sig, y, start)
    judge_s = time.perf_counter() - t_judge
    checks["snr_db"] = {"value": verdict["snr_db"], "limit": cfg["snr_limit_db"],
                        "ok": bool(verdict["snr_db"] <= cfg["snr_limit_db"])}

    run = {"audio_s": win.steps * s_n * t_n * fragm / cfg["rate"],
           "window_s": win.window_s, "step_ms": win.step_ms, "setup_s": setup_s,
           "enqueue_ms": win.enqueue_ms,
           "bound": step.bound(), "steps": win.steps}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_metric(m["name"]).read(run, win.trace)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    correct = all(c["ok"] for c in checks.values())
    result = {"correct": correct, "attempted": win.steps * s_n,
              "failed": sum(1 for _, v in verdict["per_stream"]
                            if not v <= cfg["snr_limit_db"]),
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if trace and win.trace is not None:
        result["device"]["busy_s"] = win.trace.busy_s
        result["device"]["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    extra = {"steps": win.steps, "step_samples": len(win.step_ms), "peaks": peaks,
             "bound": step.bound(), "bytes": step.byte_parts(), "ops": step.op_parts(),
             "nvidia_smi": smi, "streams_compared": idx, "judge_s": judge_s,
             "per_stream_snr_db": verdict["per_stream"], "setup_phases_s": phases,
             "checks_ok": {k: c["ok"] for k, c in checks.items()}}
    return {"result": result, "extra": extra}
