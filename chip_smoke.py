"""Smoke test of the PyTorch port (folve_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's exception is caught):
  build        build the eight CUDA kernels from folve_tpu_torch/engine/kernels/csrc
  kernels      each kernel against its plain PyTorch version at the flagship
               shapes (131,072-tap stereo, fragm 8192, P 16, S 8 x T 8; the
               split MAC with per-stream and shared H and at one freq
               shard's 2,080 bins; the window MAC at P 1 and at P 128 x
               T 64; the row-window FFTs for each of 4 freq shards), with
               times (back to back, and from a CUDA graph), bounds, and the
               torch.fft and torch.einsum yardsticks; both MACs also at
               their edges (P 13 with T 5, T 11, Cin 1 with Cout 16) and
               two calls of each MAC case held bit-identical; the fused
               kernel also at S 1 with T 1 and T 8, in both hist layouts,
               two calls held bit-identical, and against the split
               kernels 2 -> 3 -> 4 on the same inputs
  serve_shared 8 streams of one filter through DeviceScheduler (fused kernel)
  serve_mixed  8 streams of two filters of one shape (split kernels)
  processor    a lone SoundProcessor: pump_chunk at 16 and 24 bits, then the
               single-block write_processed path for a ragged end
  serve_short  8 streams of an 8,192-tap filter (P 1, window MAC), one shared
               filter and then two filters
  deep         a 1,048,576-tap bank (P 128) through chunk_step at T 64 (window
               MAC)
  sharded      the flagship through DeviceScheduler on a mesh of 4 freq shards
               of the card (row-window FFT kernels), held against the
               single-device split route
  multihost    the flagship through the SlotServer: 2 hosts x 4 slots, each
               host stream 1 x freq 2 on the card, T 8, six ticks of a
               script (slot 7 joins at tick 1, slot 2 pauses at tick 3,
               slot 5 is reset after tick 3 for a new stream, slot 0 ends
               777 frames early); every stream at -90 dB against the
               float64 oracle, every output bit-equal to a server that
               never paused slot 2 and gave the new stream a fresh slot,
               kernels 6, 3 and 7 launched 2 hosts x 2 shards per tick;
               then the same script from 2 fresh processes, one host
               each, over a gloo group on 127.0.0.1, within 1e-6 of the
               single process, no torch.distributed call in a tick, a row
               of the other host refused; a "multihost" JSON line
  filesystem   FolveFilesystem on the card serving 8 FLAC tracks of 60 s (4 at
               16 bits, 4 at 24) through the flagship filter, one reader
               thread per track, as a player reads (open, stat, 64 KiB reads
               to EOF, close): "shared" (one filter, fused kernel), "mixed"
               (two filters in toplevel-dir mode, split kernels), "gapless"
               (an album of three 20 s tracks read in order) and "warm" (a
               new filesystem that loads the spectra from the cache the cold
               opens wrote); 16-bit tracks within 1 LSB of the float64
               oracle, 24-bit at -90 dB or better; a "filesystem" JSON line
               with served realtime factors and first-read latencies
  cli          the entry points a user runs, each in a fresh process, as
               `python -m folve_tpu_torch` runs them (through runpy, which
               writes the kernels' launch counts at exit): `convolve` of a
               240 s 16-bit FLAC through the flagship filter (within 1 LSB
               of the float64 oracle, the realtime factor it prints);
               `serve -D`: the cold process's first 64 KiB of a track over
               HTTP, 8 reader threads streaming the 60 s tracks over HTTP
               (the filesystem phase's limits), a `/profile` trace of their
               window that must list kernel 1's four kernels, the status
               page, 64 KiB Range requests and the file openings they cost,
               and `/settings?f=B` with a track then served to B's oracle;
               `mount` in daemon mode with a track read through the kernel
               where a FUSE mount is permitted (the daemon stopped by
               `umount`, or by SIGINT where the kernel's unmount does not
               end its loop), else the port's FuseSession over a
               socketpair (the route is named); no kernel rebuilt
  dryrun       entry.dryrun_multichip(8) with its default device: a mesh of
               eight entries of the card, held to the engine step
Every serving phase holds the output to -90 dB against a float64 oracle and
runs no plain MAC on a CUDA tensor.  Prints the card's name and power limit
first, each phase's seconds, a "filesystem" and a "cli" JSON line, a "fused_vs_split"
JSON line (kernel 1's graph time beside kernels 2 + 3 + 4's, and the
serve_shared and serve_mixed steady steps), a "multihost" JSON line, each MAC kernel's ptxas
registers and spills, a "kernels" JSON
line before the last line, and as the last line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from folve_tpu_torch.audio.types import SampleCodec
from folve_tpu_torch.audio.wav import write_wav
from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.kernels.conv_step import (
    all_paths,
    conv_step_fused,
    conv_step_fused_plain,
    fused_preshape,
    live_paths,
    permute_h_for_fused,
)
from folve_tpu_torch.engine.kernels.fdl_mac import (
    fdl_mac,
    fdl_mac_plain,
    fdl_mac_split,
    fdl_mac_split_plain,
)
from folve_tpu_torch.engine.kernels.fft_half import (
    fft_real_half,
    fft_real_half_plain,
    fft_real_half_rows,
    fft_real_half_rows_plain,
)
from folve_tpu_torch.engine.kernels.ifft_half import (
    ifft_from_half,
    ifft_from_half_plain,
    ifft_ola,
    ifft_ola_plain,
    ifft_partial_rows,
    ifft_partial_rows_plain,
)
from folve_tpu_torch.engine.rfft import get_plan, half_bins

# Flagship configuration (BASELINE config 5): 131,072-tap stereo filter.
SIZE, FRAGM, P, CIN, COUT, S, T = 131072, 8192, 16, 2, 2, 8, 8
N = 2 * FRAGM
K = half_bins(N)
DENSE = all_paths(CIN, COUT)  # the flagship is true stereo: every pair live
# 5.1 bass management (FLAC's order L R C LFE Ls Rs): each main to itself,
# each main and LFE to the LFE channel's output, the subwoofer.
BASS_CH, BASS_SUB, BASS_MAINS = 6, 3, (0, 1, 2, 4, 5)
RATE = 44100
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-5   # max|kernel - plain| <= KERNEL_TOL * max|plain|
SNR_LIMIT_DB = -90.0
FREQ = 4            # freq shards of the sharded phase
SHORT_SIZE = 8192   # one fragment: P = 1
DEEP_SIZE, DEEP_T = 1 << 20, 64  # MAXSIZE: P = 128
# The multihost phase: 2 hosts of stream 1 x freq 2 (entries of the
# card), 4 slots each, 6 ticks; slot 0's last tick ends MH_PARTIAL frames
# early, slot 5 carries stream MH_NEW_STREAM after its reset.  Its worker
# processes and their gloo group time out after MH_TIMEOUT seconds; the
# two-process outputs are held to the JAX test's tolerance.
MH_HOSTS, MH_FREQ, MH_S_LOCAL, MH_TICKS = 2, 2, 4, 6
MH_PARTIAL, MH_NEW_STREAM = 777, 8
MH_TIMEOUT = 120
MH_PROC_TOL = 1e-6
MH_KERNELS = ("fft_real_half_rows", "fdl_mac_split", "ifft_partial_rows")
# The filesystem phase: 8 tracks of 60 s (cut from a typical 4-minute
# track to bound the float64 oracle's time), an album of three 20 s
# tracks, a Gaussian level whose oracle peak stays below 0.9 of full
# scale, and the served bytes that make the first-read latency.
FS_TRACKS, FS_SECONDS, FS_ALBUM_SECONDS = 8, 60, 20
FS_LEVEL = 0.1
FS_FIRST_BYTES = 65536
# The cli phase: a typical track's length for convolve, the device its
# processes are told to use, kernel 1's four kernels with a part of the
# name a trace gives each (conv_step.cu's mac_kernel is the one taking a
# MacLayout; fdl_mac.cu has a mac_kernel too), and the 64 KiB Range
# requests of each HTTP reader.
CLI_LONG_SECONDS = 240
CLI_PLATFORM = "cuda"
CONV_STEP_KERNELS = {"forward_kernel": "forward_kernel", "mac_kernel": "MacLayout",
                     "inverse_kernel": "inverse_kernel", "max_kernel": "max_kernel"}
CLI_RANGE_REQUESTS = 8
HERE = os.path.dirname(os.path.abspath(__file__))
# `python -m folve_tpu_torch ARGS` through runpy; at exit (not at a
# fork's os._exit) the launch counts of the wrappers named in argv[2]
# and the plain MAC's CUDA calls go to the file argv[1].  SIGUSR1 dumps
# every thread's stack to argv[1] + ".stacks" (a process that hangs).
_RUN_CLI = """
import faulthandler, importlib, json, runpy, signal, sys
counts_path, modules = sys.argv[1], json.loads(sys.argv[2])
sys.argv = ["folve_tpu_torch"] + sys.argv[3:]
stacks = open(counts_path + ".stacks", "w")
faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
try:
    runpy.run_module("folve_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac_plain
    counts = {name: getattr(importlib.import_module(mod), name).launches
              for name, mod in modules.items()}
    counts["fdl_mac_plain_cuda_calls"] = fdl_mac_plain.cuda_calls
    with open(counts_path, "w") as f:
        json.dump(counts, f)
"""

KERNELS = {
    "conv_step_fused": dict(
        fn=conv_step_fused, source="folve_tpu_torch/engine/kernels/csrc/conv_step.cu",
        replaces="folve_tpu/engine/kernels/conv_step.py:227"),
    "fft_real_half": dict(
        fn=fft_real_half, source="folve_tpu_torch/engine/kernels/csrc/fft_half.cu",
        replaces="folve_tpu/engine/kernels/fft_half.py:36"),
    "fdl_mac_split": dict(
        fn=fdl_mac_split, source="folve_tpu_torch/engine/kernels/csrc/fdl_mac.cu",
        replaces="folve_tpu/engine/kernels/fdl_mac.py:115"),
    "ifft_ola": dict(
        fn=ifft_ola, source="folve_tpu_torch/engine/kernels/csrc/ifft_half.cu",
        replaces="folve_tpu/engine/kernels/ifft_half.py:67"),
    "fdl_mac": dict(
        fn=fdl_mac, source="folve_tpu_torch/engine/kernels/csrc/fdl_mac.cu",
        replaces="folve_tpu/engine/kernels/fdl_mac.py:222"),
    "fft_real_half_rows": dict(
        fn=fft_real_half_rows, source="folve_tpu_torch/engine/kernels/csrc/fft_half.cu",
        replaces="folve_tpu/engine/kernels/fft_half.py:57"),
    "ifft_partial_rows": dict(
        fn=ifft_partial_rows, source="folve_tpu_torch/engine/kernels/csrc/ifft_half.cu",
        replaces="folve_tpu/engine/kernels/ifft_half.py:177"),
    "ifft_from_half": dict(
        fn=ifft_from_half, source="folve_tpu_torch/engine/kernels/csrc/ifft_half.cu",
        replaces="folve_tpu/engine/kernels/ifft_half.py:231"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0
    fdl_mac_plain.cuda_calls = 0


def no_plain_mac(phase: str) -> None:
    """The serving path runs kernels on a card, never the plain MAC."""
    assert fdl_mac_plain.cuda_calls == 0, (
        f"{phase}: fdl_mac_plain ran {fdl_mac_plain.cuda_calls} times on CUDA tensors")


def counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times, so the host's time per launch (the
    Python wrapper) drops out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the allocator off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def kernel_device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, by
    kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            name = re.search(r"::(\w+)[<(]", e.key)
            out[name.group(1) if name else e.key] = us / iters / 1e3
    return out


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fft_ops(n: int) -> float:
    """Operations of one real FFT of length ``n`` (the textbook
    2.5*n*log2(n)): what the function needs, whatever the kernel's own
    DFT schedule does."""
    return 2.5 * n * math.log2(n)


def mac_einsum(h, xr, xi, t: int):
    """The FDL MAC Y[t] = sum_p H[p] * X[t + P-1 - p] as one torch.einsum
    over complex64 operands built here, outside any timed region: H
    flipped over p, and the window [S, T+P-1, Cin, K] unfolded over p.
    The yardstick of kernels 3 and 5 (no port path calls it).  Returns
    the call and its (re, im) result."""
    hc = torch.complex(h[..., 0, :], h[..., 1, :]).flip(-4).contiguous()
    wu = torch.complex(xr, xi).unfold(1, h.shape[-5], 1)  # [S, T, Cin, K, P]
    eq = "stikj,jiok->stok" if h.dim() == 5 else "stikj,sjiok->stok"
    call = lambda: torch.einsum(eq, wu, hc)
    y = call()
    return call, (y.real, y.imag)


def max_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|) over tensors or tuples of tensors."""
    if torch.is_tensor(got):
        got, ref = (got,), (ref,)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return err, scale


def check_kernel(name: str, got, ref) -> float:
    err, scale = max_err(got, ref)
    ok = err <= KERNEL_TOL * scale
    log(f"  {name}: max|kernel-plain| = {err:.3e}, max|plain| = {scale:.3e}, "
        f"relative {err / scale:.3e} (limit {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def fused_inputs(cu, rng, hp, s: int, t: int, hist_t: bool, cin: int = CIN,
                 cout: int = COUT) -> tuple:
    """Seeded inputs of kernel 1 at the flagship width for ``s`` streams of
    ``t`` blocks: x and tail pre-shaped, the hist in the layout ``hist_t``
    names, and a ragged ``valid`` (the last stream ends inside its last
    block, the one before it halfway through the chunk)."""
    b = FRAGM
    rows, m2, m1, cols = fused_preshape(N)
    xs = cu(rng.standard_normal((s, t, cin, rows, m2)))
    tl = cu(rng.standard_normal((s, cout, rows, m2)))
    shape = (s, P - 1, cin, cols, m1) if hist_t else (s, P - 1, cin, K)
    h_re, h_im = cu(rng.standard_normal(shape)), cu(rng.standard_normal(shape))
    nv = np.full(s, t * b)
    nv[-1] -= b // 2 + 3
    if s > 1:
        nv[-2] = t * b // 2 + 11
    valid = torch.from_numpy(np.clip(nv[:, None] - np.arange(t)[None] * b, 0, b)
                             .astype(np.int32)).to(xs.device)
    return hp, xs, h_re, h_im, tl, valid, N


def fused_vs_split(cu, rng) -> dict:
    """Kernel 1 against the split route it fuses (kernels 2 -> 3 -> 4) on
    the same seeded flagship inputs with one shared H: device time of
    each from CUDA graphs, kernel 1's four launches apart from
    torch.profiler, and the two routes' y and new tail held together.  The fused call takes the hist in its serving layout (the
    transposed carry) and, second, in the canonical one the split route
    takes; it also writes the new hist and the max, which the split
    kernels leave to other calls."""
    b = FRAGM
    h = cu(rng.standard_normal((P, CIN, COUT, 2, K)) / 64)
    hp = permute_h_for_fused(h, N)
    x = cu(rng.standard_normal((S, T, CIN, b)))
    hr, hi = cu(rng.standard_normal((S, P - 1, CIN, K))), cu(rng.standard_normal((S, P - 1, CIN, K)))
    tl = cu(rng.standard_normal((S, COUT, b)))
    valid = torch.full((S, T), b, dtype=torch.int32, device=x.device)
    hr_t, hi_t = permute_h_for_fused(hr, N), permute_h_for_fused(hi, N)
    fused = lambda: conv_step_fused(hp, x, hr_t, hi_t, tl, valid, N, hist_t=True,
                                    paths=DENSE)
    fused_canonical = lambda: conv_step_fused(hp, x, hr, hi, tl, valid, N, paths=DENSE)
    xr, xi = fft_real_half(x, N)
    yr, yi = fdl_mac_split(h, hr, hi, xr, xi)

    def split():
        sr, si = fft_real_half(x, N)
        mr, mi = fdl_mac_split(h, hr, hi, sr, si)
        return ifft_ola(mr, mi, tl, N)

    got, ref = fused(), split()
    err, scale = max_err((got[0], got[3]), ref)
    log(f"  fused vs split route (y, new tail): relative {err / scale:.3e} "
        f"(limit {KERNEL_TOL:g})")
    assert err <= KERNEL_TOL * scale, "fused and split routes disagree"
    parts = dict(fft_real_half=graph_ms(lambda: fft_real_half(x, N), 20),
                 fdl_mac_split=graph_ms(lambda: fdl_mac_split(h, hr, hi, xr, xi), 20),
                 ifft_ola=graph_ms(lambda: ifft_ola(yr, yi, tl, N), 20))
    out = dict(fused_graph_ms=graph_ms(fused, 20),
               fused_canonical_hist_graph_ms=graph_ms(fused_canonical, 20),
               split_graph_ms=parts, split_sum_graph_ms=sum(parts.values()),
               split_chain_graph_ms=graph_ms(split, 20), rel_err=err / scale,
               fused_phases_ms=kernel_device_ms(fused),
               fused_canonical_hist_phases_ms=kernel_device_ms(fused_canonical))
    out["target_met"] = out["fused_graph_ms"] <= out["split_sum_graph_ms"]
    log(f"  fused {out['fused_graph_ms']:.4f} ms (canonical hist "
        f"{out['fused_canonical_hist_graph_ms']:.4f}) vs split 2+3+4 "
        f"{out['split_sum_graph_ms']:.4f} ms {parts} (as one chain "
        f"{out['split_chain_graph_ms']:.4f}): target met {out['target_met']}; "
        f"fused phases (torch.profiler) {out['fused_phases_ms']}, with the "
        f"canonical hist {out['fused_canonical_hist_phases_ms']}")
    return out


def phase_kernels(dev, results: dict) -> dict:
    log("phase kernels: flagship shapes, seeded inputs")
    rng = np.random.default_rng(1)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    b = FRAGM

    # Kernel 2: forward FFT of the mixed-filter path, R = S*T*Cin signals.
    x = cu(rng.standard_normal((S, T, CIN, b)))
    got = fft_real_half(x, N)
    ref = fft_real_half_plain(x, N)
    err = check_kernel("fft_real_half", got, ref)
    r = S * T * CIN
    bms, bby = bound(r * fft_ops(N), 4.0 * r * (b + 2 * K))
    rfft_call = lambda: torch.fft.rfft(x, n=N)
    results["fft_real_half"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fft_real_half(x, N), 20),
        graph_ms=graph_ms(lambda: fft_real_half(x, N), 20),
        plain_ms=time_ms(lambda: fft_real_half_plain(x, N), 5),
        library_ms=time_ms(rfft_call, 20), library_graph_ms=graph_ms(rfft_call, 20),
        library="torch.fft.rfft", bound_ms=bms, bound_by=bby)

    # Kernel 3: FDL MAC with per-stream filters (serve_mixed's batch, the
    # row's numbers), with one shared filter, and at one freq shard's
    # bins (the sharded phase's shared bank); then the edge cases.
    mixed = mac_case(cu, rng, "split", S, P, T, shared=False)
    cases = [mixed, mac_case(cu, rng, "split", S, P, T, shared=True),
             mac_case(cu, rng, "split", S, P, T, shared=True, k=K // FREQ)]
    cases += mac_edge_cases(cu, rng, "split")
    results["fdl_mac_split"] = dict(
        {k: v for k, v in mixed.items() if k not in ("shape", "bit_identical")},
        max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases)

    # Kernel 4: inverse + overlap-add of the mixed path's MAC output.
    yr, yi = cu(rng.standard_normal((S, T, COUT, K))), cu(rng.standard_normal((S, T, COUT, K)))
    tail = cu(rng.standard_normal((S, COUT, b)))
    got = ifft_ola(yr, yi, tail, N)
    ref = ifft_ola_plain(yr, yi, tail, N)
    err = check_kernel("ifft_ola", got, ref)
    spec = torch.complex(cu(rng.standard_normal((S * T * COUT, N // 2 + 1))),
                         cu(rng.standard_normal((S * T * COUT, N // 2 + 1))))
    nrow = S * T * COUT
    # Per row: the inverse FFT, the c/n weight on each bin, the OLA add.
    bms, bby = bound(nrow * (fft_ops(N) + 2 * K + b),
                     4.0 * (nrow * (2 * K + b) + 2 * S * COUT * b))
    irfft_call = lambda: torch.fft.irfft(spec, n=N)
    results["ifft_ola"] = dict(
        max_abs_err=err, ms=time_ms(lambda: ifft_ola(yr, yi, tail, N), 20),
        graph_ms=graph_ms(lambda: ifft_ola(yr, yi, tail, N), 20),
        plain_ms=time_ms(lambda: ifft_ola_plain(yr, yi, tail, N), 5),
        library_ms=time_ms(irfft_call, 20), library_graph_ms=graph_ms(irfft_call, 20),
        library="torch.fft.irfft", bound_ms=bms, bound_by=bby)

    # Kernel 1: the fused step on the shared filter, both hist layouts, at
    # the flagship batch and at the lone stream's (S = 1, T = 1 and T).
    hp = permute_h_for_fused(cu(rng.standard_normal((P, CIN, COUT, 2, K)) / 64), N)
    cases, timed = [], None
    for s, t in ((S, T), (1, 1), (1, T)):
        for hist_t in (True, False):
            args = fused_inputs(cu, rng, hp, s, t, hist_t)
            got = conv_step_fused(*args, hist_t=hist_t, paths=DENSE)
            again = conv_step_fused(*args, hist_t=hist_t, paths=DENSE)
            ref = conv_step_fused_plain(*args, hist_t=hist_t)
            err = check_kernel(f"conv_step_fused(S={s}, T={t}, hist_t={hist_t})", got, ref)
            # The overlap-add's atomics sum two terms per sample: the
            # result does not depend on their order.
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            log(f"  conv_step_fused(S={s}, T={t}, hist_t={hist_t}): two calls "
                f"bit-identical: {same}")
            assert same, "conv_step_fused differs between two calls on the same inputs"
            case = dict(S=s, T=t, hist_t=hist_t, max_abs_err=err, bit_identical=same)
            if hist_t:  # the serving layout: time the call that was checked
                timed = timed or args
                case["graph_ms"] = graph_ms(
                    lambda: conv_step_fused(*args, hist_t=True, paths=DENSE), 20)
            cases.append(case)
    args = timed  # the flagship's, checked first
    flagship = lambda: conv_step_fused(*args, hist_t=True, paths=DENSE)
    # Per (stream, block): Cin forward and Cout inverse FFTs, the MAC, the
    # OLA add.  Bytes: H, x, y, hist in and out (two planes each), tail in
    # and out, valid, max.
    flops = S * T * ((CIN + COUT) * fft_ops(N) + 8.0 * P * CIN * COUT * K + COUT * b)
    nbytes = 4.0 * (hp.numel() + args[1].numel() + S * T * COUT * b
                    + 4 * args[2].numel() + 2 * args[4].numel() + args[5].numel() + S)
    bms, bby = bound(flops, nbytes)
    results["conv_step_fused"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=time_ms(flagship, 20),
        graph_ms=cases[0]["graph_ms"],
        plain_ms=time_ms(lambda: conv_step_fused_plain(*args, hist_t=True), 5),
        library_ms=None, bound_ms=bms, bound_by=bby, cases=cases,
        bass_managed=fused_bass_managed(cu, rng))
    kernels_window_mac(cu, rng, results)
    kernels_row_windows(cu, rng, results)
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms (graph {r.get('graph_ms')}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (graph "
            f"{r.get('library_graph_ms')}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return fused_vs_split(cu, rng)


def fused_bass_managed(cu, rng) -> dict:
    """Kernel 1 on a 5.1 bass-managed bank (6 x 6, 11 live paths of 36)
    at the flagship widths (fragm 8192, P 16, S 8 x T 8, a ragged
    ``valid``), in copy-out mode (the canonical hist, as the lone-stream
    pump runs it) and in ring mode (the serving carry, its new rows
    wrapping past the last slot): the bank's live paths against the
    plain version over the same paths, and bit for bit against the
    dense call over all 36 pairs (the pairs left out have all-zero
    spectra, so they add exact zeros); one launch a call and no other
    kernel; device times of the live and the dense call."""
    c = BASS_CH
    h = cu(np.zeros((P, c, c, 2, K)))
    for i, o in [(m, m) for m in BASS_MAINS] + [(i, BASS_SUB) for i in range(c)]:
        h[:, i, o] = cu(rng.standard_normal((P, 2, K)) / 64)
    hp = permute_h_for_fused(h, N)
    live, dense = live_paths(hp), all_paths(c, c)
    assert len(live) == 11, live
    out = dict(live_paths=len(live), pairs=len(dense))
    for ring in (False, True):
        args = fused_inputs(cu, rng, hp, S, T, ring, c, c)
        head = P - 2 if ring else None
        call = lambda fn, paths: fn(*(a.clone() if torch.is_tensor(a) else a for a in args),
                                    hist_t=ring, head=head, paths=paths)
        name = f"conv_step_fused(6 x 6 bass-managed, {'ring' if ring else 'copy-out'})"
        reset_counts()
        terms = conv_step_fused.mac_terms
        got = call(conv_step_fused, live)
        assert conv_step_fused.mac_terms - terms == S * T * P * len(live) * K
        full = call(conv_step_fused, dense)
        c_ = counts()
        assert c_["conv_step_fused"] == 2 and sum(c_.values()) == 2, c_
        err = check_kernel(name, got, call(conv_step_fused_plain, live))
        same = all(torch.equal(a, b) for a, b in zip(got, full))
        log(f"  {name}: bit-identical to the dense call over {len(dense)} pairs: {same}; "
            f"launches {c_['conv_step_fused']}")
        assert same, f"{name}: the live paths and the dense call differ"
        # Timed on the checked inputs themselves (a ring call rewrites
        # the same slots each time).
        ms = {k: graph_ms(lambda: conv_step_fused(*args, hist_t=ring, head=head, paths=p), 20)
              for k, p in (("live", live), ("dense", dense))}
        log(f"  {name}: graph ms live {ms['live']:.4f}, dense {ms['dense']:.4f}")
        out["ring" if ring else "copy_out"] = dict(
            max_abs_err=err, bit_identical_to_dense=same, launches=c_["conv_step_fused"],
            live_graph_ms=ms["live"], dense_graph_ms=ms["dense"])
    return out


def mac_case(cu, rng, kind: str, s: int, p: int, t: int, shared: bool,
             cin: int = CIN, cout: int = COUT, k: int = K, timed: bool = True) -> dict:
    """Kernel 3 (``kind`` "split": hist and new spectra apart) or 5
    ("window": one concatenated window) against its plain version at one
    shape, and two calls held bit for bit.  With ``timed``, its bound
    (H, the window and Y each moved once, 8 FLOP per complex term) and
    times: ``ms`` a stream of back-to-back calls, host time per launch
    included; ``graph_ms`` the same calls replayed from a CUDA graph,
    device time alone; ``library_ms`` one torch.einsum
    (:func:`mac_einsum`)."""
    h = cu(rng.standard_normal(((p,) if shared else (s, p)) + (cin, cout, 2, k))
           / np.sqrt(p * cin))
    xr = cu(rng.standard_normal((s, t + p - 1, cin, k)))
    xi = cu(rng.standard_normal((s, t + p - 1, cin, k)))
    if kind == "split":
        hr, nr, hi, ni = (a[:, sl].contiguous() for a in (xr, xi)
                          for sl in (slice(0, p - 1), slice(p - 1, None)))
        call = lambda: fdl_mac_split(h, hr, hi, nr, ni)
        plain = lambda: fdl_mac_split_plain(h, hr, hi, nr, ni)
    else:
        call = lambda: fdl_mac(h, xr, xi, t)
        plain = lambda: fdl_mac_plain(h, xr, xi, t)
    name = (f"{'fdl_mac_split' if kind == 'split' else 'fdl_mac'}(S={s}, P={p}, T={t}, "
            f"Cin={cin}, Cout={cout}, K={k}, {'shared' if shared else 'per-stream'} H)")
    ref = plain()
    got, again = call(), call()
    err = check_kernel(name, got, ref)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  {name}: two calls bit-identical: {same}")
    assert same, f"{name} differs between two calls on the same inputs"
    case = dict(shape=dict(S=s, P=p, T=t, Cin=cin, Cout=cout, K=k, shared_filter=shared),
                max_abs_err=err, bit_identical=same)
    if not timed:
        return case
    lib, lib_out = mac_einsum(h, xr, xi, t)
    check_kernel(f"{name} yardstick (torch.einsum)", lib_out, ref)
    bms, bby = bound(8.0 * s * t * cout * p * cin * k,
                     4.0 * (h.numel() + 2 * xr.numel() + 2 * s * t * cout * k))
    return dict(case, ms=time_ms(call, 200), graph_ms=graph_ms(call, 50),
                plain_ms=time_ms(plain, 3),
                library_ms=time_ms(lib, 20), library_graph_ms=graph_ms(lib, 10),
                library=("torch.einsum over complex64, the window ("
                         + ("hist and new spectra concatenated, " if kind == "split" else "")
                         + "unfolded) built beforehand"),
                bound_ms=bms, bound_by=bby)


def mac_edge_cases(cu, rng, kind: str) -> list:
    """A MAC kernel against its plain version where its tiles have edges:
    P = 13 with T = 5 (P and T not multiples of 8), T = 11 (a masked
    tail chunk), and Cin = 1 with Cout = 16 (16 warps for one stream and
    chunk), with per-stream and shared H, at a bin count that is no
    multiple of 32."""
    k = K // FREQ + 5
    return [mac_case(cu, rng, kind, 3, 13, 5, shared=False, k=k, timed=False),
            mac_case(cu, rng, kind, 3, 13, 11, shared=True, k=k, timed=False),
            mac_case(cu, rng, kind, 3, 9, 20, shared=True, cin=1, cout=16, k=k,
                     timed=False)]


def kernels_window_mac(cu, rng, results: dict) -> None:
    # Kernel 5 at serve_short's shapes (an 8,192-tap filter: P = 1, the
    # window is the new spectra; one shared filter, then per-stream
    # spectra as in its two-filter batch) and at the deep phase's
    # (P = 128, T = 64); then the edge cases.
    short = mac_case(cu, rng, "window", S, 1, T, shared=True)
    mixed = mac_case(cu, rng, "window", S, 1, T, shared=False)
    deep = mac_case(cu, rng, "window", 1, DEEP_SIZE // FRAGM, DEEP_T, shared=True)
    cases = [short, mixed, deep] + mac_edge_cases(cu, rng, "window")
    results["fdl_mac"] = dict(
        {k: v for k, v in short.items() if k not in ("shape", "bit_identical")},
        max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases)


def ptxas_report(source: str) -> dict:
    """Per kernel of ``csrc/<source>.cu`` (mangled name): registers, stack
    frame and spill bytes, from the ptxas report of this run's build."""
    out, name = {}, None
    for line in _build.build_log.get(source, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w.$]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernels_row_windows(cu, rng, results: dict) -> None:
    """Kernels 6 and 7 for each of FREQ k1 windows at the flagship shape,
    the windows' partial inverses summed against the whole inverse, and
    kernel 8.  Each window's bound counts its share of the FFT's
    operations (2.5*n*log2(n) / FREQ) and its own bytes."""
    b, r = FRAGM, S * T * CIN
    plan = get_plan(N)
    m1, cols = plan.m1, plan.m2 // 2 + 1
    kn = m1 // FREQ
    x = cu(rng.standard_normal((S, T, CIN, b)))
    yr = cu(rng.standard_normal((S, T, COUT, K)))
    yi = cu(rng.standard_normal((S, T, COUT, K)))
    win = lambda a, ks: a.reshape(S, T, COUT, m1, cols)[..., ks:ks + kn, :].reshape(
        S, T, COUT, kn * cols).contiguous()
    spec = torch.complex(cu(rng.standard_normal((r, N // 2 + 1))),
                         cu(rng.standard_normal((r, N // 2 + 1))))
    fwd, inv, total = [], [], None
    for f in range(FREQ):
        ks = f * kn
        err = check_kernel(f"fft_real_half_rows(window {f})",
                           fft_real_half_rows(x, N, ks, kn),
                           fft_real_half_rows_plain(x, N, ks, kn))
        bms, bby = bound(r * fft_ops(N) / FREQ, 4.0 * r * (b + 2 * kn * cols))
        fwd.append(dict(
            k1_start=ks, k1_n=kn, max_abs_err=err, bound_ms=bms, bound_by=bby,
            ms=time_ms(lambda: fft_real_half_rows(x, N, ks, kn), 20),
            graph_ms=graph_ms(lambda: fft_real_half_rows(x, N, ks, kn), 20),
            plain_ms=time_ms(lambda: fft_real_half_rows_plain(x, N, ks, kn), 5)))
        wr, wi = win(yr, ks), win(yi, ks)
        part = ifft_partial_rows(wr, wi, N, ks, kn)
        err = check_kernel(f"ifft_partial_rows(window {f})", part,
                           ifft_partial_rows_plain(wr, wi, N, ks, kn))
        total = part if total is None else total + part
        bms, bby = bound(r * (fft_ops(N) / FREQ + 2 * kn * cols),
                         4.0 * r * (2 * kn * cols + N))
        inv.append(dict(
            k1_start=ks, k1_n=kn, max_abs_err=err, bound_ms=bms, bound_by=bby,
            ms=time_ms(lambda: ifft_partial_rows(wr, wi, N, ks, kn), 20),
            graph_ms=graph_ms(lambda: ifft_partial_rows(wr, wi, N, ks, kn), 20),
            plain_ms=time_ms(lambda: ifft_partial_rows_plain(wr, wi, N, ks, kn), 5)))
    whole = ifft_from_half_plain(yr, yi, N)
    sum_err = check_kernel(f"sum of {FREQ} ifft_partial_rows vs ifft_from_half_plain",
                           total, whole)
    rfft_call = lambda: torch.fft.rfft(x, n=N)
    irfft_call = lambda: torch.fft.irfft(spec, n=N)
    for name, rows, lib in (("fft_real_half_rows", fwd, rfft_call),
                            ("ifft_partial_rows", inv, irfft_call)):
        results[name] = dict(
            max_abs_err=max(w["max_abs_err"] for w in rows),
            ms=float(np.mean([w["ms"] for w in rows])),
            graph_ms=float(np.mean([w["graph_ms"] for w in rows])),
            plain_ms=float(np.mean([w["plain_ms"] for w in rows])),
            bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
            library_ms=time_ms(lib, 20), library_graph_ms=graph_ms(lib, 20),
            library=("torch.fft." + ("rfft" if name.startswith("fft") else "irfft")
                     + " over all k1 rows (the whole transform), one call"),
            per_window="ms, graph_ms, plain_ms, bound_ms are one window's (mean over windows)",
            windows=rows)
    results["ifft_partial_rows"]["sum_vs_whole_err"] = sum_err

    # Kernel 8: the whole inverse at the flagship shape.
    err = check_kernel("ifft_from_half", ifft_from_half(yr, yi, N), whole)
    bms, bby = bound(r * (fft_ops(N) + 2 * K), 4.0 * r * (2 * K + N))
    results["ifft_from_half"] = dict(
        max_abs_err=err, ms=time_ms(lambda: ifft_from_half(yr, yi, N), 20),
        graph_ms=graph_ms(lambda: ifft_from_half(yr, yi, N), 20),
        plain_ms=time_ms(lambda: ifft_from_half_plain(yr, yi, N), 5),
        library_ms=time_ms(irfft_call, 20), library_graph_ms=graph_ms(irfft_call, 20),
        library="torch.fft.irfft", bound_ms=bms, bound_by=bby)


def make_ir(seed: int, size: int) -> np.ndarray:
    """A seeded true-stereo IR of ``size`` taps: decaying noise, float32
    [Cin, Cout, size]."""
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(size) / (size / 6.0))
    ir = (rng.standard_normal((CIN, COUT, size)) * env).astype(np.float32)
    ir *= np.float32(np.sqrt(0.5 / np.sum(ir[0, 0].astype(np.float64) ** 2)))
    return ir


def make_config(tmp: str, name: str, seed: int,
                size: int | None = None) -> tuple[str, np.ndarray]:
    """A seeded true-stereo IR (:func:`make_ir`, one WAV channel per
    in/out pair, ``SIZE`` taps by default) and its zita config; returns
    (config path, ir [Cin, Cout, size] float32)."""
    size = SIZE if size is None else size
    ir = make_ir(seed, size)
    wav = os.path.join(tmp, f"{name}.wav")
    write_wav(wav, ir.reshape(CIN * COUT, size).T, RATE, SampleCodec.FLOAT)
    lines = [f"/convolver/new {CIN} {COUT} {FRAGM} {size}"]
    for i in range(CIN):
        for o in range(COUT):
            lines.append(f"/impulse/read {i + 1} {o + 1} 1 0 0 0 {i * COUT + o + 1} {name}.wav")
    cfg = os.path.join(tmp, f"{name}.conf")
    with open(cfg, "w") as f:
        f.write("\n".join(lines) + "\n")
    return cfg, ir


def oracle(ir: np.ndarray, x: np.ndarray) -> np.ndarray:
    """float64 linear convolution truncated to the input: x [N, Cin] -> [N, Cout]."""
    from scipy import signal

    n = x.shape[0]
    y = np.zeros((n, ir.shape[1]))
    for o in range(ir.shape[1]):
        for i in range(ir.shape[0]):
            y[:, o] += signal.fftconvolve(x[:, i].astype(np.float64),
                                          ir[i, o].astype(np.float64))[:n]
    return y


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    err = np.asarray(out, np.float64) - ref
    return float(10 * np.log10(np.sum(err ** 2) / np.sum(ref ** 2) + 1e-300))


def serve(dev, configs: list, rounds: int = 6, mesh=None) -> tuple:
    """S streams (stream i uses configs[i % len]) submit T-block chunks to
    one DeviceScheduler (on ``mesh`` when given) from threads for
    ``rounds`` rounds; returns (scheduler, worst SNR in dB against the
    float64 oracle, per-stream outputs [rounds*T, Cout, B], the input
    audio [S, frames, Cin], the banks)."""
    from folve_tpu_torch.engine.stream import init_state
    from folve_tpu_torch.filters.compiler import compile_config_file
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler

    compiled = [compile_config_file(cfg, fsamp=RATE, device=dev) for cfg, _ in configs]
    for c, (_, ir) in zip(compiled, configs):
        assert np.array_equal(c.ir, ir), "loaded IR differs from the written one"
    rng = np.random.default_rng(7)
    b = FRAGM
    audio = (0.1 * rng.standard_normal((S, rounds * T * b, CIN))).astype(np.float32)
    sched = DeviceScheduler(max_batch=S, window_s=0.2, device=dev, mesh=mesh)
    banks = [compiled[i % len(compiled)].bank for i in range(S)]
    states = [init_state(banks[i], device=dev) for i in range(S)]
    outs = [[] for _ in range(S)]
    barrier = threading.Barrier(S)
    errors = []

    def pump(i):
        try:
            for r in range(rounds):
                chunk = audio[i, r * T * b:(r + 1) * T * b]
                x = np.ascontiguousarray(chunk.reshape(T, b, CIN).transpose(0, 2, 1))
                barrier.wait(timeout=600)
                states[i], y = sched.submit(banks[i], states[i], x, T * b).result(timeout=600)
                outs[i].append(y.cpu().numpy())
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=pump, args=(i,)) for i in range(S)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=1200)
    sched.stop()
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "a stream never finished"
    worst = -np.inf
    ys = []
    for i in range(S):
        ys.append(np.concatenate(outs[i], axis=0))  # [rounds*T, Cout, B]
        y = ys[-1].transpose(0, 2, 1).reshape(-1, COUT)
        assert np.all(np.isfinite(y)) and y.shape == (rounds * T * b, COUT)
        worst = max(worst, snr_db(oracle(configs[i % len(configs)][1], audio[i]), y))
    return sched, worst, ys, audio, banks


def report_serving(name: str, sched) -> dict:
    # The first two steps load lazily-loaded CUDA modules (state stacking,
    # the carry gather); the rest are steady state.
    steps = sched.latency._recent
    steady = steps[2:]
    step_s = float(np.median(steady))
    audio_s = S * T * FRAGM / RATE
    log(f"  {name}: {sched.steps} steps (fused {sched.fused_steps}, fast "
        f"{sched.fused_fast_steps}, sharded {sched.sharded_steps}, sharded fast "
        f"{sched.sharded_fast_steps}, batched jobs {sched.batched_jobs}); step ms "
        f"{[round(1e3 * v, 3) for v in steps]}; steady median {1e3 * step_s:.3f} ms "
        f"for {S} streams x {T} blocks = {audio_s:.2f} s of audio: "
        f"realtime factor {audio_s / step_s:.1f}")
    return dict(step_ms=1e3 * step_s, realtime=audio_s / step_s)


def phase_serve_shared(dev, tmp: str) -> dict:
    log("phase serve_shared: 8 streams, one 131,072-tap stereo filter, DeviceScheduler")
    cfg = make_config(tmp, "shared", 11)
    reset_counts()
    sched, worst, *_ = serve(dev, [cfg])
    c = counts()
    log(f"  launches {c}; worst SNR vs float64 oracle {worst:.2f} dB (limit {SNR_LIMIT_DB})")
    no_plain_mac("serve_shared")
    assert sched.fused_steps > 0 and sched.fused_fast_steps > 0, "fused path not taken"
    assert c["conv_step_fused"] > 0, "fused kernel never launched"
    assert worst <= SNR_LIMIT_DB, f"shared serving SNR {worst:.2f} dB"
    return dict(report_serving("serve_shared", sched), launches=c, snr_db=worst)


def phase_serve_mixed(dev, tmp: str) -> dict:
    log("phase serve_mixed: 8 streams, two filters of one shape in one batch")
    cfgs = [make_config(tmp, "mixa", 21), make_config(tmp, "mixb", 22)]
    reset_counts()
    sched, worst, *_ = serve(dev, cfgs)
    c = counts()
    log(f"  launches {c}; worst SNR vs float64 oracle {worst:.2f} dB (limit {SNR_LIMIT_DB})")
    no_plain_mac("serve_mixed")
    for name in ("fft_real_half", "fdl_mac_split", "ifft_ola"):
        assert c[name] > 0, f"{name} never launched"
    assert worst <= SNR_LIMIT_DB, f"mixed serving SNR {worst:.2f} dB"
    return dict(report_serving("serve_mixed", sched), launches=c, snr_db=worst)


class _Source:
    def __init__(self, data: np.ndarray):
        self.data, self.pos = data, 0

    def read_float(self, n: int) -> np.ndarray:
        out = self.data[self.pos:self.pos + n]
        self.pos += out.shape[0]
        return out


def phase_processor(dev, tmp: str) -> dict:
    log("phase processor: lone SoundProcessor, pump_chunk at 16 and 24 bits + ragged end")
    from folve_tpu_torch.filters.compiler import compile_config_file
    from folve_tpu_torch.runtime.processor import SoundProcessor

    cfg, ir = make_config(tmp, "proc", 31)
    compiled = compile_config_file(cfg, fsamp=RATE, device=dev)
    rng = np.random.default_rng(8)
    n = 2 * T * FRAGM + 3001
    # -30 dBFS RMS: one 24-bit LSB is 2^-23, and the float32 engine's
    # error (about -125 dB of the signal) stays below it at this level.
    audio = (0.03 * rng.standard_normal((n, CIN))).astype(np.float32)
    ref = oracle(ir, audio)
    reset_counts()
    worst = 0
    for bits in (16, 24):
        proc = SoundProcessor(compiled, cfg)
        src, got = _Source(audio), []
        while n - src.pos >= T * FRAGM:
            assert proc.pump_chunk(src, got.append, T, quantize_bits=bits) == T * FRAGM
        proc.drain_pipeline()
        r = proc.fill_buffer(src)
        proc.write_processed(got.append, r, quantize_bits=bits)
        pcm = np.concatenate(got, axis=0).astype(np.int64)
        scale = float(1 << (bits - 1))
        want = np.clip(np.round(ref * scale), -scale, scale - 1).astype(np.int64)
        assert pcm.shape == want.shape, (pcm.shape, want.shape)
        lsb = int(np.max(np.abs(pcm - want)))
        log(f"  {bits}-bit: {pcm.shape[0]} frames, max |PCM - oracle| = {lsb} LSB")
        assert lsb <= 1, f"{bits}-bit PCM off by {lsb} LSB"
        worst = max(worst, lsb)
    c = counts()
    log(f"  launches {c}")
    no_plain_mac("processor")
    assert c["conv_step_fused"] > 0, "fused kernel never launched"
    return dict(launches=c, max_lsb=worst)


def phase_serve_short(dev, tmp: str) -> dict:
    log(f"phase serve_short: 8 streams, {SHORT_SIZE}-tap stereo filters (P = 1), "
        "one shared filter, then two filters")
    launches = 0
    for cfgs in ([make_config(tmp, "short", 61, SHORT_SIZE)],
                 [make_config(tmp, "shorta", 62, SHORT_SIZE),
                  make_config(tmp, "shortb", 63, SHORT_SIZE)]):
        reset_counts()
        sched, worst, _, _, banks = serve(dev, cfgs, rounds=3)
        c = counts()
        assert banks[0].partitions == 1, banks[0].h_spec.shape
        log(f"  {len(cfgs)} filter(s): launches {c}; worst SNR vs float64 oracle "
            f"{worst:.2f} dB (limit {SNR_LIMIT_DB})")
        report_serving(f"serve_short ({len(cfgs)} filters)", sched)
        no_plain_mac("serve_short")
        assert c["fdl_mac"] > 0, "window MAC never launched"
        assert worst <= SNR_LIMIT_DB, f"serve_short SNR {worst:.2f} dB"
        launches += c["fdl_mac"]
    return dict(launches=launches)


def phase_deep(dev) -> dict:
    log(f"phase deep: a {DEEP_SIZE}-tap stereo bank (P = {DEEP_SIZE // FRAGM}) "
        f"through chunk_step at T = {DEEP_T}, 3 chunks")
    from folve_tpu_torch.engine.filter_bank import compile_filter_bank
    from folve_tpu_torch.engine.stream import chunk_step, init_state

    ir = make_ir(71, DEEP_SIZE)
    bank = compile_filter_bank(ir, fragm=FRAGM, device=dev)
    assert (bank.fragm, bank.partitions) == (FRAGM, DEEP_SIZE // FRAGM)
    rng = np.random.default_rng(72)
    rounds, b = 3, FRAGM
    audio = (0.1 * rng.standard_normal((rounds * DEEP_T * b, CIN))).astype(np.float32)
    reset_counts()
    state, outs, steps = init_state(bank, device=dev), [], []
    for r in range(rounds):
        chunk = audio[r * DEEP_T * b:(r + 1) * DEEP_T * b]
        x = np.ascontiguousarray(chunk.reshape(DEEP_T, b, CIN).transpose(0, 2, 1))
        t0 = time.perf_counter()
        state, y = chunk_step(bank, state, x)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        outs.append(y.cpu().numpy())
    c = counts()
    y = np.concatenate(outs).transpose(0, 2, 1).reshape(-1, COUT)
    assert np.all(np.isfinite(y)) and y.shape == audio.shape
    worst = snr_db(oracle(ir, audio), y)
    audio_s = DEEP_T * b / RATE
    log(f"  launches {c}; step ms {[round(1e3 * v, 3) for v in steps]} for one "
        f"stream x {DEEP_T} blocks = {audio_s:.2f} s of audio: realtime factor "
        f"{[round(audio_s / v, 1) for v in steps]}; SNR vs float64 oracle "
        f"{worst:.2f} dB (limit {SNR_LIMIT_DB})")
    no_plain_mac("deep")
    assert c["fdl_mac"] > 0, "window MAC never launched"
    assert worst <= SNR_LIMIT_DB, f"deep SNR {worst:.2f} dB"
    return dict(launches=c["fdl_mac"], snr_db=worst)


def phase_sharded(dev, tmp: str) -> dict:
    log(f"phase sharded: the flagship through DeviceScheduler on {FREQ} freq "
        "shards of the card")
    from folve_tpu_torch.engine.stream import (
        batched_chunk_step,
        init_state,
        stack_states,
    )
    from folve_tpu_torch.parallel import make_serving_mesh

    mesh = make_serving_mesh(devices=[dev] * FREQ, freq_parallel=FREQ)
    cfg = make_config(tmp, "sharded", 81)
    rounds = 4
    reset_counts()
    sched, worst, ys, audio, banks = serve(dev, [cfg], rounds=rounds, mesh=mesh)
    c = counts()
    log(f"  launches {c}; worst SNR vs float64 oracle {worst:.2f} dB (limit {SNR_LIMIT_DB})")
    report_serving("sharded", sched)
    no_plain_mac("sharded")
    for name in ("fft_real_half_rows", "ifft_partial_rows"):
        assert c[name] > 0, f"{name} never launched"
    assert sched.sharded_fast_steps > 0, "on-mesh state gather never ran"
    assert worst <= SNR_LIMIT_DB, f"sharded serving SNR {worst:.2f} dB"
    # The same inputs through the single-device split route.
    b = FRAGM
    states = stack_states([init_state(banks[0], device=dev)] * S)
    split = []
    for r in range(rounds):
        x = np.ascontiguousarray(audio[:, r * T * b:(r + 1) * T * b].reshape(
            S, T, b, CIN).transpose(0, 1, 3, 2))
        states, y = batched_chunk_step(banks[0], states, x, [T * b] * S)
        split.append(y.cpu().numpy())
    split = np.concatenate(split, axis=1)  # [S, rounds*T, Cout, B]
    got = np.stack(ys)
    rel = float(np.max(np.abs(got - split)) / np.max(np.abs(split)))
    log(f"  max|sharded - split route| / max|split| = {rel:.3e} (limit {KERNEL_TOL:g})")
    assert rel <= KERNEL_TOL, "sharded output disagrees with the split route"
    return dict(launches=c, snr_db=worst, rel_vs_split=rel)


# ---------------------------------------------------------------------------
# The multihost phase: the SlotServer over (host, stream, freq).

def mh_schedule(fragm: int, reference: bool = False) -> list:
    """The multihost phase's script, one entry per tick: ``({row: (stream,
    block)}, {row: n_valid}, [rows reset after the tick])``.  Slot 7
    joins at tick 1, slot 2 pauses at tick 3, slot 5 is reset after tick
    3 and then carries stream 8, and slot 0's last tick is partial.
    ``reference``: the server the pause and the reset are held against,
    where slot 2 never pauses and slot 5 carries stream 8 from the start."""
    fed, out = {}, []
    for tick in range(MH_TICKS):
        feed, nv = {}, {}
        for row in range(MH_HOSTS * MH_S_LOCAL):
            if (row == 7 and tick < 1) or (row == 2 and tick == 3 and not reference):
                continue
            stream = MH_NEW_STREAM if row == 5 and (reference or tick > 3) else row
            feed[row] = (stream, fed.get(stream, 0))
            fed[stream] = feed[row][1] + 1
            if row == 0 and tick == MH_TICKS - 1:
                nv[row] = T * fragm - MH_PARTIAL
        out.append((feed, nv, [5] if tick == 3 and not reference else []))
    return out


def mh_audio(stream: int, fragm: int) -> np.ndarray:
    """Stream ``stream``'s seeded audio [MH_TICKS*T*fragm, Cin]; stream 0
    ends MH_PARTIAL frames before its last block does."""
    rng = np.random.default_rng(900 + stream)
    audio = (0.1 * rng.standard_normal((MH_TICKS * T * fragm, CIN))).astype(np.float32)
    if stream == 0:
        audio[-MH_PARTIAL:] = 0
    return audio


def mh_block(audio: np.ndarray, block: int, fragm: int) -> np.ndarray:
    chunk = audio[block * T * fragm:(block + 1) * T * fragm]
    return np.ascontiguousarray(chunk.reshape(T, fragm, CIN).transpose(0, 2, 1))


def mh_run(srv, schedule: list, rows, audio: dict) -> tuple:
    """Drive ``srv`` through ``schedule`` for ``rows``; returns ({(row,
    tick): y}, each tick's seconds from the call to the device's
    synchronize, each tick's active slots)."""
    outs, secs, active = {}, [], []
    fragm, dev = srv.bank.fragm, srv.bank.device
    for tick, (feed, nv, resets) in enumerate(schedule):
        x = {row: mh_block(audio[s], j, fragm) for row, (s, j) in feed.items() if row in rows}
        t0 = time.perf_counter()
        y = srv.tick(x, n_valid={r: v for r, v in nv.items() if r in rows})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        active.append(len(x))
        for row in resets:
            srv.reset_slot(row)
        outs.update({(row, tick): v for row, v in y.items()})
    return outs, secs, active


def mh_timing(secs: list, active: list, fragm: int) -> dict:
    """Median tick and realtime factor (active slots x T x fragm / rate
    over the tick's seconds, median over ticks)."""
    rt = [a * T * fragm / RATE / s for a, s in zip(active, secs)]
    return dict(tick_ms=[1e3 * s for s in secs], median_tick_ms=1e3 * float(np.median(secs)),
                realtime=float(np.median(rt)))


def slot_worker(rank: int, port: int, cfg: str, out_path: str, device: str) -> None:
    """One host of the multihost phase's two-process run (started in a
    fresh process by :func:`phase_multihost`): a ``gloo`` group on
    127.0.0.1, the host's own stream 1 x freq 2 row on ``device``, its
    own slots fed the phase's script.  Writes its outputs to ``out_path`` and
    prints its figures as a ``MH_WORKER`` JSON line."""
    import datetime

    from torch import distributed as dist

    from folve_tpu_torch.filters.compiler import compile_config_file
    from folve_tpu_torch.parallel import multihost as mh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=MH_HOSTS, rank=rank,
                            timeout=datetime.timedelta(seconds=MH_TIMEOUT))
    try:
        dev = torch.device(device)
        bank = compile_config_file(cfg, fsamp=RATE, device=dev).bank
        mesh = mh.make_multihost_serving_mesh(freq_parallel=MH_FREQ, devices=[dev] * MH_FREQ)
        assert mesh.shape == {"host": MH_HOSTS, "stream": 1, "freq": MH_FREQ}, mesh.shape
        assert mesh.local_hosts == (rank,), mesh.local_hosts
        srv = mh.SlotServer(mesh, bank, s_local=MH_S_LOCAL, t=T)
        assert srv.host_index == rank
        lo = mh.host_rows(mesh, rank, MH_S_LOCAL)
        rows = range(lo.start, lo.stop)
        audio = {s: mh_audio(s, bank.fragm) for s in range(MH_HOSTS * MH_S_LOCAL + 1)}
        # Count every torch.distributed call the ticks and resets make.
        calls = []
        real = {n: getattr(dist, n) for n in dir(dist) if not n.startswith("_")
                and callable(getattr(dist, n)) and not isinstance(getattr(dist, n), type)}

        def counted(name):
            def call(*a, **k):
                calls.append(name)
                return real[name](*a, **k)
            return call

        reset_counts()
        for name in real:
            setattr(dist, name, counted(name))
        try:
            outs, secs, active = mh_run(srv, mh_schedule(bank.fragm), rows, audio)
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        c = counts()
        other = lo.stop % (MH_HOSTS * MH_S_LOCAL)
        try:
            srv.tick({other: mh_block(audio[other], 0, bank.fragm)})
        except ValueError as e:
            foreign = str(e)
        else:
            raise AssertionError(f"host {rank} accepted row {other} of another host")
        np.savez(out_path, **{f"r{row}_t{tick}": y for (row, tick), y in outs.items()})
        print("MH_WORKER " + json.dumps(dict(
            rank=rank, **mh_timing(secs, active, bank.fragm), launches=c, dist_calls_in_tick=calls,
            plain_mac_cuda_calls=fdl_mac_plain.cuda_calls, foreign_row_error=foreign)),
            flush=True)
    finally:
        dist.destroy_process_group()


def mh_workers(tmp: str, cfg: str, dev) -> tuple:
    """The two-process run: two fresh processes on ``dev``, one host
    each.  Returns (their figures, their outputs {(row, tick): y})."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(tmp, f"mh_worker{r}.npz") for r in range(MH_HOSTS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke, sys; chip_smoke.slot_worker("
         "int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])",
         str(r), str(port), cfg, outs[r], str(dev)],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MH_HOSTS)]
    figures, got = [], {}
    try:
        for r, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=MH_TIMEOUT)
            assert proc.returncode == 0, f"multihost worker {r} failed:\n{text[-4000:]}"
            line = [ln for ln in text.splitlines() if ln.startswith("MH_WORKER ")]
            assert line, f"multihost worker {r} printed no figures:\n{text[-4000:]}"
            figures.append(json.loads(line[-1][len("MH_WORKER "):]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for path in outs:
        with np.load(path) as z:
            for k in z.files:
                row, tick = k[1:].split("_t")
                got[int(row), int(tick)] = z[k]
    return figures, got


def mh_check_launches(where: str, c: dict, per_tick: int) -> None:
    """Kernels 6, 3 and 7 launched ``per_tick`` times a tick (one per host
    row and freq shard), and no other kernel."""
    for name in KERNELS:
        want = per_tick * MH_TICKS if name in MH_KERNELS else 0
        assert c[name] == want, f"{where}: {name} launched {c[name]} times, not {want}"


def mh_shape_checks(dev) -> list:
    """Kernels 6, 3 and 7 against their plain versions at the shapes one
    host row of the multihost phase gives them: 4 slots, T 8, each of 2
    k1 windows, the shared bank at one shard's bins."""
    rng = np.random.default_rng(95)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    plan = get_plan(N)
    kn, cols = plan.m1 // MH_FREQ, plan.m2 // 2 + 1
    x = cu(rng.standard_normal((MH_S_LOCAL, T, CIN, FRAGM)))
    yr = cu(rng.standard_normal((MH_S_LOCAL, T, COUT, kn * cols)))
    yi = cu(rng.standard_normal((MH_S_LOCAL, T, COUT, kn * cols)))
    errs = []
    for f in range(MH_FREQ):
        ks = f * kn
        errs.append(check_kernel(f"fft_real_half_rows(multihost window {f})",
                                 fft_real_half_rows(x, N, ks, kn),
                                 fft_real_half_rows_plain(x, N, ks, kn)))
        errs.append(check_kernel(f"ifft_partial_rows(multihost window {f})",
                                 ifft_partial_rows(yr, yi, N, ks, kn),
                                 ifft_partial_rows_plain(yr, yi, N, ks, kn)))
    errs.append(mac_case(cu, rng, "split", MH_S_LOCAL, P, T, shared=True,
                         k=K // MH_FREQ, timed=False)["max_abs_err"])
    return errs


def phase_multihost(dev, tmp: str) -> dict:
    log(f"phase multihost: SlotServer, {MH_HOSTS} hosts x {MH_S_LOCAL} slots x "
        f"{MH_FREQ} freq shards on the card, T = {T}, {MH_TICKS} ticks; then "
        f"{MH_HOSTS} processes over gloo")
    from folve_tpu_torch.filters.compiler import compile_config_file
    from folve_tpu_torch.parallel import multihost as mh

    cfg, ir = make_config(tmp, "multihost", 91)
    bank = compile_config_file(cfg, fsamp=RATE, device=dev).bank
    fragm = bank.fragm
    mesh = mh.make_multihost_serving_mesh(n_hosts=MH_HOSTS, freq_parallel=MH_FREQ,
                                          devices=[dev] * (MH_HOSTS * MH_FREQ))
    assert mesh.shape == {"host": MH_HOSTS, "stream": 1, "freq": MH_FREQ}, mesh.shape
    rows = range(MH_HOSTS * MH_S_LOCAL)
    audio = {s: mh_audio(s, fragm) for s in range(MH_HOSTS * MH_S_LOCAL + 1)}
    srv = mh.SlotServer(mesh, bank, s_local=MH_S_LOCAL, t=T)
    schedule = mh_schedule(fragm)
    reset_counts()
    outs, secs, active = mh_run(srv, schedule, rows, audio)
    c = counts()
    single = mh_timing(secs, active, fragm)
    log(f"  launches {c}; tick ms {[round(v, 3) for v in single['tick_ms']]}, median "
        f"{single['median_tick_ms']:.3f}, realtime factor {single['realtime']:.1f}")
    no_plain_mac("multihost")
    mh_check_launches("multihost", c, MH_HOSTS * MH_FREQ)
    # Each stream's audio, in the order it was fed, against the oracle.
    by_stream: dict = {}
    for tick, (feed, _, _) in enumerate(schedule):
        for row, key in feed.items():
            by_stream[key] = outs[row, tick]
    snr = {}
    for s in sorted({s for s, _ in by_stream}):
        n_blocks = max(j for t_, j in by_stream if t_ == s) + 1
        y = np.concatenate([by_stream[s, j] for j in range(n_blocks)])
        y = y.transpose(0, 2, 1).reshape(-1, COUT)
        n = n_blocks * T * fragm - (MH_PARTIAL if s == 0 else 0)
        assert np.all(np.isfinite(y)) and y.shape == (n_blocks * T * fragm, COUT)
        snr[s] = snr_db(oracle(ir, audio[s][:n]), y[:n])
    log(f"  SNR vs float64 oracle by stream {{{', '.join(f'{s}: {v:.2f}' for s, v in snr.items())}}} "
        f"dB (limit {SNR_LIMIT_DB})")
    assert max(snr.values()) <= SNR_LIMIT_DB, f"multihost SNR {max(snr.values()):.2f} dB"
    # The pause and the reset against a server that never paused slot 2
    # and gave stream 8 a fresh slot 5: every (stream, block) both
    # servers computed is equal bit for bit.
    ref_srv = mh.SlotServer(mesh, bank, s_local=MH_S_LOCAL, t=T)
    ref_schedule = mh_schedule(fragm, reference=True)
    ref_outs, _, _ = mh_run(ref_srv, ref_schedule, rows, audio)
    ref_by_stream = {key: ref_outs[row, tick] for tick, (feed, _, _) in enumerate(ref_schedule)
                     for row, key in feed.items()}
    common = sorted(set(by_stream) & set(ref_by_stream))
    differ = [k for k in common if not np.array_equal(by_stream[k], ref_by_stream[k])]
    paused = [k for k in common if k[0] == 2]
    reset = [k for k in common if k[0] == MH_NEW_STREAM]
    log(f"  bit-equal to the reference server: {len(common) - len(differ)} of {len(common)} "
        f"(stream, block) outputs, the paused slot's {len(paused)} and the reset slot's "
        f"{len(reset)} among them")
    assert len(paused) == MH_TICKS - 1 and len(reset) == 2, (paused, reset)
    assert not differ, f"outputs differ from the reference server: {differ}"
    # Device time of a tick with every slot fed, by kernel (PyTorch's
    # copies and selects included), from torch.profiler on the reference
    # server; the idle share sets it against the median tick above.
    full = {row: mh_block(audio[row], 0, fragm) for row in rows}
    by_kernel = kernel_device_ms(lambda: ref_srv.tick(full), iters=5)
    device_ms = sum(by_kernel.values())
    idle = 1.0 - device_ms / single["median_tick_ms"]
    log(f"  device ms per tick {device_ms:.4f} "
        f"({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}); idle share "
        f"{100 * idle:.2f}% of the median tick")
    shape_errs = mh_shape_checks(dev)
    # Two processes, one host each.
    before = build_listing()
    t0 = time.perf_counter()
    workers, got = mh_workers(tmp, cfg, dev)
    wall = time.perf_counter() - t0
    assert build_listing() == before, "a multihost worker rebuilt the kernels"
    assert sorted(got) == sorted(outs), (sorted(got), sorted(outs))
    diff = max(float(np.max(np.abs(got[k] - outs[k]))) for k in outs)
    for w in workers:
        log(f"  worker {w['rank']}: launches {w['launches']}; tick ms "
            f"{[round(v, 3) for v in w['tick_ms']]}, median {w['median_tick_ms']:.3f}, "
            f"realtime factor {w['realtime']:.1f}; torch.distributed calls in its ticks "
            f"{w['dist_calls_in_tick']}; another host's row: {w['foreign_row_error']!r}")
        assert not w["dist_calls_in_tick"], "a tick called torch.distributed"
        assert w["plain_mac_cuda_calls"] == 0, "a worker ran the plain MAC on CUDA"
        mh_check_launches(f"multihost worker {w['rank']}", w["launches"], MH_FREQ)
    log(f"  two processes ({wall:.1f} s): max|two-process - one-process| = {diff:.3e} "
        f"(limit {MH_PROC_TOL:g})")
    assert diff <= MH_PROC_TOL, "the two-process run disagrees with the single process"
    return dict(
        config=dict(hosts=MH_HOSTS, s_local=MH_S_LOCAL, freq=MH_FREQ, T=T, ticks=MH_TICKS,
                    taps=SIZE, fragm=fragm, partitions=bank.partitions),
        single=single, workers=workers, workers_wall_s=wall,
        device_ms_per_tick=device_ms, device_ms_by_kernel=by_kernel, idle_share=idle,
        launches={name: c[name] for name in MH_KERNELS},
        snr_db={str(s): v for s, v in snr.items()}, worst_snr_db=max(snr.values()),
        bit_equal_outputs=len(common), paused_bit_equal=len(paused),
        reset_bit_equal=len(reset), max_diff_two_process=diff,
        max_abs_err_at_phase_shapes=max(shape_errs))


class FsOracle:
    """float64 linear convolution of a track with one filter's IR through
    scipy.fft (the IR's spectra cached per transform length), truncated
    to the track: x [n, Cin] -> [n, Cout]."""

    def __init__(self, ir: np.ndarray):
        self.ir, self.spectra = ir.astype(np.float64), {}

    def __call__(self, x: np.ndarray) -> np.ndarray:
        from scipy import fft as sfft

        n = x.shape[0]
        nfft = sfft.next_fast_len(n + self.ir.shape[-1] - 1, real=True)
        h = self.spectra.get(nfft)
        if h is None:
            h = self.spectra[nfft] = sfft.rfft(self.ir, nfft, axis=-1, workers=-1)
        xs = sfft.rfft(x.T.astype(np.float64), nfft, axis=-1, workers=-1)
        y = np.einsum("if,iof->of", xs, h)
        return sfft.irfft(y, nfft, axis=-1, workers=-1)[:, :n].T


def fs_read(fs, path: str) -> dict:
    """Read ``path`` as a player does: open, stat, 64 KiB reads from the
    start until EOF, close.  ``first_s``: open plus the reads that bring
    the first FS_FIRST_BYTES of the served file."""
    t0 = time.perf_counter()
    h = fs.get_or_create_handler(path)
    try:
        h.stat()  # a player stats before it reads
        out, first_s = bytearray(), None
        while True:
            data = h.read(65536, len(out))
            if not data:
                break
            out += data
            if first_s is None and len(out) >= FS_FIRST_BYTES:
                first_s = time.perf_counter() - t0
        return dict(handler=h, blob=bytes(out), first_s=first_s,
                    status=h.get_handler_status(), t0=t0, t1=time.perf_counter())
    finally:
        fs.close_handler(path, h)


def fs_read_all(fs, paths: list) -> tuple[dict, float]:
    """Every path read from its own thread at once; returns ({path: result
    of fs_read}, wall seconds from the first open to the last EOF).  An
    exception in any reader is raised here."""
    results, errors = {}, []

    def reader(path):
        try:
            results[path] = fs_read(fs, path)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(p,)) for p in paths]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "a reader never finished"
    wall = max(r["t1"] for r in results.values()) - min(r["t0"] for r in results.values())
    return results, wall


def fs_check(name: str, res: dict, x: np.ndarray, bits: int, ref: np.ndarray) -> float:
    """A convolving handler served ``res``; :func:`pcm_check` of its bytes."""
    from folve_tpu_torch.runtime import ConvolveFileHandler

    assert isinstance(res["handler"], ConvolveFileHandler), f"{name}: not convolved"
    return pcm_check(name, res["blob"], x, bits, ref)


def pcm_check(name: str, blob: bytes, x: np.ndarray, bits: int, ref: np.ndarray) -> float:
    """The FLAC bytes ``blob`` decode to the source's frames, rate and
    bits, and hold to the float64 oracle: 16-bit within 1 LSB of the
    oracle quantized on the host, 24-bit at SNR_LIMIT_DB or better.
    Returns the 16-bit LSB error or the 24-bit SNR in dB."""
    from folve_tpu_torch.audio.flac import read_flac

    y, info = read_flac(blob)
    assert (info.frames, info.rate, info.channels, info.bits_per_sample) == (
        x.shape[0], RATE, COUT, bits), f"{name}: served {info}"
    assert np.all(np.isfinite(y))
    if bits == 16:
        want = np.clip(np.round(ref * 32768.0), -32768, 32767)
        err = float(np.max(np.abs(np.round(y.astype(np.float64) * 32768.0) - want)))
        assert err <= 1, f"{name}: 16-bit PCM off the oracle by {err} LSB"
        return err
    snr = snr_db(ref, y)
    assert snr <= SNR_LIMIT_DB, f"{name}: 24-bit SNR {snr:.2f} dB"
    return snr


def fs_step_report(step: str, fs, results: dict, wall: float, c: dict, smi: str) -> dict:
    sched = fs.device_scheduler
    frames = sum(r["handler"]._in_info.frames for r in results.values())
    audio_s = frames / RATE
    steps_ms = [1e3 * v for v in sched.latency._recent]
    out = dict(tracks=len(results), audio_s=audio_s, wall_s=wall,
               served_realtime=audio_s / wall,
               first_read_s=sorted(r["first_s"] for r in results.values()),
               scheduler=dict(steps=sched.steps, fused_steps=sched.fused_steps,
                              fused_fast_steps=sched.fused_fast_steps,
                              batched_jobs=sched.batched_jobs,
                              step_ms_median=float(np.median(steps_ms)) if steps_ms else None,
                              step_ms_max=max(steps_ms, default=None)),
               fused_route_launches=c["conv_step_fused"],
               split_route_launches=c["fdl_mac_split"], launches=c, card=smi,
               # Host seconds summed over the readers (threads overlap):
               # the pump's dispatch and wait, device->host fetch, encode.
               pump_s={k: sum(getattr(r["status"], f"pump_{k}_s") for r in results.values())
                       for k in ("dispatch", "fetch", "encode")},
               reader_s=sum(r["t1"] - r["t0"] for r in results.values()))
    log(f"  {step}: {len(results)} tracks, {audio_s:.1f} s of audio in {wall:.3f} s: "
        f"served realtime factor {out['served_realtime']:.1f}; scheduler "
        f"{out['scheduler']}; first-read s {[round(v, 3) for v in out['first_read_s']]}; "
        f"reader s {out['reader_s']:.3f} of which pump s {out['pump_s']}; "
        f"launches {c} ({smi})")
    no_plain_mac(f"filesystem {step}")
    return out


def fs_tracks(src: str, seed: int, names: list, frames: list, bits: list,
              sub: str = "") -> dict:
    """Seeded stereo FLAC tracks written with the port's encoder; returns
    {name: samples as decoded, float32 [frames, 2]}.  Gaussian at
    FS_LEVEL of full scale, on the track's PCM grid."""
    from folve_tpu_torch.audio.flac import write_flac

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(src, sub), exist_ok=True)
    out = {}
    for name, n, b in zip(names, frames, bits):
        scale = float(1 << (b - 1))
        x = np.clip(FS_LEVEL * rng.standard_normal((n, CIN)), -0.99, 0.99)
        x = (np.round(x * scale) / scale).astype(np.float32)
        write_flac(os.path.join(src, sub, name), x, RATE, bits=b)
        out[name] = x
    return out


def phase_filesystem(dev, smi: str) -> dict:
    log(f"phase filesystem: FolveFilesystem serving {FS_TRACKS} FLAC tracks of "
        f"{FS_SECONDS} s (16 and 24 bits) through the {SIZE}-tap filter: shared, "
        "mixed, gapless, warm")
    from folve_tpu_torch.filters import compiler
    from folve_tpu_torch.runtime import ConvolveFileHandler, FolveFilesystem

    tmp = tempfile.mkdtemp(prefix="folve_chip_smoke_fs_")
    old_cache = os.environ.get("FOLVE_SPECTRA_CACHE")
    os.environ["FOLVE_SPECTRA_CACHE"] = os.path.join(tmp, "spectra")  # cold
    filters, src = os.path.join(tmp, "filters"), os.path.join(tmp, "src")
    irs = {}
    for name, seed in (("A", 91), ("B", 92)):
        os.makedirs(os.path.join(filters, name))
        irs[name] = make_config(os.path.join(filters, name), f"filter-{RATE}", seed)[1]
    oracles = {name: FsOracle(ir) for name, ir in irs.items()}
    names = [f"t{i}.flac" for i in range(FS_TRACKS)]
    bits = [16 if i < FS_TRACKS // 2 else 24 for i in range(FS_TRACKS)]
    tracks = fs_tracks(src, 93, names, [FS_SECONDS * RATE] * FS_TRACKS, bits)
    refs = {}

    def ref(filt: str, name: str) -> np.ndarray:
        if (filt, name) not in refs:
            refs[filt, name] = oracles[filt](tracks[name])
            peak = float(np.max(np.abs(refs[filt, name])))
            assert peak < 0.9, f"oracle peak {peak:.3f} of full scale (limit 0.9)"
        return refs[filt, name]

    def new_fs(**kw):
        fs = FolveFilesystem(device=dev)
        fs.underlying_dir, fs.base_config_dir = src, filters
        for k, v in kw.items():
            setattr(fs, k, v)
        assert fs.check_initialized()
        return fs

    out, lsb, snr = {}, {}, {}

    def check(step: str, res: dict, name: str, b: int, filt: str) -> None:
        v = fs_check(f"{step} {name}", res, tracks[name], b, ref(filt, name))
        (lsb if b == 16 else snr)[f"{step} {name}"] = v
    try:
        # 1. shared: one filter, one reader thread per track.
        fs = new_fs(current_config_subdir="A")
        reset_counts()
        res, wall = fs_read_all(fs, [f"/{n}" for n in names])
        c = counts()
        out["shared"] = fs_step_report("shared", fs, res, wall, c, smi)
        out["cold_first_read_s"] = out["shared"]["first_read_s"][0]
        assert c["conv_step_fused"] > 0, "shared: fused kernel never launched"
        for n, b in zip(names, bits):
            check("shared", res[f"/{n}"], n, b, "A")
        cold_spec = [cf.bank.h_spec for cf in fs.processor_pool._bank_cache.values()]
        assert len(cold_spec) == 1, "shared: the filter was compiled more than once"
        fs.device_scheduler.stop()

        # 2. mixed: two filters of one shape, toplevel-dir mode.
        fs = new_fs(toplevel_dir_is_filter=True)
        paths = [f"/{'A' if i < FS_TRACKS // 2 else 'B'}/{n}" for i, n in enumerate(names)]
        reset_counts()
        res, wall = fs_read_all(fs, paths)
        c = counts()
        out["mixed"] = fs_step_report("mixed", fs, res, wall, c, smi)
        for k in ("fft_real_half", "fdl_mac_split", "ifft_ola"):
            assert c[k] > 0, f"mixed: {k} never launched"
        for p, n, b in zip(paths, names, bits):
            check("mixed", res[p], n, b, p[1])
        fs.device_scheduler.stop()

        # 3. gapless: an album of three tracks read in order.
        album = [f"a{i}.flac" for i in range(1, 4)]
        lens = [FS_ALBUM_SECONDS * RATE + 1000 * i + 77 for i in range(3)]
        assert all(n % FRAGM for n in lens)
        atracks = fs_tracks(src, 94, album, lens, [16] * 3, sub="album")
        fs = new_fs(current_config_subdir="A", gapless_processing=True)
        reset_counts()
        t0, res = time.perf_counter(), {}
        for n in album:
            res[f"/album/{n}"] = fs_read(fs, f"/album/{n}")
        wall = time.perf_counter() - t0
        c = counts()
        out["gapless"] = fs_step_report("gapless", fs, res, wall, c, smi)
        gap = [res[f"/album/{n}"]["status"].out_gapless for n in album]
        log(f"  gapless: out_gapless per track {gap}")
        assert gap[:2] == [True, True], "gapless: no handover on tracks 1 and 2"
        from folve_tpu_torch.audio.flac import read_flac

        ys = []
        for n, k in zip(album, lens):
            assert isinstance(res[f"/album/{n}"]["handler"], ConvolveFileHandler), n
            y, info = read_flac(res[f"/album/{n}"]["blob"])
            assert (info.frames, info.rate, info.channels, info.bits_per_sample) == (
                k, RATE, COUT, 16), f"gapless {n}: served {info}"
            ys.append(y)
        x_all = np.concatenate([atracks[n] for n in album])
        want = np.clip(np.round(oracles["A"](x_all) * 32768.0), -32768, 32767)
        got = np.round(np.concatenate(ys).astype(np.float64) * 32768.0)
        lsb["gapless album"] = float(np.max(np.abs(got - want)))
        log(f"  gapless: album of {x_all.shape[0]} frames, max |PCM - oracle of the "
            f"joined input| = {lsb['gapless album']:.0f} LSB")
        assert lsb["gapless album"] <= 1, "gapless: the join is off the oracle"
        fs.device_scheduler.stop()

        # 4. warm: a new filesystem over the same spectra cache.
        fs = new_fs(current_config_subdir="A")
        compile_spec = compiler.compile_spec

        def no_compile(*a, **k):
            raise AssertionError("warm: the filter was compiled, not loaded")

        compiler.compile_spec = no_compile
        try:
            reset_counts()
            t0 = time.perf_counter()
            res = {f"/{names[0]}": fs_read(fs, f"/{names[0]}")}
            wall = time.perf_counter() - t0
        finally:
            compiler.compile_spec = compile_spec
        c = counts()
        out["warm"] = fs_step_report("warm", fs, res, wall, c, smi)
        out["warm_first_read_s"] = out["warm"]["first_read_s"][0]
        check("warm", res[f"/{names[0]}"], names[0], bits[0], "A")
        warm_spec = [cf.bank.h_spec for cf in fs.processor_pool._bank_cache.values()]
        assert len(warm_spec) == 1 and torch.equal(warm_spec[0], cold_spec[0]), (
            "warm: cached spectra differ from the cold compile's")
        fs.device_scheduler.stop()
    finally:
        if old_cache is None:
            os.environ.pop("FOLVE_SPECTRA_CACHE", None)
        else:
            os.environ["FOLVE_SPECTRA_CACHE"] = old_cache
        shutil.rmtree(tmp, ignore_errors=True)
    worst_lsb, worst_snr = max(lsb.values()), max(snr.values())
    log(f"  filesystem: worst 16-bit error {worst_lsb:.0f} LSB (limit 1), worst 24-bit "
        f"SNR {worst_snr:.2f} dB (limit {SNR_LIMIT_DB}); cold first read "
        f"{out['cold_first_read_s']:.3f} s, warm first read {out['warm_first_read_s']:.3f} s "
        f"({smi})")
    launches = {k: sum(out[s]["launches"][k] for s in ("shared", "mixed", "gapless", "warm"))
                for k in KERNELS}
    out.update(worst_lsb=worst_lsb, worst_snr_db=worst_snr, launches=launches)
    return out


# ---------------------------------------------------------------------------
# The cli phase: the entry points a user runs, each in a fresh process.

def cli_env(spectra: str) -> dict:
    return dict(os.environ, FOLVE_PLATFORM=CLI_PLATFORM, FOLVE_SPECTRA_CACHE=spectra)


def cli_command(counts_path: str, *argv: str) -> list:
    """``python -m folve_tpu_torch *argv`` (run by runpy, as ``-m``
    runs it), writing the kernels' launch counts at exit to
    ``counts_path``."""
    modules = {name: k["fn"].__module__ for name, k in KERNELS.items()}
    return [sys.executable, "-c", _RUN_CLI, counts_path, json.dumps(modules), *argv]


def cli_counts(path: str, where: str) -> dict:
    with open(path) as f:
        c = json.load(f)
    assert c.pop("fdl_mac_plain_cuda_calls") == 0, f"{where}: the plain MAC ran on CUDA"
    return c


def expect_launches(where: str, c: dict, names) -> None:
    for name in names:
        assert c[name] > 0, f"{where}: {name} never launched ({c})"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str, headers=None, timeout: float = 600) -> tuple:
    """(status, headers, body) of one GET, the body read in 64 KiB
    pieces as a player reads a stream."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        body = bytearray()
        while True:
            piece = resp.read(65536)
            if not piece:
                break
            body += piece
        return resp.status, dict(resp.getheaders()), bytes(body)
    finally:
        conn.close()


def fail_with(proc_err: str, msg: str) -> None:
    with open(proc_err) as f:
        tail = f.read()[-4000:]
    raise AssertionError(f"{msg}\n--- stderr of the process ---\n{tail}")


def build_listing() -> dict:
    d = _build.BUILD_DIR
    return {p.name: p.stat().st_mtime for p in d.glob("*.so")} if d.exists() else {}


class FuseWire:
    """The kernel's side of a FUSE session over a SOCK_SEQPACKET
    socketpair: hand-packed requests of the linux/fuse.h ABI 7.x
    (INIT, LOOKUP, OPEN, READ, RELEASE, DESTROY)."""

    IN = struct.Struct("<IIQQIIII")   # len opcode unique nodeid uid gid pid pad
    OUT = struct.Struct("<IiQ")       # len error unique

    def __init__(self, session):
        import socket

        self.sock, self._theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        session.set_fd(self._theirs.fileno())
        self.unique = 0
        self.thread = threading.Thread(target=session.loop, kwargs=dict(num_threads=1),
                                       daemon=True)
        self.thread.start()
        err, _ = self.request(26, 0, struct.pack("<IIII", 7, 38, 65536, 0) + bytes(48))
        assert err == 0, f"FUSE_INIT: {err}"

    def request(self, opcode: int, nodeid: int, payload: bytes = b"") -> tuple:
        self.unique += 1
        self.sock.send(self.IN.pack(self.IN.size + len(payload), opcode, self.unique,
                                    nodeid, 0, 0, 0, 0) + payload)
        reply = self.sock.recv(1 << 21)
        length, error, unique = self.OUT.unpack_from(reply)
        assert unique == self.unique
        return error, reply[self.OUT.size:length]

    def read_file(self, name: str, chunk: int = 65536) -> bytes:
        err, body = self.request(1, 1, name.encode() + b"\0")  # LOOKUP under the root
        assert err == 0, f"FUSE_LOOKUP {name}: {err}"
        nodeid = struct.unpack_from("<Q", body)[0]
        err, body = self.request(14, nodeid, struct.pack("<II", os.O_RDONLY, 0))
        assert err == 0, f"FUSE_OPEN {name}: {err}"
        fh = struct.unpack_from("<Q", body)[0]
        out = bytearray()
        while True:
            err, body = self.request(15, nodeid, struct.pack("<QQIIQII", fh, len(out),
                                                             chunk, 0, 0, 0, 0))
            assert err == 0, f"FUSE_READ {name} at {len(out)}: {err}"
            if not body:
                break
            out += body
        self.request(18, nodeid, struct.pack("<QIIQ", fh, 0, 0, 0))
        return bytes(out)

    def close(self) -> None:
        try:
            self.request(38, 0)  # FUSE_DESTROY: the loop exits
        except OSError:
            pass
        self.thread.join(timeout=10)
        self.sock.close()
        self._theirs.close()


def cli_convolve(tmp: str, cfg: str, track: str, x: np.ndarray, ref: np.ndarray,
                 env: dict, smi: str) -> dict:
    out, counts_path = os.path.join(tmp, "out.flac"), os.path.join(tmp, "convolve.json")
    t0 = time.perf_counter()
    res = subprocess.run(cli_command(counts_path, "convolve", "-C", cfg, "-i", "A", track, out),
                         cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert res.returncode == 0, f"convolve exited {res.returncode}:\n{res.stderr[-4000:]}"
    m = re.search(r"convolved ([\d.]+)s of audio in ([\d.]+)s \(([\d.]+)x realtime\)",
                  res.stdout)
    assert m, f"convolve printed {res.stdout!r}"
    with open(out, "rb") as f:
        lsb = pcm_check("cli convolve", f.read(), x, 16, ref)
    c = cli_counts(counts_path, "cli convolve")
    expect_launches("cli convolve", c, ("fft_real_half", "fdl_mac_split", "ifft_ola"))
    out_d = dict(audio_s=x.shape[0] / RATE, process_wall_s=wall,
                 printed_convolve_s=float(m.group(2)), realtime=float(m.group(3)),
                 lsb=lsb, launches=c, card=smi)
    log(f"  convolve: {out_d['audio_s']:.1f} s of audio, the CLI printed "
        f"{m.group(3)}x realtime ({m.group(2)} s), process wall {wall:.2f} s, "
        f"{lsb:.0f} LSB off the oracle; launches {c} ({smi})")
    return out_d


def cli_serve(tmp: str, cfg: str, src: str, names: list, bits: list, tracks: dict,
              ref, env: dict, smi: str) -> dict:
    status_port, files_port = free_port(), free_port()
    counts_path, err = os.path.join(tmp, "serve.json"), os.path.join(tmp, "serve.err")
    cmd = cli_command(counts_path, "serve", "-C", cfg, "-i", "A", "-D", "-p", str(status_port),
                      "--files-port", str(files_port), src)
    out: dict = dict(card=smi)
    with open(err, "w") as errf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.DEVNULL,
                                stderr=errf)
    try:
        # 1. Cold process: spawn to the status page (imports, the CUDA
        # context, the filesystem), then to the first 64 KiB of a track.
        while True:
            if proc.poll() is not None:
                fail_with(err, f"serve exited {proc.returncode} before serving")
            try:
                assert http_get(status_port, "/")[0] == 200
                break
            except ConnectionRefusedError:
                if time.perf_counter() - t0 > 300:
                    fail_with(err, "serve never listened")
                time.sleep(0.02)
        out["cold_status_page_s"] = time.perf_counter() - t0
        while True:
            try:
                code, _, first = http_get(files_port, f"/files/{names[0]}",
                                          {"Range": f"bytes=0-{FS_FIRST_BYTES - 1}"})
                break
            except ConnectionRefusedError:  # the file server binds just after
                assert proc.poll() is None and time.perf_counter() - t0 < 300
                time.sleep(0.01)
        out["cold_first_read_s"] = time.perf_counter() - t0
        assert code == 206 and len(first) == FS_FIRST_BYTES, (code, len(first))

        # 2. /profile: a short first trace starts the profiler (409 while
        # it runs), then the trace of the readers' window.
        def profile(secs: float) -> str:
            code, _, body = http_get(status_port, f"/profile?secs={secs}")
            assert code == 200, (code, body)
            return body.decode().rsplit(" to ", 1)[1].strip()

        def trace_of(log_dir: str) -> dict:
            from folve_tpu_torch.utils.profiling import analyze_device_trace

            deadline = time.perf_counter() + 120
            while not os.path.exists(os.path.join(log_dir, "trace.json")):
                assert proc.poll() is None and time.perf_counter() < deadline, (
                    f"no trace in {log_dir}")
                time.sleep(0.1)
            return analyze_device_trace(log_dir)

        warm_dir = profile(0.5)
        out["profile_second_request_code"] = http_get(status_port, "/profile?secs=0.5")[0]
        assert out["profile_second_request_code"] == 409
        trace_of(warm_dir)  # waits until that trace is written

        # 3. One reader thread per track, each a streaming GET read in
        # 64 KiB pieces, with a 1 s trace over their window.
        results, errors = {}, []

        def reader(name):
            try:
                t = time.perf_counter()
                code, hdrs, blob = http_get(files_port, f"/files/{name}", {"Range": "bytes=0-"})
                assert code == 206, (name, code)
                results[name] = dict(blob=blob, t0=t, t1=time.perf_counter())
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(n,)) for n in names]
        for th in threads:
            th.start()
        trace_dir = profile(1)
        for th in threads:
            th.join(timeout=600)
        if errors:
            raise errors[0]
        assert not any(th.is_alive() for th in threads), "a reader never finished"
        wall = max(r["t1"] for r in results.values()) - min(r["t0"] for r in results.values())
        audio_s = sum(tracks[n].shape[0] for n in names) / RATE
        lsb, snr = {}, {}
        for n, b in zip(names, bits):
            v = pcm_check(f"cli serve {n}", results[n]["blob"], tracks[n], b, ref("A", n))
            (lsb if b == 16 else snr)[n] = v
        trace = trace_of(trace_dir)
        kernel_ms = {k: sum(ms for name, ms in trace.get("ops", []) if part in name)
                     for k, part in CONV_STEP_KERNELS.items()}
        log(f"  serve: /profile trace {trace_dir}: device time "
            f"{trace.get('device_time_ms', 0.0):.3f} ms, kernel 1's kernels {kernel_ms}, "
            f"top ops {[(name[:60], ms) for name, ms in trace.get('ops', [])[:6]]}")
        for k, ms in kernel_ms.items():
            assert ms > 0, f"the /profile trace lists no {k}"

        # 4. The status page: every track, and the device's steps.
        code, _, page = http_get(status_port, "/")
        assert code == 200
        missing = [n for n in names if n.encode() not in page]
        assert not missing, f"status page lacks {missing}"
        m = re.search(rb"<p>Device: (\d+) fused steps for (\d+) block jobs", page)
        assert m and int(m.group(1)) > 0, "status page shows no device steps"
        opened = re.search(rb"<p>(\d+) file openings, (\d+) re-opens", page)

        # 5. 64 KiB Range requests, one reader thread per track, each
        # request an open and a close of the file: the openings they cost.
        def ranges(name):
            try:
                full = results[name]["blob"]
                for lo in range(0, min(CLI_RANGE_REQUESTS * 65536, len(full)), 65536):
                    code, _, blob = http_get(files_port, f"/files/{name}",
                                             {"Range": f"bytes={lo}-{lo + 65535}"})
                    # Past the true end a range holds the stat size's
                    # padding, so the streamed bytes are its prefix.
                    want = full[lo:lo + 65536]
                    assert code == 206 and blob[:len(want)] == want, f"range {lo} of {name}"
            except BaseException as e:
                errors.append(e)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=ranges, args=(n,)) for n in names]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errors:
            raise errors[0]
        range_wall = time.perf_counter() - t1
        page = http_get(status_port, "/")[2]
        after = re.search(rb"<p>(\d+) file openings, (\d+) re-opens", page)
        range_opens = int(after.group(1)) - int(opened.group(1))
        range_reopens = int(after.group(2)) - int(opened.group(2))

        # 6. The filter switch: a track opened afterwards is B's.
        code, hdrs, _ = http_get(status_port, "/settings?f=B")
        assert code == 302
        code, _, blob = http_get(files_port, f"/files/{names[0]}", {"Range": "bytes=0-"})
        assert code == 206
        switch = pcm_check("cli serve after /settings?f=B", blob, tracks[names[0]],
                           bits[0], ref("B", names[0]))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)  # serve_http_files returns on it
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if proc.returncode != 0:
        fail_with(err, f"serve exited {proc.returncode}")
    c = cli_counts(counts_path, "cli serve")
    expect_launches("cli serve", c, ("conv_step_fused",))
    out.update(tracks=len(names), audio_s=audio_s, wall_s=wall,
               served_realtime=audio_s / wall, worst_lsb=max(lsb.values()),
               worst_snr_db=max(snr.values()), device_steps=int(m.group(1)),
               device_jobs=int(m.group(2)),
               profile=dict(device_time_ms=trace.get("device_time_ms"),
                            conv_step_kernels_ms=kernel_ms,
                            top_ops=[(name[:120], ms) for name, ms in trace.get("ops", [])[:8]]),
               range_requests=dict(readers=len(names), per_reader=CLI_RANGE_REQUESTS,
                                   wall_s=range_wall, file_openings=range_opens,
                                   re_opens=range_reopens),
               switch_lsb=switch, launches=c)
    log(f"  serve: cold process: status page at {out['cold_status_page_s']:.3f} s, first "
        f"read at {out['cold_first_read_s']:.3f} s after the spawn; {len(names)} "
        f"HTTP readers, {audio_s:.1f} s of audio in {wall:.3f} s: served realtime "
        f"{out['served_realtime']:.1f}; worst {out['worst_lsb']:.0f} LSB / "
        f"{out['worst_snr_db']:.2f} dB; status page {out['device_steps']} steps; "
        f"{len(names)} x {CLI_RANGE_REQUESTS} Range requests opened the files "
        f"{range_opens} times ({range_reopens} re-opens) in {range_wall:.3f} s; "
        f"after /settings?f=B {switch:.0f} LSB off B's oracle; launches {c} ({smi})")
    return out


def process_gone(pid: int, secs: float) -> bool:
    deadline = time.time() + secs
    while os.path.exists(f"/proc/{pid}"):
        if time.time() > deadline:
            return False
        time.sleep(0.1)
    return True


def mounted(path: str) -> bool:
    with open("/proc/mounts") as f:
        return any(line.split()[1] == path for line in f)


def mount_permitted(mnt: str) -> str | None:
    """None where this process may mount FUSE at ``mnt``, else why not."""
    if not os.path.exists("/dev/fuse"):
        return "no /dev/fuse"
    from folve_tpu_torch.fuse.mount import FuseSession

    session = FuseSession(vfs=None)
    try:
        session.mount(mnt)
    except OSError as e:
        return f"mount refused: {e}"
    else:
        session.unmount()
    finally:
        session.destroy()
    return None


def cli_fuse(tmp: str, cfg: str, src: str, name: str, x: np.ndarray, ref: np.ndarray,
             env: dict, dev, smi: str) -> dict:
    mnt = os.path.join(tmp, "mnt")
    os.makedirs(mnt)
    why_not = mount_permitted(mnt)
    out: dict = dict(route="kernel" if why_not is None else "socketpair",
                     mount_refused=why_not, card=smi)
    if why_not is None:
        counts_path, pid_file = os.path.join(tmp, "mount.json"), os.path.join(tmp, "mount.pid")
        t0 = time.perf_counter()
        res = subprocess.run(cli_command(counts_path, "mount", "-C", cfg, "-i", "A", "-P",
                                         pid_file, src, mnt),
                             cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
        out["mount_s"] = time.perf_counter() - t0
        assert res.returncode == 0, f"daemon mount exited {res.returncode}: {res.stderr}"
        with open(pid_file) as f:
            pid = int(f.read())
        try:
            t0 = time.perf_counter()
            with open(os.path.join(mnt, name), "rb") as f:
                blob = bytearray()
                while piece := f.read(65536):
                    blob += piece
            out["read_s"] = time.perf_counter() - t0
        finally:
            um = subprocess.run(["umount", mnt], capture_output=True, text=True)
            out["daemon_stopped_by"] = "umount"
            if not process_gone(pid, 2) and not mounted(mnt):
                # Where the kernel's FUSE does not end the session's read
                # on an unmount, the daemon is stopped as a foreground
                # mount is, by SIGINT (mount_and_serve).
                out["daemon_stopped_by"] = "SIGINT after umount"
                os.kill(pid, signal.SIGINT)
            if not process_gone(pid, 60):
                os.kill(pid, signal.SIGUSR1)
                time.sleep(2)
                with open(counts_path + ".stacks") as f:
                    stacks = f.read()[-6000:]
                os.kill(pid, signal.SIGKILL)
                subprocess.run(["umount", "-l", mnt], check=False, capture_output=True)
                raise AssertionError(
                    f"the mount daemon outlived its unmount (umount exited "
                    f"{um.returncode}: {um.stderr.strip()!r}; still mounted: {mounted(mnt)}; "
                    f"counts written: {os.path.exists(counts_path)}); its threads:\n{stacks}")
            out["umount_rc"] = um.returncode
        c = cli_counts(counts_path, "cli mount")
    else:
        from folve_tpu_torch.fuse.mount import FuseSession
        from folve_tpu_torch.runtime import FolveFilesystem
        from folve_tpu_torch.server.vfs import FolveVfs

        fs = FolveFilesystem(device=dev)
        fs.underlying_dir, fs.base_config_dir = src, cfg
        fs.current_config_subdir = "A"
        assert fs.check_initialized()
        wire = FuseWire(FuseSession(FolveVfs(fs)))
        reset_counts()
        try:
            t0 = time.perf_counter()
            blob = wire.read_file(name)
            out["read_s"] = time.perf_counter() - t0
        finally:
            wire.close()
            fs.device_scheduler.stop()
        c = counts()
        no_plain_mac("cli fuse")
    expect_launches(f"cli fuse ({out['route']})", c, ("conv_step_fused",))
    out.update(lsb=pcm_check(f"cli fuse {name}", bytes(blob), x, 16, ref),
               audio_s=x.shape[0] / RATE, launches=c)
    out["read_realtime"] = out["audio_s"] / out["read_s"]
    log(f"  fuse ({out['route']}{'' if why_not is None else ': ' + why_not}): {name} "
        f"read in {out['read_s']:.3f} s ({out['read_realtime']:.1f}x realtime), "
        f"{out['lsb']:.0f} LSB off the oracle; daemon stopped by "
        f"{out.get('daemon_stopped_by', '-')}; launches {c} ({smi})")
    return out


def phase_cli(dev, smi: str) -> dict:
    log(f"phase cli: python -m folve_tpu_torch convolve ({CLI_LONG_SECONDS} s track), "
        f"serve ({FS_TRACKS} HTTP readers of {FS_SECONDS} s tracks, /profile, "
        "/settings) and mount, each in a fresh process, through the "
        f"{SIZE}-tap filter")
    tmp = tempfile.mkdtemp(prefix="folve_chip_smoke_cli_")
    try:
        cfg, src = os.path.join(tmp, "filters"), os.path.join(tmp, "music")
        oracles = {}
        for name, seed in (("A", 91), ("B", 92)):
            os.makedirs(os.path.join(cfg, name))
            oracles[name] = FsOracle(make_config(os.path.join(cfg, name), f"filter-{RATE}",
                                                 seed)[1])
        names = [f"t{i}.flac" for i in range(FS_TRACKS)]
        bits = [16 if i < FS_TRACKS // 2 else 24 for i in range(FS_TRACKS)]
        tracks = fs_tracks(src, 95, names, [FS_SECONDS * RATE] * FS_TRACKS, bits)
        long_track = fs_tracks(os.path.join(tmp, "in"), 96, ["long.flac"],
                               [CLI_LONG_SECONDS * RATE], [16])["long.flac"]
        refs = {}

        def ref(filt: str, name: str) -> np.ndarray:
            if (filt, name) not in refs:
                refs[filt, name] = oracles[filt](tracks[name])
            return refs[filt, name]

        env = cli_env(os.path.join(tmp, "spectra"))
        built = build_listing()
        out = dict(convolve=cli_convolve(tmp, cfg, os.path.join(tmp, "in", "long.flac"),
                                         long_track, oracles["A"](long_track), env, smi),
                   serve=cli_serve(tmp, cfg, src, names, bits, tracks, ref, env, smi),
                   fuse=cli_fuse(tmp, cfg, src, names[1], tracks[names[1]],
                                 ref("A", names[1]), env, dev, smi))
        assert build_listing() == built, "a CLI process rebuilt the kernels"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_dryrun() -> dict:
    log("phase dryrun: entry.dryrun_multichip(8) on the card")
    from folve_tpu_torch.entry import dryrun_multichip

    reset_counts()
    dryrun_multichip(8)
    c = counts()
    log(f"  launches {c}")
    no_plain_mac("dryrun")
    for name in ("fft_real_half_rows", "ifft_partial_rows"):
        assert c[name] > 0, f"{name} never launched"
    return dict(launches=c)


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a GPU is required",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    log("phase build")
    t0 = time.perf_counter()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"  {nvcc[-1]}")
    _build.build_all()
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:  # the kernel (mangled) that follows
                entry = line.split("'")[1]
                log(f"  {name}: {entry}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    log(f"  built in {_build.build_seconds:.1f} s")
    log(f"  phase build: {time.perf_counter() - t0:.1f} s")

    results: dict = {}
    split = run_phase("kernels", phase_kernels, dev, results)

    # Each kernel's launches come from the serving path it belongs to:
    # the fused kernel from shared-filter serving, the split kernels from
    # mixed-filter serving, the window MAC from serve_short and deep, the
    # row-window FFTs from sharded (and multihost, in launches_by_phase
    # with kernel 3's).  Every phase runs, so every count is
    # measured; the whole inverse (ifft_from_half) has no caller.
    with tempfile.TemporaryDirectory(prefix="folve_chip_smoke_") as tmp:
        shared = run_phase("serve_shared", phase_serve_shared, dev, tmp)
        mixed = run_phase("serve_mixed", phase_serve_mixed, dev, tmp)
        proc = run_phase("processor", phase_processor, dev, tmp)
        short = run_phase("serve_short", phase_serve_short, dev, tmp)
        deep = run_phase("deep", phase_deep, dev)
        sharded = run_phase("sharded", phase_sharded, dev, tmp)
        multihost = run_phase("multihost", phase_multihost, dev, tmp)
    files = run_phase("filesystem", phase_filesystem, dev, smi)
    cli = run_phase("cli", phase_cli, dev, smi)
    run_phase("dryrun", phase_dryrun)
    callers = {"conv_step_fused": "serve_shared", "fdl_mac": "serve_short+deep",
               "fft_real_half_rows": "sharded", "ifft_partial_rows": "sharded",
               "ifft_from_half": None}
    results["conv_step_fused"]["launches"] = shared["launches"]["conv_step_fused"]
    results["conv_step_fused"]["launches_by_phase"] = dict(
        serve_shared=shared["launches"]["conv_step_fused"],
        processor=proc["launches"]["conv_step_fused"],
        filesystem=files["launches"]["conv_step_fused"],
        cli_serve=cli["serve"]["launches"]["conv_step_fused"],
        cli_fuse=cli["fuse"]["launches"]["conv_step_fused"])
    for name in ("fft_real_half", "fdl_mac_split", "ifft_ola"):
        results[name]["launches"] = mixed["launches"][name]
        results[name]["launches_by_phase"] = dict(
            serve_mixed=mixed["launches"][name], filesystem=files["launches"][name],
            cli_convolve=cli["convolve"]["launches"][name])
        callers[name] = "serve_mixed"
    results["fdl_mac_split"]["launches_by_phase"]["sharded"] = (
        sharded["launches"]["fdl_mac_split"])
    results["fdl_mac_split"]["launches_by_phase"]["multihost"] = (
        multihost["launches"]["fdl_mac_split"])
    results["fdl_mac"]["launches"] = short["launches"] + deep["launches"]
    results["fdl_mac"]["launches_by_phase"] = dict(
        serve_short=short["launches"], deep=deep["launches"])
    # Each MAC kernel's registers and spills (one template body, two
    # window-row loaders: SplitRows for kernel 3, WindowRows for 5).
    ptxas = ptxas_report("fdl_mac")
    for name, rows in (("fdl_mac_split", "SplitRows"), ("fdl_mac", "WindowRows")):
        results[name]["ptxas"] = {n: v for n, v in ptxas.items() if rows in n}
        log(f"  {name} ptxas: {results[name]['ptxas']}")
    for name in ("fft_real_half_rows", "ifft_partial_rows"):
        results[name]["launches"] = sharded["launches"][name]
        results[name]["launches_by_phase"] = dict(
            sharded=sharded["launches"][name], multihost=multihost["launches"][name])
    results["ifft_from_half"]["launches"] = None
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], caller=callers[name],
             **results[name])
        for name in KERNELS]}
    split.update({f"{name}_{k}": v for name, r in (("serve_shared", shared), ("serve_mixed", mixed))
                  for k, v in r.items() if k in ("step_ms", "realtime")})
    log(json.dumps({"filesystem": files}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"fused_vs_split": split}))
    log(json.dumps({"multihost": multihost}))
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
