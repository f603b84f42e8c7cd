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
  dryrun       entry.dryrun_multichip(8) with its default device: a mesh of
               eight entries of the card, held to the engine step
Every serving phase holds the output to -90 dB against a float64 oracle and
runs no plain MAC on a CUDA tensor.  Prints the card's name and power limit
first, each phase's seconds, a "filesystem" JSON line, a "fused_vs_split"
JSON line (kernel 1's graph time beside kernels 2 + 3 + 4's, and the
serve_shared and serve_mixed steady steps), each MAC kernel's ptxas
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
    conv_step_fused,
    conv_step_fused_plain,
    fused_preshape,
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
# The filesystem phase: 8 tracks of 60 s (cut from a typical 4-minute
# track to bound the float64 oracle's time), an album of three 20 s
# tracks, a Gaussian level whose oracle peak stays below 0.9 of full
# scale, and the served bytes that make the first-read latency.
FS_TRACKS, FS_SECONDS, FS_ALBUM_SECONDS = 8, 60, 20
FS_LEVEL = 0.1
FS_FIRST_BYTES = 65536

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


def fused_inputs(cu, rng, hp, s: int, t: int, hist_t: bool) -> tuple:
    """Seeded inputs of kernel 1 at the flagship width for ``s`` streams of
    ``t`` blocks: x and tail pre-shaped, the hist in the layout ``hist_t``
    names, and a ragged ``valid`` (the last stream ends inside its last
    block, the one before it halfway through the chunk)."""
    b = FRAGM
    rows, m2, m1, cols = fused_preshape(N)
    xs = cu(rng.standard_normal((s, t, CIN, rows, m2)))
    tl = cu(rng.standard_normal((s, COUT, rows, m2)))
    shape = (s, P - 1, CIN, cols, m1) if hist_t else (s, P - 1, CIN, K)
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
    fused = lambda: conv_step_fused(hp, x, hr_t, hi_t, tl, valid, N, hist_t=True)
    fused_canonical = lambda: conv_step_fused(hp, x, hr, hi, tl, valid, N)
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
            got = conv_step_fused(*args, hist_t=hist_t)
            again = conv_step_fused(*args, hist_t=hist_t)
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
                case["graph_ms"] = graph_ms(lambda: conv_step_fused(*args, hist_t=True), 20)
            cases.append(case)
    args = timed  # the flagship's, checked first
    flagship = lambda: conv_step_fused(*args, hist_t=True)
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
        library_ms=None, bound_ms=bms, bound_by=bby, cases=cases)
    kernels_window_mac(cu, rng, results)
    kernels_row_windows(cu, rng, results)
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms (graph {r.get('graph_ms')}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (graph "
            f"{r.get('library_graph_ms')}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return fused_vs_split(cu, rng)


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
    """The served bytes decode to the source's frames, rate and bits, and
    hold to the float64 oracle: 16-bit within 1 LSB of the oracle
    quantized on the host, 24-bit at SNR_LIMIT_DB or better.  Returns the
    16-bit LSB error or the 24-bit SNR in dB."""
    from folve_tpu_torch.audio.flac import read_flac
    from folve_tpu_torch.runtime import ConvolveFileHandler

    assert isinstance(res["handler"], ConvolveFileHandler), f"{name}: not convolved"
    y, info = read_flac(res["blob"])
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
    # row-window FFTs from sharded.  Every phase runs, so every count is
    # measured; the whole inverse (ifft_from_half) has no caller.
    with tempfile.TemporaryDirectory(prefix="folve_chip_smoke_") as tmp:
        shared = run_phase("serve_shared", phase_serve_shared, dev, tmp)
        mixed = run_phase("serve_mixed", phase_serve_mixed, dev, tmp)
        proc = run_phase("processor", phase_processor, dev, tmp)
        short = run_phase("serve_short", phase_serve_short, dev, tmp)
        deep = run_phase("deep", phase_deep, dev)
        sharded = run_phase("sharded", phase_sharded, dev, tmp)
    files = run_phase("filesystem", phase_filesystem, dev, smi)
    run_phase("dryrun", phase_dryrun)
    callers = {"conv_step_fused": "serve_shared", "fdl_mac": "serve_short+deep",
               "fft_real_half_rows": "sharded", "ifft_partial_rows": "sharded",
               "ifft_from_half": None}
    results["conv_step_fused"]["launches"] = shared["launches"]["conv_step_fused"]
    results["conv_step_fused"]["launches_by_phase"] = dict(
        serve_shared=shared["launches"]["conv_step_fused"],
        processor=proc["launches"]["conv_step_fused"],
        filesystem=files["launches"]["conv_step_fused"])
    for name in ("fft_real_half", "fdl_mac_split", "ifft_ola"):
        results[name]["launches"] = mixed["launches"][name]
        results[name]["launches_by_phase"] = dict(
            serve_mixed=mixed["launches"][name], filesystem=files["launches"][name])
        callers[name] = "serve_mixed"
    results["fdl_mac_split"]["launches_by_phase"]["sharded"] = (
        sharded["launches"]["fdl_mac_split"])
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
    results["ifft_from_half"]["launches"] = None
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], caller=callers[name],
             **results[name])
        for name in KERNELS]}
    split.update({f"{name}_{k}": v for name, r in (("serve_shared", shared), ("serve_mixed", mixed))
                  for k, v in r.items() if k in ("step_ms", "realtime")})
    log(json.dumps({"filesystem": files}))
    log(json.dumps({"fused_vs_split": split}))
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
