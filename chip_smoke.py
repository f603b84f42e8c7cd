"""Smoke test of the PyTorch port (folve_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's exception is caught):
  build        build the four CUDA kernels from folve_tpu_torch/engine/kernels/csrc
  kernels      each kernel against its plain PyTorch version at the flagship
               shapes (131,072-tap stereo, fragm 8192, P 16, S 8 x T 8), with
               times, bounds and the torch.fft yardstick
  serve_shared 8 streams of one filter through DeviceScheduler (fused kernel)
  serve_mixed  8 streams of two filters of one shape (split kernels)
  processor    a lone SoundProcessor: pump_chunk at 16 and 24 bits, then the
               single-block write_processed path for a ragged end
Prints the card's name and power limit first, a "kernels" JSON line before the
last line, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.kernels.conv_step import (
    conv_step_fused,
    conv_step_fused_plain,
    fused_preshape,
    permute_h_for_fused,
)
from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac_split, fdl_mac_split_plain
from folve_tpu_torch.engine.kernels.fft_half import fft_real_half, fft_real_half_plain
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola, ifft_ola_plain
from folve_tpu_torch.engine.rfft import half_bins

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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fft_ops(n: int) -> float:
    """Operations of one real FFT of length ``n`` (the textbook
    2.5*n*log2(n)): what the function needs, whatever the kernel's own
    DFT schedule does."""
    return 2.5 * n * math.log2(n)


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


def phase_kernels(dev, results: dict) -> None:
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
    results["fft_real_half"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fft_real_half(x, N), 20),
        plain_ms=time_ms(lambda: fft_real_half_plain(x, N), 5),
        library_ms=time_ms(lambda: torch.fft.rfft(x, n=N), 20),
        bound_ms=bms, bound_by=bby)

    # Kernel 3: FDL MAC with per-stream filters (mixed batch).
    h = cu(rng.standard_normal((S, P, CIN, COUT, 2, K)) / 64)
    hr, hi = cu(rng.standard_normal((S, P - 1, CIN, K))), cu(rng.standard_normal((S, P - 1, CIN, K)))
    xr, xi = cu(rng.standard_normal((S, T, CIN, K))), cu(rng.standard_normal((S, T, CIN, K)))
    got = fdl_mac_split(h, hr, hi, xr, xi)
    ref = fdl_mac_split_plain(h, hr, hi, xr, xi)
    err = check_kernel("fdl_mac_split", got, ref)
    flops = 8.0 * S * T * COUT * P * CIN * K
    nbytes = 4.0 * (h.numel() + 2 * hr.numel() + 2 * xr.numel() + 2 * S * T * COUT * K)
    bms, bby = bound(flops, nbytes)
    results["fdl_mac_split"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fdl_mac_split(h, hr, hi, xr, xi), 20),
        plain_ms=time_ms(lambda: fdl_mac_split_plain(h, hr, hi, xr, xi), 5),
        library_ms=None, bound_ms=bms, bound_by=bby)

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
    results["ifft_ola"] = dict(
        max_abs_err=err, ms=time_ms(lambda: ifft_ola(yr, yi, tail, N), 20),
        plain_ms=time_ms(lambda: ifft_ola_plain(yr, yi, tail, N), 5),
        library_ms=time_ms(lambda: torch.fft.irfft(spec, n=N), 20),
        bound_ms=bms, bound_by=bby)

    # Kernel 1: the fused step on the shared filter, both hist layouts.
    rows, m2, m1, cols = fused_preshape(N)
    hp = permute_h_for_fused(cu(rng.standard_normal((P, CIN, COUT, 2, K)) / 64), N)
    xs = cu(rng.standard_normal((S, T, CIN, rows, m2)))
    tl = cu(rng.standard_normal((S, COUT, rows, m2)))
    nv = np.array([T * b] * (S - 2) + [T * b - b // 2 - 3, 5 * b + 11])
    valid = torch.from_numpy(np.clip(nv[:, None] - np.arange(T)[None] * b, 0, b)
                             .astype(np.int32)).to(dev)
    err, timed = 0.0, None
    for hist_t in (True, False):
        shape = (S, P - 1, CIN, cols, m1) if hist_t else (S, P - 1, CIN, K)
        h_re, h_im = cu(rng.standard_normal(shape)), cu(rng.standard_normal(shape))
        args = (hp, xs, h_re, h_im, tl, valid, N)
        got = conv_step_fused(*args, hist_t=hist_t)
        ref = conv_step_fused_plain(*args, hist_t=hist_t)
        err = max(err, check_kernel(f"conv_step_fused(hist_t={hist_t})", got, ref))
        if hist_t:  # the serving layout: time the call that was checked
            timed = args
    # Per (stream, block): Cin forward and Cout inverse FFTs, the MAC, the
    # OLA add.  Bytes: H, x, y, hist in and out (two planes each), tail in
    # and out, valid, max.
    flops = S * T * ((CIN + COUT) * fft_ops(N) + 8.0 * P * CIN * COUT * K + COUT * b)
    nbytes = 4.0 * (hp.numel() + xs.numel() + S * T * COUT * b
                    + 4 * h_re.numel() + 2 * tl.numel() + valid.numel() + S)
    bms, bby = bound(flops, nbytes)
    results["conv_step_fused"] = dict(
        max_abs_err=err, ms=time_ms(lambda: conv_step_fused(*timed, hist_t=True), 5),
        plain_ms=time_ms(lambda: conv_step_fused_plain(*timed, hist_t=True), 5),
        library_ms=None, bound_ms=bms, bound_by=bby)
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def write_float_wav(path: str, data: np.ndarray, rate: int) -> None:
    """IEEE float32 WAV writer (the port reads WAVs only)."""
    data = np.ascontiguousarray(data, dtype="<f4")
    ch = data.shape[1]
    fmt = np.array([3, ch], "<u2").tobytes() + np.array(
        [rate, rate * ch * 4], "<u4").tobytes() + np.array([ch * 4, 32], "<u2").tobytes()
    body = (b"WAVE" + b"fmt " + np.uint32(len(fmt)).tobytes() + fmt
            + b"data" + np.uint32(data.nbytes).tobytes() + data.tobytes())
    with open(path, "wb") as f:
        f.write(b"RIFF" + np.uint32(len(body)).tobytes() + body)


def make_config(tmp: str, name: str, seed: int) -> tuple[str, np.ndarray]:
    """A seeded 131,072-tap true-stereo IR (decaying noise, one WAV channel
    per in/out pair) and its zita config; returns (config path, ir
    [Cin, Cout, SIZE] float32)."""
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(SIZE) / (SIZE / 6.0))
    ir = (rng.standard_normal((CIN, COUT, SIZE)) * env).astype(np.float32)
    ir *= np.float32(np.sqrt(0.5 / np.sum(ir[0, 0].astype(np.float64) ** 2)))
    wav = os.path.join(tmp, f"{name}.wav")
    write_float_wav(wav, ir.reshape(CIN * COUT, SIZE).T, RATE)
    lines = [f"/convolver/new {CIN} {COUT} {FRAGM} {SIZE}"]
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


def serve(dev, configs: list, rounds: int = 6) -> tuple:
    """S streams (stream i uses configs[i % len]) submit T-block chunks to
    one DeviceScheduler from threads for ``rounds`` rounds; returns
    (scheduler, worst SNR in dB against the float64 oracle)."""
    from folve_tpu_torch.engine.stream import init_state
    from folve_tpu_torch.filters.compiler import compile_config_file
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler

    compiled = [compile_config_file(cfg, fsamp=RATE, device=dev) for cfg, _ in configs]
    for c, (_, ir) in zip(compiled, configs):
        assert np.array_equal(c.ir, ir), "loaded IR differs from the written one"
    rng = np.random.default_rng(7)
    b = FRAGM
    audio = (0.1 * rng.standard_normal((S, rounds * T * b, CIN))).astype(np.float32)
    sched = DeviceScheduler(max_batch=S, window_s=0.2, device=dev)
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
    for i in range(S):
        y = np.concatenate(outs[i], axis=0)  # [rounds*T, Cout, B]
        y = y.transpose(0, 2, 1).reshape(-1, COUT)
        assert np.all(np.isfinite(y)) and y.shape == (rounds * T * b, COUT)
        worst = max(worst, snr_db(oracle(configs[i % len(configs)][1], audio[i]), y))
    return sched, worst


def report_serving(name: str, sched) -> dict:
    # The first two steps load lazily-loaded CUDA modules (state stacking,
    # the carry gather); the rest are steady state.
    steps = sched.latency._recent
    steady = steps[2:]
    step_s = float(np.median(steady))
    audio_s = S * T * FRAGM / RATE
    log(f"  {name}: {sched.steps} steps (fused {sched.fused_steps}, fast "
        f"{sched.fused_fast_steps}, batched jobs {sched.batched_jobs}); step ms "
        f"{[round(1e3 * v, 3) for v in steps]}; steady median {1e3 * step_s:.3f} ms "
        f"for {S} streams x {T} blocks = {audio_s:.2f} s of audio: "
        f"realtime factor {audio_s / step_s:.1f}")
    return dict(step_ms=1e3 * step_s, realtime=audio_s / step_s)


def phase_serve_shared(dev, tmp: str) -> dict:
    log("phase serve_shared: 8 streams, one 131,072-tap stereo filter, DeviceScheduler")
    cfg = make_config(tmp, "shared", 11)
    reset_counts()
    sched, worst = serve(dev, [cfg])
    c = counts()
    log(f"  launches {c}; worst SNR vs float64 oracle {worst:.2f} dB (limit {SNR_LIMIT_DB})")
    assert sched.fused_steps > 0 and sched.fused_fast_steps > 0, "fused path not taken"
    assert c["conv_step_fused"] > 0, "fused kernel never launched"
    assert worst <= SNR_LIMIT_DB, f"shared serving SNR {worst:.2f} dB"
    return dict(report_serving("serve_shared", sched), launches=c, snr_db=worst)


def phase_serve_mixed(dev, tmp: str) -> dict:
    log("phase serve_mixed: 8 streams, two filters of one shape in one batch")
    cfgs = [make_config(tmp, "mixa", 21), make_config(tmp, "mixb", 22)]
    reset_counts()
    sched, worst = serve(dev, cfgs)
    c = counts()
    log(f"  launches {c}; worst SNR vs float64 oracle {worst:.2f} dB (limit {SNR_LIMIT_DB})")
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
    assert c["conv_step_fused"] > 0, "fused kernel never launched"
    return dict(launches=c, max_lsb=worst)


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
    _build.build_all()
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    log(f"  built in {_build.build_seconds:.1f} s")

    results: dict = {}
    phase_kernels(dev, results)

    # Each kernel's launches come from the serving path it belongs to:
    # the fused kernel from shared-filter serving, the split kernels from
    # mixed-filter serving.  Every phase runs, so every count is measured.
    with tempfile.TemporaryDirectory(prefix="folve_chip_smoke_") as tmp:
        shared = phase_serve_shared(dev, tmp)
        mixed = phase_serve_mixed(dev, tmp)
        phase_processor(dev, tmp)
    results["conv_step_fused"]["launches"] = shared["launches"]["conv_step_fused"]
    for name in ("fft_real_half", "fdl_mac_split", "ifft_ola"):
        results[name]["launches"] = mixed["launches"][name]
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], **results[name])
        for name in KERNELS]}
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
