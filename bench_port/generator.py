"""The one traffic generator: a ring of input chunks, and the impulse
responses of a configuration, both from the run's seed.

Everything is made on the run's device with a seeded ``torch.Generator``
in a few large calls.  Parameters come from the traffic mix's and the
configuration's JSON files; nothing here names a cell.  Imports nothing
of the program.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np
import torch


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th independent 63-bit seed drawn from the run's seed."""
    seq = np.random.SeedSequence(abs(int(seed)))
    return int(seq.spawn(k + 1)[k].generate_state(1, np.uint64)[0] >> np.uint64(1))


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _uniform(shape, lo, hi, gen, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float64)


def make_ring(sig: dict, ring: int, streams: int, blocks: int, channels: int,
              fragm: int, rate: int, seed: int, device) -> tuple[torch.Tensor, list]:
    """``[ring, streams, blocks, channels, fragm]`` float32 chunks and the
    peak |x| of each.  Stream ``s`` plays chunk ``r``'s row ``s`` as its
    samples ``[r, r+1) * blocks * fragm`` of one continuous tone: a
    fundamental drawn log-uniform from ``f0_hz``, ``harmonics`` partials
    of amplitude ``amp / k``, a slow envelope, and white noise of
    ``noise_rms``; the ring repeats."""
    gen = _gen(device, seed)
    sc = (streams, channels)
    f0 = torch.exp(_uniform(sc, math.log(sig["f0_hz"][0]), math.log(sig["f0_hz"][1]),
                            gen, device))
    phase = _uniform((sig["harmonics"],) + sc, 0.0, 1.0, gen, device)
    env_hz = _uniform(sc, *sig["envelope_hz"], gen, device)
    env_ph = _uniform(sc, 0.0, 1.0, gen, device)
    chunk = blocks * fragm
    n = torch.arange(chunk, device=device, dtype=torch.float64).reshape(blocks, 1, fragm)
    out = torch.empty((ring, streams, blocks, channels, fragm), device=device,
                      dtype=torch.float32)
    peaks = []
    for r in range(ring):
        sec = (r * chunk + n) / rate  # [blocks, 1, fragm] seconds
        x = torch.zeros((streams, blocks, channels, fragm), device=device,
                        dtype=torch.float32)
        for k in range(1, sig["harmonics"] + 1):
            cyc = torch.frac(sec[None] * (k * f0)[:, None, :, None]
                             + phase[k - 1][:, None, :, None])
            x += (sig["amp"] / k) * torch.sin(2 * math.pi * cyc).float()
        env = torch.frac(sec[None] * env_hz[:, None, :, None] + env_ph[:, None, :, None])
        x *= (0.6 + 0.4 * torch.sin(2 * math.pi * env)).float()
        x += sig["noise_rms"] * torch.randn(x.shape, generator=gen, device=device)
        out[r] = x
        peaks.append(x.abs().max())
    return out, [float(p) for p in torch.stack(peaks).cpu()]


def _decaying_noise(spec: dict, rate: int, gen, device) -> torch.Tensor:
    taps, nch = spec["taps"], spec["channels"]
    t = torch.arange(taps, device=device, dtype=torch.float32) / rate
    ir = torch.randn((taps, nch), generator=gen, device=device)
    ir *= torch.exp(-spec["decay_per_s"] * t)[:, None]
    for ms, g in spec["early"]:
        ir[int(rate * ms / 1000)] += g
    return ir * spec["scale"]


def _windowed_sinc(spec: dict, rate: int, gen, device) -> torch.Tensor:
    """A Blackman-Harris windowed-sinc FIR, its cutoff drawn uniformly
    from ``cutoff_hz``; a highpass is the spectral inversion."""
    taps = spec["taps"]
    fc = float(_uniform((1,), *spec["cutoff_hz"], gen, device)[0]) / rate
    m = torch.arange(taps, device=device, dtype=torch.float64) - (taps - 1) / 2
    w = 2 * math.pi * torch.arange(taps, device=device, dtype=torch.float64) / (taps - 1)
    win = 0.35875 - 0.48829 * torch.cos(w) + 0.14128 * torch.cos(2 * w) - 0.01168 * torch.cos(3 * w)
    h = 2 * fc * torch.sinc(2 * fc * m) * win
    h /= h.sum()
    if spec["kind"] == "highpass_sinc":
        h = -h
        h[(taps - 1) // 2] += 1.0
    return h.float()[:, None].repeat(1, spec["channels"])


IR_KINDS = {"decaying_noise": _decaying_noise, "lowpass_sinc": _windowed_sinc,
            "highpass_sinc": _windowed_sinc}


def make_irs(config: dict, seed: int, device) -> list[np.ndarray]:
    """Each filter's IR file contents, ``[frames, nch]`` float32, made on
    ``device`` and brought to the host once."""
    gen = _gen(device, seed)
    return [IR_KINDS[f["ir"]["kind"]](f["ir"], config["rate"], gen, device).cpu().numpy()
            for f in config["filters"]]


def write_wav_float(path: Path, data: np.ndarray, rate: int) -> None:
    """IEEE-float32 WAV of ``data`` ``[frames, nch]``."""
    frames, nch = data.shape
    raw = np.ascontiguousarray(data, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, nch, rate, rate * nch * 4, nch * 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(raw)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(raw)) + raw)


def conf_text(filt: dict) -> str:
    """The jconvolver configuration file of one filter entry."""
    c = filt["convolver"]
    lines = [f"# {filt['name']}",
             f"/convolver/new {c['inputs']} {c['outputs']} {c['partition']} {c['maxsize']}"]
    for imp in filt["impulses"]:
        if "dirac" in imp:
            lines.append(f"/impulse/dirac {imp['in']} {imp['out']} {imp['gain']} {imp['dirac']}")
        else:
            lines.append(f"/impulse/read {imp['in']} {imp['out']} {imp['gain']} 0 0 0 "
                         f"{imp['chan']} {filt['ir']['file']}")
    return "\n".join(lines) + "\n"


def write_filters(config: dict, irs: list, directory: Path) -> list[Path]:
    """Each filter's conf and IR wav under ``directory``; returns the
    conf paths."""
    paths = []
    for filt, ir in zip(config["filters"], irs):
        d = directory / filt["name"]
        d.mkdir(parents=True, exist_ok=True)
        write_wav_float(d / filt["ir"]["file"], ir, config["rate"])
        conf = d / f"filter-{config['rate']}.conf"
        conf.write_text(conf_text(filt))
        paths.append(conf)
    return paths
