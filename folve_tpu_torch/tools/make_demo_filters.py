"""Generate a demo filter set in jconvolver config format.

The reference ships demo-filters/{lowpass,highpass,echo,SantaLucia}
covering IR-file convolution, dirac-only configs, long reverb, and
multi-rate variants (SURVEY.md §2 "Demo filters").  This tool generates
an equivalent, self-contained set from scratch (scipy-designed FIRs and
a synthetic exponentially-decaying reverb) so the framework's fixtures
carry no third-party audio.

Usage: python -m folve_tpu_torch.tools.make_demo_filters <target-dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from folve_tpu_torch.audio import SampleCodec, write_wav

DEFAULT_RATES = (44100, 48000, 96000)


def _firwin(numtaps: int, cutoff_norm: float, highpass: bool = False) -> np.ndarray:
    from scipy import signal

    taps = signal.firwin(
        numtaps, cutoff_norm, pass_zero=not highpass, window="blackmanharris"
    )
    return taps.astype(np.float32)


def _write_conf(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def make_lowpass(root: str, rates=DEFAULT_RATES) -> None:
    d = os.path.join(root, "lowpass")
    os.makedirs(d, exist_ok=True)
    for rate in rates:
        taps = _firwin(16383, 2 * 1000.0 / rate)
        write_wav(
            os.path.join(d, f"lowpass_{rate}.wav"), taps, rate, SampleCodec.FLOAT
        )
        _write_conf(
            os.path.join(d, f"filter-{rate}.conf"),
            "# Generated demo filter: 1 kHz FIR lowpass\n"
            "#                 in  out  partition  maxsize\n"
            "/convolver/new    2    2      1024      65536\n"
            "#               in out  gain  delay  offset  length  chan  file\n"
            f"/impulse/read    1   1  0.75    0      0       0       1   lowpass_{rate}.wav\n"
            f"/impulse/read    2   2  0.75    0      0       0       1   lowpass_{rate}.wav\n",
        )


def make_highpass(root: str, rates=DEFAULT_RATES) -> None:
    d = os.path.join(root, "highpass")
    os.makedirs(d, exist_ok=True)
    for rate in rates:
        taps = _firwin(16383, 2 * 2000.0 / rate, highpass=True)
        write_wav(
            os.path.join(d, f"highpass_{rate}.wav"), taps, rate, SampleCodec.FLOAT
        )
        _write_conf(
            os.path.join(d, f"filter-{rate}.conf"),
            "# Generated demo filter: 2 kHz FIR highpass\n"
            "/convolver/new    2    2      1024      65536\n"
            f"/impulse/read    1   1  0.75    0      0       0       1   highpass_{rate}.wav\n"
            f"/impulse/read    2   2  0.75    0      0       0       1   highpass_{rate}.wav\n",
        )


def make_echo(root: str, rates=DEFAULT_RATES) -> None:
    """Dirac-only config — pure delays, no IR file (cf. the reference's
    demo-filters/echo)."""
    d = os.path.join(root, "echo")
    os.makedirs(d, exist_ok=True)
    for rate in rates:
        delay = rate // 2  # half a second
        _write_conf(
            os.path.join(d, f"filter-{rate}.conf"),
            "# Generated demo filter: 500 ms echo via dirac pulses\n"
            f"/convolver/new    2    2      256     {delay + 1024}\n"
            "/impulse/dirac   1   1   0.7       0\n"
            "/impulse/dirac   2   2   0.7       0\n"
            f"/impulse/dirac   1   1   0.3       {delay}\n"
            f"/impulse/dirac   2   2   0.3       {delay}\n",
        )


def make_reverb(root: str, rate: int = 44100, seconds: float = 4.0) -> None:
    """Synthetic long-IR reverb (stand-in for the reference's SantaLucia
    church IR): exponentially decaying noise with early reflections,
    mixed with a dry dirac."""
    d = os.path.join(root, "reverb")
    os.makedirs(d, exist_ok=True)
    n = int(rate * seconds)
    rng = np.random.default_rng(1234)
    t = np.arange(n) / rate
    env = np.exp(-3.0 * t)  # ~ -26 dB over 2 s
    ir = rng.standard_normal((n, 2)).astype(np.float32) * env[:, None]
    # Early reflections.
    for tap_ms, g in ((17, 0.5), (23, -0.4), (41, 0.3)):
        idx = int(rate * tap_ms / 1000)
        ir[idx, :] += g
    ir *= 0.02
    write_wav(os.path.join(d, "reverb_ir.wav"), ir, rate, SampleCodec.FLOAT)
    _write_conf(
        os.path.join(d, f"filter-{rate}.conf"),
        "# Generated demo filter: synthetic 4 s reverb + dry mix\n"
        f"/convolver/new    2    2      256     {n}      0.5\n"
        "/impulse/read    1   1   1.0     0      0       0    1   reverb_ir.wav\n"
        "/impulse/read    2   2   1.0     0      0       0    2   reverb_ir.wav\n"
        "/impulse/dirac   1   1   0.4       0\n"
        "/impulse/dirac   2   2   0.4       0\n",
    )


def make_all(root: str) -> None:
    make_lowpass(root)
    make_highpass(root)
    make_echo(root)
    make_reverb(root)


if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else "demo-filters"
    make_all(target)
    print(f"demo filters written to {target}")
