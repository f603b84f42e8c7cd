"""Plain float64 reference of a jconvolver multichannel filter, in plain
``torch`` (TF32 off), for the multichannel tests.

A conf is a list of paths ``(in, out, gain, ir)``, 0-based channels:
each ``/impulse/read`` or ``/impulse/dirac`` line adds ``gain * ir`` to
the response from input ``in`` to output ``out``, and output ``o`` of a
stream is ``sum over paths (i, o) of gain * (x_i conv ir)``, with silence
before the first sample.  Pairs the conf never names carry nothing.
This module imports no kernel or module of the port and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# FLAC's 5.1 channel order (ITU-R BS.775 layout), 0-based.
L, R, C, LFE, LS, RS = range(6)
MAINS = (L, R, C, LS, RS)
SUB = LFE  # the LFE channel's output feeds the subwoofer


def bass_managed_51(irs, bass_gain: float = 0.5) -> list:
    """The 11 paths of 5.1 bass management from 11 responses ``irs``:
    each main to itself (its correction with the 80 Hz highpass folded
    in, gain 1), each main to the sub's output (the 80 Hz lowpass with
    the sub's correction, ``bass_gain``), and LFE to the sub's output
    (gain 1)."""
    irs = list(irs)
    assert len(irs) == 11
    return ([(m, m, 1.0, irs[k]) for k, m in enumerate(MAINS)]
            + [(LFE, SUB, 1.0, irs[5])]
            + [(m, SUB, bass_gain, irs[6 + k]) for k, m in enumerate(MAINS)])


def pairs(paths) -> tuple:
    """The distinct (in, out) pairs of ``paths``, in (in, out) order."""
    return tuple(sorted({(i, o) for i, o, _, _ in paths}))


def dense_ir(paths, cin: int, cout: int, size: int) -> np.ndarray:
    """``[Cin, Cout, size]`` float32 response of ``paths`` (for a
    filter bank compiled from arrays)."""
    out = np.zeros((cin, cout, size), np.float64)
    for i, o, gain, ir in paths:
        ir = np.asarray(ir, np.float64)[:size]
        out[i, o, :ir.shape[0]] += gain * ir
    return out.astype(np.float32)


def convolve(paths, x, cout: int) -> np.ndarray:
    """``[N, Cout]`` float64 output of ``paths`` for the input ``x``
    ``[N, Cin]`` (the first N samples of the linear convolution)."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    n = x.shape[0]
    y = torch.zeros(n, cout, dtype=torch.float64)
    for i, o, gain, ir in paths:
        h = torch.as_tensor(np.asarray(ir), dtype=torch.float64)
        nfft = 1 << (n + h.shape[0] - 2).bit_length()
        spec = torch.fft.rfft(x[:, i], nfft) * torch.fft.rfft(h, nfft)
        y[:, o] += gain * torch.fft.irfft(spec, nfft)[:n]
    return y.numpy()


def snr_db(ref, got) -> float:
    """Error energy over signal energy, dB."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(np.sum(err * err) / np.sum(ref * ref) + 1e-300))
