"""Plain float64 reference of what the timed step returns.

A filter configuration, as ``configs/<config>.json`` states it, is a
dense impulse response ``[Cin, Cout, maxsize]``: each ``/impulse/read``
adds ``gain`` times one channel of the IR file, each ``/impulse/dirac``
adds ``gain`` at its delay.  Output channel ``o`` of a stream is the
linear convolution of its input channels with that response,
``y_o[n] = sum_i sum_k ir[i, o, k] * x_i[n - k]``, with silence before
the stream's first sample.  Here it is computed in float64 with NumPy's
FFT, whose rounding (~1e-16) lies far below any limit the benchmark
sets.  This module imports NumPy alone: nothing of the program, its
kernels, its oracles or its tests.
"""

from __future__ import annotations

import numpy as np


def dense_ir(filt: dict, channels: np.ndarray) -> np.ndarray:
    """``[Cin, Cout, maxsize]`` float64 response of one filter entry of a
    configuration; ``channels`` is the IR file's ``[frames, nch]``."""
    conv = filt["convolver"]
    size = conv["maxsize"]
    ir = np.zeros((conv["inputs"], conv["outputs"], size))
    for imp in filt["impulses"]:
        i, o, gain = imp["in"] - 1, imp["out"] - 1, imp["gain"]
        if "dirac" in imp:
            ir[i, o, imp["dirac"]] += gain
        else:
            seg = channels[:size, imp["chan"] - 1].astype(np.float64)
            ir[i, o, :seg.shape[0]] += gain * seg
    return ir


def periodic_segment(signal: np.ndarray, start: int, length: int) -> np.ndarray:
    """Samples ``[start, start + length)`` of a stream that plays the
    ``[C, period]`` ``signal`` over and over from sample 0, with silence
    before sample 0."""
    period = signal.shape[-1]
    idx = np.arange(start, start + length)
    out = signal[:, idx % period].astype(np.float64)
    out[:, idx < 0] = 0.0
    return out


class Convolver:
    """Output samples ``[start, start + n_out)`` of streams through one
    dense response, by FFT over the ``maxsize + n_out - 1`` input samples
    they depend on (the response's spectra are taken once)."""

    def __init__(self, ir: np.ndarray, n_out: int):
        self.ir = ir
        self.n_out = n_out
        size = ir.shape[-1]
        self.seg = size - 1 + n_out
        self.nfft = 1 << (self.seg - 1).bit_length()
        self.pairs = [(i, o) for i in range(ir.shape[0])
                      for o in range(ir.shape[1]) if np.any(ir[i, o])]
        self.h = {(i, o): np.fft.rfft(ir[i, o], self.nfft) for i, o in self.pairs}

    def __call__(self, signal: np.ndarray, start: int) -> np.ndarray:
        """``[Cout, n_out]`` float64 for the stream playing ``signal``
        (``[Cin, period]``)."""
        size = self.ir.shape[-1]
        x = periodic_segment(signal, start - (size - 1), self.seg)
        xf = {i: np.fft.rfft(x[i], self.nfft) for i in {i for i, _ in self.pairs}}
        y = np.zeros((self.ir.shape[1], self.n_out))
        for o in range(self.ir.shape[1]):
            acc = sum((xf[i] * self.h[i, oo] for i, oo in self.pairs if oo == o),
                      start=np.zeros(self.nfft // 2 + 1, np.complex128))
            # Circular over nfft >= seg: outputs from size - 1 on are exact.
            y[o] = np.fft.irfft(acc, self.nfft)[size - 1 : size - 1 + self.n_out]
        return y


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    """Error energy over signal energy in dB (the engine's accuracy
    measure; its budget is -90 dB)."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    den = float(np.sum(ref * ref))
    num = float(np.sum(err * err))
    if den == 0.0:
        return -np.inf if num == 0.0 else np.inf
    return 10.0 * np.log10(num / den + 1e-300)


def tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32 (10 explicit mantissa bits, to nearest
    even), as the tensor cores round float32 operands."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    lsb = (u >> np.uint32(13)) & np.uint32(1)
    r = (u + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)
    return r.view(np.float32)
