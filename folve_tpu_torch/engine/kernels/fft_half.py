"""Forward real FFT to the permuted half spectrum.

Replaces ``folve_tpu/engine/kernels/fft_half.py:pallas_fft_real_half``
(Pallas body ``_kernel``) with ``csrc/fft_half.cu``.

Bound on the H100: bytes.  At the flagship shape (n = 16384, R = 16
signals per stream) each signal reads 32 KB and writes 66 KB, and a real
FFT needs 2.5*n*log2(n) = 0.57 MFLOP of it: ~6 FLOP per byte, below the
card's fp32 (non tensor core) balance of ~20.  This kernel runs the two
DFT stages as dense products instead, 4*m1*rows*m2 + 8*m1*cols*m2 =
12.7 MFLOP per signal (22x the FFT count), which is what keeps it far
above the bound.  Design: grid (k1-row tiles, signals); the signal's
non-zero rows sit in shared memory once per block and each warp computes
whole k1 rows, both stages in registers and a per-warp shared row, in
fp32 FMA (no TF32: the engine's -90 dB budget needs full fp32 products).
"""

from __future__ import annotations

import math

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.rfft import fft_real, half_bins, plan_tensors


def fft_real_half_plain(x: torch.Tensor, n: int):
    """Plain PyTorch version: ``engine.rfft.fft_real(x, n, half=True)``."""
    return fft_real(x, n, half=True)


def fft_real_half(x: torch.Tensor, n: int):
    """``x``: float32 ``[..., L]`` with L <= n.  Returns ``(re, im)``
    each ``[..., half_bins(n)]`` in the permuted half-spectrum layout."""
    if not x.is_cuda:
        return fft_real_half_plain(x, n)
    length = x.shape[-1]
    if x.dtype != torch.float32:
        raise TypeError(f"fft_real_half takes float32, got {x.dtype}")
    if length > n or n > 16384:
        raise ValueError(f"fft_real_half: length {length}, n {n} unsupported")
    x = x.contiguous()
    batch = x.shape[:-1]
    k = half_bins(n)
    yr = torch.empty(*batch, k, device=x.device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    pt = plan_tensors(n, x.device)
    fn = _build.function("fft_half", "folve_fft_real_half", [
        _build.P, _build.P, _build.P, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.P])
    fft_real_half.launches += 1
    _build.check(fn(_build.ptr(x), _build.ptr(yr), _build.ptr(yi),
                    _build.ptr(pt.packed), math.prod(batch), length,
                    pt.m1, pt.m2, _build.stream_of(x)), "fft_real_half")
    return yr, yi


fft_real_half.launches = 0
