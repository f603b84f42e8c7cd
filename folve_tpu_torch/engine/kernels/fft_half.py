"""Forward real FFT to the permuted half spectrum.

Replaces ``folve_tpu/engine/kernels/fft_half.py:pallas_fft_real_half``
(Pallas body ``_kernel``) with ``csrc/fft_half.cu``, and
``pallas_fft_real_half_rows`` (the same body over a window of k1 rows:
one frequency shard's bins) with :func:`fft_real_half_rows`, the same
CUDA kernel over that window.  The TPU kernel takes the shard's factor
rows as inputs because its shard index is traced; here ``k1_start`` is
an int and the kernel indexes the plan's factors.

Bound on the H100: bytes.  At the flagship shape (n = 16384, R = 16
signals per stream) each signal reads 32 KB and writes 66 KB, and a real
FFT needs 2.5*n*log2(n) = 0.57 MFLOP of it: ~6 FLOP per byte, below the
card's fp32 (non tensor core) balance of ~20.  Design: one block per
signal runs both stages of the four-step split n = m1*m2 as radix FFTs
(``csrc/fft_radix.cuh``: register DFTs of at most 16 points, exchanges
through a 132 KB shared-memory intermediate), so device memory sees each
input byte and each output byte once; stage 1 reads only the non-zero
input rows and prunes the first layer under the engine's 2x zero pad,
and a k1 window runs stage 2 on its rows alone.  All arithmetic is fp32
on the CUDA cores (no TF32: the engine's -90 dB budget needs full fp32),
with twiddles from the host's float64 tables rounded once.
"""

from __future__ import annotations

import math

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.rfft import fft_real, plan_tensors


def _half_rows(wrapper, x: torch.Tensor, n: int, k1_start: int, k1_n: int):
    """Launch ``csrc/fft_half.cu`` for ``wrapper`` (whose launch count it
    raises): float32 ``x [..., L]`` -> ``(re, im)`` each ``[...,
    k1_n * cols]``, the k1 rows ``[k1_start, k1_start + k1_n)``."""
    what = wrapper.__name__
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    if x.shape[-1] > n or not 128 <= n <= 16384:
        raise ValueError(f"{what}: length {x.shape[-1]}, n {n} unsupported")
    x, pt = x.contiguous(), plan_tensors(n, x.device)
    if k1_n < 1 or k1_start < 0 or k1_start + k1_n > pt.m1:
        raise ValueError(f"{what}: window ({k1_start}, {k1_n}) "
                         f"outside {pt.m1} rows")
    batch = x.shape[:-1]
    k = k1_n * (pt.m2 // 2 + 1)
    yr = torch.empty(*batch, k, device=x.device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    P_, I_ = _build.P, _build.I
    fn = _build.function("fft_half", "folve_fft_real_half_rows",
                         [P_, P_, P_, P_, I_, I_, I_, I_, I_, I_, P_])
    wrapper.launches += 1
    _build.check(fn(_build.ptr(x), _build.ptr(yr), _build.ptr(yi),
                    _build.ptr(pt.packed), math.prod(batch), x.shape[-1],
                    pt.m1, pt.m2, k1_start, k1_n, _build.stream_of(x)), what)
    return yr, yi


def fft_real_half_plain(x: torch.Tensor, n: int):
    """Plain PyTorch version: ``engine.rfft.fft_real(x, n, half=True)``."""
    return fft_real(x, n, half=True)


def fft_real_half(x: torch.Tensor, n: int):
    """``x``: float32 ``[..., L]`` with L <= n.  Returns ``(re, im)``
    each ``[..., half_bins(n)]`` in the permuted half-spectrum layout."""
    if not x.is_cuda:
        return fft_real_half_plain(x, n)
    m1 = plan_tensors(n, x.device).m1
    return _half_rows(fft_real_half, x, n, 0, m1)


fft_real_half.launches = 0


def fft_real_half_rows_plain(x: torch.Tensor, n: int, k1_start: int,
                             k1_n: int):
    """Plain PyTorch version: ``engine.rfft.fft_real(x, n, half=True,
    k1_start=k1_start, k1_n=k1_n)``."""
    return fft_real(x, n, half=True, k1_start=k1_start, k1_n=k1_n)


def fft_real_half_rows(x: torch.Tensor, n: int, k1_start: int, k1_n: int):
    """The k1 rows ``[k1_start, k1_start + k1_n)`` of the half spectrum
    (kernel 6).  ``x``: float32 ``[..., L]`` with L <= n.  Returns
    ``(re, im)`` each ``[..., k1_n * cols]``, cols = M2/2 + 1."""
    if not x.is_cuda:
        return fft_real_half_rows_plain(x, n, k1_start, k1_n)
    return _half_rows(fft_real_half_rows, x, n, k1_start, k1_n)


fft_real_half_rows.launches = 0
