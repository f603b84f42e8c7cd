"""Inverse FFT from the half spectrum fused with the overlap-add.

Replaces ``folve_tpu/engine/kernels/ifft_half.py:pallas_ifft_ola``
(Pallas body ``_ola_kernel``) with ``csrc/ifft_half.cu``.

Bound on the H100: bytes.  Per block and channel at n = 16384 the
kernel reads 66 KB of spectrum and writes 32 KB of audio (plus the tail),
and a real inverse FFT needs 2.5*n*log2(n) = 0.57 MFLOP of it: ~6 FLOP
per byte, below the card's fp32 balance of ~20.  This kernel's dense DFT
stages do 8*m1*cols*m2 + 4*m1*m1*m2 = 17 MFLOP (30x the FFT count).
Design: one block per (stream, t, channel) holds the whole complex
intermediate V [m1, m2] in shared memory; the overlap tail that the TPU
carried over a sequential t grid is instead added with two-term
atomicAdds into an output pre-set to (tail_in, 0, ...), which is
deterministic (see the source note in the .cu file) and keeps all blocks
in flight.
"""

from __future__ import annotations

import math

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.rfft import half_bins, ifft_from_half, plan_tensors


def ifft_ola_plain(yr: torch.Tensor, yi: torch.Tensor, tail: torch.Tensor,
                   n: int):
    """Plain PyTorch version.  ``yr``/``yi``: ``[..., T, C, K]``;
    ``tail``: ``[..., C, n/2]``.  Returns ``(y [..., T, C, n/2], new_tail)``."""
    b = n // 2
    y2 = ifft_from_half(yr, yi, n)
    heads, tails = y2[..., :b], y2[..., b:]
    carry_in = torch.cat([tail.unsqueeze(-3), tails[..., :-1, :, :]], dim=-3)
    return heads + carry_in, tails[..., -1, :, :]


def ifft_ola(yr: torch.Tensor, yi: torch.Tensor, tail: torch.Tensor, n: int):
    """Inverse + overlap-add for the engine's chunk step (same contract
    as :func:`ifft_ola_plain`)."""
    if not yr.is_cuda:
        return ifft_ola_plain(yr, yi, tail, n)
    *lead, t, c, k = yr.shape
    b = n // 2
    if k != half_bins(n) or n > 16384:
        raise ValueError(f"ifft_ola: {k} bins do not fit n = {n}")
    if tuple(tail.shape) != (*lead, c, b) or yi.shape != yr.shape:
        raise ValueError(f"ifft_ola: shapes {yr.shape}, {yi.shape}, {tail.shape}")
    for a in (yr, yi, tail):
        if a.dtype != torch.float32:
            raise TypeError(f"ifft_ola takes float32, got {a.dtype}")
    s = math.prod(lead)
    yr, yi = yr.contiguous(), yi.contiguous()
    y = torch.zeros(s, t, c, b, device=yr.device, dtype=torch.float32)
    y[:, 0].copy_(tail.reshape(s, c, b))
    new_tail = torch.empty(s, c, b, device=yr.device, dtype=torch.float32)
    pt = plan_tensors(n, yr.device)
    fn = _build.function("ifft_half", "folve_ifft_ola", [
        _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.P])
    ifft_ola.launches += 1
    _build.check(fn(_build.ptr(yr), _build.ptr(yi), _build.ptr(y),
                    _build.ptr(new_tail), _build.ptr(pt.packed), s, t, c,
                    pt.m1, pt.m2, _build.stream_of(yr)), "ifft_ola")
    return y.reshape(*lead, t, c, b), new_tail.reshape(*lead, c, b)


ifft_ola.launches = 0
