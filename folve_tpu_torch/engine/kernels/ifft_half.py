"""Inverse FFT from the half spectrum, fused with the overlap-add or over
a window of k1 rows.

Replaces ``folve_tpu/engine/kernels/ifft_half.py:pallas_ifft_ola``
(Pallas body ``_ola_kernel``) with ``csrc/ifft_half.cu``, and the two
callers of that file's ``_kernel`` with one CUDA kernel over a k1-row
window: :func:`ifft_partial_rows` (``pallas_ifft_partial_rows``: one
frequency shard's partial inverse, before the sum over shards) and
:func:`ifft_from_half` (``pallas_ifft_from_half``: the window of all
rows, the whole inverse; the engine has no caller for it, as the JAX
package has none).

Bound on the H100: bytes.  Per block and channel at n = 16384 the
kernel reads 66 KB of spectrum and writes 32 KB of audio (plus the tail),
and a real inverse FFT needs 2.5*n*log2(n) = 0.57 MFLOP of it: ~6 FLOP
per byte, below the card's fp32 balance of ~20.  Design: one kernel body
for both entry points, templated on its epilogue; one block per signal
(per (stream, t, channel) for the overlap-add) runs the inverse of the
four-step split as radix FFTs (``csrc/fft_radix.cuh``) with the complex
intermediate in shared memory, so device memory sees each byte once;
the window's rows alone enter stage 1, and the zero columns c >= cols
prune its first layer.  The overlap tail that the TPU carried over a
sequential t grid is instead added with two-term atomicAdds into an
output pre-set to (tail_in, 0, ...), which is deterministic (see the
source note in the .cu file) and keeps all blocks in flight.
"""

from __future__ import annotations

import math

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine import rfft
from folve_tpu_torch.engine.rfft import half_bins, plan_tensors


def ifft_ola_plain(yr: torch.Tensor, yi: torch.Tensor, tail: torch.Tensor,
                   n: int):
    """Plain PyTorch version.  ``yr``/``yi``: ``[..., T, C, K]``;
    ``tail``: ``[..., C, n/2]``.  Returns ``(y [..., T, C, n/2], new_tail)``."""
    b = n // 2
    y2 = rfft.ifft_from_half(yr, yi, n)
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
    if k != half_bins(n) or not 128 <= n <= 16384:
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


def ifft_partial_rows_plain(yr: torch.Tensor, yi: torch.Tensor, n: int,
                            k1_start: int, k1_n: int) -> torch.Tensor:
    """Plain PyTorch version: ``engine.rfft.ifft_from_half`` over the
    window."""
    return rfft.ifft_from_half(yr, yi, n, k1_start=k1_start, k1_n=k1_n)


def ifft_from_half_plain(yr: torch.Tensor, yi: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Plain PyTorch version: ``engine.rfft.ifft_from_half``."""
    return rfft.ifft_from_half(yr, yi, n)


def _inverse_rows(wrapper, yr, yi, n: int, k1_start: int,
                  k1_n: int) -> torch.Tensor:
    """Launch ``csrc/ifft_half.cu``'s row-window inverse for ``wrapper``
    (whose launch count it raises): ``yr``/``yi`` ``[..., k1_n * cols]``
    -> float32 ``[..., n]``."""
    what = wrapper.__name__
    pt = plan_tensors(n, yr.device)
    cols = pt.m2 // 2 + 1
    if (not 128 <= n <= 16384 or yr.shape[-1] != k1_n * cols
            or yi.shape != yr.shape):
        raise ValueError(f"{what}: shapes {tuple(yr.shape)}, "
                         f"{tuple(yi.shape)} do not fit n = {n}, k1_n = {k1_n}")
    if k1_n < 1 or k1_start < 0 or k1_start + k1_n > pt.m1:
        raise ValueError(f"{what}: window ({k1_start}, {k1_n}) outside "
                         f"{pt.m1} rows")
    for a in (yr, yi):
        if a.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {a.dtype}")
    yr, yi = yr.contiguous(), yi.contiguous()
    batch = yr.shape[:-1]
    out = torch.empty(*batch, n, device=yr.device, dtype=torch.float32)
    P_, I_ = _build.P, _build.I
    fn = _build.function("ifft_half", "folve_ifft_partial_rows",
                         [P_, P_, P_, P_, I_, I_, I_, I_, I_, P_])
    wrapper.launches += 1
    _build.check(fn(_build.ptr(yr), _build.ptr(yi), _build.ptr(out),
                    _build.ptr(pt.packed), math.prod(batch), pt.m1, pt.m2,
                    k1_start, k1_n, _build.stream_of(yr)), what)
    return out


def ifft_partial_rows(yr: torch.Tensor, yi: torch.Tensor, n: int,
                      k1_start: int, k1_n: int) -> torch.Tensor:
    """This k1 window's partial inverse (kernel 7).  ``yr``/``yi``:
    ``[..., k1_n * cols]``, the unweighted half-spectrum rows ``[k1_start,
    k1_start + k1_n)``.  Returns float32 ``[..., n]``: summed over
    windows that tile the M1 rows, the inverse."""
    if not yr.is_cuda:
        return ifft_partial_rows_plain(yr, yi, n, k1_start, k1_n)
    return _inverse_rows(ifft_partial_rows, yr, yi, n, k1_start, k1_n)


ifft_partial_rows.launches = 0


def ifft_from_half(yr: torch.Tensor, yi: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse from the half spectrum ``[..., half_bins(n)]`` to a real
    signal ``[..., n]`` (kernel 8: kernel 7's CUDA kernel over all rows)."""
    if not yr.is_cuda:
        return ifft_from_half_plain(yr, yi, n)
    m1 = plan_tensors(n, yr.device).m1
    return _inverse_rows(ifft_from_half, yr, yi, n, 0, m1)


ifft_from_half.launches = 0
