"""Frequency-delay-line MAC over (history, new spectra), no window concat.

Replaces ``folve_tpu/engine/kernels/fdl_mac.py:pallas_fdl_mac_split``
(Pallas body ``_split_kernel``) with ``csrc/fdl_mac.cu`` — written in
CUDA C++ like the other kernels so that one build path serves all four
(Triton would have been allowed: the MAC is elementwise, no matrix
product).

Bound on the H100: bytes.  The MAC does 8 FLOP per complex term and
reads H, the history and the new spectra once and writes Y once: at the
flagship shape (P = 16, Cin = Cout = 2, K = 8320, T = 8, one stream) that
is 5.9 MB for 34 MFLOP, ~6 FLOP per byte, below the card's balance.
Design: one thread per (bin, t, stream) with neighbouring threads on
neighbouring bins, so every load is coalesced and each stream's
spectra stream through once; the p, Cin and Cout loops stay in
registers, and the T re-reads of a bin's H hit L2.
"""

from __future__ import annotations

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.rfft import _einsum


def fdl_mac_plain(h_spec: torch.Tensor, xall_re: torch.Tensor,
                  xall_im: torch.Tensor, t: int):
    """Y[t] = sum_p H[p] * Xall[t + (P-1) - p] over a concatenated window.

    ``h_spec``: ``[P, Cin, Cout, 2, K]``, or ``[S, P, ...]`` per stream;
    ``xall_re``/``xall_im``: ``[..., T+P-1, Cin, K]``.  Returns
    ``(yr, yi)`` each ``[..., T, Cout, K]``.  Small channel counts run
    as elementwise products, large ones as an einsum."""
    p, cin, cout = h_spec.shape[-5], h_spec.shape[-4], h_spec.shape[-3]
    if cin * cout <= 16:
        acc_r = [None] * cout
        acc_i = [None] * cout
        for pi in range(p):
            off = (p - 1) - pi
            for o in range(cout):
                for i in range(cin):
                    xr = xall_re[..., off : off + t, i, :]
                    xi = xall_im[..., off : off + t, i, :]
                    hr = h_spec[..., pi, i, o, 0, :].unsqueeze(-2)
                    hi = h_spec[..., pi, i, o, 1, :].unsqueeze(-2)
                    tr = xr * hr - xi * hi
                    ti = xr * hi + xi * hr
                    acc_r[o] = tr if acc_r[o] is None else acc_r[o] + tr
                    acc_i[o] = ti if acc_i[o] is None else acc_i[o] + ti
        return torch.stack(acc_r, dim=-2), torch.stack(acc_i, dim=-2)
    yr = yi = None
    for pi in range(p):
        off = (p - 1) - pi
        xr = xall_re[..., off : off + t, :, :]
        xi = xall_im[..., off : off + t, :, :]
        hr, hi = h_spec[..., pi, :, :, 0, :], h_spec[..., pi, :, :, 1, :]
        rr = _einsum("...tik,...iok->...tok", xr, hr)
        ii = _einsum("...tik,...iok->...tok", xi, hi)
        ri = _einsum("...tik,...iok->...tok", xr, hi)
        ir = _einsum("...tik,...iok->...tok", xi, hr)
        yr = (rr - ii) if yr is None else yr + (rr - ii)
        yi = (ri + ir) if yi is None else yi + (ri + ir)
    return yr, yi


def fdl_mac_split_plain(h_spec, hist_re, hist_im, xr, xi):
    """Plain PyTorch version of :func:`fdl_mac_split`."""
    t = xr.shape[-3]
    return fdl_mac_plain(h_spec, torch.cat([hist_re, xr], dim=-3),
                         torch.cat([hist_im, xi], dim=-3), t)


def fdl_mac_split(h_spec: torch.Tensor, hist_re: torch.Tensor,
                  hist_im: torch.Tensor, xr: torch.Tensor, xi: torch.Tensor):
    """FDL MAC without concatenation.

    ``h_spec``: ``[P, Cin, Cout, 2, K]`` (shared) or ``[S, P, Cin, Cout,
    2, K]`` (per stream); ``hist_re``/``hist_im``: ``[S, P-1, Cin, K]``
    (or unbatched ``[P-1, Cin, K]``); ``xr``/``xi``: ``[S, T, Cin, K]``
    (or ``[T, Cin, K]``).  Returns ``(yr, yi)`` each ``[S, T, Cout, K]``
    (unbatched ``[T, Cout, K]``).  Requires P >= 2."""
    if not xr.is_cuda:
        return fdl_mac_split_plain(h_spec, hist_re, hist_im, xr, xi)
    unbatched = xr.dim() == 3
    if unbatched:
        hist_re, hist_im, xr, xi = (a.unsqueeze(0)
                                    for a in (hist_re, hist_im, xr, xi))
    s, t, cin, k = xr.shape
    p, hcin, cout, two, hk = h_spec.shape[-5:]
    shared = h_spec.dim() == 5
    if (p < 2 or hcin != cin or hk != k or two != 2
            or tuple(hist_re.shape) != (s, p - 1, cin, k)
            or hist_im.shape != hist_re.shape or xi.shape != xr.shape
            or (not shared and h_spec.shape[0] != s)):
        raise ValueError(
            f"fdl_mac_split: shapes h {tuple(h_spec.shape)}, hist "
            f"{tuple(hist_re.shape)}, x {tuple(xr.shape)}")
    for a in (h_spec, hist_re, hist_im, xr, xi):
        if a.dtype != torch.float32:
            raise TypeError(f"fdl_mac_split takes float32, got {a.dtype}")
    h_spec, hist_re, hist_im, xr, xi = (
        a.contiguous() for a in (h_spec, hist_re, hist_im, xr, xi))
    yr = torch.empty(s, t, cout, k, device=xr.device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    h_stride = 0 if shared else p * cin * cout * 2 * k
    fn = _build.function("fdl_mac", "folve_fdl_mac_split", [
        _build.P, _build.L, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I,
        _build.I, _build.I, _build.P])
    fdl_mac_split.launches += 1
    _build.check(fn(_build.ptr(h_spec), h_stride, _build.ptr(hist_re),
                    _build.ptr(hist_im), _build.ptr(xr), _build.ptr(xi),
                    _build.ptr(yr), _build.ptr(yi), s, p, cin, cout, t, k,
                    _build.stream_of(xr)), "fdl_mac_split")
    if unbatched:
        return yr[0], yi[0]
    return yr, yi


fdl_mac_split.launches = 0
