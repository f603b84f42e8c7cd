"""Frequency-delay-line MAC: Y[t] = sum_p H[p] * X[t + P-1 - p].

Two kernels in ``csrc/fdl_mac.cu``, both CUDA C++ (Triton would have been
allowed: the MAC is elementwise, no matrix product):

* :func:`fdl_mac_split` replaces
  ``folve_tpu/engine/kernels/fdl_mac.py:pallas_fdl_mac_split`` (Pallas
  body ``_split_kernel``): history and new spectra as two inputs, no
  window concat; the route for P >= 2 with min(P, T) <= 32.
* :func:`fdl_mac` replaces ``pallas_fdl_mac`` (Pallas body ``_kernel``):
  the same MAC over one concatenated ``[T+P-1]`` window; the route for a
  single partition (P = 1, every filter of at most one fragment) and for
  deep FDLs with min(P, T) > 32.

On the split route more than 16 channel pairs take
:func:`fdl_mac_einsum`, a plain einsum, as the JAX package leaves them to
XLA and not to a kernel (:func:`folve_tpu_torch.engine.stream.mac_route`
holds the rule).  The serving steps' shared banks of up to 16 x 16
channels (the 5.1 and 7.1 confs among them) do not come here: kernel 1
(``conv_step.py``) takes them, its MAC over the live paths alone.

Bound on the H100: bytes.  The MAC does 8 FLOP per complex term and
reads H, the history and the new spectra once and writes Y once: at the
flagship shape (P = 16, Cin = Cout = 2, K = 8320, T = 8, one stream) that
is 5.9 MB for 34 MFLOP, ~6 FLOP per byte, below the card's balance.  At
P = 128 and T = 64 (one stream) the window kernel's 2.2 GFLOP against
~68 MB make it bound by operations instead.
Design: both kernels run one tiled body and differ only in where a
window row comes from.  A block takes a tile of bins and a group of
streams and chunks of 8 blocks t; per input channel and pass of
partitions it stages H's tile and the window rows in shared memory, and
each warp keeps the sums of (stream, output channel, 8 blocks) for 32
bins in registers while the window rows slide through registers.  Each
H value is read from device memory once per block, so once per call at
the shapes the engine runs; a block with per-stream H takes one stream
and a wider tile of bins (the source's header says how the launcher
picks the tile).
"""

from __future__ import annotations

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.rfft import _einsum
from folve_tpu_torch.utils.profiling import device_span, span


def fdl_mac_einsum(h_spec: torch.Tensor, xall_re: torch.Tensor,
                   xall_im: torch.Tensor, t: int):
    """The MAC over a concatenated window as one einsum per partition:
    the split route's MAC for more than 16 channel pairs (shapes as
    :func:`fdl_mac_plain`); kernel 1 takes the serving steps' shared
    banks of up to 16 x 16."""
    p = h_spec.shape[-5]
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


def fdl_mac_plain(h_spec: torch.Tensor, xall_re: torch.Tensor,
                  xall_im: torch.Tensor, t: int, paths=None):
    """Y[t] = sum_p H[p] * Xall[t + (P-1) - p] over a concatenated window:
    the plain version of :func:`fdl_mac`.

    ``h_spec``: ``[P, Cin, Cout, 2, K]``, or ``[S, P, ...]`` per stream;
    ``xall_re``/``xall_im``: ``[..., T+P-1, Cin, K]``.  Returns
    ``(yr, yi)`` each ``[..., T, Cout, K]``.  Small channel counts run
    as elementwise products, large ones as :func:`fdl_mac_einsum`.  With
    ``paths``, (input, output) pairs, the elementwise products run over
    those pairs alone: where the pairs left out have all-zero H, the
    sums equal the dense ones bit for bit (they only skip exact zeros).
    ``fdl_mac_plain.cuda_calls`` counts calls on CUDA tensors: the engine
    never makes one (a card runs the kernels), only comparisons do."""
    if xall_re.is_cuda:
        fdl_mac_plain.cuda_calls += 1
    p, cin, cout = h_spec.shape[-5], h_spec.shape[-4], h_spec.shape[-3]
    if paths is None:
        if cin * cout > 16:
            return fdl_mac_einsum(h_spec, xall_re, xall_im, t)
        paths = [(i, o) for i in range(cin) for o in range(cout)]
    # Per output, its inputs in order, as the dense loop sums them.
    paths = sorted(paths, key=lambda io: (io[1], io[0]))
    acc_r = [None] * cout
    acc_i = [None] * cout
    for pi in range(p):
        off = (p - 1) - pi
        for i, o in paths:
            xr = xall_re[..., off : off + t, i, :]
            xi = xall_im[..., off : off + t, i, :]
            hr = h_spec[..., pi, i, o, 0, :].unsqueeze(-2)
            hi = h_spec[..., pi, i, o, 1, :].unsqueeze(-2)
            tr = xr * hr - xi * hi
            ti = xr * hi + xi * hr
            acc_r[o] = tr if acc_r[o] is None else acc_r[o] + tr
            acc_i[o] = ti if acc_i[o] is None else acc_i[o] + ti
    shape = (*xall_re.shape[:-3], t, xall_re.shape[-1])
    zero = xall_re.new_zeros(shape)
    return (torch.stack([zero if a is None else a for a in acc_r], dim=-2),
            torch.stack([zero if a is None else a for a in acc_i], dim=-2))


fdl_mac_plain.cuda_calls = 0


def fdl_mac(h_spec: torch.Tensor, xall_re: torch.Tensor,
            xall_im: torch.Tensor, t: int):
    """FDL MAC over a concatenated window (kernel 5).

    ``h_spec``: ``[P, Cin, Cout, 2, K]`` (shared) or ``[S, P, Cin, Cout,
    2, K]`` (per stream); ``xall_re``/``xall_im``: ``[S, T+P-1, Cin, K]``
    (or unbatched ``[T+P-1, Cin, K]``).  Returns ``(yr, yi)`` each
    ``[S, T, Cout, K]`` (unbatched ``[T, Cout, K]``).  At most 16
    channel pairs."""
    if not xall_re.is_cuda:
        with span("kernel.fdl_mac"):
            return fdl_mac_plain(h_spec, xall_re, xall_im, t)
    with span("engine.prep"):
        unbatched = xall_re.dim() == 3
        if unbatched:
            xall_re, xall_im = xall_re.unsqueeze(0), xall_im.unsqueeze(0)
        s, w, cin, k = xall_re.shape
        p, hcin, cout, two, hk = h_spec.shape[-5:]
        shared = h_spec.dim() == 5
        if (h_spec.dim() not in (5, 6) or t < 1 or w != t + p - 1
                or hcin != cin or hk != k or two != 2 or cin * cout > 16
                or xall_im.shape != xall_re.shape
                or (not shared and h_spec.shape[0] != s)):
            raise ValueError(
                f"fdl_mac: shapes h {tuple(h_spec.shape)}, xall "
                f"{tuple(xall_re.shape)}, t {t}")
        for a in (h_spec, xall_re, xall_im):
            if a.dtype != torch.float32:
                raise TypeError(f"fdl_mac takes float32, got {a.dtype}")
        h_spec, xall_re, xall_im = (a.contiguous() for a in (h_spec, xall_re, xall_im))
    with span("engine.alloc"):
        yr = torch.empty(s, t, cout, k, device=xall_re.device, dtype=torch.float32)
        yi = torch.empty_like(yr)
    h_stride = 0 if shared else p * cin * cout * 2 * k
    with device_span("kernel.fdl_mac"):
        fn = _build.function("fdl_mac", "folve_fdl_mac", [
            _build.P, _build.L, _build.P, _build.P, _build.P, _build.P,
            _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.P])
        fdl_mac.launches += 1
        _build.check(fn(_build.ptr(h_spec), h_stride, _build.ptr(xall_re),
                        _build.ptr(xall_im), _build.ptr(yr), _build.ptr(yi),
                        s, p, cin, cout, t, k, _build.stream_of(xall_re)),
                     "fdl_mac")
    if unbatched:
        return yr[0], yi[0]
    return yr, yi


fdl_mac.launches = 0


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
        with span("kernel.fdl_mac_split"):
            return fdl_mac_split_plain(h_spec, hist_re, hist_im, xr, xi)
    with span("engine.prep"):
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
    with span("engine.alloc"):
        yr = torch.empty(s, t, cout, k, device=xr.device, dtype=torch.float32)
        yi = torch.empty_like(yr)
    h_stride = 0 if shared else p * cin * cout * 2 * k
    with device_span("kernel.fdl_mac_split"):
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
