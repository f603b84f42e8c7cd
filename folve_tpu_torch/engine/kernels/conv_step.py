"""Fused convolution step: forward FFT -> FDL MAC -> inverse + overlap-add
+ clipping max, in one call.

Replaces ``folve_tpu/engine/kernels/conv_step.py:_kernel`` (reached
through ``pallas_conv_step_fused_pre`` and ``pallas_conv_step_fused``)
with ``csrc/conv_step.cu``.

Bound on the H100: bytes.  At the flagship shape (n = 16384, P = 16,
Cin = Cout = 2, S = T = 8) the function moves about 46 MB (the 4.3 MB of
filter spectra once, the audio in and out, the hist carry in and out,
the tail) against 0.42 GFLOP (2.5*n*log2(n) per FFT, 8 per complex MAC
term): 0.0136 ms at 3.35 TB/s, as ``chip_smoke.py`` computes it.

Design: the TPU kernel walks the chunk's blocks in order only to keep H
and the ring of past spectra resident in VMEM; the function has no such
chain.  So the step runs as four phases, each over the whole card,
launched in order on the caller's stream: every forward FFT at once (the
radix body of ``csrc/fft_half.cu``) into scratch spectra; the MAC by
tiles of bins, each block staging its tile of H in shared memory and
reusing it for every stream, block and output channel of its group (H
read once per call at the flagship, not once per stream and block),
with the sums in registers, which also copies the new hist out; every
inverse at once with the overlap-add of ``csrc/ifft_half.cu``
(deterministic two-term atomics), which writes a ring's new rows; the
masked max|y|.  Each phase has its own block shape and registers, and a
CUDA graph captures the four launches.  See the note in the .cu file.

The hist, two ways.  Without ``head`` (a canonical state's callers) the
step copies the new hist out, oldest row first, into new buffers.  With
``head`` (the serving carry) the hist is a ring whose oldest row sits in
slot ``head``: the step reads it in place and writes only its
min(T, P-1) new spectra, over the oldest rows, in the same tensors; the
caller's head becomes ``(head + T) % (P-1)``.

Only the live paths.  A jconvolver conf defines some of its Cin x Cout
channel pairs; zita-convolver's ``Convproc`` computes only those.  The
step takes the bank's table of live paths (:func:`live_paths`: the
pairs whose spectra are not all zero) and its MAC stages, multiplies and
sums those pairs alone, in the order of the dense sum, so every output
is bit for bit the dense one.  ``conv_step_fused.mac_terms`` counts the
complex multiply-adds the launches asked for: (stream, block, partition,
path, bin).

The gate is a rule on shapes alone (:func:`fused_supported`).  A CUDA
tensor whose kernel fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from folve_tpu_torch.engine.kernels import _build
from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac_plain
from folve_tpu_torch.engine.kernels.fft_half import fft_real_half_plain
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola_plain
from folve_tpu_torch.engine.rfft import get_plan, plan_tensors
from folve_tpu_torch.utils.profiling import device_span, span


# Channels kernel 1 takes on each side: phase B's block holds one warp
# per output channel of a stream (16 warps at most), and its path table
# one 16-bit mask of outputs per input.
MAX_CHANNELS = 16


def fused_supported(p: int, cin: int, cout: int, t: int, n: int) -> bool:
    """True when the fused kernel takes these shapes (``n`` = 2*fragm):
    an FDL of at least two partitions, at most ``MAX_CHANNELS`` input and
    output channels, and an even m1 (the output block is the first m1/2
    rows of the inverse).  The caller checks that the bank is
    half-layout."""
    if p < 2 or t < 1 or not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        return False
    return get_plan(n).m1 % 2 == 0


def live_paths(h: torch.Tensor) -> tuple:
    """The (input, output) channel pairs of the spectra ``h`` [P, Cin,
    Cout, 2, K] that are not all zero, in (input, output) order: the
    paths a conf defined.  Exact: an all-zero response has an all-zero
    spectrum, and a pair left out adds only exact zeros.  Synchronizes:
    compute it once per bank."""
    p, cin, cout = h.shape[:3]
    live = h.reshape(p, cin, cout, -1).ne(0).any(dim=3).any(dim=0).cpu()
    return tuple((i, o) for i in range(cin) for o in range(cout) if live[i, o])


def all_paths(cin: int, cout: int) -> tuple:
    """Every (input, output) pair: the dense MAC."""
    return tuple((i, o) for i in range(cin) for o in range(cout))


@functools.lru_cache(maxsize=64)
def _path_masks(paths: tuple, cin: int, cout: int) -> torch.Tensor:
    """int32 [Cin] on the host: bit o of entry i is set for each path
    (i, o), as ``folve_conv_step`` reads it."""
    masks = [0] * cin
    for i, o in paths:
        if not (0 <= i < cin and 0 <= o < cout):
            raise ValueError(f"conv_step_fused: path {(i, o)} outside {cin} x {cout}")
        masks[i] |= 1 << o
    return torch.tensor(masks, dtype=torch.int32)


def fused_preshape(n: int) -> tuple[int, int, int, int]:
    """(rows, m2, m1, cols) of the fused step's pre-shaped layouts for DFT
    size ``n``: ``x5`` [S,T,Cin,rows,m2], the transposed hist carry
    [S,P-1,Cin,cols,m1], ``tail4`` [S,Cout,rows,m2].  All but the hist
    carry are plain views of the canonical flat layouts."""
    plan = get_plan(n)
    cols = plan.m2 // 2 + 1
    return plan.m1 // 2, plan.m2, plan.m1, cols


def permute_h_for_fused(h_spec: torch.Tensor, n: int) -> torch.Tensor:
    """Re-flatten canonical half-spectrum bins (k = cols*q + c) into the
    fused kernel's transposed-tile order (k' = m1*c + q).  Do this once
    per compiled filter — it is a real transpose."""
    _, _, m1, cols = fused_preshape(n)
    lead = h_spec.shape[:-1]
    r = h_spec.reshape(*lead, m1, cols)
    return r.transpose(-1, -2).reshape(*lead, m1 * cols).contiguous()


def _canonical(h: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`permute_h_for_fused` on the last axis."""
    _, _, m1, cols = fused_preshape(n)
    lead = h.shape[:-1]
    return h.reshape(*lead, cols, m1).transpose(-1, -2).reshape(*lead, m1 * cols)


def unroll_ring(hist: torch.Tensor, head: int, axis: int = 1) -> torch.Tensor:
    """The rows of a hist ring whose oldest row is slot ``head`` on
    ``axis``, oldest first."""
    return hist.roll(-head, axis) if head else hist


def conv_step_fused_plain(h_perm, x, hist_re, hist_im, tail, valid, n,
                          hist_t=False, head=None, paths=None):
    """Plain PyTorch version of :func:`conv_step_fused`: the split
    pipeline's plain versions over the stream batch, the MAC's
    elementwise products over ``paths`` (default: every pair).  With
    ``head`` it reads the ring in place and writes the new rows into it,
    as the kernel does."""
    p, cin, cout, _, k = h_perm.shape
    s, t = x.shape[0], x.shape[1]
    b = n // 2
    h = _canonical(h_perm, n)
    hr = unroll_ring(hist_re.reshape(s, p - 1, cin, k), head or 0)
    hi = unroll_ring(hist_im.reshape(s, p - 1, cin, k), head or 0)
    if hist_t:
        hr, hi = _canonical(hr, n), _canonical(hi, n)
    xr, xi = fft_real_half_plain(x.reshape(s, t, cin, b), n)
    yr, yi = fdl_mac_plain(h, torch.cat([hr, xr], dim=1), torch.cat([hi, xi], dim=1),
                           t, all_paths(cin, cout) if paths is None else paths)
    y, new_tail = ifft_ola_plain(yr, yi, tail.reshape(s, cout, b), n)
    frame = torch.arange(b, device=x.device)
    mask = frame[None, None, None, :] < valid.to(x.device)[:, :, None, None]
    mx = torch.where(mask, y.abs(), torch.zeros((), device=y.device)).amax(
        dim=(1, 2, 3))
    y = y.reshape(s, t, cout, *x.shape[3:])
    if head is not None:
        # X[t0 ..] into the slots of the oldest min(T, P-1) rows.
        t0 = t - min(t, p - 1)
        new_r, new_i = xr[:, t0:], xi[:, t0:]
        if hist_t:
            new_r, new_i = (permute_h_for_fused(a, n) for a in (new_r, new_i))
        slots = (head + torch.arange(t0, t, device=x.device)) % (p - 1)
        hist_re, hist_im = hist_re.contiguous(), hist_im.contiguous()
        hist_re.view(s, p - 1, cin, k)[:, slots] = new_r
        hist_im.view(s, p - 1, cin, k)[:, slots] = new_i
        return y, hist_re, hist_im, new_tail.reshape(tail.shape), mx
    if t >= p - 1:
        nr, ni = xr[:, t - (p - 1):], xi[:, t - (p - 1):]
    else:
        nr = torch.cat([hr[:, t:], xr], dim=1)
        ni = torch.cat([hi[:, t:], xi], dim=1)
    if hist_t:
        nr, ni = permute_h_for_fused(nr, n), permute_h_for_fused(ni, n)
    return (y, nr.reshape(hist_re.shape), ni.reshape(hist_im.shape),
            new_tail.reshape(tail.shape), mx)


def conv_step_fused(h_perm: torch.Tensor, x: torch.Tensor,
                    hist_re: torch.Tensor, hist_im: torch.Tensor,
                    tail: torch.Tensor, valid: torch.Tensor, n: int,
                    hist_t: bool = False, head: int | None = None, *,
                    paths: tuple):
    """Batched fused convolution step.

    ``h_perm``: [P, Cin, Cout, 2, K] filter spectra in transposed-tile bin
    order (:func:`permute_h_for_fused`).  ``x``: [S, T, Cin, B] or the
    pre-shaped [S, T, Cin, rows, m2].  ``hist_re``/``hist_im``: [S, P-1,
    Cin, K] canonical, or with ``hist_t`` the transposed carry [S, P-1,
    Cin, cols, m1]; oldest row first, or with ``head`` (0 <= head < P-1)
    a ring whose oldest row is slot ``head``.  ``tail``: [S, Cout, B] or
    [S, Cout, rows, m2].  ``valid``: int32 [S, T], valid frames per
    block (clipping mask).  ``n`` = 2*B.  ``paths``: the (input, output)
    pairs the MAC computes, a superset of :func:`live_paths` of
    ``h_perm`` (:func:`all_paths` for the dense MAC); the rest of Y gets
    no term.

    Returns ``(y, hist_re', hist_im', tail', max_s)``: ``y`` shaped like
    ``x`` with Cout channels, the state outputs shaped like their inputs,
    and ``max_s`` float32 [S] the masked max|y| over the chunk.  With
    ``head`` the hist outputs are the hist inputs (made contiguous),
    updated in place, with the oldest row at ``(head + T) % (P-1)``:
    the input ring is consumed.  ``conv_step_fused.ring_steps`` counts
    such calls on either path.  Each launch adds to ``launches`` and adds
    its complex multiply-adds, S x T x P x len(paths) x K, to
    ``mac_terms``: the MAC arithmetic the wrapper asked of the kernel.
    """
    if head is not None:
        p = h_perm.shape[0]
        if not 0 <= head < p - 1:
            raise ValueError(f"conv_step_fused: ring head {head} outside [0, {p - 1})")
        conv_step_fused.ring_steps += 1
    if not x.is_cuda:
        with span("kernel.conv_step_fused"):
            return conv_step_fused_plain(h_perm, x, hist_re, hist_im, tail,
                                         valid, n, hist_t, head, paths)
    with span("engine.prep"):
        p, cin, cout, two, k = h_perm.shape
        s, t = x.shape[0], x.shape[1]
        b = n // 2
        rows, m2, m1, cols = fused_preshape(n)
        if (not fused_supported(p, cin, cout, t, n) or two != 2
                or k != m1 * cols or not 128 <= n <= 16384
                or x[0, 0].numel() != cin * b
                or hist_re.numel() != s * (p - 1) * cin * k
                or hist_im.shape != hist_re.shape
                or tail.numel() != s * cout * b
                or tuple(valid.shape) != (s, t)):
            raise ValueError(
                f"conv_step_fused: unsupported shapes h {tuple(h_perm.shape)}, "
                f"x {tuple(x.shape)}, hist {tuple(hist_re.shape)}, "
                f"tail {tuple(tail.shape)}, valid {tuple(valid.shape)}")
        for a in (h_perm, x, hist_re, hist_im, tail):
            if a.dtype != torch.float32:
                raise TypeError(f"conv_step_fused takes float32, got {a.dtype}")
        h_perm, x, hist_re, hist_im, tail = (
            a.contiguous() for a in (h_perm, x, hist_re, hist_im, tail))
        valid = valid.to(device=x.device, dtype=torch.int32).contiguous()
        dev = x.device
        pt = plan_tensors(n, dev)
        masks = _path_masks(tuple(paths), cin, cout)
    with span("engine.alloc"):
        f32 = dict(device=dev, dtype=torch.float32)
        y = torch.empty(s, t, cout, *x.shape[3:], **f32)
        if head is None:
            hr_o, hi_o = torch.empty_like(hist_re), torch.empty_like(hist_im)
        else:
            hr_o, hi_o = hist_re, hist_im
        tl_o = torch.empty_like(tail)
        mx = torch.empty(s, **f32)
        # Scratch spectra of the forward and the MAC.
        xs = torch.empty(s, t, cin, 2, k, **f32)
        ys = torch.empty(s, t, cout, 2, k, **f32)
    with device_span("kernel.conv_step_fused"):
        P_, I_ = _build.P, _build.I
        fn = _build.function("conv_step", "folve_conv_step",
                             [P_] * 14 + [I_] * 9 + [P_, P_])
        conv_step_fused.launches += 1
        conv_step_fused.mac_terms += s * t * p * len(paths) * k
        _build.check(fn(*(_build.ptr(a) for a in (
            h_perm, x, hist_re, hist_im, tail, valid, y, hr_o, hi_o, tl_o, mx,
            xs, ys, pt.packed)), s, p, cin, cout, t, m1, m2,
            int(hist_t), -1 if head is None else head, _build.ptr(masks),
            _build.stream_of(x)),
            "conv_step_fused")
    return y, hr_o, hi_o, tl_o, mx


conv_step_fused.launches = 0
conv_step_fused.ring_steps = 0
conv_step_fused.mac_terms = 0
