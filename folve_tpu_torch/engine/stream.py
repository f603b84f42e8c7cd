"""Streaming partitioned convolution — the device engine (PyTorch port).

Semantics match the reference's uniform partitioned scheme (quantum =
minpart = maxpart = fragm): the output equals plain linear convolution
of the input with the impulse response, computed block by block with
overlap-add.  In a uniform frequency-delay-line (FDL) scheme output
block ``t`` depends only on the input spectra of blocks ``t-P+1 .. t``
and the previous block's overlap tail, so a whole chunk of ``T`` blocks
runs in one device step; the carried state is the last ``P-1`` input
spectra and one ``fragm``-frame tail.

Every step here takes an explicit stream batch (the JAX package's
``vmap``).  Routing follows the tensors' device: on CUDA the kernels of
:mod:`folve_tpu_torch.engine.kernels` run, on the CPU their plain
versions.  Layouts are the JAX package's: spectra are (re, im) float32
planes in the permuted bin layout of :mod:`folve_tpu_torch.engine.rfft`.
"""

from __future__ import annotations

import dataclasses
import typing
import weakref

import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.engine.kernels.conv_step import (
    conv_step_fused,
    fused_preshape,
    fused_supported,
    permute_h_for_fused,
)
from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac_plain, fdl_mac_split
from folve_tpu_torch.engine.kernels.fft_half import fft_real_half
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola
from folve_tpu_torch.engine.rfft import fft_real, half_bins, ifft_to_real


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Per-stream carried convolution state (a leading stream axis on
    every field when batched).

    ``hist_re``/``hist_im``: float32 ``[P-1, Cin, K]`` — spectra of the
    most recent ``P-1`` input blocks, oldest first.  ``tail``: float32
    ``[Cout, fragm]`` — the overlap-add carry.  ``max_abs``: float32
    scalar — running max |output| over frames the caller declared valid
    (the clipping monitor)."""

    hist_re: torch.Tensor
    hist_im: torch.Tensor
    tail: torch.Tensor
    max_abs: torch.Tensor


def init_state(bank: FilterBank, device="cuda") -> StreamState:
    dev = resolve_device(device)
    p, cin, cout, _, k = bank.h_spec.shape
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return StreamState(hist_re=z(p - 1, cin, k), hist_im=z(p - 1, cin, k),
                       tail=z(cout, bank.fragm), max_abs=z())


def reset_state(state: StreamState, reset_max: bool = True) -> StreamState:
    """Re-arm a state for a fresh stream."""
    return StreamState(
        hist_re=torch.zeros_like(state.hist_re),
        hist_im=torch.zeros_like(state.hist_im),
        tail=torch.zeros_like(state.tail),
        max_abs=torch.zeros_like(state.max_abs) if reset_max else state.max_abs,
    )


def stack_states(states: typing.Sequence[StreamState]) -> StreamState:
    return StreamState(*(torch.stack([getattr(s, f.name) for s in states])
                         for f in dataclasses.fields(StreamState)))


def unstack_state(states: StreamState, i: int) -> StreamState:
    return StreamState(*(getattr(states, f.name)[i]
                         for f in dataclasses.fields(StreamState)))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _n_valid(n_valid, s: int, default: int, device) -> torch.Tensor:
    if n_valid is None:
        n_valid = default
    return torch.as_tensor(n_valid, device=device).to(torch.int64).expand(s)


def _batched_step(h_spec: torch.Tensor, fragm: int, states: StreamState,
                  x: torch.Tensor, n_valid: torch.Tensor):
    """The engine step over a stream batch.  ``h_spec``: shared
    ``[P, Cin, Cout, 2, K]`` or per-stream ``[S, P, ...]``; ``states``
    batched; ``x``: ``[S, T, Cin, fragm]``; ``n_valid``: ``[S]``."""
    p, cin, cout, _, k = h_spec.shape[-5:]
    b = fragm
    n = 2 * b
    s, t = x.shape[0], x.shape[1]
    if x.shape[2] != cin or x.shape[3] != b:
        raise ValueError(f"x must be [S, T, {cin}, {b}], got {tuple(x.shape)}")
    half = k == half_bins(n) and k != n

    # 1. Block spectra of each block zero-padded to 2*fragm.
    if half:
        xr, xi = fft_real_half(x, n)
    else:
        xr, xi = fft_real(x, n)

    # 2. FDL MAC against all partitions.  The split kernel reads history
    # and new spectra as two inputs; P = 1 and wide channel counts run
    # the plain MAC over the concatenated window.
    if p >= 2 and cin * cout <= 16:
        y_re, y_im = fdl_mac_split(h_spec, states.hist_re, states.hist_im,
                                   xr, xi)
        if t >= p - 1:
            new_re, new_im = xr[:, t - (p - 1):], xi[:, t - (p - 1):]
        else:
            new_re = torch.cat([states.hist_re[:, t:], xr], dim=1)
            new_im = torch.cat([states.hist_im[:, t:], xi], dim=1)
    else:
        xall_re = torch.cat([states.hist_re, xr], dim=1)
        xall_im = torch.cat([states.hist_im, xi], dim=1)
        y_re, y_im = fdl_mac_plain(h_spec, xall_re, xall_im, t)
        new_re, new_im = xall_re[:, t:], xall_im[:, t:]

    # 3. Inverse FFT + overlap-add between consecutive blocks.
    if half:
        y, new_tail = ifft_ola(y_re, y_im, states.tail, n)
    else:
        y2 = ifft_to_real(y_re, y_im, n)
        heads, tails = y2[..., :b], y2[..., b:]
        carry_in = torch.cat([states.tail[:, None], tails[:, :-1]], dim=1)
        y = heads + carry_in
        new_tail = tails[:, -1]

    # 4. Clipping monitor over valid frames only.
    frame = (torch.arange(t, device=x.device)[:, None] * b
             + torch.arange(b, device=x.device)[None, :])
    valid = frame[None, :, None, :] < n_valid[:, None, None, None]
    blk = torch.where(valid, y.abs(), torch.zeros((), device=y.device))
    max_abs = torch.maximum(states.max_abs, blk.amax(dim=(1, 2, 3)))
    return StreamState(new_re.contiguous(), new_im.contiguous(),
                       new_tail.contiguous(), max_abs), y


def chunk_step(bank: FilterBank, state: StreamState, x, n_valid=None):
    """Convolve ``T`` full input blocks ``x`` [T, Cin, fragm] in one
    device step.  Partial final blocks are zero-padded by the caller;
    ``n_valid`` = genuine frames in the chunk (clipping monitor).
    Returns ``(new_state, y)`` with ``y`` float32 [T, Cout, fragm]."""
    x = _f32(x, bank.device)
    t = x.shape[0]
    nv = _n_valid(n_valid, 1, t * bank.fragm, bank.device)
    new, y = _batched_step(bank.h_spec, bank.fragm, stack_states([state]),
                           x[None], nv)
    return unstack_state(new, 0), y[0]


def block_step(bank: FilterBank, state: StreamState, x):
    """Single-block convenience wrapper: ``x`` is [Cin, fragm]."""
    state, y = chunk_step(bank, state, _f32(x, bank.device)[None])
    return state, y[0]


def batched_chunk_step(bank: FilterBank, states: StreamState, x, n_valid):
    """Many streams with per-stream filters of one shape: ``bank.h_spec``
    is [S, P, Cin, Cout, 2, K], ``states`` batched, ``x`` [S, T, Cin,
    fragm], ``n_valid`` [S]."""
    x = _f32(x, bank.device)
    nv = _n_valid(n_valid, x.shape[0], x.shape[1] * bank.fragm, bank.device)
    return _batched_step(bank.h_spec, bank.fragm, states, x, nv)


# Many streams through one shared filter: the same step with an
# unbatched bank (the MAC broadcasts the spectra over the streams).
shared_filter_chunk_step = batched_chunk_step


# Pre-permuted fused-kernel spectra per bank: the permute is a real
# device transpose, done once per compiled filter, not per step.
_H_PERM: "weakref.WeakKeyDictionary[FilterBank, torch.Tensor]" = (
    weakref.WeakKeyDictionary())


def fused_serving_supported(bank: FilterBank, t: int) -> bool:
    """True when a serving step of ``t`` blocks runs as the one fused
    kernel: a half-layout bank of a shape the kernel takes."""
    p, cin, cout, _, k = bank.h_spec.shape[-5:]
    n = 2 * bank.fragm
    if k != half_bins(n) or k == n:
        return False
    return fused_supported(p, cin, cout, t, n)


def eager_h_perm(bank: FilterBank):
    """Pre-permuted fused-kernel filter spectra for ``bank``, or None
    when the bank cannot take the fused route; cached per bank."""
    if not fused_serving_supported(bank, 1):
        return None
    hit = _H_PERM.get(bank)
    if hit is None:
        hit = permute_h_for_fused(bank.h_spec, 2 * bank.fragm)
        _H_PERM[bank] = hit
    return hit


def _valid_frames(n_valid: torch.Tensor, t: int, b: int) -> torch.Tensor:
    blk = torch.arange(t, device=n_valid.device) * b
    return torch.clamp(n_valid[:, None] - blk[None, :], 0, b).to(torch.int32)


def serving_chunk_step(bank: FilterBank, states: StreamState, x, n_valid,
                       h_perm=None):
    """Batched shared-filter serving step: ``states`` batched, ``x``
    [S, T, Cin, fragm], ``n_valid`` [S].  Runs as the one fused kernel
    when the shape allows (:func:`fused_serving_supported`), else as the
    split three-kernel step; same semantics either way."""
    x = _f32(x, bank.device)
    s, t = x.shape[0], x.shape[1]
    nv = _n_valid(n_valid, s, t * bank.fragm, bank.device)
    if not fused_serving_supported(bank, t):
        return _batched_step(bank.h_spec, bank.fragm, states, x, nv)
    y, hr, hi, tl, mx = conv_step_fused(
        h_perm if h_perm is not None else eager_h_perm(bank),
        x, states.hist_re, states.hist_im, states.tail,
        _valid_frames(nv, t, bank.fragm), 2 * bank.fragm)
    return StreamState(hr, hi, tl, torch.maximum(states.max_abs, mx)), y


def single_chunk_step(bank: FilterBank, state: StreamState, x,
                      n_valid=None, h_perm=None):
    """:func:`chunk_step` for one stream, through the fused kernel when
    the shape allows (the lone-stream pump)."""
    x = _f32(x, bank.device)
    t = x.shape[0]
    if not fused_serving_supported(bank, t):
        return chunk_step(bank, state, x, n_valid)
    new, y = serving_chunk_step(bank, stack_states([state]), x[None],
                                t * bank.fragm if n_valid is None else n_valid,
                                h_perm)
    return unstack_state(new, 0), y[0]


class FusedServingCarry(typing.NamedTuple):
    """Batched serving state in the fused kernel's pre-shaped layouts.

    ``hist_re``/``hist_im``: [S, P-1, Cin, cols, m1] — the kernel's
    transposed tile layout; ``tail``: [S, Cout, rows, m2]; ``max_abs``:
    [S].  Convert with :func:`carry_from_states` /
    :func:`states_from_carry`."""

    hist_re: torch.Tensor
    hist_im: torch.Tensor
    tail: torch.Tensor
    max_abs: torch.Tensor


def fused_carry_init(bank: FilterBank, s: int) -> FusedServingCarry:
    p, cin, cout, _, k = bank.h_spec.shape
    rows, m2, m1, cols = fused_preshape(2 * bank.fragm)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=bank.device)
    return FusedServingCarry(z(s, p - 1, cin, cols, m1),
                             z(s, p - 1, cin, cols, m1),
                             z(s, cout, rows, m2), z(s))


def carry_from_states(bank: FilterBank, states: StreamState) -> FusedServingCarry:
    """Batched StreamState (canonical flat bins) -> pre-shaped carry."""
    p, cin, cout, _, k = bank.h_spec.shape
    rows, m2, m1, cols = fused_preshape(2 * bank.fragm)
    s = states.hist_re.shape[0]
    tr = lambda h: h.reshape(s, p - 1, cin, m1, cols).transpose(-1, -2).contiguous()
    return FusedServingCarry(tr(states.hist_re), tr(states.hist_im),
                             states.tail.reshape(s, cout, rows, m2),
                             states.max_abs)


def states_from_carry(bank: FilterBank, carry: FusedServingCarry) -> StreamState:
    """Inverse of :func:`carry_from_states`."""
    p, cin, cout, _, k = bank.h_spec.shape
    s = carry.hist_re.shape[0]
    untr = lambda h: h.transpose(-1, -2).reshape(s, p - 1, cin, k)
    return StreamState(untr(carry.hist_re), untr(carry.hist_im),
                       carry.tail.reshape(s, cout, bank.fragm), carry.max_abs)


def stage_x_for_fused(bank: FilterBank, x):
    """[S, T, Cin, fragm] audio -> the kernel's [S, T, Cin, rows, m2]
    view (numpy or tensor; a free reshape)."""
    rows, m2, m1, cols = fused_preshape(2 * bank.fragm)
    s, t, cin, b = x.shape
    return x.reshape(s, t, cin, rows, m2)


def fused_serving_step_pre(bank: FilterBank, carry: FusedServingCarry, x5,
                           n_valid, h_perm=None):
    """Steady-state fused serving step on pre-shaped arrays: ``x5``
    [S, T, Cin, rows, m2]; returns ``(carry', y5)`` with ``y5`` [S, T,
    Cout, rows, m2].  Same semantics as :func:`serving_chunk_step`."""
    x5 = _f32(x5, bank.device)
    s, t = x5.shape[0], x5.shape[1]
    nv = _n_valid(n_valid, s, t * bank.fragm, bank.device)
    y5, hr, hi, tl, mx = conv_step_fused(
        h_perm if h_perm is not None else eager_h_perm(bank),
        x5, carry.hist_re, carry.hist_im, carry.tail,
        _valid_frames(nv, t, bank.fragm), 2 * bank.fragm, hist_t=True)
    return FusedServingCarry(hr, hi, tl, torch.maximum(carry.max_abs, mx)), y5
