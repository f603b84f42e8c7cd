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
versions; the MAC's kernel follows the shapes (:func:`mac_route`).
Layouts are the JAX package's: spectra are (re, im) float32 planes in the
permuted bin layout of :mod:`folve_tpu_torch.engine.rfft`.

The freq-sharded step is split around its one reduction:
:func:`shard_partial_step` runs on each shard's k1 rows and
:func:`finish_sharded_step` on the summed partials
(:mod:`folve_tpu_torch.parallel.serving` runs both and the sum).
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
    unroll_ring,
)
from folve_tpu_torch.engine.kernels.fdl_mac import (
    fdl_mac,
    fdl_mac_einsum,
    fdl_mac_split,
)
from folve_tpu_torch.engine.kernels.fft_half import (
    fft_real_half,
    fft_real_half_rows,
)
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola, ifft_partial_rows
from folve_tpu_torch.engine.rfft import (
    fft_real,
    get_plan,
    half_bins,
    ifft_to_real,
)
from folve_tpu_torch.utils.profiling import device_span, span

# Partitions the split MAC kernel takes below T (the JAX package's
# _UNROLL_LIMIT): past it the window kernel runs.
SPLIT_LIMIT = 32


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


def mac_route(p: int, cin: int, cout: int, t: int) -> str:
    """Which MAC runs for these shapes, mirroring the JAX package's
    ``chunk_step``: ``"einsum"`` past 16 channel pairs (XLA there, no
    kernel), ``"split"`` (:func:`fdl_mac_split`) for P >= 2 with
    min(P, T) <= 32, else ``"window"`` (:func:`fdl_mac` over the
    concatenated [T+P-1] window: P = 1, or a deep FDL)."""
    if cin * cout > 16:
        return "einsum"
    if p >= 2 and min(p, t) <= SPLIT_LIMIT:
        return "split"
    return "window"


def _mac(h_spec: torch.Tensor, hist_re: torch.Tensor, hist_im: torch.Tensor,
         xr: torch.Tensor, xi: torch.Tensor):
    """FDL MAC of the new spectra ``xr``/``xi`` [S, T, Cin, K] against
    all partitions; returns ``(y_re, y_im, hist_re', hist_im')``."""
    p, cin, cout = h_spec.shape[-5:-2]
    t = xr.shape[1]
    route = mac_route(p, cin, cout, t)
    if route == "split":
        y_re, y_im = fdl_mac_split(h_spec, hist_re, hist_im, xr, xi)
        if t >= p - 1:
            return y_re, y_im, xr[:, t - (p - 1):], xi[:, t - (p - 1):]
        with device_span("engine.state"):
            return (y_re, y_im, torch.cat([hist_re[:, t:], xr], dim=1),
                    torch.cat([hist_im[:, t:], xi], dim=1))
    # P = 1: the window is the new spectra alone (no empty hist joins it).
    with span("engine.prep"):
        xall_re = torch.cat([hist_re, xr], dim=1) if p > 1 else xr
        xall_im = torch.cat([hist_im, xi], dim=1) if p > 1 else xi
    mac = fdl_mac if route == "window" else fdl_mac_einsum
    y_re, y_im = mac(h_spec, xall_re, xall_im, t)
    return y_re, y_im, xall_re[:, t:], xall_im[:, t:]


def _check_x(h_spec: torch.Tensor, fragm: int, x: torch.Tensor) -> None:
    cin = h_spec.shape[-4]
    if x.dim() != 4 or x.shape[2] != cin or x.shape[3] != fragm:
        raise ValueError(
            f"x must be [S, T, {cin}, {fragm}], got {tuple(x.shape)}")


def _overlap_add(y2: torch.Tensor, tail: torch.Tensor):
    """Heads of the length-2B blocks ``y2`` [S, T, Cout, 2B] plus the
    previous block's tail ``tail`` [S, Cout, B]; returns ``(y,
    new_tail)``."""
    b = tail.shape[-1]
    heads, tails = y2[..., :b], y2[..., b:]
    with device_span("engine.state"):
        carry_in = torch.cat([tail[:, None], tails[:, :-1]], dim=1)
        return heads + carry_in, tails[:, -1]


def _monitor(y: torch.Tensor, max_abs: torch.Tensor,
             n_valid: torch.Tensor) -> torch.Tensor:
    """The clipping monitor: running max |y| over valid frames only."""
    t, b = y.shape[1], y.shape[3]
    with device_span("engine.monitor"):
        frame = (torch.arange(t, device=y.device)[:, None] * b
                 + torch.arange(b, device=y.device)[None, :])
        valid = frame[None, :, None, :] < n_valid.to(y.device)[:, None, None, None]
        blk = torch.where(valid, y.abs(), torch.zeros((), device=y.device))
        return torch.maximum(max_abs, blk.amax(dim=(1, 2, 3)))


def _batched_step(h_spec: torch.Tensor, fragm: int, states: StreamState,
                  x: torch.Tensor, n_valid: torch.Tensor):
    """The engine step over a stream batch.  ``h_spec``: shared
    ``[P, Cin, Cout, 2, K]`` or per-stream ``[S, P, ...]``; ``states``
    batched; ``x``: ``[S, T, Cin, fragm]``; ``n_valid``: ``[S]``."""
    k = h_spec.shape[-1]
    n = 2 * fragm
    _check_x(h_spec, fragm, x)
    half = k == half_bins(n) and k != n

    # 1. Block spectra of each block zero-padded to 2*fragm.
    xr, xi = fft_real_half(x, n) if half else fft_real(x, n)
    # 2. FDL MAC against all partitions (route: mac_route).
    y_re, y_im, new_re, new_im = _mac(h_spec, states.hist_re, states.hist_im,
                                      xr, xi)
    # 3. Inverse FFT + overlap-add between consecutive blocks.
    if half:
        y, new_tail = ifft_ola(y_re, y_im, states.tail, n)
    else:
        y, new_tail = _overlap_add(ifft_to_real(y_re, y_im, n), states.tail)
    # 4. Clipping monitor over valid frames only.
    max_abs = _monitor(y, states.max_abs, n_valid)
    with device_span("engine.state"):
        return StreamState(new_re.contiguous(), new_im.contiguous(),
                           new_tail.contiguous(), max_abs), y


def _k1_window(fragm: int, bins: int, freq_shards: int,
               shard: int) -> tuple[int, int, bool]:
    """``(k1_start, k1_n, half)`` of frequency shard ``shard`` of
    ``freq_shards`` for a bank of ``bins`` local bins at block length
    ``fragm``: the shard holds k1 rows ``[k1_start, k1_start + k1_n)``
    of the permuted spectrum."""
    n = 2 * fragm
    plan = get_plan(n)
    k_global = bins * freq_shards
    half = k_global == half_bins(n) and k_global != n
    if plan.m1 % freq_shards:
        raise ValueError(
            f"M1={plan.m1} rows not divisible by freq_shards={freq_shards}")
    k1_n = plan.m1 // freq_shards
    cols = plan.m2 // 2 + 1 if half else plan.m2
    if bins != k1_n * cols:
        raise ValueError(
            f"local bins {bins} != k1_n*cols = {k1_n}*{cols} (bad shard layout)")
    return shard * k1_n, k1_n, half


def shard_partial_step(h_spec: torch.Tensor, fragm: int,
                       hist_re: torch.Tensor, hist_im: torch.Tensor,
                       x: torch.Tensor, freq_shards: int, shard: int):
    """One frequency shard's part of the engine step (the JAX package's
    ``chunk_step`` with ``freq_axis``, up to its ``psum``).

    ``h_spec`` and ``hist_re``/``hist_im`` hold only this shard's k1 rows
    of the permuted spectrum (``K_local = K / freq_shards`` bins, in the
    shapes of :func:`_batched_step`); ``x`` [S, T, Cin, fragm] is the
    whole input.  The forward transform computes the local rows, the MAC
    is elementwise in bins, and the inverse stops at this shard's partial
    stage-2 sum.  Returns ``(partial, hist_re', hist_im')`` with
    ``partial`` [S, T, Cout, 2*fragm]: the sum of all shards' partials
    (:func:`finish_sharded_step`) is the blocks' inverse transform."""
    n = 2 * fragm
    _check_x(h_spec, fragm, x)
    ks, kn, half = _k1_window(fragm, h_spec.shape[-1], freq_shards, shard)
    if half:
        xr, xi = fft_real_half_rows(x, n, ks, kn)
    else:
        xr, xi = fft_real(x, n, k1_start=ks, k1_n=kn)
    y_re, y_im, new_re, new_im = _mac(h_spec, hist_re, hist_im, xr, xi)
    if half:
        partial = ifft_partial_rows(y_re, y_im, n, ks, kn)
    else:
        partial = ifft_to_real(y_re, y_im, n, k1_start=ks, k1_n=kn)
    return partial, new_re.contiguous(), new_im.contiguous()


def finish_sharded_step(y2: torch.Tensor, tail: torch.Tensor,
                        max_abs: torch.Tensor, n_valid: torch.Tensor):
    """The rest of a frequency-sharded step, once the shards' partials
    are summed into ``y2`` [S, T, Cout, 2*fragm]: overlap-add with
    ``tail`` [S, Cout, fragm] and the clipping monitor.  Returns
    ``(tail', max_abs', y)``."""
    y, new_tail = _overlap_add(y2, tail)
    return new_tail.contiguous(), _monitor(y, max_abs, n_valid), y


def chunk_step(bank: FilterBank, state: StreamState, x, n_valid=None):
    """Convolve ``T`` full input blocks ``x`` [T, Cin, fragm] in one
    device step.  Partial final blocks are zero-padded by the caller;
    ``n_valid`` = genuine frames in the chunk (clipping monitor).
    Returns ``(new_state, y)`` with ``y`` float32 [T, Cout, fragm]."""
    with device_span("engine.step"):
        with span("engine.prep"):
            x = _f32(x, bank.device)
            t = x.shape[0]
            nv = _n_valid(n_valid, 1, t * bank.fragm, bank.device)
            states = stack_states([state])
        new, y = _batched_step(bank.h_spec, bank.fragm, states, x[None], nv)
        return unstack_state(new, 0), y[0]


def block_step(bank: FilterBank, state: StreamState, x):
    """Single-block convenience wrapper: ``x`` is [Cin, fragm]."""
    state, y = chunk_step(bank, state, _f32(x, bank.device)[None])
    return state, y[0]


def batched_chunk_step(bank: FilterBank, states: StreamState, x, n_valid):
    """Many streams with per-stream filters of one shape: ``bank.h_spec``
    is [S, P, Cin, Cout, 2, K], ``states`` batched, ``x`` [S, T, Cin,
    fragm], ``n_valid`` [S]."""
    with device_span("engine.step"):
        with span("engine.prep"):
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
    with device_span("engine.step"):
        with span("engine.prep"):
            x = _f32(x, bank.device)
            s, t = x.shape[0], x.shape[1]
            nv = _n_valid(n_valid, s, t * bank.fragm, bank.device)
            fused = fused_serving_supported(bank, t)
            if fused:
                valid = _valid_frames(nv, t, bank.fragm)
                h = h_perm if h_perm is not None else eager_h_perm(bank)
        if not fused:
            return _batched_step(bank.h_spec, bank.fragm, states, x, nv)
        y, hr, hi, tl, mx = conv_step_fused(
            h, x, states.hist_re, states.hist_im, states.tail, valid, 2 * bank.fragm)
        with device_span("engine.monitor"):
            mx = torch.maximum(states.max_abs, mx)
        return StreamState(hr, hi, tl, mx), y


def single_chunk_step(bank: FilterBank, state: StreamState, x,
                      n_valid=None, h_perm=None):
    """:func:`chunk_step` for one stream, through the fused kernel when
    the shape allows (the lone-stream pump)."""
    with device_span("engine.step"):
        with span("engine.prep"):
            x = _f32(x, bank.device)
            t = x.shape[0]
            fused = fused_serving_supported(bank, t)
            if fused:
                states = stack_states([state])
        if not fused:
            return chunk_step(bank, state, x, n_valid)
        new, y = serving_chunk_step(bank, states, x[None],
                                    t * bank.fragm if n_valid is None else n_valid,
                                    h_perm)
        return unstack_state(new, 0), y[0]


class FusedServingCarry(typing.NamedTuple):
    """Batched serving state in the fused kernel's pre-shaped layouts.

    ``hist_re``/``hist_im``: [S, P-1, Cin, cols, m1] — the kernel's
    transposed tile layout, a ring whose oldest row is slot ``head``;
    ``tail``: [S, Cout, rows, m2]; ``max_abs``: [S]; ``head``: a host
    int, the same for every stream (each step advances all of them by T
    blocks).  Convert with :func:`carry_from_states` /
    :func:`states_from_carry`."""

    hist_re: torch.Tensor
    hist_im: torch.Tensor
    tail: torch.Tensor
    max_abs: torch.Tensor
    head: int = 0


def fused_carry_init(bank: FilterBank, s: int) -> FusedServingCarry:
    p, cin, cout, _, k = bank.h_spec.shape
    rows, m2, m1, cols = fused_preshape(2 * bank.fragm)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=bank.device)
    return FusedServingCarry(z(s, p - 1, cin, cols, m1),
                             z(s, p - 1, cin, cols, m1),
                             z(s, cout, rows, m2), z(s))


def carry_from_states(bank: FilterBank, states: StreamState) -> FusedServingCarry:
    """Batched StreamState (canonical flat bins) -> pre-shaped carry,
    head 0."""
    p, cin, cout, _, k = bank.h_spec.shape
    rows, m2, m1, cols = fused_preshape(2 * bank.fragm)
    s = states.hist_re.shape[0]
    tr = lambda h: h.reshape(s, p - 1, cin, m1, cols).transpose(-1, -2).contiguous()
    return FusedServingCarry(tr(states.hist_re), tr(states.hist_im),
                             states.tail.reshape(s, cout, rows, m2),
                             states.max_abs)


def states_from_carry(bank: FilterBank, carry: FusedServingCarry) -> StreamState:
    """Inverse of :func:`carry_from_states`: the hist unrolled by the
    head, oldest row first."""
    p, cin, cout, _, k = bank.h_spec.shape
    s = carry.hist_re.shape[0]
    untr = lambda h: unroll_ring(h, carry.head).transpose(-1, -2).reshape(
        s, p - 1, cin, k)
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
    Cout, rows, m2].  Same semantics as :func:`serving_chunk_step`.

    The kernel runs in ring mode: it writes the step's new hist rows into
    ``carry``'s hist in place and advances the head, so ``carry`` is
    consumed (``carry'`` holds the same hist tensors)."""
    with device_span("engine.step"):
        with span("engine.prep"):
            x5 = _f32(x5, bank.device)
            s, t = x5.shape[0], x5.shape[1]
            nv = _n_valid(n_valid, s, t * bank.fragm, bank.device)
            valid = _valid_frames(nv, t, bank.fragm)
            h = h_perm if h_perm is not None else eager_h_perm(bank)
        y5, hr, hi, tl, mx = conv_step_fused(
            h, x5, carry.hist_re, carry.hist_im, carry.tail, valid, 2 * bank.fragm,
            hist_t=True, head=carry.head)
        with device_span("engine.monitor"):
            mx = torch.maximum(carry.max_abs, mx)
        head = (carry.head + t) % (bank.partitions - 1)
        return FusedServingCarry(hr, hi, tl, mx, head), y5
