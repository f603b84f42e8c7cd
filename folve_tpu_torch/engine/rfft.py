"""Matmul FFT in the permuted half-spectrum layout (PyTorch port).

The DFT of size n = M1*M2 runs as two stages of dense products
(Cooley-Tukey), with complex values carried as separate (re, im)
float32 planes.  With n = M2*n1 + n2 and k = k1 + M1*k2 the output is
the *permuted* matrix [k1, k2] (flattened j = k1*M2 + k2), which the
engine never unscrambles: filter spectra are stored in the same layout
(:func:`permute_spectrum`) and the inverse consumes it directly.

The plans, the half-spectrum weights and :func:`permute_spectrum` are
host numpy and byte-equal to the JAX package's.  The transforms here
are the plain PyTorch versions; the CUDA kernels in
:mod:`folve_tpu_torch.engine.kernels` compute the same functions.
Every product runs in full float32: a TF32 product cannot hold the
engine's -90 dB accuracy budget, so :func:`_einsum` refuses to run a
CUDA product while TF32 matmuls are enabled.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


def _split_factors(n: int) -> tuple[int, int]:
    """Factor n = m1 * m2 with m1, m2 as close as possible (n power of 2)."""
    if n & (n - 1):
        raise ValueError(f"FFT size must be a power of two, got {n}")
    log = n.bit_length() - 1
    m1 = 1 << ((log + 1) // 2)
    return m1, n // m1


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Constant factor matrices for one FFT size (host numpy)."""

    n: int
    m1: int
    m2: int
    f1_re: np.ndarray  # [M1, M1]
    f1_im: np.ndarray
    tw_re: np.ndarray  # [M1, M2] twiddle W_N^{k1 n2}
    tw_im: np.ndarray
    f2_re: np.ndarray  # [M2, M2]
    f2_im: np.ndarray


@lru_cache(maxsize=None)
def get_plan(n: int) -> FFTPlan:
    m1, m2 = _split_factors(n)

    def dft(m):
        k = np.arange(m)
        ang = -2.0 * np.pi * np.outer(k, k) / m
        return np.cos(ang), np.sin(ang)

    f1_re, f1_im = dft(m1)
    f2_re, f2_im = dft(m2)
    ang = -2.0 * np.pi * np.outer(np.arange(m1), np.arange(m2)) / n
    return FFTPlan(
        n=n,
        m1=m1,
        m2=m2,
        f1_re=f1_re.astype(np.float32),
        f1_im=f1_im.astype(np.float32),
        tw_re=np.cos(ang).astype(np.float32),
        tw_im=np.sin(ang).astype(np.float32),
        f2_re=f2_re.astype(np.float32),
        f2_im=f2_im.astype(np.float32),
    )


def half_bins(n: int) -> int:
    """Bin count of the half-spectrum rectangle: k2 <= M2/2 of the
    permuted [k1, k2] grid (real input implies X[N-k] = conj(X[k]))."""
    plan = get_plan(n)
    return plan.m1 * (plan.m2 // 2 + 1)


@lru_cache(maxsize=None)
def _half_weights(n: int) -> np.ndarray:
    """Per-stored-bin conjugate multiplicity c_k for the half-spectrum
    rectangle: the full inverse equals Re(two-stage-inverse(c ⊙ X_half))
    because every missing bin m satisfies X_m e_m = conj(X_σ(m) e_σ(m))
    for a stored σ(m) — so each stored bin contributes (1 + #images)
    times its real part."""
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols = m2 // 2 + 1
    c = np.ones((m1, cols), dtype=np.float32)
    for k2 in range(cols, m2):
        for k1 in range(m1):
            k = k1 + m1 * k2
            m = (n - k) % n  # conjugate bin
            mk1, mk2 = m % m1, m // m1
            assert mk2 < cols, (k1, k2)
            c[mk1, mk2] += 1.0
    return c


def permute_spectrum(spec: np.ndarray, n: int, half: bool = False) -> np.ndarray:
    """Reorder a natural-order complex spectrum [..., n] (host numpy) into
    the permuted [k1, k2] layout produced by :func:`fft_real`; with
    ``half``, keep only the k2 <= M2/2 rectangle."""
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    # P[k1, k2] = spec[k1 + M1*k2]; spec.reshape(M2, M1) indexes [k2, k1].
    mat = np.swapaxes(spec.reshape(*spec.shape[:-1], m2, m1), -1, -2)
    if half:
        cols = m2 // 2 + 1
        return mat[..., :cols].reshape(*spec.shape[:-1], m1 * cols)
    return mat.reshape(*spec.shape[:-1], n)


@dataclasses.dataclass(frozen=True)
class PlanTensors:
    """One plan's factors as float32 tensors on one device.

    ``packed`` holds f1_re, f1_im, tw_re, tw_im, f2_re, f2_im and the
    inverse weights ``_half_weights(n)/n`` back to back: the kernels take
    it as one pointer (layout fixed by ``csrc/fft_common.cuh``)."""

    m1: int
    m2: int
    f1_re: torch.Tensor
    f1_im: torch.Tensor
    tw_re: torch.Tensor
    tw_im: torch.Tensor
    f2_re: torch.Tensor
    f2_im: torch.Tensor
    wn: torch.Tensor  # [M1, cols] multiplicity / n
    packed: torch.Tensor


_PLAN_TENSORS: dict = {}


def plan_tensors(n: int, device) -> PlanTensors:
    dev = torch.device(device)
    key = (n, str(dev))
    hit = _PLAN_TENSORS.get(key)
    if hit is not None:
        return hit
    plan = get_plan(n)
    wn = (_half_weights(n) / float(n)).astype(np.float32)
    parts = [plan.f1_re, plan.f1_im, plan.tw_re, plan.tw_im,
             plan.f2_re, plan.f2_im, wn]
    packed = torch.from_numpy(
        np.concatenate([p.reshape(-1) for p in parts])).to(dev)
    views, off = [], 0
    for p in parts:
        views.append(packed[off : off + p.size].view(p.shape))
        off += p.size
    pt = PlanTensors(plan.m1, plan.m2, *views, packed=packed)
    _PLAN_TENSORS[key] = pt
    return pt


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    if ops[-1].is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are enabled; the engine's DFT products need full "
            "float32 (set torch.backends.cuda.matmul.allow_tf32 = False)"
        )
    return torch.einsum(eq, *ops)


def _rows(mat: torch.Tensor, start: int, nrows: int, axis: int = 0):
    """``nrows`` rows of ``mat`` along ``axis`` from ``start``: a
    frequency shard's k1 window of a plan factor."""
    return mat.narrow(axis, start, nrows)


def _window(m1: int, k1_start, k1_n) -> tuple[int, int]:
    """(start, rows) of a k1-row window of the [m1, .] grid; the whole
    grid when ``k1_start`` is None."""
    if k1_start is None:
        return 0, m1
    k1_start, k1_n = int(k1_start), int(k1_n)
    if k1_n < 1 or k1_start < 0 or k1_start + k1_n > m1:
        raise ValueError(f"k1 window ({k1_start}, {k1_n}) outside {m1} rows")
    return k1_start, k1_n


def fft_real(
    x: torch.Tensor, n: int, half: bool = False, *, k1_start=None,
    k1_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT of a real signal, permuted-layout output.

    ``x``: float ``[..., L]`` with L <= n (zero-padded to n).  Returns
    ``(re, im)`` each ``[..., n]`` in permuted bin order, or
    ``[..., half_bins(n)]`` when ``half`` (stage 2 computes only the
    k2 <= M2/2 columns).

    ``k1_start``/``k1_n`` restrict the output to a window of k1 rows of
    the permuted [k1, k2] grid (a frequency shard computes only its own
    rows; the forward direction needs no communication).  The output is
    then ``[..., k1_n * cols]``."""
    pt = plan_tensors(n, x.device)
    m1, m2 = pt.m1, pt.m2
    ks, kn = _window(m1, k1_start, k1_n)
    length = x.shape[-1]
    # Zero-padding awareness: a signal of L < n samples fills only the
    # first ceil(L/m2) rows, so stage 1 contracts over those rows alone.
    rows = min(m1, -(-length // m2))
    x = x.to(torch.float32)
    if length < rows * m2:
        x = torch.nn.functional.pad(x, (0, rows * m2 - length))
    a = x.reshape(*x.shape[:-1], rows, m2)
    s1r = _einsum("kn,...nm->...km", _rows(pt.f1_re[:, :rows], ks, kn), a)
    s1i = _einsum("kn,...nm->...km", _rows(pt.f1_im[:, :rows], ks, kn), a)
    tr, ti = _rows(pt.tw_re, ks, kn), _rows(pt.tw_im, ks, kn)
    t_r = s1r * tr - s1i * ti
    t_i = s1r * ti + s1i * tr
    cols = m2 // 2 + 1 if half else m2
    f2r, f2i = pt.f2_re[:, :cols], pt.f2_im[:, :cols]
    xr = _einsum("...km,ml->...kl", t_r, f2r) - _einsum("...km,ml->...kl", t_i, f2i)
    xi = _einsum("...km,ml->...kl", t_r, f2i) + _einsum("...km,ml->...kl", t_i, f2r)
    batch = x.shape[:-1]
    return xr.reshape(*batch, kn * cols), xi.reshape(*batch, kn * cols)


def _inverse_stages(pt: PlanTensors, ar, ai, f2r, f2i, ks: int,
                    kn: int) -> torch.Tensor:
    """Stage 1 against conj(F2) (``f2r``/``f2i`` [M2, cols]), the
    conjugate twiddle of rows ``[ks, ks+kn)``, then stage 2 against those
    columns of conj(F1); real part only."""
    ur = _einsum("...kl,ml->...km", ar, f2r) + _einsum("...kl,ml->...km", ai, f2i)
    ui = _einsum("...kl,ml->...km", ai, f2r) - _einsum("...kl,ml->...km", ar, f2i)
    tr, ti = _rows(pt.tw_re, ks, kn), _rows(pt.tw_im, ks, kn)
    vr = ur * tr + ui * ti
    vi = ui * tr - ur * ti
    return (_einsum("nk,...km->...nm", _rows(pt.f1_re, ks, kn, axis=1), vr)
            + _einsum("nk,...km->...nm", _rows(pt.f1_im, ks, kn, axis=1), vi))


def ifft_to_real(xr: torch.Tensor, xi: torch.Tensor, n: int, *,
                 k1_start=None, k1_n: int | None = None) -> torch.Tensor:
    """Inverse DFT of full permuted-layout spectra ``[..., n]``; returns
    the real part, float32 ``[..., n]``.

    With ``k1_start``/``k1_n`` the inputs hold one window of k1 rows
    (``[..., k1_n * M2]``) and the result is that window's partial
    stage-2 sum: the partials of windows that tile the M1 rows add up to
    the inverse (the JAX package's ``psum`` over the freq axis; here the
    caller sums)."""
    pt = plan_tensors(n, xr.device)
    ks, kn = _window(pt.m1, k1_start, k1_n)
    ar = xr.reshape(*xr.shape[:-1], kn, pt.m2)
    ai = xi.reshape(*xi.shape[:-1], kn, pt.m2)
    out = _inverse_stages(pt, ar, ai, pt.f2_re, pt.f2_im, ks, kn)
    return (out / n).reshape(*xr.shape[:-1], n)


def ifft_from_half(xr: torch.Tensor, xi: torch.Tensor, n: int, *,
                   k1_start=None, k1_n: int | None = None) -> torch.Tensor:
    """Inverse DFT of a *real* signal straight from the half-spectrum
    rectangle ``[..., half_bins(n)]``: the multiplicity weights and 1/n
    fold into one per-bin factor; stage 1 contracts only the stored
    columns.  Returns float32 ``[..., n]``.

    The weights are per (k1, k2), so a k1-row window (``[..., k1_n *
    cols]`` inputs) slices them locally and returns its partial sum, as
    :func:`ifft_to_real` does."""
    pt = plan_tensors(n, xr.device)
    m1, m2 = pt.m1, pt.m2
    ks, kn = _window(m1, k1_start, k1_n)
    cols = m2 // 2 + 1
    batch = xr.shape[:-1]
    wn = _rows(pt.wn, ks, kn)
    ar = xr.reshape(*batch, kn, cols) * wn
    ai = xi.reshape(*batch, kn, cols) * wn
    out = _inverse_stages(pt, ar, ai, pt.f2_re[:, :cols], pt.f2_im[:, :cols],
                          ks, kn)
    return out.reshape(*batch, n)


def reconstruct_full(xr: torch.Tensor, xi: torch.Tensor,
                     n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rebuild the full permuted spectrum of a *real* signal from its
    half-spectrum rectangle via conjugate symmetry.

    With bin k = k1 + M1*k2 and X[N-k] = conj(X[k]), the missing
    columns k2 in [M2/2+1, M2) satisfy
      X[k1, k2] = conj(X[M1-k1, M2-1-k2])   for k1 > 0,
      X[0,  k2] = conj(X[0,     M2-k2]),
    both of which live inside the stored k2 <= M2/2 rectangle."""
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols = m2 // 2 + 1
    take = m2 - cols  # number of missing columns
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, m1, cols)
    ai = xi.reshape(*batch, m1, cols)
    # Rows k1 -> (m1-k1) % m1 == roll(flip(rows), 1).
    mr = torch.roll(torch.flip(ar, dims=(-2,)), 1, dims=-2)
    mi = torch.roll(torch.flip(ai, dims=(-2,)), 1, dims=-2)
    # Columns for k1>0 rows: k2' = m2-1-k2 in [0, take-1] -> slice+flip.
    rec_r = torch.flip(mr[..., :take], dims=(-1,))
    rec_i = -torch.flip(mi[..., :take], dims=(-1,))
    # Row k1 = 0 mirrors within itself with k2' = m2-k2 in [1, take].
    row0_r = torch.flip(ar[..., 0:1, 1 : take + 1], dims=(-1,))
    row0_i = -torch.flip(ai[..., 0:1, 1 : take + 1], dims=(-1,))
    rec_r = torch.cat([row0_r, rec_r[..., 1:, :]], dim=-2)
    rec_i = torch.cat([row0_i, rec_i[..., 1:, :]], dim=-2)
    fr = torch.cat([ar, rec_r], dim=-1)
    fi = torch.cat([ai, rec_i], dim=-1)
    return fr.reshape(*batch, n), fi.reshape(*batch, n)
