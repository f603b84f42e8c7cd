"""The port's k1-row windows and window MAC against the JAX package:
``engine.rfft``'s windowed transforms and ``reconstruct_full`` against
``folve_tpu.engine.rfft``, the plain versions of the window MAC and of the
row-window FFT kernels against the Pallas kernels run in interpret mode,
and the MAC route rule against the JAX step's.  Tolerance atol 2e-4, as
in ``test_torch_kernels.py``; on the CPU a wrapper runs its plain version
and launches nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from folve_tpu.engine import rfft as jr
from folve_tpu.engine.kernels.fdl_mac import _UNROLL_LIMIT, pallas_fdl_mac
from folve_tpu.engine.kernels.fft_half import pallas_fft_real_half_rows
from folve_tpu.engine.kernels.ifft_half import (
    pallas_ifft_from_half,
    pallas_ifft_partial_rows,
)
from folve_tpu_torch.engine import rfft as tr
from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac, fdl_mac_plain
from folve_tpu_torch.engine.kernels.fft_half import fft_real_half_rows
from folve_tpu_torch.engine.kernels.ifft_half import (
    ifft_from_half,
    ifft_partial_rows,
)
from folve_tpu_torch.engine.stream import mac_route

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol=2e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("p,t", [(1, 4), (40, 36)])
def test_fdl_mac_plain_matches_pallas(rng, p, t):
    cin, cout, k = 2, 2, tr.half_bins(128)
    h = (rng.standard_normal((p, cin, cout, 2, k)) / np.sqrt(p * cin)).astype(np.float32)
    xr = rng.standard_normal((t + p - 1, cin, k)).astype(np.float32)
    xi = rng.standard_normal((t + p - 1, cin, k)).astype(np.float32)
    jre, jim = pallas_fdl_mac(*(jnp.asarray(a) for a in (h, xr, xi)), t,
                              interpret=True)
    fdl_mac.launches = fdl_mac_plain.cuda_calls = 0
    tre, tim = fdl_mac(_t(h), _t(xr), _t(xi), t)
    assert fdl_mac.launches == 0 and fdl_mac_plain.cuda_calls == 0
    _close(tre, jre)
    _close(tim, jim)
    # A stream batch with per-stream filters equals each stream alone.
    br, bi = fdl_mac(_t(np.stack([h, 2 * h])), _t(np.stack([xr, xr])),
                     _t(np.stack([xi, xi])), t)
    np.testing.assert_allclose(br[0].numpy(), tre.numpy(), atol=1e-6)
    np.testing.assert_allclose(bi[1].numpy(), 2 * tim.numpy(), atol=1e-5)


@pytest.mark.parametrize("freq", [2, 4])
def test_row_window_kernels_plain_match_pallas(rng, freq):
    n = 256
    plan = jr.get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols, kn = m2 // 2 + 1, m1 // freq
    x = (0.3 * rng.standard_normal((3, 2, n // 2))).astype(np.float32)
    rows = min(m1, -(-x.shape[-1] // m2))
    yr = rng.standard_normal((3, 2, m1 * cols)).astype(np.float32)
    yi = rng.standard_normal((3, 2, m1 * cols)).astype(np.float32)
    wn = (jr._half_weights(n) / float(n)).astype(np.float32)
    fft_real_half_rows.launches = ifft_partial_rows.launches = 0
    total = None
    for f in range(freq):
        ks = f * kn
        jre, jim = pallas_fft_real_half_rows(
            jnp.asarray(x), n, jr._rows(plan.f1_re[:, :rows], ks, kn),
            jr._rows(plan.f1_im[:, :rows], ks, kn), jr._rows(plan.tw_re, ks, kn),
            jr._rows(plan.tw_im, ks, kn), interpret=True)
        tre, tim = fft_real_half_rows(_t(x), n, ks, kn)
        _close(tre, jre)
        _close(tim, jim)
        win = lambda a: a.reshape(3, 2, m1, cols)[:, :, ks:ks + kn].reshape(3, 2, -1)
        jp = pallas_ifft_partial_rows(
            jnp.asarray(win(yr)), jnp.asarray(win(yi)), n, jr._rows(wn, ks, kn),
            jr._rows(plan.f1_re, ks, kn, axis=1), jr._rows(plan.f1_im, ks, kn, axis=1),
            jr._rows(plan.tw_re, ks, kn), jr._rows(plan.tw_im, ks, kn),
            interpret=True)
        tp = ifft_partial_rows(_t(win(yr)), _t(win(yi)), n, ks, kn)
        _close(tp, jp)
        total = tp if total is None else total + tp
    assert fft_real_half_rows.launches == ifft_partial_rows.launches == 0
    # The windows' partials add up to the whole inverse.
    _close(total, pallas_ifft_from_half(jnp.asarray(yr), jnp.asarray(yi), n,
                                        interpret=True))


@pytest.mark.parametrize("n", [256, 1024])
def test_ifft_from_half_plain_matches_pallas(rng, n):
    k = tr.half_bins(n)
    yr = rng.standard_normal((2, 3, k)).astype(np.float32)
    yi = rng.standard_normal((2, 3, k)).astype(np.float32)
    ref = pallas_ifft_from_half(jnp.asarray(yr), jnp.asarray(yi), n, interpret=True)
    ifft_from_half.launches = 0
    got = ifft_from_half(_t(yr), _t(yi), n)
    assert ifft_from_half.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("half", [True, False])
def test_rfft_windows_match_jax(rng, half):
    n, freq = 512, 4
    m1 = jr.get_plan(n).m1
    kn = m1 // freq
    x = (0.3 * rng.standard_normal((2, 3, 200))).astype(np.float32)
    fr, fi = (np.asarray(a) for a in jr.fft_real(jnp.asarray(x), n, half=half))
    inverse = (jr.ifft_from_half, tr.ifft_from_half) if half else (
        jr.ifft_to_real, tr.ifft_to_real)
    cols = fr.shape[-1] // m1
    total = None
    for f in range(freq):
        ks = f * kn
        jre, jim = jr.fft_real(jnp.asarray(x), n, half=half, k1_start=ks, k1_n=kn)
        tre, tim = tr.fft_real(_t(x), n, half=half, k1_start=ks, k1_n=kn)
        _close(tre, jre)
        _close(tim, jim)
        wr, wi = (np.ascontiguousarray(
            a.reshape(2, 3, m1, cols)[:, :, ks:ks + kn].reshape(2, 3, -1))
            for a in (fr, fi))
        jp = inverse[0](jnp.asarray(wr), jnp.asarray(wi), n, k1_start=ks, k1_n=kn)
        tp = inverse[1](_t(wr), _t(wi), n, k1_start=ks, k1_n=kn)
        _close(tp, jp)
        total = tp if total is None else total + tp
    # Round trip: the windows' partials add up to the zero-padded signal.
    want = np.concatenate([x, np.zeros((2, 3, n - 200), np.float32)], axis=-1)
    np.testing.assert_allclose(total.numpy(), want, atol=2e-5)
    with pytest.raises(ValueError):
        tr.fft_real(_t(x), n, k1_start=m1 - 1, k1_n=2)


@pytest.mark.parametrize("n", [256, 2048])
def test_reconstruct_full_matches_jax(rng, n):
    x = rng.standard_normal((3, n // 2)).astype(np.float32)
    hr, hi = (np.asarray(a) for a in jr.fft_real(jnp.asarray(x), n, half=True))
    jf = jr.reconstruct_full(jnp.asarray(hr), jnp.asarray(hi), n)
    tf = tr.reconstruct_full(_t(hr), _t(hi), n)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    full_r, _ = tr.fft_real(_t(x), n)
    np.testing.assert_allclose(tf[0].numpy(), full_r.numpy(), atol=2e-4)


@pytest.mark.parametrize("cin,cout", [(1, 1), (2, 2), (4, 4), (5, 4), (1, 17)])
def test_mac_route_rule_matches_jax_step(cin, cout):
    """The JAX step's rule (folve_tpu/engine/stream.py, ``use_split`` and
    ``_fdl_mac``) without its TPU VMEM tiling gate."""
    for p in (1, 2, 16, 32, 33, 40, 128):
        for t in (1, 8, 32, 33, 36, 64):
            if cin * cout > 16:
                want = "einsum"
            elif p >= 2 and min(p, t) <= _UNROLL_LIMIT:
                want = "split"
            else:
                want = "window"
            assert mac_route(p, cin, cout, t) == want, (p, t, cin, cout)
