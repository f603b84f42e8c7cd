"""Each kernel module of folve_tpu_torch: its plain version against the
JAX Pallas kernel run in interpret mode (the fused kernel with
passes=6, full float32 dots), atol 2e-4 — the reference's own
tolerance.  On the CPU a wrapper runs its plain version and launches
nothing.  ``test_torch_cuda.py`` holds the CUDA kernels against the
same plain versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from folve_tpu.engine.filter_bank import compile_filter_bank as j_bank
from folve_tpu.engine.kernels import conv_step as jcs
from folve_tpu.engine.kernels.fdl_mac import pallas_fdl_mac_split
from folve_tpu.engine.kernels.fft_half import pallas_fft_real_half
from folve_tpu.engine.kernels.ifft_half import pallas_ifft_ola
from folve_tpu_torch.engine.kernels import conv_step as tcs
from folve_tpu_torch.engine.kernels.fdl_mac import (
    fdl_mac_split,
    fdl_mac_split_plain,
)
from folve_tpu_torch.engine.kernels.fft_half import (
    fft_real_half,
    fft_real_half_plain,
)
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola, ifft_ola_plain
from folve_tpu_torch.engine.rfft import half_bins

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("n,batch", [(256, (3, 2)), (512, (4,))])
def test_fft_real_half_plain_matches_pallas(rng, n, batch):
    x = (0.2 * rng.standard_normal(batch + (n // 2,))).astype(np.float32)
    jre, jim = pallas_fft_real_half(jnp.asarray(x), n, interpret=True)
    fft_real_half.launches = 0
    tre, tim = fft_real_half(_t(x), n)
    assert fft_real_half.launches == 0  # CPU tensor: plain version
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=2e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=2e-4)


@pytest.mark.parametrize("t,c", [(3, 2), (1, 1)])
def test_ifft_ola_plain_matches_pallas(rng, t, c):
    n = 256
    k = half_bins(n)
    yr = rng.standard_normal((t, c, k)).astype(np.float32)
    yi = rng.standard_normal((t, c, k)).astype(np.float32)
    tail = rng.standard_normal((c, n // 2)).astype(np.float32)
    jy, jt = pallas_ifft_ola(jnp.asarray(yr), jnp.asarray(yi),
                             jnp.asarray(tail), n, interpret=True)
    ifft_ola.launches = 0
    ty, tt = ifft_ola(_t(yr), _t(yi), _t(tail), n)
    assert ifft_ola.launches == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)
    # Batched (stream axis) equals per-stream.
    by, bt = ifft_ola_plain(_t(yr)[None].repeat(2, 1, 1, 1),
                            _t(yi)[None].repeat(2, 1, 1, 1),
                            _t(tail)[None].repeat(2, 1, 1), n)
    np.testing.assert_array_equal(by[1].numpy(), ty.numpy())
    np.testing.assert_array_equal(bt[1].numpy(), tt.numpy())


@pytest.mark.parametrize("p,t,cin,cout", [(4, 2, 2, 2), (3, 5, 1, 2), (2, 1, 2, 1)])
def test_fdl_mac_split_plain_matches_pallas(rng, p, t, cin, cout):
    k = half_bins(256)
    h = rng.standard_normal((p, cin, cout, 2, k)).astype(np.float32)
    hr = rng.standard_normal((p - 1, cin, k)).astype(np.float32)
    hi = rng.standard_normal((p - 1, cin, k)).astype(np.float32)
    xr = rng.standard_normal((t, cin, k)).astype(np.float32)
    xi = rng.standard_normal((t, cin, k)).astype(np.float32)
    jr, ji = pallas_fdl_mac_split(*(jnp.asarray(a) for a in (h, hr, hi, xr, xi)),
                                  interpret=True)
    fdl_mac_split.launches = 0
    tr, ti = fdl_mac_split(*(_t(a) for a in (h, hr, hi, xr, xi)))
    assert fdl_mac_split.launches == 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=2e-4)
    # Per-stream filters [S, P, ...] over a stream batch.
    hs = np.stack([h, 2 * h])
    br, bi = fdl_mac_split_plain(_t(hs), _t(np.stack([hr, hr])),
                                 _t(np.stack([hi, hi])), _t(np.stack([xr, xr])),
                                 _t(np.stack([xi, xi])))
    np.testing.assert_allclose(br[0].numpy(), tr.numpy(), atol=1e-6)
    np.testing.assert_allclose(br[1].numpy(), 2 * tr.numpy(), atol=1e-5)


def test_fused_helpers_match_jax(rng):
    n = 256
    assert tcs.fused_preshape(n) == jcs.fused_preshape(n)
    for args in [(4, 2, 2, 3, n), (1, 1, 1, 2, n), (3, 1, 1, 0, n), (2, 1, 16, 2, n),
                 (2, 4, 4, 2, n), (1, 6, 6, 2, n)]:
        assert tcs.fused_supported(*args) == jcs.fused_supported(*args)
    # Past 16 pairs the JAX package leaves the fused kernel; the port's
    # takes up to 16 channels a side (its MAC computes the live paths).
    for args in [(2, 4, 5, 2, n), (2, 6, 6, 8, n), (16, 8, 8, 8, 2 * 8192),
                 (2, 16, 16, 1, n)]:
        assert tcs.fused_supported(*args) and not jcs.fused_supported(*args)
    for args in [(2, 17, 1, 2, n), (2, 1, 17, 2, n), (2, 17, 17, 2, n)]:
        assert not tcs.fused_supported(*args)
    h = rng.standard_normal((3, 2, 2, 2, half_bins(n))).astype(np.float32)
    a = np.asarray(jcs.permute_h_for_fused(jnp.asarray(h), n))
    b = tcs.permute_h_for_fused(_t(h), n).numpy()
    assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(tcs._canonical(_t(b), n).numpy(), h)


def _fused_inputs(rng, p, t, fragm, cin, cout, s=3):
    ir = rng.standard_normal((cin, cout, p * fragm - 3)).astype(np.float32)
    bank = j_bank(ir, fragm=fragm)
    hp = np.asarray(jcs.permute_h_for_fused(bank.h_spec, 2 * fragm))
    k = bank.bins
    x = rng.standard_normal((s, t, cin, fragm)).astype(np.float32)
    hr = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    hi = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    tail = rng.standard_normal((s, cout, fragm)).astype(np.float32)
    nv = np.array([t * fragm, t * fragm - fragm // 2 - 1, 1][:s])
    valid = np.clip(nv[:, None] - np.arange(t)[None] * fragm, 0, fragm)
    return hp, x, hr, hi, tail, valid.astype(np.int32)


@pytest.mark.parametrize("p,t,fragm,cin,cout", [
    (4, 6, 64, 2, 2),    # T >= P-1
    (5, 2, 64, 2, 2),    # T < P-1: old hist rows shift
    (3, 4, 128, 1, 2),   # upmix
])
def test_conv_step_plain_matches_pallas(rng, p, t, fragm, cin, cout):
    hp, x, hr, hi, tail, valid = _fused_inputs(rng, p, t, fragm, cin, cout)
    ref = jcs.pallas_conv_step_fused(
        *(jnp.asarray(a) for a in (hp, x, hr, hi, tail, valid)), 2 * fragm,
        interpret=True, passes=6)
    tcs.conv_step_fused.launches = 0
    got = tcs.conv_step_fused(*(_t(a) for a in (hp, x, hr, hi, tail)),
                              torch.from_numpy(valid), 2 * fragm,
                              paths=tcs.all_paths(cin, cout))
    assert tcs.conv_step_fused.launches == 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)


def test_conv_step_pre_hist_t_matches_pallas(rng):
    p, t, fragm, cin, cout = 4, 2, 64, 2, 2
    hp, x, hr, hi, tail, valid = _fused_inputs(rng, p, t, fragm, cin, cout, s=2)
    rows, m2, m1, cols = tcs.fused_preshape(2 * fragm)
    tr5 = lambda h: np.ascontiguousarray(
        h.reshape(2, p - 1, cin, m1, cols).swapaxes(-1, -2))
    args = (hp, x.reshape(2, t, cin, rows, m2), tr5(hr), tr5(hi),
            tail.reshape(2, cout, rows, m2))
    ref = jcs.pallas_conv_step_fused_pre(
        *(jnp.asarray(a) for a in args), jnp.asarray(valid), 2 * fragm,
        interpret=True, passes=6, hist_t=True)
    got = tcs.conv_step_fused(*(_t(a) for a in args), torch.from_numpy(valid),
                              2 * fragm, hist_t=True, paths=tcs.all_paths(cin, cout))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)
