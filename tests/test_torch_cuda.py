"""The CUDA kernels of folve_tpu_torch against their plain PyTorch
versions on the card (max|kernel - plain| < 1e-5 * max|plain|: both are
float32, summed in another order).  Every test here needs a CUDA device
and skips without one.  This file imports no JAX, so it runs on a
machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.engine.kernels import conv_step as tcs
from folve_tpu_torch.engine.kernels.fdl_mac import fdl_mac_split, fdl_mac_split_plain
from folve_tpu_torch.engine.kernels.fft_half import fft_real_half, fft_real_half_plain
from folve_tpu_torch.engine.kernels.ifft_half import ifft_ola, ifft_ola_plain
from folve_tpu_torch.engine.rfft import half_bins


@pytest.fixture
def rng():
    return np.random.default_rng(0xF01BE)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _fused_inputs(rng, p, t, fragm, cin, cout, s=3):
    ir = rng.standard_normal((cin, cout, p * fragm - 3)).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=fragm, device="cpu")
    hp = tcs.permute_h_for_fused(bank.h_spec, 2 * fragm).numpy()
    k = bank.bins
    x = rng.standard_normal((s, t, cin, fragm)).astype(np.float32)
    hr = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    hi = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    tail = rng.standard_normal((s, cout, fragm)).astype(np.float32)
    nv = np.array([t * fragm, t * fragm - fragm // 2 - 1, 1][:s])
    valid = np.clip(nv[:, None] - np.arange(t)[None] * fragm, 0, fragm)
    return hp, x, hr, hi, tail, valid.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    if torch.is_tensor(got):
        got, ref = (got,), (ref,)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return err / max(float(r.abs().max()) for r in ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fragm", [64, 1024, 8192])
def test_split_kernels_match_plain_on_card(cuda, rng, fragm):
    n, s, t, p, cin, cout = 2 * fragm, 2, 3, 4, 2, 2
    k = half_bins(n)
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    x = cu(s, t, cin, fragm)
    assert _rel_err(fft_real_half(x, n), fft_real_half_plain(x, n)) < 1e-5
    h, hr, hi = cu(s, p, cin, cout, 2, k), cu(s, p - 1, cin, k), cu(s, p - 1, cin, k)
    xr, xi = cu(s, t, cin, k), cu(s, t, cin, k)
    assert _rel_err(fdl_mac_split(h[0], hr, hi, xr, xi),
                    fdl_mac_split_plain(h[0], hr, hi, xr, xi)) < 1e-5
    assert _rel_err(fdl_mac_split(h, hr, hi, xr, xi),
                    fdl_mac_split_plain(h, hr, hi, xr, xi)) < 1e-5
    yr, yi, tail = cu(s, t, cout, k), cu(s, t, cout, k), cu(s, cout, fragm)
    assert _rel_err(ifft_ola(yr, yi, tail, n), ifft_ola_plain(yr, yi, tail, n)) < 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,fragm,hist_t", [
    (4, 6, 64, False), (5, 2, 256, True), (16, 8, 8192, True),
])
def test_fused_kernel_matches_plain_on_card(cuda, rng, p, t, fragm, hist_t):
    hp, x, hr, hi, tail, valid = _fused_inputs(rng, p, t, fragm, 2, 2)
    if hist_t:
        rows, m2, m1, cols = tcs.fused_preshape(2 * fragm)
        hr, hi = (np.ascontiguousarray(h.reshape(3, p - 1, 2, m1, cols).swapaxes(-1, -2))
                  for h in (hr, hi))
    args = [_t(a).to(cuda) for a in (hp, x, hr, hi, tail)]
    v = torch.from_numpy(valid).to(cuda)
    got = tcs.conv_step_fused(*args, v, 2 * fragm, hist_t=hist_t)
    ref = tcs.conv_step_fused_plain(*args, v, 2 * fragm, hist_t=hist_t)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,fragm", [(5, 2, 64), (3, 4, 512)])
def test_engine_on_card_matches_cpu(cuda, rng, p, t, fragm):
    """Three chained chunks through the split and fused routes on the
    card against the plain path on the CPU (T < P-1 and a ragged end)."""
    from folve_tpu_torch.engine import stream as ts

    ir = rng.standard_normal((2, 2, p * fragm - 5)).astype(np.float32)
    banks = {d: compile_filter_bank(ir, fragm=fragm, device=d) for d in ("cpu", cuda)}
    x = rng.standard_normal((3, 2, t, 2, fragm)).astype(np.float32)
    nv = [t * fragm, t * fragm, t * fragm - 7]
    outs = {}
    for d, bank in banks.items():
        st = ts.init_state(bank, device=d)
        sts = ts.stack_states([ts.init_state(bank, device=d)] * 2)
        ys = []
        for r in range(3):
            st, y = ts.chunk_step(bank, st, x[r, 0], nv[r])
            sts, y2 = ts.serving_chunk_step(bank, sts, x[r], [nv[r]] * 2)
            ys += [y.cpu(), y2.cpu(), sts.max_abs.cpu(), sts.hist_re.cpu()]
        outs[d] = ys
    for a, b in zip(outs["cpu"], outs[cuda]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
