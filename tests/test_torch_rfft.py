"""folve_tpu_torch.engine.rfft against folve_tpu.engine.rfft: host plans,
weights and permutations byte-equal; the torch DFTs within 2e-4 of the
JAX DFTs (both float32; the tolerance of the reference's own tests)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from folve_tpu.engine import rfft as jr
from folve_tpu_torch.engine import rfft as tr

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [128, 512, 1024, 16384])
def test_plan_weights_and_bins_byte_equal(n):
    a, b = jr.get_plan(n), tr.get_plan(n)
    assert (a.n, a.m1, a.m2) == (b.n, b.m1, b.m2)
    for f in ("f1_re", "f1_im", "tw_re", "tw_im", "f2_re", "f2_im"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert jr._half_weights(n).tobytes() == tr._half_weights(n).tobytes()
    assert jr.half_bins(n) == tr.half_bins(n)


@pytest.mark.parametrize("half", [True, False])
def test_permute_spectrum_byte_equal(rng, half):
    n = 256
    spec = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    a = jr.permute_spectrum(spec, n, half=half)
    b = tr.permute_spectrum(spec, n, half=half)
    assert a.tobytes() == b.tobytes()


def test_plan_tensors_pack_the_host_plan():
    n = 512
    pt = tr.plan_tensors(n, "cpu")
    plan = tr.get_plan(n)
    np.testing.assert_array_equal(pt.f1_re.numpy(), plan.f1_re)
    np.testing.assert_array_equal(pt.f2_im.numpy(), plan.f2_im)
    np.testing.assert_array_equal(
        pt.wn.numpy(), (tr._half_weights(n) / n).astype(np.float32))
    assert pt.packed.numel() == 2 * pt.m1 ** 2 + 2 * pt.m1 * pt.m2 + \
        2 * pt.m2 ** 2 + pt.m1 * (pt.m2 // 2 + 1)


@pytest.mark.parametrize("n,length,half", [
    (256, 128, True), (256, 128, False), (512, 300, True), (128, 128, True),
])
def test_fft_real_matches_jax(rng, n, length, half):
    x = (0.1 * rng.standard_normal((2, 3, length))).astype(np.float32)
    jre, jim = jr.fft_real(jnp.asarray(x), n, half=half)
    tre, tim = tr.fft_real(torch.from_numpy(x), n, half=half)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=2e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=2e-4)


@pytest.mark.parametrize("n", [256, 1024])
def test_inverse_transforms_match_jax(rng, n):
    x = (0.1 * rng.standard_normal((2, n // 2))).astype(np.float32)
    hr, hi = jr.fft_real(jnp.asarray(x), n, half=True)
    fr, fi = jr.fft_real(jnp.asarray(x), n, half=False)
    hr, hi, fr, fi = (np.asarray(a) for a in (hr, hi, fr, fi))
    jh = np.asarray(jr.ifft_from_half(jnp.asarray(hr), jnp.asarray(hi), n))
    th = tr.ifft_from_half(torch.from_numpy(hr), torch.from_numpy(hi), n)
    np.testing.assert_allclose(th.numpy(), jh, atol=2e-4)
    jf = np.asarray(jr.ifft_to_real(jnp.asarray(fr), jnp.asarray(fi), n))
    tf = tr.ifft_to_real(torch.from_numpy(fr), torch.from_numpy(fi), n)
    np.testing.assert_allclose(tf.numpy(), jf, atol=2e-4)
    # Round trip: the zero-padded signal comes back.
    want = np.concatenate([x, np.zeros_like(x)], axis=-1)
    np.testing.assert_allclose(th.numpy(), want, atol=2e-5)


def test_non_power_of_two_rejected():
    with pytest.raises(ValueError):
        tr.get_plan(300)
