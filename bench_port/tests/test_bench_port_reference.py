"""``reference.py`` against ``numpy.convolve``, and its TF32 rounding."""

import bench_port_tiny  # noqa: F401
import numpy as np
import pytest

from bench_port import reference


def _filt(maxsize, impulses):
    return {"convolver": {"inputs": 2, "outputs": 2, "partition": 64, "maxsize": maxsize},
            "impulses": impulses}


def test_dense_ir_adds_reads_and_diracs():
    rng = np.random.default_rng(1)
    ch = rng.standard_normal((50, 3)).astype(np.float32)
    filt = _filt(40, [{"in": 1, "out": 2, "gain": 0.5, "chan": 3},
                      {"in": 1, "out": 2, "gain": 2.0, "dirac": 7},
                      {"in": 2, "out": 2, "gain": 1.0, "chan": 1}])
    ir = reference.dense_ir(filt, ch)
    assert ir.shape == (2, 2, 40)
    want = 0.5 * ch[:40, 2].astype(np.float64)
    want[7] += 2.0
    np.testing.assert_array_equal(ir[0, 1], want)
    np.testing.assert_array_equal(ir[1, 1], ch[:40, 0].astype(np.float64))
    assert not ir[0, 0].any() and not ir[1, 0].any()


@pytest.mark.parametrize("start", [0, 5, 130, 1000])
def test_convolver_matches_numpy_convolve(start):
    rng = np.random.default_rng(start)
    ir = rng.standard_normal((2, 2, 37))
    ir[1, 0] = 0.0
    period = 96
    sig = rng.standard_normal((2, period))
    n_out = 24
    got = reference.Convolver(ir, n_out)(sig, start)
    # The stream plays sig over and over from sample 0: build it whole.
    reps = (start + n_out) // period + 2
    x = np.tile(sig, reps)
    for o in range(2):
        want = sum(np.convolve(x[i], ir[i, o])[start : start + n_out] for i in range(2))
        np.testing.assert_allclose(got[o], want, rtol=0, atol=1e-12)


def test_periodic_segment_is_silent_before_the_start():
    sig = np.arange(1, 7, dtype=np.float64).reshape(1, 6)
    seg = reference.periodic_segment(sig, -3, 10)
    np.testing.assert_array_equal(seg[0], [0, 0, 0, 1, 2, 3, 4, 5, 6, 1])


def test_snr_db():
    ref = np.ones(100)
    assert reference.snr_db(ref, ref) < -290
    assert reference.snr_db(ref, ref * 1.001) == pytest.approx(-60.0)


def test_tf32_keeps_ten_mantissa_bits_and_rounds_to_nearest():
    x = np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0], np.float32)
    got = reference.tf32(x)
    np.testing.assert_array_equal(got, [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0])
    rng = np.random.default_rng(0)
    y = rng.standard_normal(10000).astype(np.float32)
    rel = np.abs(reference.tf32(y) - y) / np.abs(y)
    assert rel.max() <= 2**-11 * 1.0001
    assert rel.max() > 2**-12
