"""A numpy model of the radix FFT kernels (``csrc/fft_radix.cuh``,
``csrc/fft_half.cu``, ``csrc/ifft_half.cu``) in their stage order, run
over the plan tables the kernels read, against the plain transforms of
``folve_tpu_torch.engine.rfft`` (within 1e-6 of max|plain|: both float32,
summed in another order).

The kernels run only on a card; this model repeats their passes on the
CPU: the four-step split n = m1*m2, each m-point FFT split as m = p*q
(register DFTs of p and q points, radix-2 decimation in frequency with
the W_16 constants), the twiddles W_m^j from row 1 of the DFT factors
and W_n^{k1*n2} from ``tw``, the pruned first layer for zero-padded
inputs, the k1-row windows and the half-spectrum weights ``wn``.
"""

import numpy as np
import pytest
import torch

from folve_tpu_torch.engine import rfft

NS = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]
F32 = np.float32

# cos(2*pi*k/16) for k = 0..15, as the kernels' float literals.
_C = [1.0, 0.92387953251128674, 0.70710678118654752, 0.38268343236508977]
COS16 = np.array(_C + [0.0] + [-c for c in _C[:0:-1]]
                 + [-c for c in _C] + [0.0] + _C[:0:-1], F32)
assert COS16.shape == (16,)


def split_p(m):
    return 16 if m >= 128 else 8 if m >= 32 else 4


def brev(k, p):
    r, m = 0, 1
    while m < p:
        r, k, m = (r << 1) | (k & 1), k >> 1, m << 1
    return r


def rot16(re, im, k, inv):
    """(re, im) * W_16^k (W = exp(-2*pi*i/16)), or its conjugate."""
    k &= 15
    if k == 0:
        return re, im
    if k == 8:
        return -re, -im
    c = COS16[k]
    s = COS16[(k + 12) & 15] if inv else -COS16[(k + 12) & 15]
    if k in (4, 12):
        return -im * s, re * s
    return re * c - im * s, re * s + im * c


def dif(re, im, inv, span=None):
    """Radix-2 DIF layers of span ``span``, span/2, ..., 2 over the last
    axis (P points); output k at index brev(k, P)."""
    p = re.shape[-1]
    span = p if span is None else span
    re, im = re.copy(), im.copy()
    while span >= 2:
        h = span // 2
        for s in range(0, p, span):
            for j in range(h):
                a, b = s + j, s + j + h
                ar, ai = re[..., a].copy(), im[..., a].copy()
                br, bi = re[..., b].copy(), im[..., b].copy()
                re[..., a], im[..., a] = ar + br, ai + bi
                re[..., b], im[..., b] = rot16(ar - br, ai - bi, j * (16 // span), inv)
        span = h
    return re, im


def dft_reg(re, im, inv, low_half=False):
    """The kernels' P-point register DFT over the last axis, natural
    output order; ``low_half``: inputs past P/2 are zero (first layer
    pruned)."""
    p = re.shape[-1]
    if low_half:
        re, im = re.copy(), im.copy()
        for j in range(p // 2):
            re[..., j + p // 2], im[..., j + p // 2] = rot16(
                re[..., j], im[..., j], j * (16 // p), inv)
        re, im = dif(re, im, inv, p // 2)
    else:
        re, im = dif(re, im, inv)
    order = [brev(k, p) for k in range(p)]
    return re[..., order], im[..., order]


def cmul(re, im, wr, wi, inv):
    wi = -wi if inv else wi
    return re * wr - im * wi, re * wi + im * wr


def tables(n):
    """The plan tables the kernels read from the packed plan."""
    pt = rfft.plan_tensors(n, "cpu")
    m1, m2 = pt.m1, pt.m2
    return dict(m1=m1, m2=m2, w1=(pt.f1_re[1].numpy(), pt.f1_im[1].numpy()),
                w2=(pt.f2_re[1].numpy(), pt.f2_im[1].numpy()),
                tw=(pt.tw_re.numpy(), pt.tw_im.numpy()), wn=pt.wn.numpy())


def model_forward(x, n, ks, kn):
    """fft_half.cu: x [R, L] -> (re, im) [R, kn*cols]."""
    t = tables(n)
    m1, m2 = t["m1"], t["m2"]
    p1, p2 = split_p(m1), split_p(m2)
    q1, q2 = m1 // p1, m2 // p2
    cols = m2 // 2 + 1
    r, length = x.shape
    a = np.zeros((r, m1 * m2), F32)
    a[:, :length] = x
    a = a.reshape(r, m1, m2)
    # 1A: column n2, residue b, inputs n1 = q1*a + b -> [R, c, b, n2].
    v = a.reshape(r, p1, q1, m2).transpose(0, 2, 3, 1)  # [R, b, n2, a]
    re, im = dft_reg(v, np.zeros_like(v), False, low_half=2 * length <= n)
    bc = np.arange(q1)[:, None] * np.arange(p1)[None]  # [b, c]
    wr, wi = t["w1"][0][bc][:, None], t["w1"][1][bc][:, None]  # [b, 1, c]
    re, im = cmul(re, im, wr, wi, False)
    # 1B: Q1-point DFTs over b for each (c, n2); k1 = c + p1*d.
    re, im = dft_reg(re.transpose(0, 3, 2, 1), im.transpose(0, 3, 2, 1), False)
    # [R, c, n2, d] -> [R, k1, n2] with k1 = c + p1*d.
    re = re.transpose(0, 3, 1, 2).reshape(r, m1, m2)
    im = im.transpose(0, 3, 1, 2).reshape(r, m1, m2)
    re, im = cmul(re, im, t["tw"][0], t["tw"][1], False)
    re, im = re[:, ks:ks + kn], im[:, ks:ks + kn]
    # 2A: row kk, residue b2, inputs n2 = q2*a + b2 -> [R, kk, b2, c2].
    re, im = (z.reshape(r, kn, p2, q2).transpose(0, 1, 3, 2) for z in (re, im))
    re, im = dft_reg(re, im, False)
    bc = np.arange(q2)[:, None] * np.arange(p2)[None]
    re, im = cmul(re, im, t["w2"][0][bc], t["w2"][1][bc], False)
    # 2B: Q2-point DFTs over b2; k2 = c2 + p2*d2.
    re, im = dft_reg(re.transpose(0, 1, 3, 2), im.transpose(0, 1, 3, 2), False)
    re = re.transpose(0, 1, 3, 2).reshape(r, kn, m2)[..., :cols]
    im = im.transpose(0, 1, 3, 2).reshape(r, kn, m2)[..., :cols]
    return re.reshape(r, -1), im.reshape(r, -1)


def model_inverse(yr, yi, n, ks, kn):
    """ifft_half.cu over a window: yr, yi [R, kn*cols] -> [R, n]."""
    t = tables(n)
    m1, m2 = t["m1"], t["m2"]
    p1, p2 = split_p(m1), split_p(m2)
    q1, q2 = m1 // p1, m2 // p2
    cols = m2 // 2 + 1
    r = yr.shape[0]
    w = t["wn"][ks:ks + kn]
    re = np.zeros((r, kn, m2), F32)
    im = np.zeros((r, kn, m2), F32)
    re[..., :cols] = yr.reshape(r, kn, cols) * w
    im[..., :cols] = yi.reshape(r, kn, cols) * w
    # 1'A: inputs c = q2*a + b, low half plus bin m2/2 at b = 0.
    vr = re.reshape(r, kn, p2, q2).transpose(0, 1, 3, 2).copy()  # [R, kk, b, a]
    vi = im.reshape(r, kn, p2, q2).transpose(0, 1, 3, 2).copy()
    er, ei = vr[:, :, 0, p2 // 2].copy(), vi[:, :, 0, p2 // 2].copy()
    vr[..., p2 // 2:] = 0
    vi[..., p2 // 2:] = 0
    vr, vi = dft_reg(vr, vi, True, low_half=True)
    sgn = np.where(np.arange(p2) % 2, F32(-1), F32(1))
    vr[:, :, 0] += sgn * er[..., None]
    vi[:, :, 0] += sgn * ei[..., None]
    bc = np.arange(q2)[:, None] * np.arange(p2)[None]
    vr, vi = cmul(vr, vi, t["w2"][0][bc], t["w2"][1][bc], True)
    # 1'B: Q2-point DFTs over b; n2 = c2 + p2*d; conjugate twiddle.
    vr, vi = dft_reg(vr.transpose(0, 1, 3, 2), vi.transpose(0, 1, 3, 2), True)
    vr = vr.transpose(0, 1, 3, 2).reshape(r, kn, m2)
    vi = vi.transpose(0, 1, 3, 2).reshape(r, kn, m2)
    tr, ti = t["tw"][0][ks:ks + kn], t["tw"][1][ks:ks + kn]
    vr, vi = cmul(vr, vi, tr, ti, True)
    # 2'A: column n2, inputs k1 = q1*a + b, zero outside the window.
    ur = np.zeros((r, m1, m2), F32)
    ui = np.zeros((r, m1, m2), F32)
    ur[:, ks:ks + kn], ui[:, ks:ks + kn] = vr, vi
    ur = ur.reshape(r, p1, q1, m2).transpose(0, 2, 3, 1)  # [R, b, n2, a]
    ui = ui.reshape(r, p1, q1, m2).transpose(0, 2, 3, 1)
    ur, ui = dft_reg(ur, ui, True)
    bc = np.arange(q1)[:, None] * np.arange(p1)[None]
    ur, ui = cmul(ur, ui, t["w1"][0][bc][:, None], t["w1"][1][bc][:, None], True)
    # 2'B: Q1-point DFTs over b; sample (c + p1*d)*m2 + n2, real part.
    ur, _ = dft_reg(ur.transpose(0, 3, 2, 1), ui.transpose(0, 3, 2, 1), True)
    return ur.transpose(0, 3, 1, 2).reshape(r, n)  # [R, d, c, n2]


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("n", NS)
def test_plan_tables_hold_the_radix_twiddles(n):
    """Row 1 of f1 and f2 is W_m^j and tw is W_n^{k1*n2}, each the
    float64 value rounded once to float32."""
    t = tables(n)
    for m, (wr, wi) in ((t["m1"], t["w1"]), (t["m2"], t["w2"])):
        w = np.exp(-2j * np.pi * np.arange(m) / m)
        np.testing.assert_array_equal(wr, w.real.astype(F32))
        np.testing.assert_array_equal(wi, w.imag.astype(F32))
    k1n2 = np.outer(np.arange(t["m1"]), np.arange(t["m2"]))
    np.testing.assert_array_equal(t["tw"][0], np.cos(-2 * np.pi * k1n2 / n).astype(F32))
    c = np.cos(2 * np.pi * np.arange(16) / 16)
    assert np.max(np.abs(COS16 - c)) < 3e-8


@pytest.mark.parametrize("n", NS)
def test_forward_model_matches_fft_real_half(rng, n):
    m1 = rfft.get_plan(n).m1
    for length in (n // 2 - 3, n // 2, n):
        x = rng.standard_normal((2, length)).astype(F32)
        for ks, kn in ((0, m1), (0, m1 // 2), (m1 // 4, m1 // 4), (m1 - m1 // 8, m1 // 8)):
            got = model_forward(x, n, ks, kn)
            ref = rfft.fft_real(torch.from_numpy(x), n, half=True, k1_start=ks, k1_n=kn)
            assert _rel(np.stack(got), torch.stack(ref).numpy()) < 1e-6, (length, ks, kn)


@pytest.mark.parametrize("n", NS)
def test_inverse_model_matches_ifft_from_half(rng, n):
    plan = rfft.get_plan(n)
    m1, cols = plan.m1, plan.m2 // 2 + 1
    yr = rng.standard_normal((2, m1, cols)).astype(F32)
    yi = rng.standard_normal((2, m1, cols)).astype(F32)
    whole = rfft.ifft_from_half(torch.from_numpy(yr.reshape(2, -1)),
                                torch.from_numpy(yi.reshape(2, -1)), n).numpy()
    assert _rel(model_inverse(yr.reshape(2, -1), yi.reshape(2, -1), n, 0, m1), whole) < 1e-6
    for freq in (2, 4, 8):
        kn, total = m1 // freq, 0
        for f in range(freq):
            wr = yr[:, f * kn:(f + 1) * kn].reshape(2, -1)
            wi = yi[:, f * kn:(f + 1) * kn].reshape(2, -1)
            part = model_inverse(wr, wi, n, f * kn, kn)
            ref = rfft.ifft_from_half(torch.from_numpy(wr), torch.from_numpy(wi), n,
                                      k1_start=f * kn, k1_n=kn).numpy()
            assert _rel(part, ref) < 1e-6, (freq, f)
            total = total + part
        assert _rel(total, whole) < 1e-6, freq
