"""A numpy model of the FDL MAC kernels' schedule (``csrc/fdl_mac.cu``,
``mac_kernel`` behind ``folve_fdl_mac_split`` and ``folve_fdl_mac``) as
the kernel indexes them, held against the JAX package's Pallas kernels
run in interpret mode (``pallas_fdl_mac_split`` and ``pallas_fdl_mac``,
one stream per call, as the JAX step vmaps them) at atol 2e-4, the
tolerance of the port's other tests against the JAX kernels.

The kernel runs only on a card; this model repeats on the CPU what its
indices do:
  * the launcher's layout choice (``mac_layout``, its constants copied):
    cg chunks of 8 blocks t, sg streams (shared H whose tile outweighs a
    stream's window rows) and at most 4 bg sub-tiles of 32 bins per
    block, at most 16 warps, halved while the grid has fewer blocks than
    the card has SMs, and pc partitions per pass, the most whose staging
    fits 7 KB a warp;
  * per input channel and pass of partitions, H's tile staged by step
    (step k holds partition p0 + np-1 - k; with per-stream H, the block's
    one stream's) and the window rows (hist then new spectra for the
    split kernel, the concatenated window for the window kernel; zero past
    the window's last row), bins past K loaded from bin K-1;
  * each warp's 8 sums fed by 8 window rows that slide through register
    slots, the pass's steps ending at its last partition;
  * the stores: blocks t past T and bins past K are not written.
A warp's 32 lanes are 32 neighbouring bins of the tile, so the model
holds a block's bins as one vector.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from folve_tpu.engine.kernels.fdl_mac import pallas_fdl_mac, pallas_fdl_mac_split

# kLane, kTBlocks, kMaxWarps, kMaxBins, kSmemPerWarp, and the H100's SMs.
LANE, TT, WARPS, MAX_BINS, SMEM_PER_WARP, SMS = 32, 8, 16, 4, 7 * 1024, 132


def cdiv(a, b):
    return -(-a // b)


def mac_layout(s, p, cout, t, k, shared, sms=SMS):
    """(sg, cg, bg, pc) as the launcher picks them."""
    nch, tiles = cdiv(t, TT), cdiv(k, LANE)
    w = WARPS
    while True:
        cg = min(nch, max(1, w // cout))
        group = shared and p * cout > cg * TT + p
        sg = min(s, max(1, w // (cout * cg))) if group else 1
        bg = min(tiles, MAX_BINS, max(1, w // (cout * cg * sg)))
        if cdiv(s, sg) * cdiv(nch, cg) * cdiv(tiles, bg) >= sms or w <= cout:
            break
        w //= 2
    budget = sg * cout * cg * bg * SMEM_PER_WARP
    pc = TT
    while pc < p and mac_smem(sg, cg, bg, pc + TT, cout) <= budget:
        pc += TT
    return sg, cg, bg, pc


def mac_smem(sg, cg, bg, pc, cout):
    """Staging bytes of a block: H's tile and the window rows, float2."""
    return (pc * cout + sg * (cg * TT + pc)) * bg * LANE * 8


def model_mac(h, row, s_, t_, w_, layout=None):
    """The kernel's function.  ``h`` complex [S or 1, P, Cin, Cout, K];
    ``row(s, w, i)`` window row w of stream s, channel i (complex [K]);
    ``w_`` the window's rows.  Returns complex y [S, T, Cout, K]."""
    hs_, p, cin, cout, k = h.shape
    shared = hs_ == 1
    sg, cg, bg, pc = layout or mac_layout(s_, p, cout, t_, k, shared)
    assert shared or sg == 1
    tb = bg * LANE
    nch = cdiv(t_, TT)
    ncg = cdiv(nch, cg)
    y = np.full((s_, t_, cout, k), np.nan, complex)
    for group in range(cdiv(s_, sg) * ncg):
        s0, c0 = group // ncg * sg, group % ncg * cg
        ns, ncc = min(sg, s_ - s0), min(cg, nch - c0)
        hb = h[0 if shared else s0]
        for tile in range(cdiv(k, tb)):
            bins = tile * tb + np.arange(tb)
            kb = np.minimum(bins, k - 1)  # clamped loads
            acc = np.zeros((ns, cout, ncc, TT, tb), complex)  # warp (us, o, uc)
            for i in range(cin):
                for p0 in range(0, p, pc):
                    npc = min(pc, p - p0)
                    nr, wbase = ncc * TT + npc, c0 * TT + p - p0 - npc
                    hs = np.stack([hb[p0 + npc - 1 - st, i][:, kb] for st in range(npc)])
                    ws = np.zeros((ns, nr, tb), complex)
                    for ss in range(ns):
                        for r in range(nr):
                            if wbase + r < w_:
                                ws[ss, r] = row(s0 + ss, wbase + r, i)[kb]
                    for us in range(ns):
                        for o in range(cout):
                            for uc in range(ncc):
                                slot = [ws[us, uc * TT + q] for q in range(TT)]
                                for base in range(0, npc, TT):
                                    for k8 in range(TT):
                                        st = base + k8
                                        if st >= npc:
                                            break
                                        for j in range(TT):
                                            acc[us, o, uc, j] += hs[st, o] * slot[(j + k8) % TT]
                                        slot[k8] = ws[us, uc * TT + st + TT]
            inb = bins < k
            for us in range(ns):
                for uc in range(ncc):
                    for j in range(TT):
                        t = (c0 + uc) * TT + j
                        if t < t_:
                            y[s0 + us, t, :, bins[inb]] = acc[us, :, uc, j][:, inb].T
    return y


def _h(rng, s, p, cin, cout, k, shared):
    h = rng.standard_normal(((1,) if shared else (s,)) + (p, cin, cout, 2, k))
    return (h / np.sqrt(p * cin)).astype(np.float32)


def _c(a):
    return a[0] + 1j * a[1]


def _close(got, jre, jim):
    np.testing.assert_allclose(got.real, np.asarray(jre), atol=2e-4)
    np.testing.assert_allclose(got.imag, np.asarray(jim), atol=2e-4)


@pytest.mark.parametrize("s,p,t,cin,cout,k,shared,layout", [
    (1, 2, 1, 2, 2, 70, True, None),           # P = 2, T = 1
    (3, 6, 3, 1, 2, 40, False, None),          # T < P-1, S = 3 per-stream H
    (3, 4, 3, 1, 2, 70, True, None),           # T = P-1, S = 3 shared H
    (2, 3, 11, 1, 2, 70, False, None),         # T > P-1, T not a multiple of 8
    (2, 13, 5, 1, 2, 64, True, None),          # P = 13, T = 5
    (2, 13, 9, 1, 1, 40, False, (1, 1, 2, 8)),  # passes of 8, a wide bin tile
    (3, 20, 9, 1, 1, 45, True, (2, 1, 1, 8)),   # passes, stream and chunk groups
])
def test_split_schedule_matches_pallas(rng, s, p, t, cin, cout, k, shared, layout):
    h = _h(rng, s, p, cin, cout, k, shared)
    hist = rng.standard_normal((2, s, p - 1, cin, k)).astype(np.float32)
    x = rng.standard_normal((2, s, t, cin, k)).astype(np.float32)
    row = lambda ss, w, i: _c(hist[:, ss, w, i] if w < p - 1 else x[:, ss, w - (p - 1), i])
    got = model_mac(_c(np.moveaxis(h, -2, 0)), row, s, t, t + p - 1, layout)
    for ss in range(s):
        jre, jim = pallas_fdl_mac_split(
            *(jnp.asarray(a) for a in (h[0 if shared else ss], hist[0, ss], hist[1, ss],
                                       x[0, ss], x[1, ss])), interpret=True)
        _close(got[ss], jre, jim)


@pytest.mark.parametrize("s,p,t,cin,cout,k,shared,layout", [
    (2, 1, 4, 2, 2, 70, True, None),          # P = 1: the window is x alone
    (3, 1, 8, 2, 2, 33, False, None),         # P = 1, per-stream H
    (1, 40, 36, 2, 2, 40, True, None),        # a deep FDL, min(P, T) > 32
    (2, 40, 33, 1, 2, 36, False, (1, 2, 1, 16)),  # deep, passes of 16
    (2, 33, 2, 1, 16, 40, True, None),        # Cin = 1, Cout = 16
    (2, 33, 3, 4, 4, 50, False, None),        # Cin = Cout = 4
])
def test_window_schedule_matches_pallas(rng, s, p, t, cin, cout, k, shared, layout):
    h = _h(rng, s, p, cin, cout, k, shared)
    xall = rng.standard_normal((2, s, t + p - 1, cin, k)).astype(np.float32)
    got = model_mac(_c(np.moveaxis(h, -2, 0)), lambda ss, w, i: _c(xall[:, ss, w, i]),
                    s, t, t + p - 1, layout)
    for ss in range(s):
        jre, jim = pallas_fdl_mac(
            *(jnp.asarray(a) for a in (h[0 if shared else ss], xall[0, ss], xall[1, ss])),
            t, interpret=True)
        _close(got[ss], jre, jim)


def test_mac_layout():
    """The deep filter stages all 128 partitions in one pass of 16-warp
    blocks; the flagship's per-stream batch takes one stream and 4 bin
    sub-tiles per block, its shared batch all 8 streams; at P = 1 the
    one-row H is not worth sharing, so shared H takes the per-stream
    layout; a freq shard's 2,080 bins halve the warps until the grid
    covers the SMs; 16 output channels fill a block."""
    assert mac_layout(1, 128, 2, 64, 8320, True) == (1, 8, 1, 128)
    assert mac_layout(8, 16, 2, 8, 8320, False) == (1, 1, 4, 16)
    assert mac_layout(8, 16, 2, 8, 8320, True) == (8, 1, 1, 16)
    assert mac_layout(8, 1, 2, 8, 8320, True) == (1, 1, 4, 8)
    assert mac_layout(8, 1, 2, 8, 8320, False) == (1, 1, 4, 8)
    assert mac_layout(8, 16, 2, 8, 2080, True) == (2, 1, 1, 16)
    assert mac_layout(3, 9, 16, 20, 2085, True) == (1, 1, 1, 16)
    for s in (1, 3, 8, 64):
        for p, t in ((1, 8), (16, 8), (128, 64), (13, 5)):
            for cin, cout in ((1, 1), (2, 2), (1, 16), (4, 4), (1, 3)):
                for k in (70, 2080, 8320):
                    for shared in (True, False):
                        sg, cg, bg, pc = mac_layout(s, p, cout, t, k, shared)
                        warps = sg * cout * cg * bg
                        assert warps <= WARPS and (shared or sg == 1)
                        assert pc % TT == 0
                        assert mac_smem(sg, cg, bg, pc, cout) <= warps * SMEM_PER_WARP
