"""A numpy model of the fused conv-step kernel's schedule
(``csrc/conv_step.cu``), its four phases as the kernel indexes them,
held against the JAX package's Pallas kernel run in interpret mode
(``pallas_conv_step_fused``, and ``pallas_conv_step_fused_pre`` with the
transposed hist carry; passes=6, full float32 dots) at atol 2e-4, the
reference's own tolerance.

The kernel runs only on a card; this model repeats on the CPU what its
indices do:
  A  the forward FFT of each (s, t, i) into scratch X in the kernel's bin
     order kk = c*m1 + q, and the overlap-add targets pre-set from
     channel i for the outputs o = i (mod Cin);
  B  the MAC by blocks of (a tile of 32 bins, a group of streams and
     chunks of 8 blocks): per input channel and pass of partitions, H's
     tile staged by step and the window rows (window row w from the hist
     for w < P-1, else from X, zero past the window's end), a warp's 8
     sums fed by 8 window rows that slide through registers, the weights
     wn, and, in copy-out mode, the new hist hist_out[j] = W[T + j] in
     either hist layout from the blocks of the first chunk group;
  C  in ring mode (a head: window row w < P-1 is the hist's slot
     (head + w) mod (P-1)) first X[s, t, i] (i = o mod Cout) into slot
     (head + t) mod (P-1) of the hist for the last min(T, P-1) blocks t,
     then the inverse of each (s, t, o) and the overlap-add as two-term
     sums;
  D  the masked max|y| per stream.
The spectra themselves come from numpy's FFT in float64.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from folve_tpu.engine.filter_bank import compile_filter_bank as j_bank
from folve_tpu.engine.kernels import conv_step as jcs
from folve_tpu_torch.engine import rfft

# MAC: bins per tile, blocks per unit, warps per block, staging budget
# (kTileBins, kTBlocks, kMacWarps, kMacSmem).
TB, TT, WARPS, SMEM = 32, 8, 16, 96 * 1024


def mac_layout(s, p, cout, t):
    """(sg, cg, pc) as the launcher picks them: sg streams and cg chunks of
    TT blocks per MAC block (one warp per (stream, o, chunk), at most
    WARPS), and the most partitions per pass, a multiple of TT, whose
    staging (H's tile and the window rows) fits SMEM."""
    nch = -(-t // TT)
    cg = min(nch, max(1, WARPS // cout))
    sg = min(s, max(1, WARPS // (cout * cg)))
    smem = lambda pc: (pc * cout + sg * (cg * TT + pc)) * TB * 8
    pc = TT
    while pc < p and smem(pc + TT) <= SMEM:
        pc += TT
    return sg, cg, pc


def model_step(hp, x, hist_re, hist_im, tail, valid, n, hist_t, layout=None,
               head=None, paths=None):
    """The kernel's function, phase by phase.  ``hp`` [P, Cin, Cout, 2, K]
    in bin order kk; ``x`` [S, T, Cin, B]; the hist [S, P-1, Cin, K]
    canonical or, with ``hist_t``, in bin order kk, oldest row first or,
    with ``head``, a ring whose oldest row is slot ``head``; ``tail``
    [S, Cout, B]; ``valid`` [S, T]; ``paths`` the (i, o) pairs the MAC
    computes (default: all).  Returns (y, hist_re', hist_im', tail',
    max), the hist a ring too with ``head``."""
    p, cin, cout, _, k = hp.shape
    # The launcher's path table: a mask of live outputs per input, and
    # those outputs in order, four bits each.
    masks = [0] * cin
    for i, o in (paths if paths is not None else
                 [(i, o) for i in range(cin) for o in range(cout)]):
        masks[i] |= 1 << o
    outs = [sum(o << (4 * j) for j, o in enumerate(o for o in range(cout) if m >> o & 1))
            for m in masks]
    s_, t_ = x.shape[:2]
    b = n // 2
    plan = rfft.get_plan(n)
    m1, cols = plan.m1, plan.m2 // 2 + 1
    sg, cg, pc = layout or mac_layout(s_, p, cout, t_)
    wn = rfft.plan_tensors(n, "cpu").wn.numpy().astype(np.float64).ravel()
    canon = lambda kk: (kk % m1) * cols + kk // m1
    hist = (hist_re + 1j * hist_im).reshape(s_, p - 1, cin, k)
    h = hp[:, :, :, 0] + 1j * hp[:, :, :, 1]
    freq = np.arange(m1)[:, None] + m1 * np.arange(cols)[None]  # bin (q, c)

    # A: spectra into X [S, T, Cin, K] (bin kk); the pre-set targets.
    xs = np.zeros((s_, t_, cin, k), complex)
    y = np.zeros((s_, t_, cout, b))
    for s in range(s_):
        for t in range(t_):
            for i in range(cin):
                xs[s, t, i] = np.fft.fft(x[s, t, i].astype(np.float64), n)[freq].T.ravel()
                for o in range(i, cout, cin):
                    y[s, t, o] = tail[s, o] if t == 0 else 0.0

    def window(s, w, i, kb):
        if w < p - 1:
            slot = w if head is None else (head + w) % (p - 1)
            return hist[s, slot, i, kb if hist_t else canon(kb)]
        return xs[s, w - (p - 1), i, kb]

    # B: blocks (tile of TB bins, group of sg streams and cg chunks).
    ys = np.full((s_, t_, cout, k), np.nan, complex)
    hist_out = np.full((s_, p - 1, cin, k), np.nan, complex)
    if head is not None:  # the ring is written in place
        hist_out = hist.copy()
    nch = -(-t_ // TT)
    ncg = -(-nch // cg)
    for tile in range(-(-k // TB)):
        lanes = tile * TB + np.arange(TB)
        inb = lanes < k
        kb = np.minimum(lanes, k - 1)
        for group in range(-(-s_ // sg) * ncg):
            s0, c0 = group // ncg * sg, group % ncg * cg
            ns, ncc = min(sg, s_ - s0), min(cg, nch - c0)
            acc = np.zeros((ns, cout, ncc, TT, TB), complex)  # one warp per (s, o, chunk)
            for i in range(cin):
                if masks[i] == 0:  # no live path from input i
                    continue
                nl = bin(masks[i]).count("1")
                for p0 in range(0, p, pc):
                    npc = min(pc, p - p0)
                    kp = -(-npc // TT) * TT
                    rows, wbase = ncc * TT + kp, c0 * TT + p - p0 - npc
                    # Step k: partition p0+npc-1-k, of i's live outputs.
                    hs = np.zeros((kp, nl, TB), complex)
                    for st in range(npc):
                        for j in range(nl):
                            oo = (outs[i] >> (4 * j)) & 15
                            hs[st, j] = h[p0 + npc - 1 - st, i, oo][kb]
                    ws = np.zeros((ns, rows, TB), complex)  # zero past row T+P-2
                    for ss in range(ns):
                        for r in range(rows):
                            if wbase + r < t_ + p - 1:
                                ws[ss, r] = window(s0 + ss, wbase + r, i, kb)
                    for us in range(ns):
                        for o in range(cout):
                            if not masks[i] >> o & 1:  # a dead path: the warp sits out
                                continue
                            jo = bin(masks[i] & ((1 << o) - 1)).count("1")
                            for uc in range(ncc):
                                slot = [ws[us, uc * TT + q] for q in range(TT)]
                                for base in range(0, kp, TT):
                                    for k8 in range(TT):
                                        for j in range(TT):
                                            acc[us, o, uc, j] += (hs[base + k8, jo]
                                                                  * slot[(j + k8) % TT])
                                        slot[k8] = ws[us, uc * TT + base + k8 + TT]
            for us in range(ns):
                for o in range(cout):
                    for uc in range(ncc):
                        for j in range(TT):
                            t = (c0 + uc) * TT + j
                            if t < t_:
                                ys[s0 + us, t, o, lanes[inb]] = (acc[us, o, uc, j]
                                                                 * wn[canon(kb)])[inb]
            if c0 == 0 and head is None:  # copy-out: the group's new hist
                for s in range(s0, s0 + ns):
                    for j in range(p - 1):
                        for i in range(cin):
                            for kk in lanes[inb]:
                                hist_out[s, j, i, kk if hist_t else canon(kk)] = (
                                    window(s, t_ + j, i, kk))

    # C: in ring mode the new rows first; inverse of the weighted
    # rectangle, real part; overlap-add.
    e = np.exp(2j * np.pi * np.outer(np.arange(n), freq.ravel()) / n)
    tail_out = np.zeros((s_, cout, b))
    for s in range(s_):
        for t in range(t_):
            for o in range(cout):
                if head is not None and t >= t_ - min(t_, p - 1):
                    for i in range(o, cin, cout):
                        bins = np.arange(k) if hist_t else canon(np.arange(k))
                        hist_out[s, (head + t) % (p - 1), i, bins] = xs[s, t, i]
                v = (e @ ys[s, t, o].reshape(cols, m1).T.ravel()).real
                y[s, t, o] += v[:b]
                if t + 1 < t_:
                    y[s, t + 1, o] += v[b:]
                else:
                    tail_out[s, o] = v[b:]

    # D: masked max|y|.
    mask = np.arange(b)[None, None, None, :] < valid[:, :, None, None]
    mx = np.where(mask, np.abs(y), 0.0).max(axis=(1, 2, 3))
    return y, hist_out.real, hist_out.imag, tail_out, mx


def _inputs(rng, p, t, fragm, cin, cout, s):
    ir = rng.standard_normal((cin, cout, p * fragm - 3)).astype(np.float32)
    hp = np.asarray(jcs.permute_h_for_fused(j_bank(ir, fragm=fragm).h_spec, 2 * fragm))
    k = hp.shape[-1]
    x = rng.standard_normal((s, t, cin, fragm)).astype(np.float32)
    hr = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    hi = rng.standard_normal((s, p - 1, cin, k)).astype(np.float32)
    tail = rng.standard_normal((s, cout, fragm)).astype(np.float32)
    nv = np.array([t * fragm - fragm // 2 - 1, t * fragm, 1][:s])  # ragged first
    valid = np.clip(nv[:, None] - np.arange(t)[None] * fragm, 0, fragm).astype(np.int32)
    return hp, x, hr, hi, tail, valid


def _close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.reshape(g, r.shape), r, atol=2e-4)


@pytest.mark.parametrize("p,t,fragm,cin,cout,s,layout", [
    (4, 6, 64, 2, 2, 3, None),         # T > P-1
    (5, 2, 64, 2, 2, 3, None),         # T < P-1: old hist rows shift
    (4, 3, 64, 2, 2, 2, None),         # T = P-1
    (3, 1, 64, 2, 2, 1, None),         # T = 1, S = 1
    (3, 4, 128, 1, 2, 2, None),        # upmix
    (11, 19, 64, 2, 2, 3, (2, 2, 8)),  # passes of partitions, stream and chunk groups
])
def test_schedule_model_matches_pallas(rng, p, t, fragm, cin, cout, s, layout):
    args = _inputs(rng, p, t, fragm, cin, cout, s)
    ref = jcs.pallas_conv_step_fused(*(jnp.asarray(a) for a in args), 2 * fragm,
                                     interpret=True, passes=6)
    _close(model_step(*args, 2 * fragm, hist_t=False, layout=layout), ref)


@pytest.mark.parametrize("p,t,fragm,cin,cout,s", [
    (4, 2, 64, 2, 2, 2),   # T < P-1
    (3, 8, 128, 2, 2, 1),  # S = 1, T = 8
    (5, 4, 64, 1, 2, 3),   # upmix, T = P-1
])
def test_schedule_model_matches_pallas_hist_t(rng, p, t, fragm, cin, cout, s):
    hp, x, hr, hi, tail, valid = _inputs(rng, p, t, fragm, cin, cout, s)
    n = 2 * fragm
    plan = rfft.get_plan(n)
    m1, m2, cols = plan.m1, plan.m2, plan.m2 // 2 + 1
    tr5 = lambda h: np.ascontiguousarray(h.reshape(s, p - 1, cin, m1, cols).swapaxes(-1, -2))
    args = (hp, x.reshape(s, t, cin, m1 // 2, m2), tr5(hr), tr5(hi),
            tail.reshape(s, cout, m1 // 2, m2))
    ref = jcs.pallas_conv_step_fused_pre(*(jnp.asarray(a) for a in args), jnp.asarray(valid),
                                         n, interpret=True, passes=6, hist_t=True)
    got = model_step(hp, x, args[2], args[3], tail, valid, n, hist_t=True)
    _close(got, ref)


def _tr5(h, s, p, cin, n):
    plan = rfft.get_plan(n)
    m1, cols = plan.m1, plan.m2 // 2 + 1
    return np.ascontiguousarray(h.reshape(s, p - 1, cin, m1, cols).swapaxes(-1, -2))


def _pre_args(x, tail, n):
    plan = rfft.get_plan(n)
    s, t, cin = x.shape[:3]
    return x.reshape(s, t, cin, plan.m1 // 2, plan.m2), tail.reshape(
        tail.shape[0], tail.shape[1], plan.m1 // 2, plan.m2)


@pytest.mark.parametrize("p,t,fragm,cin,cout,s,layout,head", [
    (5, 2, 64, 2, 2, 2, None, 0),        # T < P-1, head 0
    (5, 2, 64, 2, 2, 2, None, 3),        # T < P-1, the new rows wrap
    (4, 3, 64, 1, 2, 2, None, 2),        # T = P-1, upmix
    (4, 6, 64, 2, 2, 1, None, 1),        # T > P-1
    (11, 19, 64, 2, 2, 3, (2, 2, 8), 7), # passes, stream and chunk groups
])
def test_schedule_model_ring_matches_pallas_hist_t(rng, p, t, fragm, cin, cout, s,
                                                   layout, head):
    """Ring mode: the model takes the reference's hist rolled by ``head``
    and its ring, unrolled by the new head, is the reference's hist."""
    hp, x, hr, hi, tail, valid = _inputs(rng, p, t, fragm, cin, cout, s)
    n = 2 * fragm
    hr5, hi5 = _tr5(hr, s, p, cin, n), _tr5(hi, s, p, cin, n)
    x5, tail4 = _pre_args(x, tail, n)
    ref = jcs.pallas_conv_step_fused_pre(
        *(jnp.asarray(a) for a in (hp, x5, hr5, hi5, tail4, valid)), n,
        interpret=True, passes=6, hist_t=True)
    ring = lambda h: np.roll(h, head, axis=1)
    got = list(model_step(hp, x, ring(hr5), ring(hi5), tail, valid, n, hist_t=True,
                          layout=layout, head=head))
    new_head = (head + t) % (p - 1)
    got[1:3] = (np.roll(h.reshape(hr5.shape), -new_head, axis=1) for h in got[1:3])
    _close(got, ref)


def test_schedule_model_ring_chained_states_from_carry(rng):
    """Three chained ring steps (P = 5, T = 3: head 0, 3, 2, 1, the second
    step's rows wrapping) against three chained reference steps:
    ``states_from_carry`` on the model's ring and head gives the
    reference's oldest-first hist."""
    import torch

    from folve_tpu_torch.engine import stream as ts
    from folve_tpu_torch.engine.filter_bank import FilterBank

    p, t, fragm, cin, cout, s = 5, 3, 64, 2, 2, 2
    n = 2 * fragm
    hp, _, hr, hi, tail, valid = _inputs(rng, p, t, fragm, cin, cout, s)
    xs = rng.standard_normal((3, s, t, cin, fragm)).astype(np.float32)
    jr, ji, jt = _tr5(hr, s, p, cin, n), _tr5(hi, s, p, cin, n), tail
    mr, mi, mt, head = jr, ji, tail, 0
    for x in xs:
        x5, tail4 = _pre_args(x, jt, n)
        _, jr, ji, jt, _ = (np.asarray(a) for a in jcs.pallas_conv_step_fused_pre(
            *(jnp.asarray(a) for a in (hp, x5, jr, ji, tail4, valid)), n,
            interpret=True, passes=6, hist_t=True))
        jt = jt.reshape(tail.shape)
        _, mr, mi, mt, _ = model_step(hp, x, mr, mi, mt, valid, n, hist_t=True, head=head)
        mr, mi = mr.reshape(jr.shape), mi.reshape(ji.shape)
        head = (head + t) % (p - 1)
    assert head == 1
    bank = FilterBank(h_spec=torch.zeros(p, cin, cout, 2, hp.shape[-1]), fragm=fragm,
                      size=p * fragm)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    carry = ts.FusedServingCarry(f32(mr), f32(mi), f32(mt), torch.zeros(s), head)
    back = ts.states_from_carry(bank, carry)
    canon = lambda h: h.swapaxes(-1, -2).reshape(s, p - 1, cin, -1)
    np.testing.assert_allclose(back.hist_re.numpy(), canon(jr), atol=2e-4)
    np.testing.assert_allclose(back.hist_im.numpy(), canon(ji), atol=2e-4)
    np.testing.assert_allclose(back.tail.numpy(), jt, atol=2e-4)


# 5.1 bass management (L R C LFE Ls Rs): each main to itself and to the
# sub's output 3, and LFE to output 3 (0-based).
BASS_PATHS = tuple(sorted([(i, i) for i in (0, 1, 2, 4, 5)]
                          + [(i, 3) for i in (0, 1, 2, 3, 4, 5)]))


@pytest.mark.parametrize("head", [None, 1])
def test_schedule_model_path_table_matches_pallas(rng, head):
    """6 x 6 with 11 live paths: the model stages and sums only the
    table's paths and matches the reference's dense kernel on the same
    spectra, whose other 25 pairs are zero; in ring mode too."""
    p, t, fragm, cin, cout, s = 3, 2, 64, 6, 6, 2
    hp, x, hr, hi, tail, valid = _inputs(rng, p, t, fragm, cin, cout, s)
    live = np.zeros((cin, cout), bool)
    live[tuple(np.array(BASS_PATHS).T)] = True
    hp = np.where(live[None, :, :, None, None], hp, 0.0).astype(np.float32)
    n = 2 * fragm
    hr5, hi5 = _tr5(hr, s, p, cin, n), _tr5(hi, s, p, cin, n)
    x5, tail4 = _pre_args(x, tail, n)
    ref = jcs.pallas_conv_step_fused_pre(
        *(jnp.asarray(a) for a in (hp, x5, hr5, hi5, tail4, valid)), n,
        interpret=True, passes=6, hist_t=True)
    ring = (lambda h: h) if head is None else (lambda h: np.roll(h, head, axis=1))
    got = list(model_step(hp, x, ring(hr5), ring(hi5), tail, valid, n, hist_t=True,
                          head=head, paths=BASS_PATHS))
    if head is not None:
        new_head = (head + t) % (p - 1)
        got[1:3] = (np.roll(h.reshape(hr5.shape), -new_head, axis=1) for h in got[1:3])
    _close(got, ref)


def test_mac_layout():
    """At the flagship shape one MAC block holds every stream and H's
    whole tile (H read once per call); at the JAX headline (S = T = 64)
    a block takes one stream's 8 chunks; a deep four-channel bank takes
    its partitions in passes; 16 output channels fill a block's warps."""
    assert mac_layout(8, 16, 2, 8) == (8, 1, 16)
    assert mac_layout(64, 16, 2, 64) == (1, 8, 16)
    assert mac_layout(1, 128, 4, 8) == (1, 1, 72)
    assert mac_layout(17, 20, 1, 5) == (16, 1, 8)
    sg, cg, _ = mac_layout(3, 9, 16, 20)
    assert sg * 16 * cg <= WARPS
