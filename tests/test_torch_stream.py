"""The port's engine step as a whole against the JAX package's
``chunk_step`` on the xla path: same inputs (from numpy), outputs and
carried state within 2e-4, over chained chunks including T < P-1 and a
ragged n_valid; and below -90 dB against the float64 oracle of
tests/test_engine.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from folve_tpu.engine import stream as js
from folve_tpu.engine.filter_bank import compile_filter_bank as j_bank
from folve_tpu_torch.convert import (
    bank_from_numpy,
    carry_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from tests.test_engine import oracle, snr_db

torch.set_num_threads(1)


def _jax_chunks(jb, x, n_valid):
    """JAX chunk_step (xla route) over chained chunks of one stream."""
    js.set_mac_impl("xla")
    try:
        st = js.init_state(jb)
        ys = []
        for r in range(x.shape[0]):
            st, y = js.chunk_step(jb, st, jnp.asarray(x[r]), n_valid[r])
            ys.append(np.asarray(y))
        return st, ys
    finally:
        js.set_mac_impl("auto")


def _close_state(tstate, jstate, atol=2e-4):
    for got, f in zip(state_to_numpy(tstate),
                      ("hist_re", "hist_im", "tail", "max_abs")):
        np.testing.assert_allclose(got, np.asarray(getattr(jstate, f)),
                                   atol=atol, err_msg=f)


CASES = [
    # (cin, cout, size, fragm, T, layout)
    (2, 2, 300, 64, 2, "half"),     # P = 5 > T + 1: hist rows shift
    (2, 2, 1024, 128, 8, "half"),   # T >= P-1
    (1, 2, 700, 256, 3, "half"),    # upmix
    (1, 1, 64, 64, 3, "half"),      # P = 1: plain MAC
    (2, 1, 513, 128, 2, "full"),    # full-spectrum layout
]


@pytest.mark.parametrize("cin,cout,size,fragm,t,layout", CASES)
def test_chunk_step_matches_jax_and_oracle(rng, cin, cout, size, fragm, t, layout):
    ir = (rng.standard_normal((cin, cout, size)) / np.sqrt(size)).astype(np.float32)
    jb = j_bank(ir, fragm=fragm, size=size, layout=layout)
    tb = compile_filter_bank(ir, fragm=fragm, size=size, layout=layout, device="cpu")
    rounds = 3
    n = rounds * t * fragm - 37  # ragged end
    audio = np.zeros((rounds * t * fragm, cin), np.float32)
    audio[:n] = rng.standard_normal((n, cin))
    x = audio.reshape(rounds, t, fragm, cin).transpose(0, 1, 3, 2).copy()
    n_valid = [min(t * fragm, n - r * t * fragm) for r in range(rounds)]
    jst, jys = _jax_chunks(jb, x, n_valid)
    st = ts.init_state(tb, device="cpu")
    ys = []
    for r in range(rounds):
        st, y = ts.chunk_step(tb, st, x[r], n_valid[r])
        np.testing.assert_allclose(y.numpy(), jys[r], atol=2e-4)
        ys.append(y.numpy())
    _close_state(st, jst)
    y = np.concatenate(ys).transpose(0, 2, 1).reshape(-1, cout)[:n]
    assert snr_db(oracle(ir, audio[:n]), y) < -90


def _serving_setup(rng, p=5, t=2, fragm=64, s=3, rounds=3):
    ir = rng.standard_normal((2, 2, p * fragm - 7)).astype(np.float32)
    jb = j_bank(ir, fragm=fragm)
    tb = compile_filter_bank(ir, fragm=fragm, device="cpu")
    x = rng.standard_normal((rounds, s, t, 2, fragm)).astype(np.float32)
    nv = np.array([[t * fragm] * s] * (rounds - 1)
                  + [[t * fragm, t * fragm - 9, 1][:s]])
    refs = [_jax_chunks(jb, x[:, i], nv[:, i]) for i in range(s)]
    return tb, x, nv, refs


def test_serving_and_fused_pre_match_jax_over_chained_chunks(rng):
    """The canonical route and the carry's ring against the JAX package;
    the ring's head runs 0, 2, 0, 2 (P = 5, T = 2), wraps inside a step's
    rows (P = 5, T = 3: 0, 3, 2, 1, 0) and steps past T > P-1 (P = 3,
    T = 5)."""
    for p, t, rounds in ((5, 2, 3), (5, 3, 4), (3, 5, 3)):
        tb, x, nv, refs = _serving_setup(rng, p=p, t=t, rounds=rounds)
        s = x.shape[1]
        assert ts.fused_serving_supported(tb, t)
        states = ts.stack_states([ts.init_state(tb, device="cpu")] * s)
        carry = ts.fused_carry_init(tb, s)
        for r in range(rounds):
            states, y = ts.serving_chunk_step(tb, states, x[r], nv[r])
            carry, y5 = ts.fused_serving_step_pre(
                tb, carry, ts.stage_x_for_fused(tb, x[r]), nv[r])
            assert carry.head == (r + 1) * t % (p - 1)
            for i in range(s):
                np.testing.assert_allclose(y[i].numpy(), refs[i][1][r], atol=2e-4)
                np.testing.assert_allclose(
                    y5[i].reshape(y[i].shape).numpy(), refs[i][1][r], atol=2e-4)
        back = ts.states_from_carry(tb, carry)
        for i in range(s):
            _close_state(ts.unstack_state(states, i), refs[i][0])
            _close_state(ts.unstack_state(back, i), refs[i][0])


def test_fused_scheduler_steps_run_ring_mode_and_serving_chunk_step_does_not(rng):
    """Every fused scheduler step (the first from head 0, the rest
    gathered from one parent) runs the kernel in ring mode, and its
    streams' states read back oldest first; a canonical StreamState's
    callers keep the copy-out route."""
    from folve_tpu_torch.engine.kernels import conv_step as tcs
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler
    from tests.test_torch_runtime import _submit_round

    fragm, t, s, rounds = 64, 3, 4, 3
    ir = rng.standard_normal((2, 2, 5 * fragm - 7)).astype(np.float32)
    tb = compile_filter_bank(ir, fragm=fragm, device="cpu")
    x = rng.standard_normal((rounds, s, t, 2, fragm)).astype(np.float32)
    nv = [t * fragm] * s
    sched = DeviceScheduler(max_batch=s, window_s=0.5, device="cpu")
    states = [ts.init_state(tb, device="cpu")] * s
    before = tcs.conv_step_fused.ring_steps
    try:
        for r in range(rounds):
            out = _submit_round(sched, [tb] * s, states, x[r], nv)
            states = [o[0] for o in out]
    finally:
        sched.stop()
    assert sched.fused_steps == sched.steps == rounds
    assert sched.fused_fast_steps == rounds - 1
    assert tcs.conv_step_fused.ring_steps - before == rounds
    assert states[0].parent.carry.head == rounds * t % 4
    ref = ts.stack_states([ts.init_state(tb, device="cpu")] * s)
    before = tcs.conv_step_fused.ring_steps
    for r in range(rounds):
        ref, _ = ts.serving_chunk_step(tb, ref, x[r], nv)
    ts.single_chunk_step(tb, ts.init_state(tb, device="cpu"), x[0, 0])
    assert tcs.conv_step_fused.ring_steps == before
    for i in range(s):
        for f in ("hist_re", "hist_im", "tail", "max_abs"):
            np.testing.assert_allclose(getattr(states[i], f).numpy(),
                                       getattr(ref, f)[i].numpy(), atol=1e-5)


def test_single_chunk_step_matches_jax(rng):
    tb, x, nv, refs = _serving_setup(rng, s=2)
    st = ts.init_state(tb, device="cpu")
    for r in range(3):
        st, y = ts.single_chunk_step(tb, st, x[r, 1], nv[r, 1],
                                     h_perm=ts.eager_h_perm(tb))
        np.testing.assert_allclose(y.numpy(), refs[1][1][r], atol=2e-4)
    _close_state(st, refs[1][0])


def test_batched_chunk_step_per_stream_filters(rng):
    fragm, t = 64, 3
    irs = rng.standard_normal((2, 2, 2, 4 * fragm)).astype(np.float32)
    banks = [compile_filter_bank(ir, fragm=fragm, device="cpu") for ir in irs]
    stacked = bank_from_numpy(np.stack([b.h_spec.numpy() for b in banks]),
                              fragm, banks[0].size, device="cpu")
    x = rng.standard_normal((2, t, 2, fragm)).astype(np.float32)
    states = ts.stack_states([ts.init_state(banks[0], device="cpu")] * 2)
    new, y = ts.batched_chunk_step(stacked, states, x, [t * fragm, 5])
    for i, b in enumerate(banks):
        st, yi = ts.chunk_step(b, ts.init_state(b, device="cpu"), x[i],
                               [t * fragm, 5][i])
        np.testing.assert_allclose(y[i].numpy(), yi.numpy(), atol=1e-5)
        np.testing.assert_allclose(new.max_abs[i].numpy(), st.max_abs.numpy())


def test_carry_layouts_match_jax(rng):
    p, fragm, s = 4, 64, 2
    ir = rng.standard_normal((2, 2, p * fragm)).astype(np.float32)
    jb = j_bank(ir, fragm=fragm)
    tb = compile_filter_bank(ir, fragm=fragm, device="cpu")
    k = tb.bins
    fields = (rng.standard_normal((s, p - 1, 2, k)).astype(np.float32),
              rng.standard_normal((s, p - 1, 2, k)).astype(np.float32),
              rng.standard_normal((s, 2, fragm)).astype(np.float32),
              rng.standard_normal((s,)).astype(np.float32))
    names = ("hist_re", "hist_im", "tail", "max_abs")
    jcarry = js.carry_from_states(jb, js.StreamState(*map(jnp.asarray, fields)))
    tcarry = ts.carry_from_states(tb, state_from_numpy(*fields, device="cpu"))
    for f in names:
        assert (np.asarray(getattr(jcarry, f)).tobytes()
                == getattr(tcarry, f).numpy().tobytes()), f
    again = carry_from_numpy(*(np.asarray(getattr(jcarry, f)) for f in names),
                             device="cpu")
    back = ts.states_from_carry(tb, again)
    for a, b in zip(fields, state_to_numpy(back)):
        np.testing.assert_array_equal(a, b)
    z = ts.fused_carry_init(tb, s)
    assert ([tuple(getattr(z, f).shape) for f in names]
            == [tuple(getattr(tcarry, f).shape) for f in names])
    assert tcarry.head == again.head == z.head == 0


def test_reset_and_block_step(rng):
    ir = rng.standard_normal((2, 2, 256)).astype(np.float32)
    tb = compile_filter_bank(ir, fragm=64, device="cpu")
    st = ts.init_state(tb, device="cpu")
    st, y = ts.block_step(tb, st, rng.standard_normal((2, 64)))
    assert tuple(y.shape) == (2, 64) and float(st.max_abs) > 0
    kept = ts.reset_state(st, reset_max=False)
    assert float(kept.tail.abs().max()) == 0 and kept.max_abs is st.max_abs
    assert float(ts.reset_state(st).max_abs) == 0


def test_entry_builds_flagship_step():
    from folve_tpu_torch.entry import entry

    fn, (bank, states, x, n_valid) = entry(device="cpu")
    assert (bank.fragm, bank.partitions, bank.bins) == (8192, 16, 8320)
    assert tuple(x.shape) == (8, 8, 2, 8192)
    assert tuple(states.hist_re.shape) == (8, 15, 2, 8320)
    assert ts.fused_serving_supported(bank, x.shape[1])
