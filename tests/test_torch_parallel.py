"""The port's window-MAC routes and freq-sharded serving against the JAX
package: ``chunk_step`` at P = 1 and at a deep FDL (P = 40, T = 36)
against JAX ``chunk_step`` and the float64 oracle; the sharded step on a
mesh of eight CPU entries against JAX ``make_sharded_serving_step`` on the
virtual 8-device mesh (outputs and states, atol 2e-4 as in
``test_torch_stream.py``); ``DeviceScheduler(mesh=...)`` against
per-stream ``chunk_step``; ``dryrun_multichip``."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from folve_tpu.engine import stream as js
from folve_tpu.engine.filter_bank import compile_filter_bank as j_bank
from folve_tpu.parallel import serving as jserve
from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.parallel import serving as tserve
from folve_tpu_torch.runtime.scheduler import DeviceScheduler, ShardedStateRef
from tests.test_engine import oracle, snr_db

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def has8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _routes(monkeypatch):
    """Record which MAC the engine step runs."""
    seen = []
    for name in ("fdl_mac", "fdl_mac_split", "fdl_mac_einsum"):
        fn = getattr(ts, name)

        def spy(*a, _fn=fn, _name=name):
            seen.append(_name)
            return _fn(*a)

        monkeypatch.setattr(ts, name, spy)
    return seen


@pytest.mark.parametrize("cin,cout,size,fragm,t", [
    (2, 2, 100, 128, 4),      # P = 1: the window is the new spectra alone
    (2, 2, 40 * 64 - 5, 64, 36),  # P = 40, T = 36: min(P, T) > 32
])
def test_window_route_chunk_step_matches_jax_and_oracle(rng, monkeypatch, cin,
                                                        cout, size, fragm, t):
    ir = (rng.standard_normal((cin, cout, size)) / np.sqrt(size)).astype(np.float32)
    jb = j_bank(ir, fragm=fragm, size=size)
    tb = compile_filter_bank(ir, fragm=fragm, size=size, device="cpu")
    rounds = 2
    n = rounds * t * fragm - 29
    audio = np.zeros((rounds * t * fragm, cin), np.float32)
    audio[:n] = rng.standard_normal((n, cin))
    x = audio.reshape(rounds, t, fragm, cin).transpose(0, 1, 3, 2).copy()
    nv = [min(t * fragm, n - r * t * fragm) for r in range(rounds)]
    jst = js.init_state(jb)
    st = ts.init_state(tb, device="cpu")
    seen = _routes(monkeypatch)
    ys = []
    for r in range(rounds):
        jst, jy = js.chunk_step(jb, jst, jnp.asarray(x[r]), nv[r])
        st, y = ts.chunk_step(tb, st, x[r], nv[r])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4)
        ys.append(y.numpy())
    assert seen == ["fdl_mac"] * rounds
    for f in ("hist_re", "hist_im", "tail", "max_abs"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=2e-4)
    got = np.concatenate(ys).transpose(0, 2, 1).reshape(-1, cout)[:n]
    assert snr_db(oracle(ir, audio[:n]), got) < -90


def _inputs(rng, s, t, fragm, size, layout="half", channels=(2, 2)):
    """Per-stream banks and a nonzero starting state (so the states'
    sharding is exercised), as numpy for both packages."""
    cin, cout = channels
    irs = [(rng.standard_normal((cin, cout, size)) / np.sqrt(size)).astype(np.float32)
           for _ in range(s)]
    h = np.stack([np.asarray(j_bank(ir, fragm=fragm, size=size, layout=layout).h_spec)
                  for ir in irs])
    p, k = h.shape[1], h.shape[-1]
    hist = [(0.1 * rng.standard_normal((s, p - 1, cin, k))).astype(np.float32)
            for _ in range(2)]
    tail = (0.1 * rng.standard_normal((s, cout, fragm))).astype(np.float32)
    max_abs = np.zeros(s, np.float32)
    x = rng.standard_normal((s, t, cin, fragm)).astype(np.float32)
    n_valid = np.array([t * fragm] * (s - 1) + [t * fragm - 37], np.int32)
    return irs, (h, *hist, tail, max_abs, x, n_valid)


def _both_steps(args, fragm, freq, shared=False):
    jmesh = jserve.make_serving_mesh(8, freq_parallel=freq)
    jout = jserve.make_sharded_serving_step(jmesh, fragm, shared_bank=shared)(
        *jserve.shard_states_and_bank(jmesh, *args, shared_bank=shared))
    tmesh = tserve.make_serving_mesh(8, freq_parallel=freq, devices=CPU8)
    tout = tserve.make_sharded_serving_step(tmesh, fragm, shared_bank=shared)(
        *tserve.shard_states_and_bank(tmesh, *args, shared_bank=shared))
    return jout, tout


def _close_outputs(jout, tout, atol=2e-4):
    for name, j, t in zip(("hist_re", "hist_im", "tail", "max_abs", "y"), jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", ["half", "full"])
@pytest.mark.parametrize("freq", [1, 2, 4])
def test_sharded_step_matches_jax(rng, has8, layout, freq):
    fragm, size, s, t = 128, 512, 8, 3
    _, args = _inputs(rng, s, t, fragm, size, layout)
    _close_outputs(*_both_steps(args, fragm, freq))


def test_sharded_shared_bank_matches_jax(rng, has8):
    fragm, size, s, t = 128, 512, 8, 2
    _, args = _inputs(rng, s, t, fragm, size)
    args = (args[0][0],) + args[1:]
    _close_outputs(*_both_steps(args, fragm, 2, shared=True))


def test_sharded_many_channels_einsum_matches_jax(rng, has8, monkeypatch):
    fragm, size, s, t = 128, 256, 8, 2
    _, args = _inputs(rng, s, t, fragm, size, channels=(5, 4))
    seen = _routes(monkeypatch)
    jout, tout = _both_steps(args, fragm, 2)
    assert set(seen) == {"fdl_mac_einsum"}
    _close_outputs(jout, tout, atol=3e-4)


def test_sharded_streaming_continuity(rng):
    """Two sharded steps, the first's outputs fed back as they are, equal
    one long convolution (float64 oracle)."""
    fragm, size, s = 128, 384, 8
    irs, (h, hr, hi, tail, mx, x, nv) = _inputs(rng, s, 4, fragm, size)
    mesh = tserve.make_serving_mesh(8, freq_parallel=2, devices=CPU8)
    step = tserve.make_sharded_serving_step(mesh, fragm)
    zero = lambda a: np.zeros_like(a)
    placed = tserve.shard_states_and_bank(
        mesh, h, zero(hr), zero(hi), zero(tail), mx, x[:, :2],
        np.full(s, 2 * fragm))
    r1, i1, t1, m1, y1 = step(*placed)
    *_, y2 = step(placed[0], r1, i1, t1, m1, x[:, 2:], placed[6])
    y = np.concatenate([y1.numpy(), y2.numpy()], axis=1)
    for i in range(s):
        flat = x[i].transpose(0, 2, 1).reshape(-1, 2)
        got = y[i].transpose(0, 2, 1).reshape(-1, 2)
        assert snr_db(oracle(irs[i], flat), got) < -90


def _pump(sched, banks, states, xs, nv):
    """All streams submit at once (barrier) so they share one batch."""
    out = [None] * len(banks)
    barrier = threading.Barrier(len(banks))

    def go(i):
        barrier.wait(timeout=30)
        out[i] = sched.submit(banks[i], states[i], xs[i], nv[i]).result(timeout=60)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(banks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    return out


@pytest.mark.parametrize("shared", [True, False])
def test_scheduler_on_mesh_equals_per_stream_chunk_step(rng, shared):
    fragm, t, streams = 64, 2, 6  # 6 streams pad to 8 = 2 mesh rows x 4
    irs = rng.standard_normal((2, 2, 2, 5 * fragm - 3)).astype(np.float32)
    pool = [compile_filter_bank(ir, fragm=fragm, device="cpu") for ir in irs]
    banks = [pool[0] if shared else pool[i % 2] for i in range(streams)]
    mesh = tserve.make_serving_mesh(freq_parallel=4, devices=CPU8)
    sched = DeviceScheduler(max_batch=8, window_s=0.5, device="cpu", mesh=mesh)
    states = [ts.init_state(b, device="cpu") for b in banks]
    ref = list(states)
    try:
        for r in range(3):
            xs = rng.standard_normal((streams, t, 2, fragm)).astype(np.float32)
            nv = [t * fragm] * (streams - 1) + [t * fragm - 5]
            out = _pump(sched, banks, states, xs, nv)
            for i in range(streams):
                states[i], y = out[i]
                ref[i], ry = ts.chunk_step(banks[i], ref[i], xs[i], nv[i])
                np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-5)
    finally:
        sched.stop()
    assert all(isinstance(st, ShardedStateRef) for st in states)
    assert sched.sharded_steps == sched.steps == 3
    assert sched.sharded_fast_steps == 2  # steps 2 and 3 gather on the mesh
    for st, rs in zip(states, ref):
        for f in ("hist_re", "hist_im", "tail", "max_abs"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(rs, f).numpy(), atol=1e-5)


def test_scheduler_non_shardable_bank_takes_single_device_step(rng):
    # m1 = 16 rows at fragm 64 do not split into 3 freq shards.
    assert not tserve.check_freq_shardable(64, compile_filter_bank(
        np.ones((1, 1, 64), np.float32), fragm=64, device="cpu").bins, 3)
    bank = compile_filter_bank(rng.standard_normal((2, 2, 200)).astype(np.float32),
                               fragm=64, device="cpu")
    mesh = tserve.make_serving_mesh(freq_parallel=3, devices=["cpu"] * 3)
    sched = DeviceScheduler(max_batch=2, window_s=0.5, device="cpu", mesh=mesh)
    xs = rng.standard_normal((2, 3, 2, 64)).astype(np.float32)
    try:
        out = _pump(sched, [bank] * 2, [ts.init_state(bank, device="cpu")] * 2,
                    xs, [192, 192])
    finally:
        sched.stop()
    assert sched.steps == 1 and sched.sharded_steps == 0
    for i in range(2):
        _, ry = ts.chunk_step(bank, ts.init_state(bank, device="cpu"), xs[i], 192)
        np.testing.assert_allclose(out[i][1].numpy(), ry.numpy(), atol=1e-5)


def test_check_freq_shardable_matches_jax():
    for fragm, bins, f in [(128, 72, 4), (128, 256, 4), (128, 255, 4),
                           (128, 256, 32), (8192, 8320, 4), (8192, 8320, 3)]:
        assert (tserve.check_freq_shardable(fragm, bins, f)
                == jserve.check_freq_shardable(fragm, bins, f))


def test_sharded_array_layout_and_take(rng):
    mesh = tserve.make_serving_mesh(8, freq_parallel=2, devices=CPU8)
    a = rng.standard_normal((8, 3, 2, 10)).astype(np.float32)
    sa = tserve.ShardedArray.place(mesh, a, tserve.SPEC_HIST)
    assert tuple(sa.parts[1][1].shape) == (2, 3, 2, 5)
    np.testing.assert_array_equal(sa.numpy(), a)
    idx = [7, 0, 3, 3, 1, 6, 2, 5]
    np.testing.assert_array_equal(sa.take(idx).numpy(), a[idx])
    np.testing.assert_array_equal(sa.row(5).numpy(), a[5])
    with pytest.raises(ValueError):
        tserve.ShardedArray.place(mesh, a[:6], tserve.SPEC_HIST)


def test_dryrun_multichip():
    from folve_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
