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
from folve_tpu_torch.engine.kernels.fdl_mac import (
    fdl_mac,
    fdl_mac_plain,
    fdl_mac_split,
    fdl_mac_split_plain,
)
from folve_tpu_torch.engine.kernels.fft_half import (
    fft_real_half,
    fft_real_half_plain,
    fft_real_half_rows,
    fft_real_half_rows_plain,
)
from folve_tpu_torch.engine.kernels.ifft_half import (
    ifft_from_half,
    ifft_from_half_plain,
    ifft_ola,
    ifft_ola_plain,
    ifft_partial_rows,
    ifft_partial_rows_plain,
)
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


FRAGMS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]  # n = 128 ... 16384


@pytest.mark.cuda
@pytest.mark.parametrize("fragm", FRAGMS)
@pytest.mark.parametrize("t", [1, 3])
def test_split_kernels_match_plain_on_card(cuda, rng, fragm, t):
    """Every FFT size (m1 = m2 and m1 = 2*m2), the forward at L < n/2,
    L = n/2 and L = n, and the overlap-add at T = 1 and T > 1."""
    n, s, p, cin, cout = 2 * fragm, 2, 4, 2, 2
    k = half_bins(n)
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    for length in (fragm - 3, fragm, n):
        x = cu(s, t, cin, length)
        assert _rel_err(fft_real_half(x, n), fft_real_half_plain(x, n)) < 1e-5, length
    h, hr, hi = cu(s, p, cin, cout, 2, k), cu(s, p - 1, cin, k), cu(s, p - 1, cin, k)
    xr, xi = cu(s, t, cin, k), cu(s, t, cin, k)
    assert _rel_err(fdl_mac_split(h[0], hr, hi, xr, xi),
                    fdl_mac_split_plain(h[0], hr, hi, xr, xi)) < 1e-5
    assert _rel_err(fdl_mac_split(h, hr, hi, xr, xi),
                    fdl_mac_split_plain(h, hr, hi, xr, xi)) < 1e-5
    yr, yi, tail = cu(s, t, cout, k), cu(s, t, cout, k), cu(s, cout, fragm)
    assert _rel_err(ifft_ola(yr, yi, tail, n), ifft_ola_plain(yr, yi, tail, n)) < 1e-5
    torch.cuda.synchronize()


def _fused_case(cuda, rng, p, t, fragm, hist_t, cin=2, cout=2, s=3):
    """Kernel 1's inputs on the card, the hist in the layout ``hist_t``
    names."""
    hp, x, hr, hi, tail, valid = _fused_inputs(rng, p, t, fragm, cin, cout, s)
    if hist_t:
        rows, m2, m1, cols = tcs.fused_preshape(2 * fragm)
        hr, hi = (np.ascontiguousarray(h.reshape(s, p - 1, cin, m1, cols).swapaxes(-1, -2))
                  for h in (hr, hi))
    args = [_t(a).to(cuda) for a in (hp, x, hr, hi, tail)]
    return (*args, torch.from_numpy(valid).to(cuda), 2 * fragm)


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,fragm,hist_t,cin,cout,s,head", [
    (4, 6, 64, False, 2, 2, 3, None),      # T > P-1
    (5, 2, 256, True, 2, 2, 3, None),      # T < P-1
    (4, 3, 64, True, 2, 2, 2, None),       # T = P-1
    (3, 1, 64, False, 2, 2, 1, None),      # T = 1, S = 1
    (3, 4, 128, True, 1, 2, 2, None),      # upmix
    (20, 5, 64, False, 1, 1, 3, None),     # passes of partitions
    (9, 20, 64, True, 1, 16, 3, None),     # chunk groups
    (16, 8, 8192, True, 2, 2, 3, None),    # the flagship width
    (16, 1, 8192, False, 2, 2, 1, None),   # the lone stream, T = 1
    (16, 8, 8192, False, 2, 2, 1, None),   # the lone stream, T = 8
    (5, 2, 256, True, 2, 2, 3, 3),         # ring: T < P-1, the new rows wrap
    (4, 6, 64, False, 2, 2, 3, 1),         # ring: T > P-1, canonical hist
    (9, 20, 64, True, 1, 16, 3, 5),        # ring: chunk groups, T > P-1
    (25, 1, 8192, True, 2, 2, 3, 23),      # ring: the deep cells' shape, last slot
])
def test_fused_kernel_matches_plain_on_card(cuda, rng, p, t, fragm, hist_t, cin, cout,
                                            s, head):
    """With a head both write the new rows into their own copy of the
    ring in place; the whole ring is compared."""
    args = _fused_case(cuda, rng, p, t, fragm, hist_t, cin, cout, s)
    ref_args = [a.clone() if torch.is_tensor(a) else a for a in args]
    got = tcs.conv_step_fused(*args, hist_t=hist_t, head=head,
                              paths=tcs.all_paths(cin, cout))
    ref = tcs.conv_step_fused_plain(*ref_args, hist_t=hist_t, head=head)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) < 1e-5
    if head is not None:
        assert got[1] is args[2] and got[2] is args[3]


@pytest.mark.cuda
@pytest.mark.parametrize("hist_t", [True, False])
def test_fused_kernel_repeat_calls_bit_identical(cuda, rng, hist_t):
    """The overlap-add's atomics add two terms per sample, so two calls
    on the same inputs agree bit for bit."""
    args = _fused_case(cuda, rng, 16, 8, 8192, hist_t)
    paths = tcs.all_paths(2, 2)
    first = tcs.conv_step_fused(*args, hist_t=hist_t, paths=paths)
    second = tcs.conv_step_fused(*args, hist_t=hist_t, paths=paths)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_fused_ring_matches_copy_out_over_chained_steps(cuda, rng):
    """Five chained steps at the deep cells' shape (P = 25, T = 1,
    fragm 8192): the carry's ring (fused_serving_step_pre) against the
    copy-out route on the same inputs.  Same MAC sums in the same order,
    so the outputs and the unrolled hist agree bit for bit."""
    from folve_tpu_torch.engine import stream as ts

    p, t, fragm, s = 25, 1, 8192, 4
    ir = rng.standard_normal((2, 2, p * fragm - 5)).astype(np.float32) / 400
    bank = compile_filter_bank(ir, fragm=fragm, device=cuda)
    fused = ts.fused_filter(bank)
    x = torch.from_numpy(rng.standard_normal((5, s, t, 2, fragm)).astype(np.float32))
    x = x.to(cuda)
    nv = torch.full((s,), t * fragm, device=cuda)
    carry = ts.fused_carry_init(bank, s)
    hr, hi, tl = (torch.zeros_like(a) for a in carry[:3])
    valid = torch.full((s, t), fragm, dtype=torch.int32, device=cuda)
    before = tcs.conv_step_fused.ring_steps
    for r in range(5):
        x5 = ts.stage_x_for_fused(bank, x[r])
        carry, y5 = ts.fused_serving_step_pre(bank, carry, x5, nv, fused=fused)
        y, hr, hi, tl, _ = tcs.conv_step_fused(fused.h_perm, x5, hr, hi, tl, valid,
                                               2 * fragm, hist_t=True, paths=fused.paths)
        assert torch.equal(y5, y), r
    torch.cuda.synchronize()
    assert carry.head == 5 % (p - 1)
    assert tcs.conv_step_fused.ring_steps - before == 5
    assert torch.equal(ts.unroll_ring(carry.hist_re, carry.head), hr)
    assert torch.equal(ts.unroll_ring(carry.hist_im, carry.head), hi)
    assert torch.equal(carry.tail, tl)


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


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,s,shared", [
    (1, 4, 2, True), (1, 8, 3, False), (40, 36, 1, True), (128, 64, 1, False),
])
def test_window_mac_matches_plain_on_card(cuda, rng, p, t, s, shared):
    k = half_bins(16384)
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    h = cu(p, 2, 2, 2, k) if shared else cu(s, p, 2, 2, 2, k)
    xr, xi = cu(s, t + p - 1, 2, k), cu(s, t + p - 1, 2, k)
    fdl_mac.launches = 0
    got = fdl_mac(h, xr, xi, t)
    assert fdl_mac.launches == 1
    assert _rel_err(got, fdl_mac_plain(h, xr, xi, t)) < 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["split", "window"])
@pytest.mark.parametrize("s,p,t,cin,cout,k,shared", [
    (3, 13, 5, 2, 2, 2085, False),   # P and T not multiples of 8, K of 32
    (3, 13, 11, 2, 2, 2085, True),   # a masked tail chunk
    (3, 9, 20, 1, 16, 2085, True),   # 16 warps for one stream and chunk
    (3, 4, 3, 4, 4, 100, False),     # Cin = Cout = 4, T = P-1
    (2, 2, 1, 2, 2, 70, True),       # P = 2, T = 1
    (8, 16, 8, 2, 2, 8320, False),   # the flagship's mixed batch
    (8, 16, 8, 2, 2, 2080, True),    # one freq shard's bins
])
def test_mac_kernels_edges_on_card(cuda, rng, kind, s, p, t, cin, cout, k, shared):
    """Both MAC kernels where their tiles have edges, against their plain
    versions; two calls on the same inputs agree bit for bit (no
    atomics)."""
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    h = cu(*((p,) if shared else (s, p)), cin, cout, 2, k)
    xr, xi = cu(s, t + p - 1, cin, k), cu(s, t + p - 1, cin, k)
    if kind == "split":
        hr, nr, hi, ni = (a[:, sl].contiguous() for a in (xr, xi)
                          for sl in (slice(0, p - 1), slice(p - 1, None)))
        call = lambda: fdl_mac_split(h, hr, hi, nr, ni)
        ref = fdl_mac_split_plain(h, hr, hi, nr, ni)
    else:
        call = lambda: fdl_mac(h, xr, xi, t)
        ref = fdl_mac_plain(h, xr, xi, t)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert _rel_err(first, ref) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("fragm", FRAGMS)
@pytest.mark.parametrize("freq", [2, 4, 8])
def test_row_window_ffts_match_plain_on_card(cuda, rng, fragm, freq):
    n = 2 * fragm
    from folve_tpu_torch.engine.rfft import get_plan

    m1, cols = get_plan(n).m1, get_plan(n).m2 // 2 + 1
    kn = m1 // freq
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    x = cu(2, 3, fragm)
    yr, yi = cu(2, 3, m1 * cols), cu(2, 3, m1 * cols)
    total = None
    for f in range(freq):
        ks = f * kn
        assert _rel_err(fft_real_half_rows(x, n, ks, kn),
                        fft_real_half_rows_plain(x, n, ks, kn)) < 1e-5
        wr = yr.reshape(2, 3, m1, cols)[:, :, ks:ks + kn].reshape(2, 3, -1)
        wi = yi.reshape(2, 3, m1, cols)[:, :, ks:ks + kn].reshape(2, 3, -1)
        part = ifft_partial_rows(wr, wi, n, ks, kn)
        assert _rel_err(part, ifft_partial_rows_plain(wr, wi, n, ks, kn)) < 1e-5
        total = part if total is None else total + part
    whole = ifft_from_half_plain(yr, yi, n)
    assert _rel_err(total, whole) < 1e-5
    assert _rel_err(ifft_from_half(yr, yi, n), whole) < 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("p,t", [(1, 3), (40, 36)])
def test_window_route_on_card_matches_cpu(cuda, rng, p, t):
    """chunk_step through the window MAC on the card (P = 1 and a deep
    FDL) against the plain path on the CPU, and no plain MAC on CUDA."""
    from folve_tpu_torch.engine import stream as ts

    fragm = 64
    ir = rng.standard_normal((2, 2, p * fragm - 5)).astype(np.float32)
    banks = {d: compile_filter_bank(ir, fragm=fragm, device=d) for d in ("cpu", cuda)}
    x = rng.standard_normal((2, t, 2, fragm)).astype(np.float32)
    outs = {}
    fdl_mac.launches = fdl_mac_plain.cuda_calls = 0
    for d, bank in banks.items():
        st = ts.init_state(bank, device=d)
        ys = []
        for r in range(2):
            st, y = ts.chunk_step(bank, st, x[r], t * fragm - 3 * r)
            ys += [y.cpu(), st.tail.cpu(), st.hist_re.cpu()]
        outs[d] = ys
    assert fdl_mac.launches == 2 and fdl_mac_plain.cuda_calls == 0
    for a, b in zip(outs["cpu"], outs[cuda]):
        assert a.shape == b.shape
        if a.numel():  # P = 1 carries an empty history
            assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.cuda
def test_sharded_step_on_card_matches_cpu(cuda, rng):
    """The freq-sharded step on four shards of one card against the same
    step on a CPU mesh."""
    from folve_tpu_torch.parallel.serving import (
        make_serving_mesh,
        make_sharded_serving_step,
        shard_states_and_bank,
    )

    fragm, p, s, t = 256, 3, 4, 2
    bank = compile_filter_bank(
        rng.standard_normal((2, 2, p * fragm)).astype(np.float32), fragm=fragm,
        device="cpu")
    k = bank.bins
    args = (bank.h_spec.numpy(),
            rng.standard_normal((s, p - 1, 2, k)).astype(np.float32),
            rng.standard_normal((s, p - 1, 2, k)).astype(np.float32),
            rng.standard_normal((s, 2, fragm)).astype(np.float32),
            np.zeros(s, np.float32),
            rng.standard_normal((s, t, 2, fragm)).astype(np.float32),
            np.full(s, t * fragm))
    outs = []
    fft_real_half_rows.launches = ifft_partial_rows.launches = 0
    for devs in (["cpu"] * 4, [cuda] * 4):
        mesh = make_serving_mesh(devices=devs, freq_parallel=4)
        step = make_sharded_serving_step(mesh, fragm, shared_bank=True)
        outs.append([a.gather() for a in step(*shard_states_and_bank(
            mesh, *args, shared_bank=True))])
    assert fft_real_half_rows.launches == 4 and ifft_partial_rows.launches == 4
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("freq", [4, 2])
def test_sharded_scheduler_across_cards_matches_cpu(cuda, rng, freq):
    """The sharded step on a mesh of four distinct cards (each shard
    launched on its own card, the partials moved by peer copies, the
    state gathered on the cards between steps) through DeviceScheduler,
    against per-stream chunk_step on the CPU; mixed filters."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import threading

    from folve_tpu_torch.engine import stream as ts
    from folve_tpu_torch.parallel.serving import make_serving_mesh
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler, ShardedStateRef

    fragm, p, s, t = 256, 3, 4, 2
    irs = rng.standard_normal((2, 2, 2, p * fragm)).astype(np.float32)
    cpu = [compile_filter_bank(ir, fragm=fragm, device="cpu") for ir in irs]
    card = [compile_filter_bank(ir, fragm=fragm, device=cuda) for ir in irs]
    sched = DeviceScheduler(max_batch=s, window_s=0.5, device=cuda,
                            mesh=make_serving_mesh(4, freq_parallel=freq))
    states = [ts.init_state(card[i % 2], device=cuda) for i in range(s)]
    ref = [ts.init_state(cpu[i % 2], device="cpu") for i in range(s)]
    try:
        for r in range(3):
            xs = rng.standard_normal((s, t, 2, fragm)).astype(np.float32)
            out = [None] * s
            barrier = threading.Barrier(s)

            def go(i):
                barrier.wait(timeout=60)
                out[i] = sched.submit(card[i % 2], states[i], xs[i],
                                      t * fragm).result(timeout=120)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(s)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=180)
            assert not any(th.is_alive() for th in threads)
            for i in range(s):
                states[i], y = out[i]
                ref[i], ry = ts.chunk_step(cpu[i % 2], ref[i], xs[i], t * fragm)
                assert _rel_err(y, ry) < 1e-5
    finally:
        sched.stop()
    assert all(isinstance(st, ShardedStateRef) for st in states)
    assert sched.sharded_steps == 3 and sched.sharded_fast_steps == 2
    for st, rs in zip(states, ref):
        assert _rel_err(st.hist_re.cpu(), rs.hist_re) < 1e-5
        assert _rel_err(st.tail.cpu(), rs.tail) < 1e-5


@pytest.mark.cuda
def test_default_device_scheduler_takes_default_banks(cuda, rng):
    """A bare "cuda" names the card the banks' tensors report, so the
    default DeviceScheduler serves banks compiled with the default
    device."""
    from folve_tpu_torch.engine import stream as ts
    from folve_tpu_torch.engine.device import resolve_device
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler

    bank = compile_filter_bank(rng.standard_normal((2, 2, 300)).astype(np.float32),
                               fragm=64)
    assert resolve_device("cuda") == bank.device
    sched = DeviceScheduler(window_s=0.01)
    x = rng.standard_normal((2, 2, 64)).astype(np.float32)
    try:
        _, y = sched.submit(bank, ts.init_state(bank), x, 128).result(timeout=120)
    finally:
        sched.stop()
    _, ref = ts.chunk_step(bank, ts.init_state(bank), x, 128)
    assert _rel_err(y, ref) < 1e-6


@pytest.mark.cuda
def test_dryrun_multichip_on_card(cuda):
    """The multichip dry run with its default device: a mesh of eight
    entries of the card, whose shards run the row-window FFT kernels."""
    from folve_tpu_torch.entry import dryrun_multichip

    before = (fft_real_half_rows.launches, ifft_partial_rows.launches)
    dryrun_multichip(8)
    assert fft_real_half_rows.launches > before[0]
    assert ifft_partial_rows.launches > before[1]
