"""Kernel 1 on multichannel banks on the card: 6 x 6 (5.1 bass
management, 11 live paths of 36), 8 x 8 and 16 x 16 with sparse and full
path tables, in ring and copy-out mode with a ragged ``n_valid``,
against its plain path, against itself with the dense table (bit for
bit), and chained through the engine's steps and the scheduler against
the float64 reference of ``tests/torch_mimo_reference.py``.  Every test
needs a CUDA device and skips without one; the file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multichannel_cuda.py
"""

import numpy as np
import pytest
import torch

from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.engine.kernels import conv_step as tcs
from folve_tpu_torch.engine.kernels import fdl_mac as tfm
import torch_mimo_reference as ref


@pytest.fixture
def rng():
    return np.random.default_rng(0x51B)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paths(kind, c, rng, size):
    """Paths of a ``kind`` table over ``c`` x ``c`` channels."""
    ir = lambda: rng.standard_normal(size) / np.sqrt(size)
    if kind == "bass51":
        return ref.bass_managed_51([ir() for _ in range(11)])
    if kind == "full":
        return [(i, o, 1.0, ir()) for i in range(c) for o in range(c)]
    # sparse: each input to itself and to (i + 3) mod c, output 0 from all
    pairs = {(i, i) for i in range(c)} | {(i, (i + 3) % c) for i in range(c)}
    pairs |= {(i, 0) for i in range(c)}
    return [(i, o, 0.7, ir()) for i, o in sorted(pairs)]


def _bank(paths, c, size, fragm, dev):
    return compile_filter_bank(ref.dense_ir(paths, c, c, size), fragm=fragm, device=dev)


def _rel_err(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(float(w.abs().max()) for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,c,p,t,fragm,s,ring", [
    ("bass51", 6, 4, 3, 1024, 3, True),     # T = P-1
    ("bass51", 6, 4, 3, 1024, 3, False),    # copy-out
    ("bass51", 6, 16, 8, 8192, 2, True),    # the cell's widths
    ("bass51", 6, 16, 1, 8192, 1, False),   # a lone stream, T = 1
    ("sparse", 8, 5, 2, 512, 3, True),      # T < P-1
    ("sparse", 8, 3, 9, 256, 2, False),     # T > P-1, two chunks of blocks
    ("full", 8, 3, 4, 256, 2, True),
    ("sparse", 16, 3, 4, 256, 2, True),     # one warp per output, 16 a block
    ("full", 16, 3, 2, 256, 1, False),
])
def test_fused_kernel_path_table_on_card(cuda, rng, kind, c, p, t, fragm, s, ring):
    """Kernel 1 with the bank's live paths against its plain path, and
    against itself with every pair (bit for bit: the skipped terms are
    exact zeros); the wrapper counts the live terms."""
    size = p * fragm - 5
    bank = _bank(_paths(kind, c, rng, size), c, size, fragm, cuda)
    hp, live = ts.fused_filter(bank)
    assert (kind != "full") == (len(live) < c * c)
    n = 2 * fragm
    cu = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    k = bank.bins
    x, hr, hi, tail = cu(s, t, c, fragm), cu(s, p - 1, c, k), cu(s, p - 1, c, k), \
        cu(s, c, fragm)
    nv = torch.tensor([t * fragm, t * fragm - fragm // 2 - 1, 1][:s], device=cuda)
    valid = ts._valid_frames(nv, t, fragm)
    if ring:
        rows, m2, m1, cols = tcs.fused_preshape(n)
        x = x.reshape(s, t, c, rows, m2)
        hr, hi = (h.reshape(s, p - 1, c, m1, cols).transpose(-1, -2).contiguous()
                  for h in (hr, hi))
    head = (p - 2) if ring else None
    run = lambda fn, paths: fn(hp, x, hr.clone(), hi.clone(), tail, valid, n,
                               hist_t=ring, head=head, paths=paths)
    before, launches = tcs.conv_step_fused.mac_terms, tcs.conv_step_fused.launches
    got = run(tcs.conv_step_fused, live)
    assert tcs.conv_step_fused.mac_terms - before == s * t * p * len(live) * k
    dense = run(tcs.conv_step_fused, tcs.all_paths(c, c))
    assert tcs.conv_step_fused.launches - launches == 2
    want = run(tcs.conv_step_fused_plain, live)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    assert _rel_err(got, want) < 1e-5


def _chunks(rng, s, rounds, t, fragm, cin, cut):
    n = rounds * t * fragm
    audio = (0.3 * rng.standard_normal((s, n, cin))).astype(np.float32)
    audio[:, n - cut:] = 0.0
    x = audio.reshape(s, rounds, t, fragm, cin).transpose(1, 0, 2, 4, 3).copy()
    nv = np.array([[t * fragm] * s] * (rounds - 1) + [[t * fragm - cut] * s])
    return x, nv, audio


def _frames(y):
    """[..., rounds, T, Cout, fragm] -> [..., N, Cout]."""
    y = np.asarray(y)
    return np.swapaxes(y, -2, -1).reshape(*y.shape[:-4], -1, y.shape[-2])


@pytest.mark.cuda
def test_51_engine_steps_on_card_match_reference(cuda, rng):
    """The 5.1 bank at the cell's widths (131,072 taps: fragm 8192,
    P = 16): four chained steps of 3 streams through the ring carry and
    of one stream through the copy-out step, the last ragged, within
    -90 dB of the float64 reference; one launch of kernel 1 a step, no
    plain MAC on the card, 11 paths x K multiply-adds a (stream, block,
    partition)."""
    p, t, fragm, s, rounds = 16, 8, 8192, 3, 4
    size = p * fragm
    irs = [rng.standard_normal(size) * np.exp(-3.0 * np.arange(size) / 96000) * 0.01
           for _ in range(11)]
    for ir in irs:
        ir[0] += 0.01
    paths = ref.bass_managed_51(irs)
    bank = _bank(paths, 6, size, fragm, cuda)
    x, nv, audio = _chunks(rng, s, rounds, t, fragm, 6, cut=3001)
    launches, plain = tcs.conv_step_fused.launches, tfm.fdl_mac_plain.cuda_calls
    terms = tcs.conv_step_fused.mac_terms
    carry = ts.fused_carry_init(bank, s)
    st = ts.init_state(bank, device=cuda)
    ys, y1s = [], []
    for r in range(rounds):
        xr = torch.from_numpy(x[r]).to(cuda)
        carry, y5 = ts.fused_serving_step_pre(bank, carry, ts.stage_x_for_fused(bank, xr),
                                              torch.from_numpy(nv[r]).to(cuda))
        ys.append(y5.reshape(s, t, 6, fragm).cpu())
        st, y1 = ts.single_chunk_step(bank, st, xr[0], int(nv[r, 0]))
        y1s.append(y1.cpu())
    torch.cuda.synchronize()
    assert tcs.conv_step_fused.launches - launches == 2 * rounds
    assert tfm.fdl_mac_plain.cuda_calls == plain
    assert tcs.conv_step_fused.mac_terms - terms == rounds * (s + 1) * t * p * 11 * bank.bins
    y = torch.stack(ys, 1).numpy()
    for i in range(s):
        assert ref.snr_db(ref.convolve(paths, audio[i], 6), _frames(y[i])) < -90, i
    assert ref.snr_db(ref.convolve(paths, audio[0], 6),
                      _frames(torch.stack(y1s).numpy())) < -90


@pytest.mark.cuda
def test_scheduler_runs_51_batches_through_kernel_1_on_card(cuda, rng, monkeypatch):
    """16 streams of the 5.1 bank through ``DeviceScheduler`` at its
    default ``max_batch`` 16: every batch is one launch of kernel 1, no
    split kernel or einsum runs, and each stream matches the reference."""
    import threading

    from folve_tpu_torch.engine.kernels import fft_half, ifft_half
    from folve_tpu_torch.runtime.scheduler import DeviceScheduler

    p, t, fragm, s, rounds = 4, 8, 1024, 16, 3
    size = p * fragm - 5
    paths = _paths("bass51", 6, rng, size)
    bank = _bank(paths, 6, size, fragm, cuda)
    einsum = []
    real = ts.fdl_mac_einsum
    monkeypatch.setattr(ts, "fdl_mac_einsum", lambda *a: einsum.append(1) or real(*a))
    x, nv, audio = _chunks(rng, s, rounds, t, fragm, 6, cut=77)
    split = lambda: (fft_half.fft_real_half.launches, tfm.fdl_mac_split.launches,
                     tfm.fdl_mac.launches, ifft_half.ifft_ola.launches)
    before, launches = split(), tcs.conv_step_fused.launches
    sched = DeviceScheduler(max_batch=16, window_s=0.5, device=cuda)
    states = [ts.init_state(bank, device=cuda)] * s
    ys = [[] for _ in range(s)]
    try:
        for r in range(rounds):
            out = [None] * s
            barrier = threading.Barrier(s)

            def go(i):
                barrier.wait(timeout=30)
                out[i] = sched.submit(bank, states[i], x[r, i], nv[r, i],
                                      stream=i).result(timeout=120)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(s)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            for i in range(s):
                states[i], y = out[i]
                ys[i].append(torch.as_tensor(y).cpu())
    finally:
        sched.stop()
    assert sched.fused_steps == sched.steps == rounds
    assert tcs.conv_step_fused.launches - launches == rounds
    assert split() == before and not einsum
    for i in range(s):
        y = _frames(torch.stack(ys[i]).numpy())
        assert ref.snr_db(ref.convolve(paths, audio[i], 6), y) < -90, i
