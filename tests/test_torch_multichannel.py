"""Multichannel filters on kernel 1's route, on the CPU: the 5.1 bass
management conf (6 x 6, 11 of 36 pairs defined) through the ring carry
(``fused_serving_step_pre``) and the copy-out step (``single_chunk_step``)
against a plain float64 reference (``tests/torch_mimo_reference.py``),
the table of live paths against the dense MAC, the gate, the JAX
package's ``chunk_step``, and a 6-channel 96 kHz/24-bit FLAC served
through ``FolveFilesystem`` with ``filter-96000-6-24.conf``."""

import numpy as np
import pytest
import torch

from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.engine.kernels import conv_step as tcs
import torch_mimo_reference as ref

torch.set_num_threads(1)

FRAGM, P, T, S, ROUNDS = 128, 3, 2, 3, 3


def _paths51(rng, size):
    irs = [rng.standard_normal(size) / np.sqrt(size) for _ in range(11)]
    for ir in irs:
        ir[0] += 1.0  # the direct sound
    return ref.bass_managed_51(irs)


def _bank(paths, cin, cout, size, fragm=FRAGM):
    return compile_filter_bank(ref.dense_ir(paths, cin, cout, size), fragm=fragm,
                               device="cpu")


def _audio(rng, cin, s=S, rounds=ROUNDS, t=T, fragm=FRAGM, cut=37):
    """``x`` [rounds, S, T, Cin, fragm] of streams whose last ``cut``
    frames are silence (the caller's zero padding), the per-round
    ``n_valid`` [rounds, S], and each stream's audio [N, Cin]."""
    n = rounds * t * fragm
    audio = (0.3 * rng.standard_normal((s, n, cin))).astype(np.float32)
    audio[:, n - cut:] = 0.0
    x = audio.reshape(s, rounds, t, fragm, cin).transpose(1, 0, 2, 4, 3).copy()
    nv = np.array([[t * fragm] * s] * (rounds - 1) + [[t * fragm - cut] * s])
    return x, nv, audio


def _ring_steps(bank, x, nv):
    carry = ts.fused_carry_init(bank, x.shape[1])
    ys = []
    for r in range(x.shape[0]):
        carry, y5 = ts.fused_serving_step_pre(bank, carry, ts.stage_x_for_fused(bank, x[r]),
                                              nv[r])
        ys.append(y5.reshape(*x.shape[1:3], bank.nout, bank.fragm))
    return carry, torch.stack(ys, 1)  # [S, rounds, T, Cout, fragm]


def _copy_out_steps(bank, x, nv, stream):
    st = ts.init_state(bank, device="cpu")
    ys = []
    for r in range(x.shape[0]):
        st, y = ts.single_chunk_step(bank, st, x[r, stream], int(nv[r, stream]))
        ys.append(y)
    return st, torch.stack(ys)  # [rounds, T, Cout, fragm]


def _spy_mac_paths(monkeypatch):
    """The number of pairs each call of kernel 1's plain MAC is handed
    (the CPU path has no launch, so ``mac_terms`` does not count it)."""
    seen = []
    real = tcs.fdl_mac_plain
    monkeypatch.setattr(tcs, "fdl_mac_plain", lambda h, xr, xi, t, paths=None: (
        seen.append(len(paths)) or real(h, xr, xi, t, paths)))
    return seen


def _frames(y):
    """[..., rounds, T, Cout, fragm] -> [..., N, Cout]."""
    y = np.asarray(y)
    return np.swapaxes(y, -2, -1).reshape(*y.shape[:-4], -1, y.shape[-2])


def test_bass_managed_51_ring_and_copy_out_match_reference(rng):
    size = P * FRAGM - 5
    paths = _paths51(rng, size)
    bank = _bank(paths, 6, 6, size)
    assert ts.fused_serving_supported(bank, T)
    assert ts.fused_filter(bank).paths == ref.pairs(paths)
    x, nv, audio = _audio(rng, 6)
    carry, ys = _ring_steps(bank, x, nv)
    assert carry.head == ROUNDS * T % (P - 1)
    for s in range(S):
        want = ref.convolve(paths, audio[s], 6)
        assert ref.snr_db(want, _frames(ys[s])) < -90, s
        _, y1 = _copy_out_steps(bank, x, nv, s)
        assert ref.snr_db(want, _frames(y1)) < -90, s
        # Ring and copy-out sum the same terms in the same order.
        torch.testing.assert_close(y1, ys[s], rtol=0, atol=0)


def test_path_table_equals_dense_and_counts_live_terms(rng, monkeypatch):
    """Kernel 1's plain path over the 11 live paths and over all 36
    pairs: equal outputs and state, in ring and copy-out mode; its MAC
    is handed 11 pairs where the dense call hands it 36, and no launch
    adds to ``mac_terms``."""
    size = P * FRAGM - 5
    bank = _bank(_paths51(rng, size), 6, 6, size)
    hp, live = ts.fused_filter(bank)
    assert len(live) == 11
    seen = _spy_mac_paths(monkeypatch)
    x, nv, _ = _audio(rng, 6)
    n = 2 * FRAGM
    valid = lambda r: ts._valid_frames(torch.as_tensor(nv[r]), T, FRAGM)
    for ring in (True, False):
        outs, terms = {}, {}
        for paths in (live, tcs.all_paths(6, 6)):
            carry = ts.fused_carry_init(bank, S)
            st = ts.stack_states([ts.init_state(bank, device="cpu")] * S)
            before = tcs.conv_step_fused.mac_terms
            seen.clear()
            got = []
            for r in range(ROUNDS):
                if ring:
                    x5 = ts.stage_x_for_fused(bank, torch.from_numpy(x[r]))
                    y, hr, hi, tl, mx = tcs.conv_step_fused(
                        hp, x5, carry.hist_re, carry.hist_im, carry.tail, valid(r), n,
                        hist_t=True, head=carry.head, paths=paths)
                    carry = ts.FusedServingCarry(hr, hi, tl, mx, (carry.head + T) % (P - 1))
                else:
                    y, hr, hi, tl, mx = tcs.conv_step_fused(
                        hp, torch.from_numpy(x[r]), st.hist_re, st.hist_im, st.tail,
                        valid(r), n, paths=paths)
                    st = ts.StreamState(hr, hi, tl, mx)
                got += [y, hr, hi, tl, mx]
            outs[len(paths)] = got
            terms[len(paths)] = seen[:]
            assert tcs.conv_step_fused.mac_terms == before
        assert all(torch.equal(a, b) for a, b in zip(outs[11], outs[36])), ring
        assert terms[11] == [11] * ROUNDS
        assert terms[36] == [36] * ROUNDS


def test_live_paths_of_stereo_and_51_banks(rng, tmp_path):
    """SantaLucia-like true stereo keeps all 4 pairs, the demo lowpass's
    diagonal 2 of 4, and the 5.1 conf (compiled from its text) 11 of 36."""
    size = P * FRAGM - 5
    ir = lambda: rng.standard_normal(size)
    full = [(i, o, 1.0, ir()) for i in range(2) for o in range(2)]
    diag = [(0, 0, 0.75, ir()), (1, 1, 0.75, ir())]
    assert ts.fused_filter(_bank(full, 2, 2, size)).paths == ((0, 0), (0, 1), (1, 0), (1, 1))
    assert ts.fused_filter(_bank(diag, 2, 2, size)).paths == ((0, 0), (1, 1))
    from folve_tpu_torch.filters import compile_config_file

    conf = tmp_path / "filter-96000-6-24.conf"
    conf.write_text(_conf51(_paths51_diracs(16384)))  # fragm 8192, P = 2
    bank = compile_config_file(str(conf), fsamp=96000, device="cpu").bank
    assert (bank.ninp, bank.nout) == (6, 6)
    assert ts.fused_filter(bank).paths == ref.pairs(ref.bass_managed_51([np.ones(1)] * 11))
    assert len(ts.fused_filter(bank).paths) == 11


def test_gate_takes_6x6_and_8x8_and_the_einsum_takes_wider(rng, monkeypatch):
    """Kernel 1's route takes 6 x 6, 8 x 8 and up to 16 x 16; a bank it
    refuses (17 inputs) runs the split route's einsum MAC and still
    matches the reference."""
    for c in (6, 8, 16):
        bank = _bank([(i, i, 1.0, rng.standard_normal(P * FRAGM - 5)) for i in range(c)],
                     c, c, P * FRAGM - 5)
        assert ts.fused_serving_supported(bank, T) and ts.fused_serving_supported(bank, 1)
        assert ts.mac_route(P, c, c, T) == "einsum"  # the split route's MAC, not taken
    size = P * FRAGM - 5
    wide = [(i, i % 2, 1.0, rng.standard_normal(size) / np.sqrt(size)) for i in range(17)]
    bank = _bank(wide, 17, 2, size)
    assert not ts.fused_serving_supported(bank, T) and ts.fused_filter(bank) is None
    calls = []
    real = ts.fdl_mac_einsum
    monkeypatch.setattr(ts, "fdl_mac_einsum", lambda *a: calls.append(1) or real(*a))
    x, nv, audio = _audio(rng, 17, s=2)
    st = ts.stack_states([ts.init_state(bank, device="cpu")] * 2)
    seen = _spy_mac_paths(monkeypatch)
    ys = []
    for r in range(ROUNDS):
        st, y = ts.serving_chunk_step(bank, st, x[r], nv[r])
        ys.append(y)
    assert len(calls) == ROUNDS and seen == []
    y = torch.stack(ys, 1)
    for s in range(2):
        assert ref.snr_db(ref.convolve(wide, audio[s], 2), _frames(y[s])) < -90


def test_51_bank_matches_jax_chunk_step(rng):
    """The port's ring and copy-out steps on the 5.1 bank against the JAX
    package's ``chunk_step`` (xla route) on the same response, at the
    JAX comparison's 2e-4."""
    from folve_tpu.engine.filter_bank import compile_filter_bank as j_bank
    from tests.test_torch_stream import _close_state, _jax_chunks

    size = P * FRAGM - 5
    paths = _paths51(rng, size)
    ir = ref.dense_ir(paths, 6, 6, size)
    bank = compile_filter_bank(ir, fragm=FRAGM, device="cpu")
    x, nv, _ = _audio(rng, 6, s=2)
    carry, ys = _ring_steps(bank, x, nv)
    back = ts.states_from_carry(bank, carry)
    for s in range(2):
        jst, jys = _jax_chunks(j_bank(ir, fragm=FRAGM), x[:, s], nv[:, s])
        st, y1 = _copy_out_steps(bank, x, nv, s)
        for r in range(ROUNDS):
            np.testing.assert_allclose(ys[s, r].numpy(), jys[r], atol=2e-4)
            np.testing.assert_allclose(y1[r].numpy(), jys[r], atol=2e-4)
        _close_state(st, jst)
        _close_state(ts.unstack_state(back, s), jst)


def _paths51_diracs(size):
    """Bass management with sparse responses: a direct pulse and two
    echoes a path, one in the second partition."""
    irs = []
    for k in range(11):
        ir = np.zeros(size)
        ir[k] = 0.6 if k < 6 else 0.3
        ir[size // 3 + 7 * k] = 0.1 * (-1) ** k
        ir[size - 1 - 13 * k] = 0.05
        irs.append(ir)
    return ref.bass_managed_51(irs)


def _conf51(paths):
    """The conf text of ``paths`` (1-based channels, /impulse/dirac)."""
    size = max(len(p[3]) for p in paths)
    lines = [f"/convolver/new 6 6 1024 {size}"]
    for i, o, gain, ir in paths:
        for d in np.nonzero(ir)[0]:
            lines.append(f"/impulse/dirac {i + 1} {o + 1} {float(gain * ir[d])!r} {d}")
    return "\n".join(lines) + "\n"


def test_51_flac_served_through_folve_filesystem(rng, tmp_path, monkeypatch):
    """A 6-channel 96 kHz/24-bit FLAC resolves to filter-96000-6-24.conf
    over a stereo filter-96000.conf beside it, is served through kernel
    1's route with the 11 live paths (every call of its MAC is handed 11
    pairs), and its PCM is within 4 LSB of the float64 reference
    quantized on the host."""
    from folve_tpu_torch.audio.flac import write_flac
    from folve_tpu_torch.runtime import ConvolveFileHandler, FolveFilesystem
    from tests.test_torch_filesystem import lsb_limit, pcm, serve

    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")
    rate, bits, size = 96000, 24, 16384  # fragm 8192, P = 2
    paths = _paths51_diracs(size)
    fdir = tmp_path / "filters" / "roomeq"
    fdir.mkdir(parents=True)
    (fdir / "filter-96000-6-24.conf").write_text(_conf51(paths))
    (fdir / "filter-96000.conf").write_text(
        "/convolver/new 2 2 1024 512\n/impulse/dirac 1 1 1.0 0\n/impulse/dirac 2 2 1.0 0\n")
    src = tmp_path / "src"
    src.mkdir()
    frames = 3 * 8192 * 8 + 4321  # three bulk chunks and a ragged end
    scale = float(1 << (bits - 1))
    x = (np.round(rng.uniform(-0.3, 0.3, (frames, 6)) * scale) / scale).astype(np.float32)
    write_flac(str(src / "surround.flac"), x, rate, bits=bits)

    fs = FolveFilesystem(device="cpu")
    fs.underlying_dir, fs.base_config_dir = str(src), str(tmp_path / "filters")
    fs.current_config_subdir = "roomeq"
    assert fs.check_initialized()
    seen = _spy_mac_paths(monkeypatch)
    h, size_b, blob = serve(fs, "/surround.flac")
    assert isinstance(h, ConvolveFileHandler)
    assert seen and set(seen) == {11}
    got, info = pcm(blob)
    assert (info.frames, info.rate, info.channels, info.bits_per_sample) == (
        frames, rate, 6, bits)
    want = np.clip(np.round(ref.convolve(paths, x, 6) * scale), -scale, scale - 1)
    assert int(np.max(np.abs(got - want))) <= lsb_limit(bits)
