"""The port's runtime: device quantization bit-exact with the JAX
package's, the scheduler's shared (fused) and mixed-filter batches equal
to per-stream chunk_step, and the SoundProcessor's PCM within 1 LSB of
the JAX SoundProcessor on the same config and input."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from folve_tpu.audio.types import SampleCodec
from folve_tpu.audio.wav import write_wav
from folve_tpu.filters import compile_config_file as j_compile
from folve_tpu.runtime import processor as jp
from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.filters import compile_config_file
from folve_tpu_torch.runtime import processor as tp
from folve_tpu_torch.runtime.scheduler import DeviceScheduler, FusedStateRef

torch.set_num_threads(1)


@pytest.mark.parametrize("bits", [16, 24])
def test_quantize_bit_exact_with_jax(rng, bits):
    scale = float(1 << (bits - 1))
    edges = np.array([-2.0, -1.0, 1.0, 2.0, 0.5 / scale, -0.5 / scale,
                      1.5 / scale, 2.5 / scale, (scale - 1.5) / scale, 0.0],
                     np.float32)
    y = np.concatenate([rng.uniform(-1.2, 1.2, 997).astype(np.float32), edges])
    y = y.reshape(-1, 1)
    a = np.asarray(jp._quantize(jnp.asarray(y), bits))
    b = tp._quantize(torch.from_numpy(y), bits).numpy()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(tp._unpack24(b), jp._unpack24(a))


def _submit_round(sched, banks, states, xs, n_valid):
    """All streams submit at once (barrier) so they share one batch."""
    out = [None] * len(banks)
    barrier = threading.Barrier(len(banks))

    def go(i):
        barrier.wait(timeout=30)
        out[i] = sched.submit(banks[i], states[i], xs[i], n_valid[i]).result(timeout=60)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(banks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    return out


@pytest.mark.parametrize("mixed", [False, True])
def test_scheduler_batches_equal_per_stream_chunk_step(rng, mixed):
    fragm, t, streams = 64, 2, 4
    irs = rng.standard_normal((2, 2, 2, 5 * fragm - 3)).astype(np.float32)
    pool = [compile_filter_bank(ir, fragm=fragm, device="cpu") for ir in irs]
    banks = [pool[i % 2] if mixed else pool[0] for i in range(streams)]
    sched = DeviceScheduler(max_batch=streams, window_s=0.5, device="cpu")
    states = [ts.init_state(b, device="cpu") for b in banks]
    ref_states = list(states)
    try:
        for r in range(3):
            xs = rng.standard_normal((streams, t, 2, fragm)).astype(np.float32)
            nv = [t * fragm, t * fragm, t * fragm - 5, 1]
            out = _submit_round(sched, banks, states, xs, nv)
            for i in range(streams):
                states[i], y = out[i]
                ref_states[i], ry = ts.chunk_step(banks[i], ref_states[i], xs[i], nv[i])
                np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-5)
    finally:
        sched.stop()
    for st, rs in zip(states, ref_states):
        for f in ("hist_re", "hist_im", "tail", "max_abs"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(rs, f).numpy(), atol=1e-5)
    assert sched.batched_jobs > 0
    if mixed:
        assert sched.fused_steps == 0
    else:
        assert sched.fused_steps == sched.steps == 3
        assert sched.fused_fast_steps == 2
        assert all(isinstance(s, FusedStateRef) for s in states)


def test_scheduler_lone_stream_quantizes(rng):
    bank = compile_filter_bank(rng.standard_normal((2, 2, 256)).astype(np.float32),
                               fragm=64, device="cpu")
    sched = DeviceScheduler(max_batch=4, window_s=0.01, device="cpu")
    x = (0.1 * rng.standard_normal((3, 2, 64))).astype(np.float32)
    try:
        st, q = sched.submit(bank, ts.init_state(bank, device="cpu"), x, 150,
                             stream=1, quantize_bits=16).result(timeout=60)
    finally:
        sched.stop()
    ref_st, y = ts.chunk_step(bank, ts.init_state(bank, device="cpu"), x, 150)
    np.testing.assert_array_equal(q.numpy(), tp._quantize(y, 16).numpy())
    assert sched.steps == 1 and float(st.max_abs) == float(ref_st.max_abs)
    elsewhere = compile_filter_bank(np.ones((1, 1, 64), np.float32), device="meta")
    with pytest.raises(ValueError):
        sched.submit(elsewhere, None, x, 1)


class _Source:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def read_float(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += out.shape[0]
        return out


def _pump(proc, audio, t, bits):
    src, got = _Source(audio), []
    while audio.shape[0] - src.pos >= t * proc.fragm:
        assert proc.pump_chunk(src, got.append, t, quantize_bits=bits) == t * proc.fragm
    proc.drain_pipeline()
    r = proc.fill_buffer(src)
    proc.write_processed(got.append, r, quantize_bits=bits)
    return np.concatenate(got).astype(np.int64)


@pytest.mark.parametrize("bits", [16, 24])
def test_processor_pcm_within_one_lsb_of_jax(tmp_path, rng, bits):
    size = 16384 + 100  # fragm 8192, P = 3
    ir = (rng.standard_normal((size, 4)) * np.exp(-np.arange(size) / 2000.0)[:, None]
          / 30).astype(np.float32)
    write_wav(str(tmp_path / "ir.wav"), ir, 44100, SampleCodec.FLOAT)
    cfg = tmp_path / "f.conf"
    cfg.write_text("/convolver/new 2 2 8192 %d\n" % size + "".join(
        f"/impulse/read {i + 1} {o + 1} 1 0 0 0 {2 * i + o + 1} ir.wav\n"
        for i in range(2) for o in range(2)))
    audio = (0.03 * rng.standard_normal((2 * 8192 + 3001, 2))).astype(np.float32)
    jproc = jp.SoundProcessor(j_compile(str(cfg), fsamp=44100), str(cfg))
    tproc = tp.SoundProcessor(compile_config_file(str(cfg), 44100, device="cpu"),
                              str(cfg))
    want = _pump(jproc, audio, 2, bits)
    got = _pump(tproc, audio, 2, bits)
    assert got.shape == want.shape == (audio.shape[0], 2)
    assert int(np.max(np.abs(got - want))) <= 1
    assert tproc.max_output_value() == pytest.approx(jproc.max_output_value(), abs=2e-4)
    tproc.reset()
    assert tproc.max_output_value() == 0.0 and tproc.pending_writes() == 0
