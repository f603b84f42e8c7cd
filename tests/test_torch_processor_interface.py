"""The port's SoundProcessor members that the reference's pool and
handler call, against the JAX package's processor built from the same
config file: the channel counts, input-buffer completeness, config
staleness by mtime, and ``reset_max_values`` with a scheduler step in
flight (the clipping monitor cleared, the convolution state kept).  On
the CPU; state compared at atol 2e-4, the tolerance of the port's other
tests against the JAX engine."""

import os

import numpy as np
import pytest
import torch

from folve_tpu.audio.types import SampleCodec
from folve_tpu.audio.wav import write_wav
from folve_tpu.filters import compile_config_file as j_compile
from folve_tpu.runtime import processor as jp
from folve_tpu.runtime.scheduler import DeviceScheduler as JScheduler
from folve_tpu_torch.filters import compile_config_file
from folve_tpu_torch.runtime import processor as tp
from folve_tpu_torch.runtime.scheduler import DeviceScheduler

torch.set_num_threads(1)

SIZE, CIN, COUT = 300, 1, 2


class _Source:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def read_float(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += out.shape[0]
        return out


@pytest.fixture
def config(tmp_path, rng):
    """A one-in, two-out filter of SIZE taps."""
    ir = (rng.standard_normal((SIZE, COUT)) * np.exp(-np.arange(SIZE) / 80.0)[:, None]
          ).astype(np.float32)
    write_wav(str(tmp_path / "ir.wav"), ir, 44100, SampleCodec.FLOAT)
    cfg = tmp_path / "f.conf"
    cfg.write_text(f"/convolver/new {CIN} {COUT} 64 {SIZE}\n" + "".join(
        f"/impulse/read 1 {o + 1} 1 0 0 0 {o + 1} ir.wav\n" for o in range(COUT)))
    return str(cfg)


def _pair(cfg, schedulers=(None, None)):
    """(reference, port) processors of one config file."""
    ref = jp.SoundProcessor(j_compile(cfg, fsamp=44100), cfg, scheduler=schedulers[0])
    port = tp.SoundProcessor(compile_config_file(cfg, 44100, device="cpu"), cfg,
                             scheduler=schedulers[1])
    assert port.fragm == ref.fragm
    return ref, port


def test_channel_counts(config):
    for proc in _pair(config):
        assert (proc.input_channels, proc.output_channels) == (CIN, COUT)


def test_input_buffer_completeness(config, rng):
    for proc in _pair(config):
        b = proc.fragm
        audio = (0.1 * rng.standard_normal((b + 20, CIN))).astype(np.float32)
        src = _Source(audio)
        assert not proc.is_input_buffer_complete()
        assert proc.fill_buffer(_Source(audio[:b // 2])) == b // 2
        assert not proc.is_input_buffer_complete()
        src.pos = b // 2
        assert proc.fill_buffer(src) == b - b // 2
        assert proc.is_input_buffer_complete()
        proc.write_processed(lambda frames: None, b)
        assert not proc.is_input_buffer_complete()


def test_config_staleness_by_mtime(config):
    ref, port = _pair(config)
    assert port.config_file_timestamp == ref.config_file_timestamp
    assert port.config_still_up_to_date() and ref.config_still_up_to_date()
    later = port.config_file_timestamp + 10
    os.utime(config, (later, later))
    assert not port.config_still_up_to_date()
    assert not ref.config_still_up_to_date()
    assert port.config_file_timestamp == ref.config_file_timestamp


def test_reset_max_values_folds_inflight_state(config, rng):
    """A bulk chunk is in flight on each processor's scheduler when the
    monitor is reset: the reset folds the step's state in without
    emitting its audio, clears the max, keeps hist and tail, and the
    audio still reaches the sink afterwards."""
    t = 3
    scheds = (JScheduler(max_batch=2, window_s=0.01),
              DeviceScheduler(max_batch=2, window_s=0.01, device="cpu"))
    try:
        procs = _pair(config, scheds)
        b = procs[0].fragm
        audio = (0.2 * rng.standard_normal((2 * t * b, CIN))).astype(np.float32)
        outs = []
        for proc in procs:
            src, got = _Source(audio), []
            assert proc.pump_chunk(src, got.append, t) == t * b
            assert proc.pump_chunk(src, got.append, t) == t * b
            assert len(got) == 1  # chunk 1 emitted, chunk 2 in flight
            assert proc._inflight is not None and proc._inflight.future is not None
            assert proc.max_output_value() > 0
            proc.reset_max_values()
            assert proc.max_output_value() == 0.0
            assert proc._inflight is not None and len(got) == 1
            outs.append((proc._state, got))
        for f in ("hist_re", "hist_im", "tail"):
            np.testing.assert_allclose(np.asarray(getattr(outs[1][0], f)),
                                       np.asarray(getattr(outs[0][0], f)), atol=2e-4)
        for proc, (_, got) in zip(procs, outs):
            proc.drain_pipeline()
            assert len(got) == 2 and proc.max_output_value() == 0.0
        np.testing.assert_allclose(np.concatenate(outs[1][1]), np.concatenate(outs[0][1]),
                                   atol=2e-4)
    finally:
        for s in scheds:
            s.stop()
