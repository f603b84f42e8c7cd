"""folve_tpu_torch filter compiling against folve_tpu: spectra planes and
compiled host_spec byte-equal, WAV loading and config parsing equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from folve_tpu.audio.types import SampleCodec
from folve_tpu.audio.wav import read_wav as j_read_wav, write_wav
from folve_tpu.engine.filter_bank import compute_spectra_planes as j_planes
from folve_tpu.filters import compile_config_file as j_compile
from folve_tpu.filters import parse_config as j_parse
from folve_tpu.filters import sstring as j_sstring
from folve_tpu_torch.audio.wav import WavError, read_wav
from folve_tpu_torch.engine.filter_bank import (
    compile_filter_bank,
    compute_spectra_planes,
)
from folve_tpu_torch.filters import compile_config_file, parse_config, sstring

torch.set_num_threads(1)


@pytest.mark.parametrize("cin,cout,size,fragm,layout", [
    (2, 2, 1000, 128, "half"),
    (1, 2, 700, None, "half"),
    (2, 1, 513, 64, "full"),
])
def test_spectra_planes_byte_equal(rng, cin, cout, size, fragm, layout):
    ir = rng.standard_normal((cin, cout, size)).astype(np.float32)
    a, fa, sa = j_planes(ir, fragm, None, layout)
    b, fb, sb = compute_spectra_planes(ir, fragm, None, layout)
    assert (fa, sa) == (fb, sb)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    bank = compile_filter_bank(ir, fragm=fragm, layout=layout, device="cpu")
    assert bank.h_spec.numpy().tobytes() == b.tobytes()
    assert (bank.partitions, bank.ninp, bank.nout) == (b.shape[0], cin, cout)


@pytest.mark.parametrize("codec", [
    SampleCodec.PCM_16, SampleCodec.PCM_24, SampleCodec.PCM_32,
    SampleCodec.FLOAT, SampleCodec.DOUBLE,
])
def test_wav_reader_matches_jax(tmp_path, rng, codec):
    data = (0.5 * rng.standard_normal((300, 3))).clip(-1, 0.99).astype(np.float32)
    path = str(tmp_path / "ir.wav")
    write_wav(path, data, 48000, codec)
    a, ainfo = j_read_wav(path)
    b, binfo = read_wav(path)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (binfo.rate, binfo.channels, binfo.frames) == (48000, 3, 300)


def test_wav_reader_rejects_other_formats(tmp_path):
    with pytest.raises(WavError):
        read_wav(b"RIFF\x04\x00\x00\x00WAVE")
    with pytest.raises(WavError):
        read_wav(b"not a wav file at all")


def _write_config(tmp_path, rng):
    ir = (0.3 * rng.standard_normal((900, 2))).astype(np.float32)
    write_wav(str(tmp_path / "ir.wav"), ir, 44100, SampleCodec.PCM_24)
    cfg = tmp_path / "f.conf"
    cfg.write_text(
        "# test filter\n"
        "/convolver/new 2 2 512 1000\n"
        "/impulse/read 1 1 0.5 3 10 0 1 ir.wav\n"
        "/impulse/read 2 2 1 0 0 400 2 \"ir.wav\"\n"
        "/impulse/dirac 1 2 0.25 17\n"
        "/impulse/hilbert 2 1 0.5 200 128\n"
        "/impulse/copy 2 1 1 1\n"
    )
    return str(cfg)


def test_compiled_config_byte_equal(tmp_path, rng):
    cfg = _write_config(tmp_path, rng)
    a = j_compile(cfg, fsamp=44100)
    b = compile_config_file(cfg, fsamp=44100, device="cpu")
    assert a.ir.tobytes() == b.ir.tobytes()
    assert a.host_spec.tobytes() == b.host_spec.tobytes()
    assert b.bank.h_spec.numpy().tobytes() == b.host_spec.tobytes()
    assert a.warnings == b.warnings
    assert (a.fragm, a.bank.size) == (b.fragm, b.bank.size)


def test_parse_config_matches_jax(tmp_path, rng):
    cfg = _write_config(tmp_path, rng)
    a, b = j_parse(cfg), parse_config(cfg)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("src", [
    "plain rest", "  'quoted name' x", '"esc\\"aped"', "a\\ b", "'bad",
    "mid'quote", "",
])
def test_sstring_matches_jax(src):
    assert sstring(src) == j_sstring(src)


def test_unreadable_impulse_aborts_like_jax(tmp_path):
    cfg = tmp_path / "g.conf"
    cfg.write_text("/convolver/new 1 1 64 128\n"
                   "/impulse/dirac 1 1 1 5\n"
                   "/impulse/read 1 1 1 0 0 0 1 missing.wav\n"
                   "/impulse/dirac 1 1 1 9\n")
    a = j_compile(str(cfg), fsamp=44100)
    b = compile_config_file(str(cfg), fsamp=44100, device="cpu")
    assert a.ir.tobytes() == b.ir.tobytes()
    assert len(b.warnings) == len(a.warnings) == 1
