"""The port's persistent spectra cache: the cases of
tests/test_spectra_cache.py run on folve_tpu_torch, and cache files
shared with the JAX package in both directions."""

import os

import numpy as np
import pytest
import torch

from folve_tpu.audio.wav import write_wav
from folve_tpu.filters import spectra_cache as j_cache
from folve_tpu_torch.filters import spectra_cache
from folve_tpu_torch.filters.compiler import compile_config_file

torch.set_num_threads(1)

RATE = 44100


def _make_filter(tmp_path, rng, name="f", taps=600):
    d = tmp_path / name
    os.makedirs(d, exist_ok=True)
    ir = (rng.standard_normal((taps, 1)) / 64).astype(np.float32)
    write_wav(str(d / "ir.wav"), ir, RATE)
    conf = d / f"filter-{RATE}.conf"
    conf.write_text(
        "/cd %s\n/convolver/new 2 2 64 1024\n"
        "/impulse/read 1 1 1.0 0 0 0 1 ir.wav\n"
        "/impulse/read 2 2 1.0 0 0 0 1 ir.wav\n" % d
    )
    return str(conf), d / "ir.wav", ir


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    cdir = tmp_path / "cache"
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", str(cdir))
    return cdir


def _no_compile(monkeypatch, message):
    def boom(*a, **k):
        raise AssertionError(message)

    monkeypatch.setattr("folve_tpu_torch.filters.compiler.compile_spec", boom)


def test_hit_is_equal_and_skips_compile(tmp_path, rng, cache_env, monkeypatch):
    conf, _, _ = _make_filter(tmp_path, rng)
    first = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert len(os.listdir(cache_env)) == 1
    _no_compile(monkeypatch, "cache miss: compile_spec was called")
    second = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert torch.equal(first.bank.h_spec, second.bank.h_spec)
    assert second.bank.h_spec.device == torch.device("cpu")
    np.testing.assert_array_equal(first.ir, second.ir)
    assert first.bank.fragm == second.bank.fragm
    assert first.warnings == second.warnings


def test_ir_content_change_misses_even_with_same_mtime(tmp_path, rng, cache_env):
    conf, ir_path, ir = _make_filter(tmp_path, rng)
    spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    st = os.stat(ir_path)
    write_wav(str(ir_path), (ir * 0.5).astype(np.float32), RATE)
    os.utime(ir_path, (st.st_atime, st.st_mtime))  # mtime would lie
    fresh = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    ref = compile_config_file(conf, fsamp=RATE, device="cpu")
    assert torch.equal(fresh.bank.h_spec, ref.bank.h_spec)
    assert len(os.listdir(cache_env)) == 2  # distinct keys


def test_rate_is_part_of_the_key(tmp_path, rng, cache_env):
    conf, _, _ = _make_filter(tmp_path, rng)
    spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    spectra_cache.compile_with_cache(conf, 48000, device="cpu")
    assert len(os.listdir(cache_env)) == 2


def test_corrupt_entry_recompiles(tmp_path, rng, cache_env):
    conf, _, _ = _make_filter(tmp_path, rng)
    first = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    (entry,) = os.listdir(cache_env)
    (cache_env / entry).write_bytes(b"garbage")
    again = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert torch.equal(first.bank.h_spec, again.bank.h_spec)


def test_disabled_by_env(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")
    conf, _, _ = _make_filter(tmp_path, rng)
    c = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert c.bank.fragm > 0
    assert spectra_cache.cache_dir() is None


def test_warnings_survive_cache(tmp_path, rng, cache_env):
    conf, _, _ = _make_filter(tmp_path, rng)
    # A 48k stream over a 44.1k IR: rate-mismatch warning.
    first = spectra_cache.compile_with_cache(conf, 48000, device="cpu")
    assert any("does not match" in w for w in first.warnings)
    second = spectra_cache.compile_with_cache(conf, 48000, device="cpu")
    assert second.warnings == first.warnings


def test_pool_cold_create_served_from_disk(tmp_path, rng, cache_env, monkeypatch):
    """A fresh ProcessorPool (new mount) finds the spectra on disk: the
    compile never runs."""
    from folve_tpu_torch.runtime.pool import ProcessorPool

    conf, _, _ = _make_filter(tmp_path, rng)
    base_dir = os.path.dirname(conf)
    proc, err = ProcessorPool(device="cpu").get_or_create(base_dir, RATE, 2, 16)
    assert proc is not None, err
    _no_compile(monkeypatch, "disk cache missed in fresh pool")
    proc2, err = ProcessorPool(device="cpu").get_or_create(base_dir, RATE, 2, 16)
    assert proc2 is not None, err
    assert torch.equal(proc.bank.h_spec, proc2.bank.h_spec)


def test_jax_written_entry_loads_in_the_port(tmp_path, rng, cache_env, monkeypatch):
    conf, _, _ = _make_filter(tmp_path, rng)
    j_cache.compile_with_cache(conf, RATE)
    assert len(os.listdir(cache_env)) == 1
    own = compile_config_file(conf, fsamp=RATE, device="cpu")
    _no_compile(monkeypatch, "the JAX package's entry was not used")
    hit = spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert hit.bank.h_spec.numpy().tobytes() == own.host_spec.tobytes()
    assert hit.host_spec.tobytes() == own.host_spec.tobytes()
    assert hit.ir.tobytes() == own.ir.tobytes()
    assert (hit.fragm, hit.bank.size, hit.warnings) == (own.fragm, own.bank.size,
                                                        own.warnings)


def test_port_written_entry_loads_in_jax(tmp_path, rng, cache_env, monkeypatch):
    from folve_tpu.filters.compiler import compile_config_file as j_compile

    conf, _, _ = _make_filter(tmp_path, rng)
    spectra_cache.compile_with_cache(conf, RATE, device="cpu")
    assert len(os.listdir(cache_env)) == 1
    ref = j_compile(conf, fsamp=RATE)

    def boom(*a, **k):
        raise AssertionError("the port's entry was not used")

    monkeypatch.setattr("folve_tpu.filters.compiler.compile_spec", boom)
    hit = j_cache.compile_with_cache(conf, RATE)
    assert np.asarray(hit.bank.h_spec).tobytes() == ref.host_spec.tobytes()
    assert hit.ir.tobytes() == ref.ir.tobytes()
    assert (hit.fragm, hit.warnings) == (ref.fragm, ref.warnings)
