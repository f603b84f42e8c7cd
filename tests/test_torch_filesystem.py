"""The port's FolveFilesystem against the JAX package's, on the CPU: the
same source and filter directories served through both, the port's PCM
within 1 LSB of the JAX package's at 16 bits (4 at 24 bits, see
:func:`lsb_limit`), and the port's own player behaviors (header-only
reads, the processor pool, gapless joins, concurrent readers)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from folve_tpu.runtime import (
    ConvolveFileHandler as JConvolve,
    FolveFilesystem as JFolveFilesystem,
    PassThroughHandler as JPassThrough,
)
from folve_tpu_torch.audio.flac import read_flac, write_flac
from folve_tpu_torch.audio.types import SampleCodec
from folve_tpu_torch.audio.wav import write_wav
from folve_tpu_torch.runtime import (
    ConvolveFileHandler,
    FolveFilesystem,
    PassThroughHandler,
)

torch.set_num_threads(1)

RATE = 44100
# tests/test_runtime.py's 512-tap echo: one 512-frame partition (P = 1,
# the window MAC).
ECHO = ("/convolver/new 2 2 64 512\n"
        "/impulse/dirac 1 1 0.7 0\n/impulse/dirac 2 2 0.7 0\n"
        "/impulse/dirac 1 1 0.3 100\n/impulse/dirac 2 2 0.3 100\n")
# The echo's shape with other gains and delays: batched with "echo", the
# mixed-filter route.
ECHO_B = ("/convolver/new 2 2 64 512\n"
          "/impulse/dirac 1 1 0.5 7\n/impulse/dirac 2 2 0.6 0\n"
          "/impulse/dirac 1 1 -0.3 300\n/impulse/dirac 2 2 0.25 411\n")
# 32,768 taps, true stereo: four 8192-frame partitions (P = 4), the fused
# route for lone streams and shared batches.
LONG = ("/convolver/new 2 2 8192 32768\n"
        "/impulse/dirac 1 1 0.6 0\n/impulse/dirac 2 2 0.6 0\n"
        "/impulse/dirac 1 2 0.2 9001\n/impulse/dirac 2 1 -0.2 20011\n"
        "/impulse/dirac 1 1 0.15 32000\n/impulse/dirac 2 2 0.1 27000\n")
CONFIGS = {"echo": ECHO, "echo_b": ECHO_B, "long": LONG}
# Frames per test track of each filter: bulk chunks of 8 blocks, then a
# ragged last block.
FRAMES = {"echo": 19 * 512 + 219, "long": 2 * 65536 + 3 * 8192 + 1234}


@pytest.fixture(autouse=True)
def no_spectra_cache(monkeypatch):
    """Each package compiles its own spectra here (the cache has its own
    tests)."""
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")


def _dirs(tmp_path, filters):
    src = tmp_path / "src"
    os.makedirs(src, exist_ok=True)
    for name, text in filters.items():
        os.makedirs(tmp_path / "filters" / name, exist_ok=True)
        (tmp_path / "filters" / name / f"filter-{RATE}.conf").write_text(text)
    return src


def _setup(fs, tmp_path, filt, gapless=False, toplevel=False):
    fs.underlying_dir = str(tmp_path / "src")
    fs.base_config_dir = str(tmp_path / "filters")
    fs.current_config_subdir = "" if toplevel else filt
    fs.gapless_processing = gapless
    fs.toplevel_dir_is_filter = toplevel
    assert fs.check_initialized()
    return fs


def make_fs(tmp_path, filt="echo", **kw):
    return _setup(FolveFilesystem(device="cpu"), tmp_path, filt, **kw)


def make_jfs(tmp_path, filt="echo", **kw):
    return _setup(JFolveFilesystem(), tmp_path, filt, **kw)


def write_song(path, frames, seed, bits=16, amp=0.4, channels=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amp, amp, (frames, channels))
    scale = float(1 << (bits - 1))
    x = (np.round(x * scale) / scale).astype(np.float32)
    write_flac(str(path), x, RATE, bits=bits)
    return x


def read_all(handler, chunk=65536, cap=400):
    out = b""
    for _ in range(cap):
        data = handler.read(chunk, len(out))
        if not data:
            break
        out += data
    return out


def serve(fs, path):
    h = fs.get_or_create_handler(path)
    try:
        return h, h.stat().st_size, read_all(h)
    finally:
        fs.close_handler(path, h)


def pcm(blob):
    y, info = read_flac(blob)
    scale = float(1 << (info.bits_per_sample - 1))
    return np.round(y.astype(np.float64) * scale).astype(np.int64), info


def lsb_limit(bits):
    """Largest |port - JAX| and |port - oracle| in LSBs: 1 at 16 bits.
    At 24 bits one LSB (2^-23) is below a float32 ulp of a loud sample,
    and the JAX package's own budget against the float64 oracle is 4 LSBs
    (tests/test_runtime.py, the WAV -> FLAC/24 case); each float32 engine
    uses up to 3 of them here, so two engines that sum in different
    orders are held to the same 4."""
    return 1 if bits <= 16 else 4


def assert_same_pcm(got_blob, want_blob):
    got, ginfo = pcm(got_blob)
    want, winfo = pcm(want_blob)
    assert (ginfo.frames, ginfo.rate, ginfo.channels, ginfo.bits_per_sample) == (
        winfo.frames, winfo.rate, winfo.channels, winfo.bits_per_sample)
    assert got.shape == want.shape
    assert int(np.max(np.abs(got - want))) <= lsb_limit(ginfo.bits_per_sample)
    return got, ginfo


def oracle_pcm(x, config_path, bits):
    """The float64 convolution of ``x`` with the config's IR (compiled by
    the JAX package), quantized on the host."""
    from scipy import signal

    from folve_tpu.filters import compile_config_file as j_compile

    ir = j_compile(config_path, fsamp=RATE).ir.astype(np.float64)
    x = np.asarray(x, np.float64)
    ref = np.zeros((x.shape[0], ir.shape[1]))
    for o in range(ir.shape[1]):
        for i in range(ir.shape[0]):
            ref[:, o] += signal.fftconvolve(x[:, i], ir[i, o])[: x.shape[0]]
    scale = float(1 << (bits - 1))
    return np.clip(np.round(ref * scale), -scale, scale - 1)


@pytest.mark.parametrize("filt", ["echo", "long"])
@pytest.mark.parametrize("kind", ["flac16", "flac24", "wav"])
def test_served_pcm_matches_jax(tmp_path, kind, filt):
    src = _dirs(tmp_path, CONFIGS)
    n = FRAMES[filt]
    if kind == "wav":
        rng = np.random.default_rng(7)
        x = rng.uniform(-0.4, 0.4, (n, 2))
        x = (np.round(x * 32768) / 32768).astype(np.float32)
        write_wav(str(src / "a.wav"), x, RATE, SampleCodec.PCM_16)
        name, bits = "/a.wav", 24  # WAV is served as FLAC/24
    else:
        bits = int(kind[4:])
        x = write_song(src / "a.flac", n, seed=3, bits=bits)
        name = "/a.flac"
    h, size, blob = serve(make_fs(tmp_path, filt), name)
    jh, jsize, jblob = serve(make_jfs(tmp_path, filt), name)
    assert isinstance(h, ConvolveFileHandler) and isinstance(jh, JConvolve)
    assert size == jsize
    assert blob[:4] == b"fLaC"
    got, info = assert_same_pcm(blob, jblob)
    assert (info.frames, info.bits_per_sample) == (n, bits)
    want = oracle_pcm(x, str(tmp_path / "filters" / filt / f"filter-{RATE}.conf"), bits)
    assert int(np.max(np.abs(got - want))) <= lsb_limit(bits)


def test_non_audio_file_passes_through_byte_equal(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    raw = bytes(np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8))
    (src / "notes.bin").write_bytes(raw)
    h, size, blob = serve(make_fs(tmp_path), "/notes.bin")
    assert isinstance(h, PassThroughHandler)
    assert blob == raw and size == len(raw)
    _, _, jblob = serve(make_jfs(tmp_path), "/notes.bin")
    assert blob == jblob


def test_channel_mismatch_falls_back(tmp_path):
    """Stereo-only filter + mono file -> clean pass-through with the JAX
    package's message."""
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "mono.flac", 600, seed=11, channels=1)
    h, _, blob = serve(make_fs(tmp_path), "/mono.flac")
    jh, _, _ = serve(make_jfs(tmp_path), "/mono.flac")
    assert isinstance(h, PassThroughHandler) and isinstance(jh, JPassThrough)
    assert "channels" in h.get_handler_status().message
    assert h.get_handler_status().message == jh.get_handler_status().message
    assert blob == (src / "mono.flac").read_bytes()


def test_toplevel_dir_mode_with_two_filters(tmp_path):
    """``-t`` mode: /echo/... and /echo_b/... serve the same file through
    two filters of one shape, read at once so their blocks may share
    mixed-filter device steps."""
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "t.flac", 5 * 512 + 77, seed=5)
    fs = make_fs(tmp_path, toplevel=True)
    jfs = make_jfs(tmp_path, toplevel=True)
    paths = ["/echo/t.flac", "/echo_b/t.flac"]
    out, errors = {}, []

    def go(path):
        try:
            out[path] = serve(fs, path)[2]
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(p,)) for p in paths]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(out) == 2
    for p in paths:
        assert_same_pcm(out[p], serve(jfs, p)[2])
    assert out[paths[0]] != out[paths[1]]
    assert fs.get_or_create_handler("/nofilter/t.flac") is None


def test_header_only_read_does_not_convolve(tmp_path):
    """A player that indexes reads the header only: no audio is
    produced, and the header is the JAX package's, byte for byte."""
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "song.flac", 200000, seed=2)
    fs, jfs = make_fs(tmp_path), make_jfs(tmp_path)
    h = fs.get_or_create_handler("/song.flac")
    jh = jfs.get_or_create_handler("/song.flac")
    header_size = h._buffer.header_size()
    assert header_size > 0 and header_size == jh._buffer.header_size()
    assert h.read(header_size, 0) == jh.read(header_size, 0)
    assert h._buffer.file_size() == header_size  # no audio produced
    assert fs.device_scheduler.jobs == 0
    fs.close_handler("/song.flac", h)
    jfs.close_handler("/song.flac", jh)


def test_processor_pool_reuse_and_staleness(tmp_path):
    _dirs(tmp_path, CONFIGS)
    fs = make_fs(tmp_path)
    cfg_dir = os.path.join(fs.base_config_dir, "echo")
    p1, msg = fs.processor_pool.get_or_create(cfg_dir, RATE, 2, 16)
    assert p1 is not None, msg
    fs.processor_pool.return_processor(p1)
    p2, _ = fs.processor_pool.get_or_create(cfg_dir, RATE, 2, 16)
    assert p2 is p1  # pooled
    fs.processor_pool.return_processor(p2)
    # Touch the config: the pooled processor must be discarded.
    conf = os.path.join(cfg_dir, f"filter-{RATE}.conf")
    os.utime(conf, (time.time() + 5, time.time() + 5))
    p3, _ = fs.processor_pool.get_or_create(cfg_dir, RATE, 2, 16)
    assert p3 is not p1
    assert not p1.config_still_up_to_date() and p3.config_still_up_to_date()
    fs.processor_pool.return_processor(p3)


def test_gapless_two_file_join_is_continuous(tmp_path):
    """Two tracks with partial blocks at the seam: the joined output is
    the convolution of the joined input (1 LSB), and the handover
    happened."""
    from scipy import signal

    src = _dirs(tmp_path, CONFIGS)
    n1, n2 = 2 * 512 + 300, 3 * 512 + 100
    x1 = write_song(src / "a_track1.flac", n1, seed=1)
    x2 = write_song(src / "a_track2.flac", n2, seed=2)
    fs = make_fs(tmp_path, gapless=True)
    h1 = fs.get_or_create_handler("/a_track1.flac")
    out1 = read_all(h1)
    assert h1.get_handler_status().out_gapless
    fs.close_handler("/a_track1.flac", h1)
    h2 = fs.get_or_create_handler("/a_track2.flac")
    assert h2.get_handler_status().in_gapless
    out2 = read_all(h2)
    fs.close_handler("/a_track2.flac", h2)
    y1, _ = pcm(out1)
    y2, _ = pcm(out2)
    assert y1.shape[0] == n1 and y2.shape[0] == n2
    ir = np.zeros(512)
    ir[0], ir[100] = 0.7, 0.3
    x = np.concatenate([x1, x2]).astype(np.float64)
    ref = np.stack([signal.fftconvolve(x[:, c], ir)[: x.shape[0]]
                    for c in range(2)], axis=1)
    want = np.clip(np.round(ref * 32768), -32768, 32767)
    assert int(np.max(np.abs(np.concatenate([y1, y2]) - want))) <= 1


def test_concurrent_reads_equal_sequential(tmp_path):
    """Four threads reading four files at once (their blocks batched on
    the fused route) get the bytes sequential reads get."""
    src = _dirs(tmp_path, CONFIGS)
    names = [f"/s{i}.flac" for i in range(4)]
    for i, name in enumerate(names):
        write_song(src / name[1:], FRAMES["long"] + 8000 * i, seed=20 + i)
    seq = {name: serve(make_fs(tmp_path, "long"), name)[2] for name in names}
    fs = make_fs(tmp_path, "long")
    fs.open_file_cache.set_max_size(8)
    got, errors = {}, []
    barrier = threading.Barrier(len(names))

    def go(name):
        try:
            h = fs.get_or_create_handler(name)
            barrier.wait(timeout=60)
            out = b""
            while True:
                data = h.read(8192, len(out))
                if not data:
                    break
                out += data
            got[name] = out
            fs.close_handler(name, h)
        except BaseException as e:  # re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=go, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert got == seq


def test_concurrent_first_opens_compile_a_filter_once(tmp_path, monkeypatch):
    """Eight streams opening one filter at once share one compile and
    one copy of its spectra (the shared batches of the fused route need
    one spectra tensor)."""
    from folve_tpu_torch.filters import compiler

    _dirs(tmp_path, CONFIGS)
    fs = make_fs(tmp_path)
    cfg_dir = os.path.join(fs.base_config_dir, "echo")
    compile_spec, calls = compiler.compile_spec, []

    def counted(*a, **k):
        calls.append(1)
        time.sleep(0.2)  # hold the compile while the others arrive
        return compile_spec(*a, **k)

    monkeypatch.setattr(compiler, "compile_spec", counted)
    procs, errors = [None] * 8, []
    barrier = threading.Barrier(len(procs))

    def go(i):
        try:
            barrier.wait(timeout=60)
            procs[i], _ = fs.processor_pool.get_or_create(cfg_dir, RATE, 2, 16)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(procs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and all(p is not None for p in procs)
    assert len(calls) == 1
    assert len({id(p) for p in procs}) == len(procs)
    assert all(p.bank.h_spec is procs[0].bank.h_spec for p in procs)
