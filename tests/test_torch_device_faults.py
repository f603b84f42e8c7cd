"""No fallback hides the device: an error of the device (a RuntimeError
from torch or CUDA) during a filter compile or a step propagates through
SoundProcessor.create, the ProcessorPool and the FolveFilesystem, and is
never served as a pass-through; a config that does not compile still
passes the file through, as in the JAX package."""

import os

import numpy as np
import pytest
import torch

from folve_tpu_torch.audio.flac import write_flac
from folve_tpu_torch.filters.compiler import FilterCompileError
from folve_tpu_torch.runtime import (
    ConvolveFileHandler,
    FolveFilesystem,
    PassThroughHandler,
    SoundProcessor,
)

torch.set_num_threads(1)

RATE = 44100
CONF = ("/convolver/new 2 2 64 512\n"
        "/impulse/dirac 1 1 0.7 0\n/impulse/dirac 2 2 0.7 0\n")


@pytest.fixture
def served(tmp_path, monkeypatch):
    """(filesystem on the CPU, config path) over one stereo FLAC track;
    the spectra cache is off so every processor compiles."""
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")
    src, cfg = tmp_path / "src", tmp_path / "filters" / "f"
    os.makedirs(src)
    os.makedirs(cfg)
    (cfg / f"filter-{RATE}.conf").write_text(CONF)
    x = np.random.default_rng(3).uniform(-0.4, 0.4, (3000, 2))
    write_flac(str(src / "song.flac"), (np.round(x * 32768) / 32768).astype(np.float32),
               RATE, bits=16)
    fs = FolveFilesystem(device="cpu")
    fs.underlying_dir, fs.base_config_dir = str(src), str(tmp_path / "filters")
    fs.current_config_subdir = "f"
    assert fs.check_initialized()
    return fs, str(cfg / f"filter-{RATE}.conf")


def _compile_raises(monkeypatch, exc):
    def fail(*a, **k):
        raise exc

    monkeypatch.setattr("folve_tpu_torch.filters.compiler.compile_spec", fail)


def test_device_error_in_compile_propagates(served, monkeypatch):
    fs, conf = served
    _compile_raises(monkeypatch, RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="CUDA error"):
        SoundProcessor.create(conf, RATE, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        fs.processor_pool.get_or_create(os.path.dirname(conf), RATE, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fs.get_or_create_handler("/song.flac")
    assert fs.open_file_cache.size() == 0  # nothing was served


@pytest.mark.parametrize("how", ["compile_error", "broken_config"])
def test_config_that_does_not_compile_passes_through(served, monkeypatch, how):
    fs, conf = served
    if how == "compile_error":
        _compile_raises(monkeypatch, FilterCompileError("no convolver defined"))
    else:
        with open(conf, "w") as f:
            f.write("/convolver/bogus nonsense\n")
    assert SoundProcessor.create(conf, RATE, 2, device="cpu") is None
    proc, msg = fs.processor_pool.get_or_create(os.path.dirname(conf), RATE, 2, 16)
    assert proc is None and msg.startswith("Problem parsing")
    h = fs.get_or_create_handler("/song.flac")
    assert isinstance(h, PassThroughHandler)
    assert "Problem parsing" in h.get_handler_status().message
    fs.close_handler("/song.flac", h)


def test_device_error_in_a_step_fails_the_read(served, monkeypatch):
    """A step that fails after the handler is built fails the read: the
    stream is not switched to a pass-through."""
    fs, _ = served
    h = fs.get_or_create_handler("/song.flac")
    assert isinstance(h, ConvolveFileHandler)

    def fail(*a, **k):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr("folve_tpu_torch.runtime.scheduler.single_chunk_step", fail)
    out = h.read(65536, 0)  # the header: no step yet
    with pytest.raises(RuntimeError, match="CUDA error"):
        while True:  # read on as a player does, until the pump fails
            data = h.read(65536, len(out))
            assert data, "the stream ended without a step"
            out += data
    fs.close_handler("/song.flac", h)


def _steps_fail(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr("folve_tpu_torch.runtime.scheduler.single_chunk_step", fail)
    monkeypatch.setattr("folve_tpu_torch.engine.chunk_step", fail)


def test_device_error_in_cli_convolve_is_no_zero_exit(served, monkeypatch, tmp_path):
    from folve_tpu_torch.cli import main

    fs, conf = served
    monkeypatch.setenv("FOLVE_PLATFORM", "cpu")
    _steps_fail(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA error"):
        main(["convolve", "-C", fs.base_config_dir, "-i", "f",
              os.path.join(fs.underlying_dir, "song.flac"), str(tmp_path / "out.flac")])


def test_device_error_in_a_served_http_read_truncates_it(served, monkeypatch):
    """Over HTTP the failed read drops the connection mid-body (the
    status line is gone): the client sees an incomplete response, never
    a complete file."""
    import http.client

    from folve_tpu_torch.server.httpfs import start_httpfs_thread
    from folve_tpu_torch.server.vfs import FolveVfs

    fs, _ = served
    _steps_fail(monkeypatch)
    httpd = start_httpfs_thread(FolveVfs(fs), 0)
    try:
        conn = http.client.HTTPConnection("localhost", httpd.server_address[1], timeout=60)
        conn.request("GET", "/files/song.flac")
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises((http.client.IncompleteRead, ConnectionError)):
            resp.read()
        conn.close()
    finally:
        httpd.shutdown()


def test_device_error_in_a_fuse_read_is_an_io_error(served, monkeypatch):
    from folve_tpu_torch.server.vfs import FolveVfs

    from tests.test_fuse import ROOT_ID
    from tests.test_torch_fuse import PortHarness

    fs, _ = served
    _steps_fail(monkeypatch)
    harness = PortHarness(FolveVfs(fs))
    try:
        err, nodeid, _ = harness.lookup(ROOT_ID, "song.flac")
        assert err == 0
        err, fh, _ = harness.open(nodeid)
        assert err == 0
        offset, errors = 0, []
        for _ in range(100):
            err, body = harness.read(nodeid, fh, offset, 65536)
            if err:
                errors.append(err)
                break
            assert body, "the stream ended without a step"
            offset += len(body)
        assert errors == [-5]  # -EIO
        harness.release(nodeid, fh)
    finally:
        harness.close()
