"""The port's command line on the CPU (``FOLVE_PLATFORM=cpu``), held to
the JAX package's: ``convolve`` output decoding to the JAX package's PCM
(1 LSB at 16 bits, 4 at 24), ``info``, ``filters`` and
``make-demo-filters`` with the same output and byte-equal demo files,
the reference-style rewrite to ``mount``, the daemon-mode early
failures, the device choice, and no ``torch.cuda`` call before
``daemonize``."""

import argparse
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from folve_tpu.cli import main as jmain
from folve_tpu_torch import cli
from folve_tpu_torch.cli import main

from tests.test_torch_filesystem import (
    CONFIGS,
    RATE,
    _dirs,
    assert_same_pcm,
    lsb_limit,
    oracle_pcm,
    write_song,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("FOLVE_PLATFORM", "cpu")
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")


def _out(capsys) -> str:
    return capsys.readouterr().out


@pytest.mark.parametrize("filt", ["echo", "long"])
@pytest.mark.parametrize("bits", [16, 24])
def test_convolve_matches_jax(tmp_path, capsys, filt, bits):
    src = _dirs(tmp_path, CONFIGS)
    # A last, partial chunk: 32 blocks of the filter's fragment, plus a
    # ragged tail.
    n = {"echo": 2 * 32 * 64 + 1000, "long": 32 * 8192 + 4321}[filt]
    x = write_song(src / "in.flac", n, seed=bits, bits=bits)
    out, jout = str(tmp_path / "out.flac"), str(tmp_path / "jout.flac")
    args = ["convolve", "-C", str(tmp_path / "filters"), "-i", filt, str(src / "in.flac")]
    assert main(args + [out]) == 0
    line = _out(capsys)
    assert line.startswith(f"convolved {n / RATE:.1f}s of audio in ")
    assert line.rstrip().endswith(f"x realtime) -> {out}")
    assert jmain(args + [jout]) == 0
    got, info = assert_same_pcm(open(out, "rb").read(), open(jout, "rb").read())
    assert (info.frames, info.bits_per_sample) == (n, bits)
    want = oracle_pcm(x, str(tmp_path / "filters" / filt / f"filter-{RATE}.conf"), bits)
    assert int(np.max(np.abs(got - want))) <= lsb_limit(bits)
    # The offline file is complete, so STREAMINFO carries the real MD5.
    with open(out, "rb") as f:
        head = f.read(42)
    assert head[:4] == b"fLaC" and head[26:42] != bytes(16)


def test_convolve_wav_output_and_clipping_warning(tmp_path, capsys):
    src = _dirs(tmp_path, {"loud": "/convolver/new 2 2 64 128\n"
                                   "/impulse/dirac 1 1 3.0 0\n/impulse/dirac 2 2 3.0 0\n"})
    write_song(src / "in.flac", 3000, seed=1, amp=0.9)
    out = str(tmp_path / "out.wav")
    args = ["convolve", "-C", str(tmp_path / "filters"), "-i", "loud", str(src / "in.flac")]
    assert main(args + [out]) == 0
    err = capsys.readouterr().err
    assert jmain(args + [str(tmp_path / "jout.wav")]) == 0
    jerr = capsys.readouterr().err
    assert err.startswith("warning: output clipping (max=")
    assert err == jerr
    from folve_tpu_torch.audio import read_audio

    y, info = read_audio(out)
    jy, _ = read_audio(str(tmp_path / "jout.wav"))
    # 4 LSBs at 24 bits is the budget for a peak of about full scale;
    # a float32 engine's error scales with the peak, here 3.0 x 0.9.
    assert info.frames == 3000
    assert np.max(np.abs(y - jy)) <= lsb_limit(24) * 3.0 * 0.9 / (1 << 23)


def test_convolve_unknown_filter_and_source(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    (src / "notes.txt").write_text("not audio")
    with pytest.raises(SystemExit, match="not a supported audio file"):
        main(["convolve", "-C", str(tmp_path / "filters"), "-i", "echo",
              str(src / "notes.txt"), str(tmp_path / "o.flac")])
    write_song(src / "in.flac", 500, seed=1)
    with pytest.raises(SystemExit, match="no filter config"):
        main(["convolve", "-C", str(tmp_path / "filters"), "-i", "nosuch",
              str(src / "in.flac"), str(tmp_path / "o.flac")])


def test_info_and_filters_match_jax(tmp_path, capsys):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "a.flac", 4410, seed=1)
    for argv in (["info", str(src / "a.flac")],
                 ["info", str(tmp_path / "filters" / "long" / f"filter-{RATE}.conf")],
                 ["filters", "-C", str(tmp_path / "filters")]):
        assert main(argv) == 0
        got = _out(capsys)
        assert jmain(argv) == 0
        assert got == _out(capsys), argv
    assert main(["info", str(src / "a.flac")]) == 0
    assert "44100 Hz, 2 ch, 16 bit, 4410 frames" in _out(capsys)


def test_make_demo_filters_byte_equal_to_jax(tmp_path, capsys):
    assert main(["make-demo-filters", str(tmp_path / "df")]) == 0
    assert _out(capsys) == f"demo filters written to {tmp_path / 'df'}\n"
    assert jmain(["make-demo-filters", str(tmp_path / "jdf")]) == 0
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "df")
                   for d, _, fs in os.walk(tmp_path / "df") for f in fs)
    jnames = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jdf")
                    for d, _, fs in os.walk(tmp_path / "jdf") for f in fs)
    assert names == jnames and len(names) == 17
    for name in names:
        assert filecmp.cmp(tmp_path / "df" / name, tmp_path / "jdf" / name,
                           shallow=False), name


def test_option_value_does_not_trigger_mount_rewrite(tmp_path, capsys):
    """`--files-port 8080 serve dir` is refused loudly, as the JAX
    package refuses it, and never serves or mounts anything."""
    src = _dirs(tmp_path, CONFIGS)
    argv = ["--files-port", "8080", "serve", str(src)]
    with pytest.raises(SystemExit) as e:
        main(argv)
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as je:
        jmain(argv)
    assert e.value.code == je.value.code == 2
    last = err.splitlines()[-1]
    assert "error" in last
    assert last.replace("folve-tpu-torch", "folve-tpu") == (
        capsys.readouterr().err.splitlines()[-1])


def test_reference_style_invocation_means_mount(tmp_path, capsys):
    """`folve [options] src mnt` with no subcommand is a mount: here it
    fails on the missing mount point, which proves the route."""
    src = _dirs(tmp_path, CONFIGS)
    rc = main(["-C", str(tmp_path / "filters"), "-f", str(src), str(tmp_path / "nope")])
    assert rc == 1
    assert "FUSE mount failed" in capsys.readouterr().out


def _no_fork(monkeypatch):
    def daemonize():
        raise AssertionError("daemonized despite an early failure")

    monkeypatch.setattr("folve_tpu_torch.fuse.mount.daemonize", daemonize)


@pytest.mark.parametrize("case", ["mount_point", "config_dir", "prebuffer"])
def test_daemon_mode_fails_before_fork(tmp_path, monkeypatch, case):
    src = _dirs(tmp_path, CONFIGS)
    _no_fork(monkeypatch)
    argv = {
        "mount_point": ["-C", str(tmp_path / "filters"), str(src), "/nonexistent-mnt"],
        "config_dir": ["-C", "/nope-dir", str(src), str(tmp_path)],
        "prebuffer": ["-b", "7", "-C", str(tmp_path / "filters"), str(src), str(tmp_path)],
    }[case]
    with pytest.raises(SystemExit) as e:
        main(["mount"] + argv)
    want = "prebuffer" if case == "prebuffer" else "is not a directory"
    assert want in str(e.value.code)


@pytest.mark.parametrize("platform", ["bogus", "tpu"])
def test_unknown_platform_exits_nonzero(monkeypatch, platform):
    monkeypatch.setenv("FOLVE_PLATFORM", platform)
    with pytest.raises(SystemExit, match="FOLVE_PLATFORM"):
        main(["info", "x.flac"])


@pytest.mark.parametrize("value,want", [("", "cuda"), ("cuda", "cuda"), ("GPU", "cuda"),
                                        ("cpu", "cpu")])
def test_platform_names(monkeypatch, value, want):
    monkeypatch.setenv("FOLVE_PLATFORM", value)
    assert cli._platform_device() == want


def test_prebuffer_flag_and_device(tmp_path):
    src = _dirs(tmp_path, CONFIGS)

    def build(prebuffer, freq_parallel=1):
        args = argparse.Namespace(
            config_dir=str(tmp_path / "filters"), initial_filter="echo",
            gapless=False, toplevel_filter=False, prebuffer=prebuffer,
            oversize_factor=1.25, flac_block_size=4096,
            workaround_flac_header=False, pid_file="", debug=False,
            freq_parallel=freq_parallel, device="cpu")
        return cli._build_fs(args, str(src))

    fs = build(-1)
    assert fs.pre_buffer_size == 0 and fs.device == torch.device("cpu")
    assert fs.serving_mesh is None and fs.current_config_subdir == "echo"
    fs.device_scheduler.stop()
    fs = build(256)
    assert fs.pre_buffer_size == 256 << 10
    fs.device_scheduler.stop()
    with pytest.raises(SystemExit, match="prebuffer"):
        build(7)
    with pytest.raises(SystemExit, match="--freq-parallel 2 needs >1 device, have 1"):
        build(128, freq_parallel=2)


def test_convolve_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "in.flac", 500, seed=1)
    env = {k: v for k, v in os.environ.items() if k != "FOLVE_PLATFORM"}
    r = subprocess.run(
        [sys.executable, "-m", "folve_tpu_torch", "convolve", "-C",
         str(tmp_path / "filters"), "-i", "echo", str(src / "in.flac"),
         str(tmp_path / "out.flac")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "FOLVE_PLATFORM=cpu" in r.stderr
    assert not (tmp_path / "out.flac").exists()


class _Forked(Exception):
    pass


def test_mount_touches_no_cuda_before_daemonize(tmp_path, monkeypatch):
    """A child forked after its parent initialized CUDA cannot use the
    card: cmd_mount validates, forks, and only then resolves the device
    (here: no card after the fork, so it exits with resolve_device's
    message)."""
    src = _dirs(tmp_path, CONFIGS)
    (tmp_path / "mnt").mkdir()
    monkeypatch.delenv("FOLVE_PLATFORM")
    events = []

    def guard(name, after):
        def call(*a, **k):
            events.append(name)
            assert "daemonize" in events, f"torch.cuda.{name} before daemonize()"
            return after

        return call

    for name, after in (("is_available", False), ("device_count", 0),
                        ("current_device", 0), ("init", None), ("_lazy_init", None)):
        monkeypatch.setattr(torch.cuda, name, guard(name, after))
    monkeypatch.setattr("folve_tpu_torch.fuse.mount.daemonize",
                        lambda: events.append("daemonize"))
    with pytest.raises(SystemExit) as e:
        main(["mount", "-C", str(tmp_path / "filters"), "-i", "echo", str(src),
              str(tmp_path / "mnt")])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    assert events[0] == "daemonize" and "is_available" in events
