"""The port's FUSE transport on the CPU: its ``FuseSession`` over a
SOCK_SEQPACKET socketpair with hand-packed kernel requests (the JAX
package's harness in ``tests/test_fuse.py``), serving the bytes of the
port's VFS read and PCM within 1 LSB of the JAX ``FuseSession``'s; the
``-o`` option parser against the JAX package's; and a real kernel mount
where the environment permits one."""

import dataclasses
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from folve_tpu.fuse.mount import parse_mount_options as j_parse_mount_options
from folve_tpu.server.status import StatusServer as JStatusServer
from folve_tpu.server.vfs import FolveVfs as JFolveVfs
from folve_tpu_torch.audio.flac import read_flac
from folve_tpu_torch.fuse.mount import FuseSession, parse_mount_options
from folve_tpu_torch.server.status import StatusServer
from folve_tpu_torch.server.vfs import FolveVfs

from tests.test_fuse import ROOT_ID, FuseHarness
from tests.test_torch_filesystem import (
    CONFIGS,
    _dirs,
    assert_same_pcm,
    make_fs,
    make_jfs,
    read_all,
    write_song,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_spectra_cache(monkeypatch):
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")


class PortHarness(FuseHarness):
    """The JAX package's socketpair harness driving the port's session."""

    def __init__(self, vfs):
        self.kernel_sock, session_sock = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_SEQPACKET)
        self.session = FuseSession(vfs)
        self._session_sock = session_sock
        self.session.set_fd(session_sock.fileno())
        self.unique = 0
        self.thread = threading.Thread(
            target=self.session.loop, kwargs=dict(num_threads=1), daemon=True)
        self.thread.start()
        self.init()


def fuse_read(harness, name, chunk=65536):
    err, nodeid, attr = harness.lookup(ROOT_ID, name)
    assert err == 0
    err, fh, _ = harness.open(nodeid)
    assert err == 0
    out = b""
    while True:
        err, body = harness.read(nodeid, fh, len(out), chunk)
        assert err == 0
        if not body:
            break
        out += body
    harness.release(nodeid, fh)
    return attr, out


@pytest.mark.parametrize("filt,bits", [("echo", 16), ("long", 16), ("long", 24)])
def test_socketpair_session_serves_vfs_bytes(tmp_path, filt, bits):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "song.flac", 3 * 8192 + 777, seed=5, bits=bits)
    (src / "notes.txt").write_bytes(b"plain")
    fs, jfs = make_fs(tmp_path, filt), make_jfs(tmp_path, filt)
    port = PortHarness(FolveVfs(fs, status_server=StatusServer(fs)))
    jharness = FuseHarness(JFolveVfs(jfs, status_server=JStatusServer(jfs)))
    try:
        attr, blob = fuse_read(port, "song.flac")
        _, jblob = fuse_read(jharness, "song.flac")
        assert sorted(port.readdir_names(ROOT_ID)) == sorted(jharness.readdir_names(ROOT_ID))
        assert fuse_read(port, "notes.txt")[1] == b"plain"
        err, nodeid, _ = port.lookup(ROOT_ID, "folve-status.html")
        assert err == 0
        assert port.lookup(ROOT_ID, "missing.flac")[0] != 0
    finally:
        port.close()
        jharness.close()
    # The port's bytes are its VFS read's; its PCM is the JAX session's.
    vfs = FolveVfs(make_fs(tmp_path, filt))
    h = vfs.open("/song.flac")
    try:
        assert blob == read_all(h)
    finally:
        vfs.release("/song.flac", h)
    got, info = assert_same_pcm(blob, jblob)
    assert (info.frames, info.bits_per_sample) == (3 * 8192 + 777, bits)
    for f in (fs, jfs, vfs.fs):
        f.device_scheduler.stop()


@pytest.mark.parametrize("options", [
    "", "ro", "allow_other", "allow_other,rw,default_permissions", "nosuchopt,ro",
    "fsname=mysrc,subtype=folve,max_read=65536", "fsname=e$(vil)`x`",
    "max_read=nonsense", "max_read=1", "max_read=99999999", " rw , allow_other ",
])
def test_parse_mount_options_equal_jax(options):
    assert dataclasses.asdict(parse_mount_options(options)) == dataclasses.asdict(
        j_parse_mount_options(options))


def test_kernel_mount(tmp_path):
    if not os.path.exists("/dev/fuse"):
        pytest.skip("no /dev/fuse")
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "song.flac", 1200, seed=6)
    fs = make_fs(tmp_path)
    mnt = tmp_path / "mnt"
    mnt.mkdir()
    session = FuseSession(FolveVfs(fs, status_server=StatusServer(fs)))
    try:
        session.mount(str(mnt))
    except OSError as e:
        pytest.skip(f"mount not permitted here: {e}")
    t = threading.Thread(target=session.loop, daemon=True)
    t.start()
    try:
        deadline = time.time() + 10
        while "song.flac" not in os.listdir(mnt) and time.time() < deadline:
            time.sleep(0.1)
        with open(mnt / "song.flac", "rb") as f:
            blob = f.read()
        assert b"Folve-TPU" in (mnt / "folve-status.html").read_bytes()
    finally:
        session.unmount()
    t.join(timeout=10)
    jvfs = JFolveVfs(make_jfs(tmp_path))
    h = jvfs.open("/song.flac")
    try:
        assert_same_pcm(blob, read_all(h))
    finally:
        jvfs.release("/song.flac", h)
    y, _ = read_flac(blob)
    assert np.all(np.isfinite(y))
