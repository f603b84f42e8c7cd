"""The port's status server, VFS and HTTP frontend on the CPU: the status
page's stream rows equal to the JAX package's for the same opens and
reads, the filter switch and its one-shot notice, retired history, the
``/profile`` trace (``torch.profiler``), the HTTP file server (GET, HEAD,
Range, traversal), and one ``serve`` process whose bytes equal the
port's VFS read."""

import http.client
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from folve_tpu.server.status import StatusServer as JStatusServer
from folve_tpu.server.vfs import FolveVfs as JFolveVfs
from folve_tpu_torch.server.httpfs import _clean_path, _parse_range, start_httpfs_thread
from folve_tpu_torch.server.status import StatusServer
from folve_tpu_torch.server.vfs import STATUS_FILE_NAME, FolveVfs
from folve_tpu_torch.utils.profiling import analyze_device_trace

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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_spectra_cache(monkeypatch):
    monkeypatch.setenv("FOLVE_SPECTRA_CACHE", "0")


def port_vfs(tmp_path, **kw):
    fs = make_fs(tmp_path, **kw)
    return FolveVfs(fs, status_server=StatusServer(fs)), fs


def jax_vfs(tmp_path, **kw):
    fs = make_jfs(tmp_path, **kw)
    return JFolveVfs(fs, status_server=JStatusServer(fs)), fs


VFS = {"torch": port_vfs, "jax": jax_vfs}


def read_path(vfs, path, size=None):
    h = vfs.open(path)
    try:
        return vfs.read(h, size, 0) if size else read_all(h)
    finally:
        vfs.release(path, h)


def stream_rows(page: bytes) -> dict:
    """{table title: [[cell, ...] per row]} of the page's stream tables."""
    text = page.decode()
    out = {}
    for title, body in re.findall(r"<h3>(.*?)</h3><table>(.*?)</table>", text):
        rows = re.findall(r"<tr><td>(.*?)</td></tr>", body)
        out[title] = [re.split(r"</td><td[^>]*>", r) for r in rows]
    return out


# Every column but Max out, a dB rendering of each engine's own float32
# peak (progress is the reads' own with the prebuffer off).
_COMPARED = (0, 1, 2, 3, 5, 6, 7, 8)


def test_status_page_rows_equal_jax(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    os.makedirs(src / "album")
    for i, n in enumerate((3 * 512 + 101, 2 * 512 + 33)):
        write_song(src / "album" / f"0{i + 1}.flac", n, seed=20 + i)
    write_song(src / "c.flac", 4 * 512, seed=23)
    pages = {}
    for name, make in VFS.items():
        vfs, fs = make(tmp_path, gapless=True)
        fs.pre_buffer_size = 0  # no prebuffer thread: progress is the reads'
        for p in ("/album/01.flac", "/album/02.flac"):
            read_path(vfs, p)
        h = vfs.open("/c.flac")
        vfs.read(h, 16, 0)  # header only
        pages[name] = vfs.status_server.create_page()
        vfs.release("/c.flac", h)
        fs.device_scheduler.stop()
    rows = {k: stream_rows(v) for k, v in pages.items()}
    active = rows["torch"]["Active streams"]
    assert [r[8].split(" <i>")[0] for r in active] == [
        "/c.flac", "/album/02.flac", "/album/01.flac"]
    assert active[0][0] == "open" and "Only header accessed" in active[0][8]
    assert active[1][6] == "&larr;" and active[2][6] == "&rarr;"
    for title in rows["jax"]:
        assert [[r[i] for i in _COMPARED] for r in rows["torch"][title]] == [
            [r[i] for i in _COMPARED] for r in rows["jax"][title]]
    opens = [re.search(rb"<p>\d+ file openings, \d+ re-opens, \d+ active handlers</p>", p)
             for p in pages.values()]
    assert opens[0].group(0) == opens[1].group(0)
    for page in pages.values():
        assert re.search(rb"<p>Device: [1-9]\d* fused steps for", page)


@pytest.mark.parametrize("pkg", list(VFS))
def test_filter_switch_and_one_shot_notice(tmp_path, pkg):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "a.flac", 900, seed=1)
    vfs, fs = VFS[pkg](tmp_path)
    h = vfs.open("/a.flac")
    status = vfs.status_server
    code, _, body = status.handle_http("/")
    assert code == 200 and b"a.flac" in body
    assert b'href="/settings?f=echo" class="sel"' in body
    code, headers, _ = status.handle_http("/settings?f=echo_b")
    assert (code, headers) == (302, {"Location": "/"})
    assert fs.current_config_subdir == "echo_b"
    notice = b"Affects re- or newly opened files."
    assert notice in status.handle_http("/")[2]
    assert notice not in status.handle_http("/")[2]  # one shot
    code, _, _ = status.handle_http("/settings?f=nosuchfilter")
    assert code == 302 and fs.current_config_subdir == "echo_b"
    assert notice not in status.handle_http("/")[2]
    vfs.release("/a.flac", h)
    # A file opened after the switch is served through the new filter.
    h = vfs.open("/a.flac")
    assert h.filter_dir() == "echo_b"
    vfs.release("/a.flac", h)
    fs.device_scheduler.stop()


@pytest.mark.parametrize("pkg", list(VFS))
def test_retired_history(tmp_path, pkg):
    src = _dirs(tmp_path, CONFIGS)
    vfs, fs = VFS[pkg](tmp_path)
    fs.open_file_cache.set_max_size(1)
    for i in range(3):
        write_song(src / f"s{i}.flac", 400, seed=i)
        read_path(vfs, f"/s{i}.flac", 4096)
    body = vfs.status_server.handle_http("/")[2]
    assert b"Recently retired" in body
    retired = stream_rows(body)["Recently retired"]
    assert [r[0] for r in retired] == ["retired"] * 2
    # Beyond the ring of 20 the page counts the rest: s0, s1, then s2
    # (evicted by this reopen of s0) and 23 more make 6 past the ring.
    status = vfs.status_server
    h = fs.get_or_create_handler("/s0.flac")
    for _ in range(23):
        status.retire_handler_event(h)
    fs.close_handler("/s0.flac", h)
    assert b"... (6 more)" in status.handle_http("/")[2]
    fs.device_scheduler.stop()


def test_profile_endpoint_writes_a_torch_trace(tmp_path):
    _dirs(tmp_path, CONFIGS)
    vfs, fs = port_vfs(tmp_path)
    status = vfs.status_server
    assert status.handle_http("/profile?secs=0.2")[0] == 403  # needs -D
    status.expensive_details = True
    assert status.handle_http("/profile?secs=abc")[0] == 400
    code, _, body = status.handle_http("/profile?secs=0.2")
    assert code == 200 and body.startswith(b"tracing 0.2s of device activity to ")
    log_dir = body.decode().rsplit(" to ", 1)[1].strip()
    assert status.handle_http("/profile?secs=0.2")[0] == 409  # one at a time
    status._profile_thread.join(timeout=30)
    assert not status._profile_thread.is_alive()
    assert os.path.isfile(os.path.join(log_dir, "trace.json"))
    trace = analyze_device_trace(log_dir)
    # No mem_bw_frac; the program's spans and the idle by span beside the ops.
    assert set(trace) == {"device_time_ms", "ops", "spans", "idle_by_span"}
    assert isinstance(trace["ops"], list) and trace["device_time_ms"] >= 0
    assert analyze_device_trace(str(tmp_path / "empty")) == {}
    fs.device_scheduler.stop()


def test_vfs_status_file_and_inflated_sizes(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "a.flac", 900, seed=1)
    (src / "cover.jpg").write_bytes(b"\xff" * 1000)
    vfs, fs = port_vfs(tmp_path)
    jvfs, jfs = jax_vfs(tmp_path)
    assert vfs.readdir("/") == jvfs.readdir("/")
    assert STATUS_FILE_NAME[1:] in vfs.readdir("/")
    for path in ("/a.flac", "/cover.jpg"):
        st, jst = vfs.getattr(path), jvfs.getattr(path)
        assert (st.st_size, st.st_mode) == (jst.st_size, jst.st_mode)
        assert not st.st_mode & 0o222
    assert b"Folve-TPU" in read_path(vfs, STATUS_FILE_NAME)
    with pytest.raises(OSError):
        vfs.open("/missing.flac")
    for f in (fs, jfs):
        f.device_scheduler.stop()


def test_clean_path_and_parse_range():
    assert _clean_path("/a/../../b") == "/b"
    assert _clean_path("a\x00b") is None
    assert _parse_range("bytes=-100", 1000) == (900, None)
    assert _parse_range("bytes=5-9", 1000) == (5, 9)
    for bad in (None, "bytes=abc-", "bytes=1-2,4-5", "bytes=9-5", "items=1-2"):
        assert _parse_range(bad, 1000) is None


def test_http_get_head_range_and_traversal(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "a.flac", 1200, seed=4)
    (tmp_path / "secret.txt").write_text("top secret")
    vfs, fs = port_vfs(tmp_path)
    jvfs, jfs = jax_vfs(tmp_path)
    httpd = start_httpfs_thread(vfs, 0)
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(f"http://localhost:{port}/files/a.flac") as r:
            full = r.read()
        assert_same_pcm(full, read_path(jvfs, "/a.flac"))
        with urllib.request.urlopen(f"http://localhost:{port}/ls/") as r:
            assert "a.flac" in r.read().decode()
        with urllib.request.urlopen(f"http://localhost:{port}/") as r:
            assert b"Folve-TPU" in r.read()
        conn = http.client.HTTPConnection("localhost", port)
        conn.request("HEAD", "/files/a.flac")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read() == b""
        assert resp.getheader("Accept-Ranges") == "bytes"
        size = int(resp.getheader("Content-Length"))
        # Suffix range: the last 100 bytes of the advertised (estimated)
        # size, as a VFS read at that offset gives them.
        conn.request("GET", "/files/a.flac", headers={"Range": "bytes=-100"})
        resp = conn.getresponse()
        assert resp.status == 206
        assert resp.getheader("Content-Range").startswith(f"bytes {size - 100}-")
        tail = resp.read()
        h = vfs.open("/a.flac")
        try:
            assert tail == vfs.read(h, 100, size - 100) and len(tail) <= 100
        finally:
            vfs.release("/a.flac", h)
        conn.request("GET", "/files/a.flac", headers={"Range": "bytes=100-299"})
        resp = conn.getresponse()
        assert resp.status == 206 and resp.read() == full[100:300]
        conn.request("HEAD", "/files/a.flac", headers={"Range": "bytes=100-299"})
        resp = conn.getresponse()
        assert resp.status == 206 and resp.getheader("Content-Length") == "200"
        assert resp.getheader("Content-Range") == f"bytes 100-299/{size}"
        resp.read()
        conn.request("GET", "/files/a.flac", headers={"Range": "bytes=abc-"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read() == full
        conn.request("GET", "/files/a.flac", headers={"Range": f"bytes={size}-"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 416
        assert resp.getheader("Content-Range") == f"bytes */{size}"
        conn.close()
        for raw in ("/files/../secret.txt", "/files/..%2fsecret.txt",
                    "/files/%2e%2e/secret.txt", "/files/a/../../secret.txt"):
            conn = http.client.HTTPConnection("localhost", port)
            conn.request("GET", raw)  # sent verbatim
            resp = conn.getresponse()
            assert b"top secret" not in resp.read(), raw
            assert resp.status in (400, 404), (raw, resp.status)
            conn.close()
        conn = http.client.HTTPConnection("localhost", port)
        conn.request("GET", "/ls/../..")
        resp = conn.getresponse()
        listing = resp.read().decode()
        assert resp.status == 200 and "secret.txt" not in listing and "a.flac" in listing
        conn.close()
    finally:
        httpd.shutdown()
        for f in (fs, jfs):
            f.device_scheduler.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_serve_process_bytes_equal_vfs_read(tmp_path):
    src = _dirs(tmp_path, CONFIGS)
    write_song(src / "a.flac", 3000, seed=8)
    write_song(src / "b.flac", 2000, seed=9, bits=24)
    status_port, files_port = _free_port(), _free_port()
    env = dict(os.environ, FOLVE_PLATFORM="cpu", FOLVE_SPECTRA_CACHE="0")
    err = tmp_path / "serve.err"
    with open(err, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "folve_tpu_torch", "serve", "-C",
             str(tmp_path / "filters"), "-i", "echo", "-p", str(status_port),
             "--files-port", str(files_port), str(src)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=errf)
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, err.read_text()
            try:
                with urllib.request.urlopen(
                        f"http://localhost:{files_port}/files/a.flac", timeout=30) as r:
                    served = {"/a.flac": r.read()}
                break
            except (ConnectionError, urllib.error.URLError):
                assert time.time() < deadline, err.read_text()
                time.sleep(0.05)
        with urllib.request.urlopen(f"http://localhost:{files_port}/files/b.flac") as r:
            served["/b.flac"] = r.read()
        with urllib.request.urlopen(f"http://localhost:{status_port}/") as r:
            page = r.read()
        assert b"a.flac" in page and b"b.flac" in page
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    vfs, fs = port_vfs(tmp_path)
    for path, blob in served.items():
        assert blob == read_path(vfs, path), path
    fs.device_scheduler.stop()
