"""HTTP file-serving frontend.

Serves the same virtual filesystem the FUSE mount exposes, but over
plain HTTP — usable where no kernel FUSE is available (containers), and
directly by network media players.  Routes:

    /                         -> status page (+ /settings?f=)
    /files/<path>             -> convolved file bytes (Range supported)
    /ls/<path>                -> directory listing (text)

No peer in the reference (its only HTTP is the status page); this is a
frontend over the same ``FolveVfs`` operations the FUSE layer uses.

Unlike FUSE, HTTP delivers raw ``..`` segments (the kernel resolves
them before a filesystem ever sees a path), so every URL path is
normalized here — anchored normalization collapses any amount of
``../`` into the VFS root — and the filesystem core additionally
rejects ``..`` segments outright.
"""

from __future__ import annotations

import posixpath
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from folve_tpu_torch.server.vfs import FolveVfs

_CHUNK = 64 << 10


def _clean_path(raw: str) -> Optional[str]:
    """Normalize a URL path into a safe absolute VFS path (or None)."""
    if "\x00" in raw:
        return None
    p = posixpath.normpath("/" + raw.lstrip("/"))
    while p.startswith("//"):
        p = p[1:]
    # normpath of an anchored path cannot keep '..' segments, but be
    # explicit — this is the security boundary.
    if any(part == ".." for part in p.split("/")):
        return None
    return p


def _parse_range(rng: Optional[str], size: int) -> Optional[Tuple[int, Optional[int]]]:
    """RFC 7233 single byte-range -> (start, inclusive_end|None).
    Returns None for absent/malformed/multi ranges (serve 200 full);
    suffix ranges (``bytes=-N``) mean the LAST N bytes."""
    if not rng or not rng.startswith("bytes="):
        return None
    spec = rng[6:]
    if "," in spec:
        return None  # multipart ranges unsupported: full response
    parts = spec.split("-", 1)
    if len(parts) != 2:
        return None
    try:
        if parts[0] == "":
            n = int(parts[1])
            if n <= 0:
                return None
            return max(0, size - n), None
        start = int(parts[0])
        end = int(parts[1]) if parts[1] else None
    except ValueError:
        return None
    if start < 0 or (end is not None and end < start):
        return None
    return start, end


def make_httpfs_server(vfs: FolveVfs, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _dispatch(self, head_only: bool) -> None:
            self._headers_sent = False  # per-request (keep-alive reuse)
            parsed = urllib.parse.urlparse(self.path)
            raw = urllib.parse.unquote(parsed.path)
            streaming = False
            try:
                if raw == "/files" or raw.startswith("/files/"):
                    sub = _clean_path(raw[len("/files") :] or "/")
                    if sub is None:
                        self._reply(400, {}, b"bad path")
                        return
                    streaming = True
                    self._serve_file(sub, head_only)
                elif raw == "/ls" or raw.startswith("/ls/"):
                    sub = _clean_path(raw[len("/ls") :] or "/")
                    if sub is None:
                        self._reply(400, {}, b"bad path")
                        return
                    self._serve_listing(sub, head_only)
                elif vfs.status_server is not None:
                    code, headers, body = vfs.status_server.handle_http(self.path)
                    # _reply itself suppresses the body for HEAD, so the
                    # advertised Content-Length stays truthful.
                    self._reply(code, headers, body)
                else:
                    self._reply(404, {}, b"not found")
            except OSError as e:
                if streaming and self._headers_sent:
                    # Mid-stream failure: the status line is long gone, a
                    # second response would corrupt the chunked body.
                    # Drop the connection; truncation IS the error signal.
                    self.close_connection = True
                else:
                    self._reply(404, {}, f"error: {e}".encode())

        def do_GET(self):
            self._dispatch(head_only=False)

        def do_HEAD(self):
            # Players commonly probe with HEAD before streaming.
            self._dispatch(head_only=True)

        def _reply(self, code, headers, body):
            self.send_response(code)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _serve_listing(self, path, head_only=False):
            del head_only  # _reply skips the body write for HEAD
            entries = vfs.readdir(path)
            body = ("\n".join(entries) + "\n").encode()
            self._reply(200, {"Content-Type": "text/plain"}, body)

        _headers_sent = False

        def _serve_file(self, path, head_only=False):
            handler = vfs.open(path)
            try:
                st = vfs.getattr(path, handler)
                span = _parse_range(self.headers.get("Range"), st.st_size)
                if span is not None and span[0] >= st.st_size:
                    # Range entirely past the (estimated) end: RFC 7233
                    # 416 with the satisfiable size.
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{st.st_size}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if span is None:
                    start, end, status = 0, None, 200
                else:
                    (start, end), status = span, 206
                self.send_response(status)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Accept-Ranges", "bytes")
                if status == 206:
                    self.send_header(
                        "Content-Range",
                        f"bytes {start}-"
                        f"{(end if end is not None else st.st_size - 1)}"
                        f"/{st.st_size}",
                    )
                # Sizes are estimates (the reference inflates them too);
                # stream chunked so we can stop at the true end.
                if head_only:
                    # No body: advertise the (estimated, like the
                    # reference's stat) length of what the GET would
                    # serve — range length for 206, full size for 200.
                    if status == 206:
                        last = end if end is not None else st.st_size - 1
                        length = max(0, last - start + 1)
                    else:
                        length = st.st_size
                    self.send_header("Content-Length", str(length))
                    self.end_headers()
                    return
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._headers_sent = True
                offset = start
                remaining = None if end is None else end - start + 1
                while True:
                    want = _CHUNK if remaining is None else min(_CHUNK, remaining)
                    if want <= 0:
                        break
                    data = vfs.read(handler, want, offset)
                    if not data:
                        break
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
                    offset += len(data)
                    if remaining is not None:
                        remaining -= len(data)
                self.wfile.write(b"0\r\n\r\n")
            finally:
                vfs.release(path, handler)

    return ThreadingHTTPServer(("", port), Handler)


def serve_http_files(vfs: FolveVfs, port: int) -> int:
    httpd = make_httpfs_server(vfs, port)
    print(f"serving files on http://localhost:{httpd.server_address[1]}/files/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def start_httpfs_thread(vfs: FolveVfs, port: int = 0) -> ThreadingHTTPServer:
    """Background variant for tests/embedding."""
    httpd = make_httpfs_server(vfs, port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
