"""Status/control HTTP server.

Behavioral twin of status-server.{h,cc}: one background HTTP thread
(stdlib ThreadingHTTPServer standing in for libmicrohttpd); routes
``/settings?f=<filter>`` -> switch filter + 302 redirect, everything
else -> the status page; the page shows filter-selector tabs, per-stream
rows with dual progress bars (played vs prebuffered), gapless arrows,
clipping highlights, a retired-handlers history fed by the cache
observer (deque of 20, status-server.cc:45,207-219), open/reopen
counters, and its own render time.  The same page is also reachable
in-filesystem as ``/folve-status.html`` via :class:`HtmlFileHandler`
(status-server.cc:105-135; folve-main.cc:123-128).
"""

from __future__ import annotations

import collections
import html
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, List, Optional

from folve_tpu_torch.runtime.filesystem import FolveFilesystem
from folve_tpu_torch.runtime.handler import FileHandler, FileStat, HandlerStats, Status
from folve_tpu_torch.version import __version__

_RETIRED_MAX = 20


def _progress_bar(access: float, buffered: float) -> str:
    """Dual progress bar: played (dark) over prebuffered (light)."""
    a = max(0.0, min(1.0, access))
    b = max(0.0, min(1.0, buffered))
    return (
        '<div class="pbar">'
        f'<div class="pbuf" style="width:{b * 100:.1f}%"></div>'
        f'<div class="pacc" style="width:{a * 100:.1f}%"></div>'
        "</div>"
    )


def _db(value: float) -> str:
    import math

    if value <= 0:
        return "&nbsp;"
    return f"{20 * math.log10(value):.1f}dB"


class HtmlFileHandler(FileHandler):
    """Read-only snapshot of the status page served as a file in the
    mount (status-server.cc:105-135)."""

    def __init__(self, content: bytes):
        super().__init__("")
        self._content = content
        self._time = time.time()

    def read(self, size: int, offset: int) -> bytes:
        return self._content[offset : offset + size]

    def stat(self) -> FileStat:
        return FileStat(
            st_size=len(self._content),
            st_mode=0o100444,
            st_mtime=self._time,
            st_atime=self._time,
            st_ctime=self._time,
        )

    def get_handler_status(self) -> HandlerStats:
        return HandlerStats(filename="folve-status.html")


class StatusServer:
    """Also the handler-cache Observer (retire events feed history)."""

    def __init__(self, fs: FolveFilesystem):
        self.fs = fs
        self._retired: Deque[HandlerStats] = collections.deque(maxlen=_RETIRED_MAX)
        self._expunged_retired = 0  # dropped beyond the ring (":.. (N more)")
        self._retired_lock = threading.Lock()
        self.meta_refresh = -1  # seconds; -1 = off (-r flag)
        self.expensive_details = False  # -D flag ties show_details
        self._filter_switched = False  # one-shot switch notice
        self._profile_thread: Optional[threading.Thread] = None
        self._profile_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._port = 0
        fs.open_file_cache.set_observer(self)

    # -- Observer ---------------------------------------------------------

    def insert_handler_event(self, handler: FileHandler) -> None:
        pass

    def retire_handler_event(self, handler: FileHandler) -> None:
        stats = handler.get_handler_status()
        stats.status = Status.RETIRED
        with self._retired_lock:
            if len(self._retired) == _RETIRED_MAX:
                self._expunged_retired += 1  # status-server.cc:216
            self._retired.appendleft(stats)

    # -- HTTP -------------------------------------------------------------

    def start(self, port: int) -> bool:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                code, headers, body = server.handle_http(self.path)
                self.send_response(code)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self._httpd = ThreadingHTTPServer(("", port), Handler)
        except OSError:
            return False
        self._port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="folve-status-http")
        t.start()
        return True

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None

    def handle_http(self, path: str) -> tuple[int, dict, bytes]:
        """Route like HandleHttp (status-server.cc:139-172)."""
        parsed = urllib.parse.urlparse(path)
        if parsed.path == "/settings":
            q = urllib.parse.parse_qs(parsed.query)
            filt = q.get("f", [""])[0]
            if self.fs.switch_current_config_dir(filt):
                # One-shot notice on the next page render
                # (status-server.cc:346-352, 359-364).
                self._filter_switched = True
            return 302, {"Location": "/"}, b""
        if parsed.path == "/profile":
            return self._handle_profile(parsed.query)
        page = self.create_page(for_http=True)
        return 200, {"Content-Type": "text/html; charset=utf-8"}, page

    def _handle_profile(self, query: str) -> tuple[int, dict, bytes]:
        """``/profile?secs=N``: capture a ``torch.profiler`` trace of the
        next N seconds of serving (a Chrome trace, ``trace.json``, with
        every CUDA kernel the process launched; viewable in Perfetto or
        ``chrome://tracing``, summed by
        :func:`folve_tpu_torch.utils.profiling.analyze_device_trace`) —
        the device-side analog of the reference's ``-d`` raw request
        tracing (SURVEY §5)."""
        if not self.expensive_details:
            # Tracing costs device time and disk; gate it behind -D like
            # the other expensive status features (and keep the
            # status-port surface inert by default).
            return 403, {"Content-Type": "text/plain"}, b"enable -D to profile\n"
        q = urllib.parse.parse_qs(query)
        try:
            secs = min(60.0, max(0.1, float(q.get("secs", ["3"])[0])))
        except ValueError:
            return 400, {"Content-Type": "text/plain"}, b"bad secs\n"
        import tempfile

        # mkdtemp: unpredictable, mode 0700 — immune to /tmp symlink
        # pre-creation games and collisions, unlike an epoch-named dir.
        log_dir = tempfile.mkdtemp(prefix="folve_profile_")

        def run():
            from folve_tpu_torch.utils.profiling import device_trace

            with device_trace(log_dir):
                time.sleep(secs)

        with self._profile_lock:  # ThreadingHTTPServer handles requests
            # concurrently; check-and-start must be atomic.
            if self._profile_thread is not None and self._profile_thread.is_alive():
                return 409, {"Content-Type": "text/plain"}, b"trace already running\n"
            self._profile_thread = threading.Thread(target=run, daemon=True,
                                                    name="folve-profile")
            self._profile_thread.start()
        msg = f"tracing {secs:.1f}s of device activity to {log_dir}\n"
        return 200, {"Content-Type": "text/plain"}, msg.encode()

    def create_status_file_handler(self) -> HtmlFileHandler:
        return HtmlFileHandler(self.create_page(for_http=False))

    # -- page -------------------------------------------------------------

    def create_page(self, for_http: bool = True) -> bytes:
        t0 = time.time()
        fs = self.fs
        parts: List[str] = []
        parts.append("<!DOCTYPE html><html><head><title>Folve-TPU</title>")
        if self.meta_refresh > 0 and for_http:
            parts.append(f'<meta http-equiv="refresh" content="{self.meta_refresh}">')
        parts.append(
            "<style>"
            "body{font-family:sans-serif;margin:1em}"
            "table{border-collapse:collapse}td,th{padding:2px 8px;"
            "border-bottom:1px solid #ddd;font-size:13px}"
            ".pbar{position:relative;width:150px;height:12px;"
            "background:#eee;border:1px solid #999}"
            ".pbuf{position:absolute;height:100%;background:#c5e1c5}"
            ".pacc{position:absolute;height:100%;background:#448844}"
            ".clip{background:#ff4444;color:white}"
            ".tabs a{padding:4px 10px;border:1px solid #888;margin-right:4px;"
            "text-decoration:none;color:black}"
            ".tabs a.sel{background:#448844;color:white}"
            "</style></head><body>"
        )
        parts.append(
            f"<h2>Folve-TPU</h2><p>version {__version__} &mdash; "
            f"convolving <code>{html.escape(fs.underlying_dir)}</code></p>"
        )
        if self.expensive_details:
            # Reference shows the filter base dir only under -D
            # (status-server.cc:401-405).
            parts.append(
                f"<p>Filter base directory "
                f"<code>{html.escape(fs.base_config_dir)}</code></p>"
            )

        # Filter selector tabs (status-server.cc:325-366).
        if for_http:
            parts.append('<div class="tabs">Active filter: ')
            current = fs.current_config_subdir
            available = sorted(fs.get_available_config_dirs())
            for name in available:
                label = html.escape(name) if name else "[none : pass through]"
                qname = urllib.parse.quote(name)
                sel = ' class="sel"' if name == current else ""
                parts.append(f'<a href="/settings?f={qname}"{sel}>{label}</a>')
            if len(available) <= 1:
                # status-server.cc:337-340
                parts.append(
                    " (This is a boring configuration, add filter directories)"
                )
            elif getattr(self, "_filter_switched", False):
                # One-shot notice after a switch (status-server.cc:359-364).
                parts.append(
                    "<span style='font-size:small;background:#FFFFa0;"
                    "border-radius:5px;padding:2px 6px'>"
                    "Affects re- or newly opened files.</span>"
                )
                self._filter_switched = False
            parts.append("</div>")
        else:
            parts.append(
                "<p>Read-only view; use the HTTP interface to switch filters.</p>"
            )

        sched = getattr(fs, "device_scheduler", None)
        if sched is not None and sched.steps:
            mean_ms = 1000.0 * sched.total_step_s / sched.steps
            batched_pct = 100.0 * sched.batched_jobs / max(sched.jobs, 1)
            sharded = (
                f", {sched.sharded_steps} multi-chip sharded "
                f"({sched.sharded_fast_steps} device-resident)"
                if sched.sharded_steps
                else ""
            )
            parts.append(
                f"<p>Device: {sched.steps} fused steps for {sched.jobs} block "
                f"jobs ({batched_pct:.0f}% batched{sharded}), last batch "
                f"{sched.last_batch}, step mean {mean_ms:.2f}ms / "
                f"p50 {sched.latency.percentile_ms(50):.2f}ms / "
                f"p99 {sched.latency.percentile_ms(99):.2f}ms / last "
                f"{sched.last_step_s * 1000:.2f}ms, queue wait p50 "
                f"{sched.queue_wait.percentile_ms(50):.2f}ms / p99 "
                f"{sched.queue_wait.percentile_ms(99):.2f}ms</p>"
            )

        stats = fs.open_file_cache.get_stats()
        # Open streams before idle, newest first (status-server.cc:368-374).
        order = {Status.OPEN: 0, Status.IDLE: 1, Status.RETIRED: 2}
        stats.sort(key=lambda s: (order.get(s.status, 3), -s.last_access))
        parts.append(
            f"<p>{fs.total_file_openings} file openings, "
            f"{fs.total_file_reopen} re-opens, "
            f"{len(stats)} active handlers</p>"
        )
        parts.append(self._render_table(stats, "Active streams"))
        with self._retired_lock:
            retired = list(self._retired)
            expunged = self._expunged_retired
        if retired:
            parts.append(self._render_table(retired, "Recently retired"))
            if expunged:
                parts.append(f"<p>... ({expunged} more)</p>")
        parts.append(
            f"<p style='color:#888'>Page created in "
            f"{(time.time() - t0) * 1000:.2f}ms</p></body></html>"
        )
        return "".join(parts).encode("utf-8")

    def _render_table(self, stats: List[HandlerStats], title: str) -> str:
        # The per-stream device-step latency column is the expensive
        # detail the -D flag unlocks (reference show_details,
        # status-server.cc:201-205).
        details = self.expensive_details
        lat_th = "<th>Device step latency</th>" if details else ""
        rows = [
            f"<h3>{title}</h3><table><tr><th>Stat</th><th>Progress</th>"
            "<th>Pos</th><th>Len</th><th>Max out</th><th>Format</th>"
            f"<th>Gapless</th>{lat_th}<th>Filter</th><th>File</th></tr>"
        ]
        for s in stats:
            pos = s.access_progress * s.duration_seconds
            clip = ' class="clip"' if s.max_output_value > 1.0 else ""
            gapless = ("&larr;" if s.in_gapless else "") + (
                "&rarr;" if s.out_gapless else ""
            )
            name = html.escape(s.filename)
            msg = f" <i>{html.escape(s.message)}</i>" if s.message else ""
            if not s.message and s.access_progress == 0 and s.buffer_progress <= 0:
                # Zero-progress handler: a metadata-indexing open that
                # never read audio (status-server.cc:284-288).
                msg = " <i>Only header accessed</i>"
            lat = html.escape(s.latency_summary)
            if s.pump_dispatch_s or s.pump_fetch_s or s.pump_encode_s:
                # Where serving time went for this stream: device
                # dispatch+wait / D2H fetch / host encode.
                lat += (
                    f" [disp={s.pump_dispatch_s:.2f}s"
                    f" fetch={s.pump_fetch_s:.2f}s"
                    f" enc={s.pump_encode_s:.2f}s]"
                )
            lat_td = f"<td>{lat or '&nbsp;'}</td>" if details else ""
            status_cell = html.escape(s.status)
            if details and s.last_access:
                # Time since last access (status-server.cc:275-281).
                ago = max(0.0, time.time() - s.last_access)
                status_cell += f" <span style='color:#888'>({ago:.1f}s)</span>"
            rows.append(
                f"<tr><td>{status_cell}</td>"
                f"<td>{_progress_bar(s.access_progress, s.buffer_progress)}</td>"
                f"<td>{_fmt_time(pos)}</td>"
                f"<td>{_fmt_time(s.duration_seconds)}</td>"
                f"<td{clip}>{_db(s.max_output_value)}</td>"
                f"<td>{html.escape(s.format)}</td>"
                f"<td>{gapless}</td>{lat_td}"
                f"<td>{html.escape(s.filter_dir)}</td>"
                f"<td>{name}{msg}</td></tr>"
            )
        rows.append("</table>")
        return "".join(rows)


def _fmt_time(seconds: float) -> str:
    if seconds <= 0:
        return "-"
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"
