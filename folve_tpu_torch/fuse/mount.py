"""FUSE mount — Python side of the native /dev/fuse transport.

Bridges the kernel-protocol session (native/fuse_transport.cc) to the
transport-independent VFS operations (folve_tpu_torch.server.vfs.FolveVfs).
Open handlers are stuffed into the kernel's 64-bit ``fh`` by id — the
same trick the reference plays with pointers (folve-main.cc:227-229).
"""

from __future__ import annotations

import ctypes
import dataclasses
import errno
import logging
import os
import stat as statmod
import threading
from typing import Dict

from folve_tpu_torch.server.vfs import FolveVfs
from folve_tpu_torch.utils.native_build import load_native

# Raw operation tracing — the reference's ``-d`` libfuse debug channel
# (folve-main.cc:357); enable via logging level DEBUG.
_log = logging.getLogger("folve_tpu_torch.fuse")


class _FolveAttr(ctypes.Structure):
    _fields_ = [
        ("size", ctypes.c_uint64),
        ("mode", ctypes.c_uint32),
        ("nlink", ctypes.c_uint32),
        ("uid", ctypes.c_uint32),
        ("gid", ctypes.c_uint32),
        ("mtime", ctypes.c_uint64),
        ("atime", ctypes.c_uint64),
        ("ctime", ctypes.c_uint64),
    ]


_GETATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(_FolveAttr)
)
_READDIR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
# The buffer must be c_void_p: c_char_p would hand the callback an
# immutable COPY of the (uninitialized) C buffer, so the target bytes
# would never reach the C side.
_READLINK_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32
)
_OPEN_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64))
_READ_T = ctypes.CFUNCTYPE(
    ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
)
_RELEASE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64)


class _FolveFuseOps(ctypes.Structure):
    _fields_ = [
        ("getattr", _GETATTR_T),
        ("readdir", _READDIR_T),
        ("readlink", _READLINK_T),
        ("open_", _OPEN_T),
        ("read_", _READ_T),
        ("release_", _RELEASE_T),
    ]


class FuseSession:
    """One mounted (or test-fd-driven) FUSE session."""

    def __init__(self, vfs: FolveVfs):
        self.vfs = vfs
        self._lib = load_native()
        lib = self._lib
        lib.folve_fuse_session_new.restype = ctypes.c_void_p
        lib.folve_fuse_session_new.argtypes = [ctypes.c_void_p]
        lib.folve_fuse_session_mount.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.folve_fuse_session_mount_opts.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.folve_fuse_session_mount_opts2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint,
        ]
        lib.folve_fuse_session_set_fd.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.folve_fuse_session_loop.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.folve_fuse_session_unmount.argtypes = [ctypes.c_void_p]
        lib.folve_fuse_session_destroy.argtypes = [ctypes.c_void_p]
        lib.folve_fuse_add_dirent.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]

        self._handles: Dict[int, object] = {}
        self._next_fh = 1
        self._lock = threading.Lock()

        # Keep callback objects alive for the session's lifetime.
        self._cbs = _FolveFuseOps(
            getattr=_GETATTR_T(self._cb_getattr),
            readdir=_READDIR_T(self._cb_readdir),
            readlink=_READLINK_T(self._cb_readlink),
            open_=_OPEN_T(self._cb_open),
            read_=_READ_T(self._cb_read),
            release_=_RELEASE_T(self._cb_release),
        )
        self._session = lib.folve_fuse_session_new(ctypes.byref(self._cbs))

    # -- callbacks (return 0 / -errno) ------------------------------------

    def _cb_getattr(self, path: bytes, fh: int, out) -> int:
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug("GETATTR %r fh=%d", path, fh)
        try:
            handler = None
            if fh:
                with self._lock:
                    handler = self._handles.get(fh)
            st = self.vfs.getattr(os.fsdecode(path), handler)
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO
        a = out.contents
        a.size = max(0, int(st.st_size))
        a.mode = st.st_mode
        a.nlink = st.st_nlink
        a.uid = st.st_uid
        a.gid = st.st_gid
        a.mtime = int(st.st_mtime)
        a.atime = int(st.st_atime)
        a.ctime = int(st.st_ctime)
        return 0

    def _cb_readdir(self, path: bytes, ctx) -> int:
        try:
            entries = self.vfs.readdir(os.fsdecode(path))
            encoded = [os.fsencode(name) for name in entries]
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO
        for name, raw in zip(entries, encoded):
            dtype = statmod.S_IFDIR >> 12 if name in (".", "..") else 0
            self._lib.folve_fuse_add_dirent(ctx, raw, 0, dtype)
        return 0

    def _cb_readlink(self, path: bytes, buf: int, bufsize: int) -> int:
        try:
            target = os.fsencode(self.vfs.readlink(os.fsdecode(path)))
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO
        if len(target) > bufsize - 1:
            return -errno.ENAMETOOLONG  # never reply a truncated target
        n = len(target)
        ctypes.memmove(buf, target, n)
        ctypes.memset(buf + n, 0, 1)
        return n  # target length; the C side replies exactly n bytes

    def _cb_open(self, path: bytes, fh_out) -> int:
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug("OPEN %r", path)
        try:
            handler = self.vfs.open(os.fsdecode(path))
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = handler
        fh_out.contents.value = fh
        return 0

    def _cb_read(self, fh: int, buf, size: int, offset: int) -> int:
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug("READ fh=%d size=%d offset=%d", fh, size, offset)
        with self._lock:
            handler = self._handles.get(fh)
        if handler is None:
            return -errno.EBADF
        try:
            data = self.vfs.read(handler, size, offset)
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO
        data = data[:size]  # never overflow the kernel-sized C buffer
        ctypes.memmove(buf, data, len(data))
        return len(data)

    def _cb_release(self, path: bytes, fh: int) -> int:
        with self._lock:
            handler = self._handles.pop(fh, None)
        if handler is not None:
            try:
                self.vfs.release(os.fsdecode(path), handler)
            except Exception:
                return -errno.EIO
        return 0

    # -- session control ---------------------------------------------------

    def mount(self, mountpoint: str, options: str = "") -> None:
        """``options``: comma-separated fuse mount options (the -o flag,
        reference folve-main.cc:499-514).  Supported: ``allow_other``,
        ``default_permissions``, ``ro`` (the default), ``rw``,
        ``fsname=NAME``, ``subtype=TYPE``, ``max_read=N``; unknown
        options are ignored with a warning, like fuse tools do for
        fs-specific ones."""
        parsed = parse_mount_options(options)
        r = self._lib.folve_fuse_session_mount_opts2(
            self._session, mountpoint.encode(), parsed.extra.encode(),
            int(parsed.writable), parsed.fsname.encode(),
            parsed.subtype.encode(), parsed.max_read,
        )
        if r != 0:
            raise OSError(-r, f"cannot mount FUSE filesystem: {-r}")

    def set_fd(self, fd: int) -> None:
        self._lib.folve_fuse_session_set_fd(self._session, fd)

    def loop(self, num_threads: int = 4) -> None:
        self._lib.folve_fuse_session_loop(self._session, num_threads)

    def unmount(self) -> None:
        self._lib.folve_fuse_session_unmount(self._session)

    def destroy(self) -> None:
        if self._session:
            self._lib.folve_fuse_session_destroy(self._session)
            self._session = None


_KERNEL_OPTS = {"allow_other", "default_permissions"}


@dataclasses.dataclass
class MountOptions:
    extra: str = ""
    writable: bool = False
    fsname: str = ""
    subtype: str = ""
    max_read: int = 0


def parse_mount_options(options: str) -> MountOptions:
    """Parse a ``-o`` option string.  Kernel data options pass through;
    fsname/subtype name the mount-table entry; max_read bounds request
    size (reference: libfuse consumes these from -o,
    folve-main.cc:499-514)."""
    out = MountOptions()
    extra = []
    for opt in (options or "").split(","):
        opt = opt.strip()
        if not opt or opt == "ro":
            continue
        if opt == "rw":
            out.writable = True
        elif opt in _KERNEL_OPTS:
            extra.append(opt)
        elif opt.startswith("fsname="):
            # mount-table source name; keep it shell/mtab-safe
            out.fsname = "".join(
                c for c in opt[7:] if c.isalnum() or c in "._:-/"
            )[:64]
        elif opt.startswith("subtype="):
            out.subtype = "".join(
                c for c in opt[8:] if c.isalnum() or c in "._-"
            )[:32]
        elif opt.startswith("max_read="):
            try:
                out.max_read = max(4096, min(1 << 20, int(opt[9:])))
            except ValueError:
                _log.warning("ignoring bad mount option %r", opt)
        else:
            _log.warning("ignoring unsupported mount option %r", opt)
    out.extra = ",".join(extra)
    return out


# Write end of the daemonize() status pipe, held by the daemon child
# until mount_and_serve() knows whether the mount succeeded.
_daemon_status_fd: int | None = None


def daemonize() -> None:
    """Classic double-fork daemonization (the reference daemonizes
    inside fuse_main when not -f, folve-main.cc:539).  Must run before
    any threads start (status server, scheduler, prefetcher), and
    before anything touches ``torch.cuda``: a child forked after its
    parent initialized CUDA cannot use the card.  After
    detaching, warnings/errors go to syslog like the reference's
    (folve-main.cc:273-277) — stdio is /dev/null.

    The invoking parent does NOT exit immediately: it blocks on a pipe
    until the daemon reports mount success (exit 0) or failure (exit 1)
    via :func:`_signal_daemon_status` — so service managers and scripts
    see a truthful exit code instead of the mount error landing only in
    syslog."""
    global _daemon_status_fd
    rfd, wfd = os.pipe()
    if os.fork() > 0:
        # Original invoker: wait for the daemon's one-byte verdict, but
        # bounded — if device init wedges before mount_and_serve() ever
        # reports (e.g. a stalled accelerator transport), detach like
        # the pre-pipe behavior did instead of hanging the invoker.
        os.close(wfd)
        import select

        try:
            timeout = float(os.environ.get("FOLVE_DAEMON_WAIT_SECS", "120"))
        except ValueError:
            timeout = 120.0
        if not (0 <= timeout <= 86400):  # also rejects inf/nan
            timeout = 120.0
        ready, _, _ = select.select([rfd], [], [], timeout)
        if not ready:
            os.write(
                2,
                b"folve-tpu-torch: daemon still starting after %ds; "
                b"detaching (check syslog)\n" % int(timeout),
            )
            os._exit(0)
        status = os.read(rfd, 1)  # EOF (daemon died early) == failure
        os._exit(0 if status == b"\x00" else 1)
    os.close(rfd)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)  # intermediate; the verdict travels via the pipe
    _daemon_status_fd = wfd
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
    if devnull > 2:
        os.close(devnull)
    try:
        import logging.handlers

        handler = logging.handlers.SysLogHandler(address="/dev/log")
        handler.setFormatter(
            logging.Formatter("folve-tpu-torch[%(process)d]: %(levelname)s %(message)s")
        )
        root = logging.getLogger()
        root.addHandler(handler)
        if root.level > logging.INFO or root.level == logging.NOTSET:
            root.setLevel(logging.INFO)
    except Exception:
        pass  # no /dev/log (containers): errors are still in the pid file's absence


def _signal_daemon_status(ok: bool) -> None:
    """Report mount success/failure to the parent still blocked in
    daemonize(); no-op in foreground mode."""
    global _daemon_status_fd
    if _daemon_status_fd is None:
        return
    try:
        os.write(_daemon_status_fd, b"\x00" if ok else b"\x01")
        os.close(_daemon_status_fd)
    except OSError:
        pass
    _daemon_status_fd = None


def mount_and_serve(
    vfs: FolveVfs, mountpoint: str, foreground: bool = True, options: str = ""
) -> int:
    """CLI entry: mount and run the request loop until unmounted.
    Daemonization (when not foreground) is handled by the CLI before
    threads start; by the time we get here we just mount and loop."""
    del foreground
    session = FuseSession(vfs)
    try:
        session.mount(mountpoint, options)
    except OSError as e:
        # Reaches the terminal in foreground mode and syslog when
        # daemonized (daemonize() attached a SysLogHandler); the
        # daemonize parent exits 1 so scripted callers see the failure.
        _log.error("FUSE mount failed (%s); is /dev/fuse available?", e)
        print(f"FUSE mount failed ({e}); is /dev/fuse available?")
        _signal_daemon_status(False)
        return 1
    _signal_daemon_status(True)
    print(f"mounted on {mountpoint}")
    # Run the request loop on a worker so the main thread stays inside
    # the interpreter: blocked in the foreign C loop it would never see
    # SIGINT, making a foreground mount unstoppable with Ctrl-C.
    looper = threading.Thread(
        target=session.loop, name="folve-fuse-loop", daemon=True
    )
    looper.start()
    status = 0
    try:
        while looper.is_alive():
            looper.join(timeout=0.5)
    except KeyboardInterrupt:
        print("interrupted; unmounting")
        session.unmount()
        looper.join(timeout=10)
    finally:
        session.unmount()
        if looper.is_alive():
            # Loop wedged past unmount: leak the session rather than
            # destroy it under a running thread.  No return here — a
            # propagating exception must not be swallowed by finally.
            status = 1
        else:
            session.destroy()
    return status
