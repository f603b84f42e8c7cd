"""VFS operations — the filesystem surface, independent of transport.

This is the logic of the reference's FUSE callback layer
(folve-main.cc:99-328) factored away from the kernel bridge so that
(a) tests can drive the exact open/read/stat/release behavior in
process, and (b) the raw /dev/fuse transport (native) and any other
frontend (HTTP file serving) share one implementation.
"""

from __future__ import annotations

import errno
import os
import stat as statmod
import threading
import time
from typing import List, Optional

from folve_tpu_torch.runtime.filesystem import FolveFilesystem
from folve_tpu_torch.runtime.handler import FileHandler, FileStat

STATUS_FILE_NAME = "/folve-status.html"

# Cover-art & friends that naive DLNA servers stat: exempt from size
# inflation (folve-main.cc:99-110, minidlna workaround).
_PASSTHROUGH_SUFFIXES = {".png", ".jpg", ".jpeg", ".svn", ".txt"}


def might_be_passthrough_file(path: str) -> bool:
    dot = path.rfind(".")
    if dot < 0:
        return False
    return path[dot:].lower() in _PASSTHROUGH_SUFFIXES


class ReaddirLogger:
    """``-R`` tracing: timestamped, thread-tagged STAT/LIST/ITEM/DONE log
    (folve-main.cc:62-97)."""

    def __init__(self, filename: str):
        self._f = open(filename, "a")
        self._lock = threading.Lock()

    def log(self, fmt: str, *args) -> "ReaddirLogger":
        msg = fmt % args if args else fmt
        with self._lock:
            self._f.write(f"{time.time():.6f} {threading.get_ident():x}: {msg}\n")
        return self

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class _NullLogger:
    def log(self, fmt: str, *args):
        return self

    def flush(self):
        pass

    def close(self):
        pass


class FolveVfs:
    """getattr/readdir/readlink/open/read/release against a
    FolveFilesystem (+ optional status server for /folve-status.html)."""

    def __init__(
        self,
        fs: FolveFilesystem,
        status_server=None,
        readdir_logger: Optional[ReaddirLogger] = None,
    ):
        self.fs = fs
        self.status_server = status_server
        self.rlog = readdir_logger or _NullLogger()

    # ------------------------------------------------------------- getattr

    def getattr(self, path: str, handler: Optional[FileHandler] = None) -> FileStat:
        if handler is not None:
            return handler.stat()
        if path == STATUS_FILE_NAME and self.status_server is not None:
            h = self.status_server.create_status_file_handler()
            try:
                return h.stat()
            finally:
                h.close()
        st = self.fs.stat_by_filename(path)
        if st is not None:
            self.rlog.log("FOLVE-Stat %s", path)
        else:
            underlying = self.fs.get_underlying_file(path)
            try:
                os_st = os.lstat(underlying)
            except OSError as e:
                self.rlog.log("STAT %s %s", path, e.strerror)
                raise
            st = FileStat(
                st_size=os_st.st_size,
                st_mode=os_st.st_mode,
                st_mtime=os_st.st_mtime,
                st_atime=os_st.st_atime,
                st_ctime=os_st.st_ctime,
                st_nlink=os_st.st_nlink,
                st_uid=os_st.st_uid,
                st_gid=os_st.st_gid,
            )
            self.rlog.log("STAT %s mode=%03o", path, st.st_mode & 0o777)
            if not might_be_passthrough_file(path) and not statmod.S_ISDIR(st.st_mode):
                st.st_size = int(st.st_size * self.fs.file_oversize_factor)
        # Whatever write mode was there before: now things are readonly.
        st.st_mode &= ~(0o222)
        return st

    # ------------------------------------------------------------- readdir

    def readdir(self, path: str) -> List[str]:
        entries = [".", ".."]
        if path == "/":
            entries.append(STATUS_FILE_NAME[1:])
            if self.fs.toplevel_dir_is_filter:
                # Toplevel dirs are the filter names; '_' = pass-through
                # (folve-main.cc:165-175).
                for name in sorted(self.fs.get_available_config_dirs()):
                    entries.append(name if name else "_")
                return entries
        real = self.fs.get_underlying_file(path)
        try:
            names = os.listdir(real)
        except OSError as e:
            raise OSError(e.errno, e.strerror, path)
        self.rlog.log("LIST %s", path)
        for name in names:
            self.rlog.log("ITEM %s%s%s", path, "/" if len(path) > 1 else "", name)
            entries.append(name)
        self.rlog.log("DONE %s", path).flush()
        return entries

    # ------------------------------------------------------------ readlink

    def readlink(self, path: str) -> str:
        return os.readlink(self.fs.get_underlying_file(path))

    # ----------------------------------------------------- open/read/close

    def open(self, path: str) -> FileHandler:
        """Raises OSError(ENOENT) if unresolvable.  The returned handler
        plays the role of fi->fh (folve-main.cc:214-234); readers must
        tolerate short reads (direct_io)."""
        if path == STATUS_FILE_NAME and self.status_server is not None:
            return self.status_server.create_status_file_handler()
        handler = self.fs.get_or_create_handler(path)
        if handler is None:
            raise OSError(errno.ENOENT, "no such file", path)
        return handler

    def read(self, handler: FileHandler, size: int, offset: int) -> bytes:
        return handler.read(size, offset)

    def release(self, path: str, handler: FileHandler) -> None:
        if path == STATUS_FILE_NAME and self.status_server is not None:
            handler.close()
            return
        self.fs.close_handler(path, handler)
