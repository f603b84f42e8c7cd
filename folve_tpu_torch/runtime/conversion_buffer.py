"""ConversionBuffer — lazily-filled, file-backed output byte store.

Behavioral twin of the reference's conversion-buffer.{h,cc}: an
anonymous (created-then-unlinked) spill file holds every output byte
produced so far; readers pull more data on demand through
``fill_until`` which synchronously pumps the handler's
``add_more_sound_data`` under a per-buffer lock; reads inside the header
region are allowed to come up short so that metadata indexing never
starts the convolver (conversion-buffer.cc:165-192); ``max_accessed``
(player progress) is tracked separately from ``file_size`` (produced
bytes) for the status page and the prefetcher.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Protocol


class SoundSource(Protocol):
    """The pull callback (reference: ConversionBuffer::SoundSource)."""

    def add_more_sound_data(self) -> bool: ...


def _tmp_dir() -> str:
    # Reference honors TMPDIR with /tmp default (conversion-buffer.cc:30-39).
    for var in ("FOLVE_TMPDIR", "TMPDIR"):
        v = os.environ.get(var)
        if v:
            return v
    return tempfile.gettempdir()


class ConversionBuffer:
    def __init__(self, source: SoundSource):
        self._source = source
        fd, path = tempfile.mkstemp(prefix="folve-", dir=_tmp_dir())
        os.unlink(path)  # anonymous: vanishes when closed (cc:44-50)
        self._fd = fd
        self._lock = threading.Lock()
        self._total_written = 0
        self._max_accessed = 0
        self._header_end = 0
        self._file_complete = False

    @property
    def pump_lock(self) -> threading.Lock:
        """The lock ``fill_until`` pumps under.  Exposed so the gapless
        handover can serialize against this stream's pump: adopting the
        donor processor + the donor's split-block write must be atomic
        w.r.t. our own ``add_more_sound_data`` (see
        ConvolveFileHandler.passover_processor)."""
        return self._lock

    # -- produce side -----------------------------------------------------

    def append(self, data: bytes) -> int:
        if not data:
            return 0
        # pwrite may write short (signals, quota edges); dropping the
        # tail silently would serve a corrupt stream — loop or raise.
        view = memoryview(data)
        total = 0
        while total < len(data):
            n = os.pwrite(self._fd, view[total:], self._total_written + total)
            if n <= 0:
                raise OSError("short write to spill file")
            total += n
        self._total_written += total
        return total

    def write_char_at(self, byte: int, offset: int) -> None:
        """Single-byte header surgery (reference WriteCharAt,
        conversion-buffer.cc:115-118)."""
        if 0 <= offset < self._total_written:
            os.pwrite(self._fd, bytes([byte & 0xFF]), offset)

    def write_bytes_at(self, data: bytes, offset: int) -> None:
        """Multi-byte header patch (used for STREAMINFO re-emission)."""
        if 0 <= offset and offset + len(data) <= self._total_written:
            os.pwrite(self._fd, data, offset)

    def header_finished(self) -> None:
        self._header_end = self.file_size()

    # -- observation ------------------------------------------------------

    def file_size(self) -> int:
        return self._total_written

    def max_accessed(self) -> int:
        return self._max_accessed

    def header_size(self) -> int:
        return self._header_end

    def is_file_complete(self) -> bool:
        with self._lock:
            return self._file_complete

    def notify_file_complete(self) -> None:
        with self._lock:
            self._file_complete = True

    # -- consume side -----------------------------------------------------

    def fill_until(self, requested_min_written: int) -> bool:
        """Pump the source until at least this many bytes exist (or EOF).
        Serializes concurrent readers per stream (cc:151-163)."""
        with self._lock:
            while not self._file_complete and self._total_written < requested_min_written:
                if not self._source.add_more_sound_data():
                    self._file_complete = True
                    break
            return self._file_complete

    def read(self, size: int, offset: int) -> bytes:
        """Read semantics incl. the header-region short-read rule and the
        kaffeine full-read workaround (cc:165-192)."""
        required_min = offset + (size if offset >= self._header_end else 1)
        self.fill_until(required_min)
        data = os.pread(self._fd, size, offset)
        if data:
            new_max = offset + len(data)
            # Compare under the lock: an unlocked check lets a small
            # racing read store AFTER a big one, moving max_accessed
            # backwards (and the prefetch goal with it).
            with self._lock:
                if new_max > self._max_accessed:
                    self._max_accessed = new_max
        return data

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
