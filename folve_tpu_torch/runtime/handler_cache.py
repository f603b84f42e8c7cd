"""FileHandlerCache — thread-safe pinned LRU of open file handlers.

Behavioral twin of file-handler-cache.{h,cc}: keyed by filter+path,
dedups concurrent opens (insert returns the existing handler), keeps
unpinned entries alive for cheap re-opens and for media players that
stat while playing, evicts the oldest unreferenced entries beyond
``max_size``, supports the gapless ``prefer_gapless`` eviction of idle
non-gapless entries (:74-99), notifies an Observer of insert/retire
events for the status page, and — crucially — destroys handlers
*outside* the lock to avoid the documented deadlock with the
buffer-thread/gapless path (:58-70).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from folve_tpu_torch.runtime.handler import FileHandler, HandlerStats, Status


class _Entry:
    __slots__ = ("handler", "references", "last_access")

    def __init__(self, handler: FileHandler):
        self.handler = handler
        self.references = 0
        self.last_access = 0.0


class Observer:
    """Cache events (file-handler-cache.h:42-47)."""

    def insert_handler_event(self, handler: FileHandler) -> None: ...

    def retire_handler_event(self, handler: FileHandler) -> None: ...


class FileHandlerCache:
    def __init__(self, max_size: int = 4):
        self._max_size = max_size
        self._mutex = threading.Lock()
        self._cache: Dict[str, _Entry] = {}
        self._observer: Optional[Observer] = None

    def set_observer(self, observer: Observer) -> None:
        assert self._observer is None
        self._observer = observer

    def set_max_size(self, n: int) -> None:
        self._max_size = n

    @property
    def max_size(self) -> int:
        return self._max_size

    def insert_pinned(self, key: str, handler: FileHandler) -> FileHandler:
        """Insert and pin; if the key exists, the given handler is
        destroyed and the existing one returned (cc:37-72)."""
        to_delete: List[FileHandler] = []
        with self._mutex:
            entry = self._cache.get(key)
            if entry is None:
                entry = _Entry(handler)
                self._cache[key] = entry
            else:
                to_delete.append(handler)  # lost the open race
            entry.references += 1
            if len(self._cache) > self._max_size:
                self._cleanup_oldest_unreferenced_locked(to_delete)
            entry.last_access = time.time()
            if self._observer:
                self._observer.insert_handler_event(entry.handler)
            result = entry.handler
        for h in to_delete:
            h.release()
        return result

    def find_and_pin(self, key: str, prefer_gapless: bool = False) -> Optional[FileHandler]:
        to_delete: Optional[FileHandler] = None
        with self._mutex:
            entry = self._cache.get(key)
            if entry is None:
                return None
            # Gapless wants a handler whose processor can be seeded:
            # evict an idle one that can no longer adopt (already
            # streamed) instead of returning it (cc:87-90).  A fresh
            # PREWARMED successor (handler.py _prewarm_successor) is
            # exactly the adoptable case — keep and return it, or the
            # prewarm work is thrown away at the seam it exists for.
            if (
                prefer_gapless
                and entry.references == 0
                and not entry.handler.is_gapless()
                and not entry.handler.can_adopt_processor()
            ):
                to_delete = self._erase_locked(key)
            else:
                entry.references += 1
                entry.last_access = time.time()
                return entry.handler
        if to_delete:
            to_delete.release()
        return None

    def evict_unreferenced(self, key: str) -> bool:
        """Drop ``key`` now if present and unpinned (gapless handover
        retry: a cached successor refused the passover — e.g. its
        prewarmed processor went config-stale — and must be rebuilt)."""
        to_delete: Optional[FileHandler] = None
        with self._mutex:
            entry = self._cache.get(key)
            if entry is None or entry.references:
                return False
            to_delete = self._erase_locked(key)
        if to_delete:
            to_delete.release()
        return True

    def unpin(self, key: str) -> None:
        to_delete: Optional[FileHandler] = None
        with self._mutex:
            entry = self._cache[key]
            entry.references -= 1
            if entry.references == 0 and len(self._cache) > self._max_size:
                to_delete = self._erase_locked(key)
        if to_delete:
            to_delete.release()

    def get_stats(self) -> List[HandlerStats]:
        out = []
        with self._mutex:
            items = list(self._cache.items())
        for _key, entry in items:
            s = entry.handler.get_handler_status()
            s.status = Status.IDLE if entry.references == 0 else Status.OPEN
            s.last_access = entry.last_access
            out.append(s)
        return out

    def size(self) -> int:
        with self._mutex:
            return len(self._cache)

    def clear(self) -> None:
        """Retire everything (shutdown path)."""
        with self._mutex:
            handlers = [self._erase_locked(k) for k in list(self._cache)]
        for h in handlers:
            if h:
                h.release()

    # -- internal ---------------------------------------------------------

    def _erase_locked(self, key: str) -> FileHandler:
        entry = self._cache.pop(key)
        if self._observer:
            self._observer.retire_handler_event(entry.handler)
        return entry.handler

    def _cleanup_oldest_unreferenced_locked(self, to_delete: List[FileHandler]) -> None:
        removable = [
            (entry.last_access, key)
            for key, entry in self._cache.items()
            if entry.references == 0
        ]
        removable.sort()
        count = min(len(self._cache) - self._max_size, len(removable))
        for _, key in removable[:count]:
            to_delete.append(self._erase_locked(key))
