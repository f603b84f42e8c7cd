"""FolveFilesystem — the central runtime object.

Behavioral twin of folve-filesystem.{h,cc}: path translation (including
the ``-t`` toplevel-directory-is-filter mode), handler creation with the
convolve->passthrough fallback, the pinned handler cache keyed by
``filter + path``, the processor pool, lazy prebuffer-thread lifecycle,
filter switching, and the open/reopen counters the status page shows.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Set

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.filters.resolve import list_config_dirs, sanitize_config_subdir
from folve_tpu_torch.runtime.buffer_thread import BufferThread
from folve_tpu_torch.runtime.conversion_buffer import ConversionBuffer
from folve_tpu_torch.runtime.handler import (
    ConvolveFileHandler,
    FileHandler,
    HandlerStats,
    PassThroughHandler,
    Status,
)
from folve_tpu_torch.runtime.handler_cache import FileHandlerCache
from folve_tpu_torch.runtime.pool import ProcessorPool
from folve_tpu_torch.runtime.scheduler import DeviceScheduler

logger = logging.getLogger("folve_tpu_torch")


class FolveFilesystem:
    def __init__(self, serving_mesh=None, device="cuda"):
        """Convolve on ``device`` (a card unless the caller asks for the
        CPU).  ``serving_mesh``: optional
        :class:`folve_tpu_torch.parallel.ServingMesh` with ("stream",
        "freq") axes; when set, the device scheduler runs the streams'
        block work as sharded serving steps on it instead of
        single-device batched steps."""
        # Defaults mirror folve-filesystem.cc:46-55.
        self.gapless_processing = False
        self.toplevel_dir_is_filter = False
        self.pre_buffer_size = 128 << 10
        self.file_oversize_factor = 1.25
        self.workaround_flac_header_issue = False
        self.flac_block_size = 4096
        self.underlying_dir = ""
        self.base_config_dir = ""
        self.current_config_subdir = ""
        self.initial_filter_config = ""

        self.open_file_cache = FileHandlerCache(max_size=4)
        # Batched device stepping across concurrent streams.
        self.device = resolve_device(device)
        self.serving_mesh = serving_mesh
        self.device_scheduler = DeviceScheduler(device=self.device,
                                                mesh=serving_mesh)
        self.processor_pool = ProcessorPool(
            max_available_per_config=3, scheduler=self.device_scheduler,
            device=self.device,
        )
        self._buffer_thread: Optional[BufferThread] = None
        self._buffer_thread_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self.total_file_openings = 0
        self.total_file_reopen = 0
        self._handler_messages: dict[str, str] = {}

    # -- logging ----------------------------------------------------------

    def log(self, message: str) -> None:
        logger.warning(message)

    def record_handler_message(self, fs_path: str, message: str) -> None:
        self._handler_messages[fs_path] = message

    # -- prebuffer lifecycle (folve-filesystem.cc:57-68) ------------------

    def request_prebuffer(self, buffer: ConversionBuffer) -> None:
        if self.pre_buffer_size <= 0:
            return
        with self._buffer_thread_lock:
            if self._buffer_thread is None:
                self._buffer_thread = BufferThread(self.pre_buffer_size)
                self._buffer_thread.start()
        self._buffer_thread.enqueue_work(buffer)

    def quit_buffering(self, buffer: ConversionBuffer) -> None:
        if self._buffer_thread is not None:
            self._buffer_thread.forget(buffer)

    # -- path translation -------------------------------------------------

    def extract_filter_name(self, fs_path: str) -> Optional[str]:
        """Filter subdir for a mount path; None = invalid toplevel dir in
        ``-t`` mode (folve-filesystem.cc:96-108)."""
        if self.toplevel_dir_is_filter:
            slash = fs_path.find("/", 1)
            if slash < 0:
                return None
            filt = fs_path[1:slash]
            if filt == "_":
                filt = ""
            if filt not in self.get_available_config_dirs():
                return None
            return filt
        return self.current_config_subdir

    def get_underlying_file(self, fs_path: str) -> str:
        """Mount path -> source-directory path (cc:134-143).

        Rejects ``..`` segments outright: the kernel resolves them
        before FUSE ever sees a path, so any occurrence here comes from
        a non-kernel frontend (HTTP) and must not escape the root."""
        if "/../" in fs_path or fs_path.endswith("/..") or fs_path == "..":
            raise OSError(2, "path traversal rejected", fs_path)
        if self.toplevel_dir_is_filter:
            slash = fs_path.find("/", 1)
            fs_path = fs_path[slash:] if slash >= 0 else ""
        return self.underlying_dir + fs_path

    @staticmethod
    def cache_key(config_path: str, fs_path: str) -> str:
        return config_path + fs_path

    # -- handler lifecycle (cc:110-132) -----------------------------------

    def get_or_create_handler(
        self, fs_path: str, want_gapless: bool = False
    ) -> Optional[FileHandler]:
        config_path = self.extract_filter_name(fs_path)
        if config_path is None:
            return None
        key = self.cache_key(config_path, fs_path)
        underlying = self.get_underlying_file(fs_path)
        handler = self.open_file_cache.find_and_pin(key, want_gapless)
        if handler is None:
            if not os.access(underlying, os.R_OK):
                return None
            with self._counter_lock:
                self.total_file_openings += 1
            handler = self._create_handler(config_path, fs_path, underlying)
            handler = self.open_file_cache.insert_pinned(key, handler)
        else:
            with self._counter_lock:
                self.total_file_reopen += 1
        return handler

    def _create_handler(
        self, config_dir: str, fs_path: str, underlying_file: str
    ) -> FileHandler:
        """Convolve if we can, else pass through (CreateFromDescriptor,
        cc:70-89)."""
        info = HandlerStats(filename=fs_path, filter_dir=config_dir, status=Status.OPEN)
        if config_dir:
            handler = ConvolveFileHandler.create(self, fs_path, config_dir, underlying_file)
            if handler is not None:
                return handler
            info.message = self._handler_messages.pop(fs_path, "")
        return PassThroughHandler(underlying_file, config_dir, info)

    def close_handler(self, fs_path: str, handler: FileHandler) -> None:
        key = self.cache_key(handler.filter_dir(), fs_path)
        self.open_file_cache.unpin(key)

    def stat_by_filename(self, fs_path: str):
        """Stat via an existing open handler, if any (cc:146-154)."""
        key = self.cache_key(self.current_config_subdir, fs_path)
        handler = self.open_file_cache.find_and_pin(key)
        if handler is None:
            return None
        try:
            return handler.stat()
        finally:
            self.open_file_cache.unpin(key)

    # -- directory listing (cc:168-182) -----------------------------------

    def list_directory(self, fs_dir: str, suffix: str) -> Set[str]:
        real_dir = self.get_underlying_file(fs_dir.rstrip("/") or "/")
        result: Set[str] = set()
        try:
            entries = os.listdir(real_dir)
        except OSError:
            return result
        for name in entries:
            if suffix and not name.endswith(suffix):
                continue
            result.add(fs_dir + name)
        return result

    # -- filter switching (cc:184-228) ------------------------------------

    def switch_current_config_dir(self, subdir: str) -> bool:
        if subdir:
            sanitized = sanitize_config_subdir(self.base_config_dir, subdir)
            if sanitized is None:
                logger.info("Can't switch to unknown filter '%s'", subdir)
                return False
            subdir = sanitized
        if subdir != self.current_config_subdir:
            self.current_config_subdir = subdir
            if subdir:
                logger.info("Switching filter config to '%s'", subdir)
            else:
                logger.info("Switching to pass-through mode.")
            return True
        return False

    def get_available_config_dirs(self) -> Set[str]:
        return list_config_dirs(self.base_config_dir)

    # -- startup (cc:230-259) ---------------------------------------------

    def check_initialized(self) -> bool:
        if not self.underlying_dir or not os.path.isdir(self.underlying_dir):
            return False
        if not self.base_config_dir or not os.path.isdir(self.base_config_dir):
            return False
        return True

    def setup_initial_config(self) -> None:
        dirs = self.get_available_config_dirs()
        if len(dirs) == 1:
            logger.info(
                "No filter configuration directories given. "
                "Any files will be just passed through verbatim."
            )
        self.switch_current_config_dir(self.initial_filter_config)
