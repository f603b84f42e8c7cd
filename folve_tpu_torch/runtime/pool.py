"""ProcessorPool — cache of ready filter processors.

Behavioral twin of processor-pool.{h,cc}: keyed by resolved config path,
staleness-checked by config mtime on checkout and return, capped per
config, processors Reset() before pooling.

Compiled :class:`FilterBank` device tensors are cached separately by
(path, mtime, rate) and shared across processors: placing the spectra
is the expensive part (the reference's analog is Convproc::configure +
IR loading, processor-pool.h:28-30), and unlike Convproc state they are
immutable, so one copy in device memory serves any number of concurrent
streams.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.filters.compiler import CompiledFilter, FilterCompileError
from folve_tpu_torch.filters.resolve import resolve_filter_config
from folve_tpu_torch.filters.spectra_cache import compile_with_cache
from folve_tpu_torch.runtime.processor import SoundProcessor


class ProcessorPool:
    def __init__(self, max_available_per_config: int = 3, scheduler=None,
                 device="cuda"):
        """Processors compile their filters onto ``device``; a
        ``scheduler`` (:class:`DeviceScheduler`) is handed to each."""
        self.device = resolve_device(device)
        self._max_per_config = max_available_per_config
        self.scheduler = scheduler  # handed to new SoundProcessors
        self._lock = threading.Lock()
        self._pool: Dict[str, List[SoundProcessor]] = {}
        # (path, mtime, fsamp) -> CompiledFilter; shared device spectra.
        self._bank_cache: Dict[Tuple[str, float, int], CompiledFilter] = {}
        # One lock per key being compiled: concurrent first opens of one
        # filter compile it once and share its spectra.
        self._compiling: Dict[Tuple[str, float, int], threading.Lock] = {}

    def get_or_create(
        self, base_dir: str, sampling_rate: int, channels: int, bits: int
    ) -> Tuple[Optional[SoundProcessor], str]:
        """Returns (processor, errmsg); processor None when no config
        matches or it does not compile (processor-pool.cc:48-92).  An
        error of the device propagates."""
        config_path = resolve_filter_config(base_dir, sampling_rate, channels, bits)
        if config_path is None:
            short_dir = os.path.basename(base_dir.rstrip("/"))
            return None, (
                f"No filter in {short_dir} for "
                f"{sampling_rate / 1000.0:.1f}kHz/{channels} ch/{bits} bits"
            )
        while True:
            proc = self._check_out_of_pool(config_path)
            if proc is None:
                break
            if proc.config_still_up_to_date():
                return proc, ""
            # outdated: drop and look again (processor-pool.cc:71-77)

        proc = self._create(config_path, sampling_rate)
        if proc is None:
            return None, f"Problem parsing {config_path}"
        return proc, ""

    def _create(self, config_path: str, sampling_rate: int) -> Optional[SoundProcessor]:
        try:
            mtime = os.stat(config_path).st_mtime
        except OSError:
            return None
        key = (config_path, mtime, sampling_rate)
        with self._lock:
            compiled = self._bank_cache.get(key)
            if compiled is None:
                compiling = self._compiling.setdefault(key, threading.Lock())
        if compiled is None:
            try:
                with compiling:
                    with self._lock:
                        compiled = self._bank_cache.get(key)  # another opener's
                    if compiled is None:
                        compiled = self._compile(key)
            finally:
                with self._lock:
                    self._compiling.pop(key, None)
            if compiled is None:
                return None
        return SoundProcessor(compiled, config_path, scheduler=self.scheduler)

    def _compile(self, key) -> Optional[CompiledFilter]:
        config_path, _, sampling_rate = key
        try:
            # Content-addressed persistent spectra cache in front of the
            # compile (filters/spectra_cache.py): cold mounts skip the IR
            # decode and the transform for known filters.
            compiled = compile_with_cache(config_path, fsamp=sampling_rate,
                                          device=self.device)
        except (FilterCompileError, OSError):
            return None  # does not compile: the caller passes through
        with self._lock:
            self._bank_cache[key] = compiled
            # Drop stale cached banks for the same path.
            for k in [k for k in self._bank_cache if k[0] == config_path and k != key]:
                del self._bank_cache[k]
            # Bound device memory held by compiled spectra (simple FIFO
            # evict; a long-IR bank is ~P*Cin*Cout*2*K*4 bytes).
            while len(self._bank_cache) > 16:
                self._bank_cache.pop(next(iter(self._bank_cache)))
        return compiled

    def return_processor(self, processor: Optional[SoundProcessor]) -> None:
        """Give a processor back (processor-pool.cc:93-117)."""
        if processor is None:
            return
        if not processor.config_still_up_to_date():
            # outdated: don't pool — but release any pipelined batch refs
            # so the stale processor doesn't pin device memory until GC.
            processor.drop_inflight()
            return
        # reset() drains the processor's in-flight device step; doing
        # that under the pool lock would block every other stream's
        # checkout on this stream's device latency — and a processor
        # the full pool is about to discard shouldn't pay the full
        # reset.  It must still drop its in-flight future, though.
        with self._lock:
            full = len(self._pool.get(processor.config_file, ())) >= self._max_per_config
        if full:
            processor.drop_inflight()
            return
        processor.reset()
        with self._lock:
            lst = self._pool.setdefault(processor.config_file, [])
            if len(lst) < self._max_per_config:
                lst.append(processor)

    def _check_out_of_pool(self, config_path: str) -> Optional[SoundProcessor]:
        with self._lock:
            lst = self._pool.get(config_path)
            if not lst:
                return None
            return lst.pop(0)
