"""Host streaming runtime: the block pump, the batch scheduler, handlers,
caches, buffers and prefetch."""

from folve_tpu_torch.runtime.buffer_thread import BufferThread
from folve_tpu_torch.runtime.conversion_buffer import ConversionBuffer
from folve_tpu_torch.runtime.filesystem import FolveFilesystem
from folve_tpu_torch.runtime.handler import (
    ConvolveFileHandler,
    FileHandler,
    FileStat,
    HandlerStats,
    PassThroughHandler,
    Status,
)
from folve_tpu_torch.runtime.handler_cache import FileHandlerCache, Observer
from folve_tpu_torch.runtime.pool import ProcessorPool
from folve_tpu_torch.runtime.processor import SoundProcessor
from folve_tpu_torch.runtime.scheduler import DeviceScheduler, FusedStateRef

__all__ = [
    "BufferThread",
    "ConversionBuffer",
    "FolveFilesystem",
    "ConvolveFileHandler",
    "FileHandler",
    "FileStat",
    "HandlerStats",
    "PassThroughHandler",
    "Status",
    "FileHandlerCache",
    "Observer",
    "ProcessorPool",
    "SoundProcessor",
    "DeviceScheduler",
    "FusedStateRef",
]
