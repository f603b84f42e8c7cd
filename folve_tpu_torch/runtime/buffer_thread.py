"""BufferThread — background prefetcher.

Behavioral twin of buffer-thread.{h,cc}: one low-priority daemon thread
round-robins a work queue of ConversionBuffers in small chunks so a
single stream cannot starve the others (buffer-thread.cc:73-105);
``enqueue_work`` dedups and just raises the goal to
``max_accessed + buffer_ahead`` (:33-52); ``forget`` blocks while its
buffer is in flight to avoid use-after-free (:54-71).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional

from folve_tpu_torch.runtime.conversion_buffer import ConversionBuffer

_BUFFER_CHUNK = 8 << 10


@dataclasses.dataclass
class _WorkItem:
    buffer: ConversionBuffer
    goal: int


class BufferThread:
    def __init__(self, buffer_ahead: int):
        self._buffer_ahead = buffer_ahead
        self._mutex = threading.Lock()
        self._enqueue_event = threading.Condition(self._mutex)
        self._picked_work = threading.Condition(self._mutex)
        self._queue: List[_WorkItem] = []
        self._current: Optional[ConversionBuffer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="folve-prebuffer", daemon=True
            )
            self._thread.start()

    def enqueue_work(self, buffer: ConversionBuffer) -> None:
        goal = buffer.max_accessed() + self._buffer_ahead
        with self._mutex:
            for item in self._queue:
                if item.buffer is buffer:
                    item.goal = goal
                    return
            self._queue.append(_WorkItem(buffer, goal))
            self._enqueue_event.notify()

    def forget(self, buffer: ConversionBuffer) -> None:
        with self._mutex:
            while self._current is buffer:
                self._picked_work.wait()
            self._queue = [it for it in self._queue if it.buffer is not buffer]

    def _run(self) -> None:
        # The reference runs this niced + SCHED_IDLE (util.cc:88-116).
        # On Linux, setpriority(who=0) applies to the calling *thread*.
        try:
            os.setpriority(os.PRIO_PROCESS, 0, 10)
        except (OSError, AttributeError):
            pass
        while True:
            with self._mutex:
                while not self._queue:
                    self._enqueue_event.wait()
                work = self._queue[0]
                self._current = work.buffer
                self._picked_work.notify_all()

            work_complete = (
                work.buffer.fill_until(work.buffer.file_size() + _BUFFER_CHUNK)
                or work.buffer.file_size() >= work.goal
            )

            with self._mutex:
                if self._queue and self._queue[0] is work:
                    if not work_complete:
                        self._queue.append(work)
                    self._queue.pop(0)
                self._current = None
                self._picked_work.notify_all()
            os.sched_yield()
