"""DeviceScheduler — fuse many streams' block work into one device step.

The reference's multi-stream story is one thread per open file, each
with its own convolver.  Here one device stepper coalesces the block jobs
of all concurrently pumping streams into one batched step (BASELINE
config 5).  Jobs are bucketed by filter-bank *shape*; streams with
different filters of one shape batch together (the mixed-filter step
carries per-stream spectra).  Batches are padded to power-of-two sizes
with replicas of job 0 (their outputs are dropped).

Shared-filter batches (and a lone stream whose shape allows it) run the
fused conv-step kernel; their state stays on the device between steps
as rows of a :class:`FusedServingCarry`, referenced by
:class:`FusedStateRef` and gathered with ``index_select``.  The kernel
writes new state buffers, so replicated padding rows never write into
job 0's state.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Tuple

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.engine.stream import (
    FusedServingCarry,
    StreamState,
    batched_chunk_step,
    carry_from_states,
    fused_serving_step_pre,
    fused_serving_supported,
    serving_chunk_step,
    single_chunk_step,
    stack_states,
    stage_x_for_fused,
    unstack_state,
)
from folve_tpu_torch.runtime.processor import _quantize
from folve_tpu_torch.utils.profiling import LatencyStats

_PLACED_CAP = 16


def _signature(bank: FilterBank) -> Tuple:
    return tuple(bank.h_spec.shape) + (bank.fragm,)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Job:
    __slots__ = ("bank", "state", "x", "n_valid", "quantize_bits", "future")

    def __init__(self, bank, state, x, n_valid, quantize_bits=None):
        self.bank = bank
        self.state = state
        self.x = x
        self.n_valid = n_valid
        # The lone-stream path folds PCM quantization into the step;
        # batched paths resolve with float audio (callers check dtype).
        self.quantize_bits = quantize_bits
        self.future: Future = Future()


class _FusedSlots:
    """One fused step's output carry, kept on the device."""

    __slots__ = ("carry", "__weakref__")

    def __init__(self, carry: FusedServingCarry):
        self.carry = carry


class FusedStateRef:
    """Duck-typed :class:`StreamState` view into a :class:`_FusedSlots`
    batch.  Field access materializes the canonical layout (only path
    switches and resets ever do)."""

    __slots__ = ("parent", "idx")

    def __init__(self, parent: _FusedSlots, idx: int):
        self.parent = parent
        self.idx = idx

    @property
    def hist_re(self):
        h = self.parent.carry.hist_re[self.idx]  # [P-1, Cin, cols, m1]
        return h.transpose(-1, -2).reshape(h.shape[0], h.shape[1], -1)

    @property
    def hist_im(self):
        h = self.parent.carry.hist_im[self.idx]
        return h.transpose(-1, -2).reshape(h.shape[0], h.shape[1], -1)

    @property
    def tail(self):
        t = self.parent.carry.tail[self.idx]  # [Cout, rows, m2]
        return t.reshape(t.shape[0], -1)

    @property
    def max_abs(self):
        return self.parent.carry.max_abs[self.idx]


def _as_plain_state(state):
    """Materialize a FusedStateRef to a canonical StreamState."""
    if isinstance(state, FusedStateRef):
        return StreamState(state.hist_re, state.hist_im, state.tail,
                           state.max_abs)
    return state


_live_schedulers: "weakref.WeakSet[DeviceScheduler]" = weakref.WeakSet()


@atexit.register
def _stop_all_schedulers() -> None:
    for sched in list(_live_schedulers):
        try:
            sched.stop()
        except Exception:
            pass


class DeviceScheduler:
    def __init__(self, max_batch: int = 16, window_s: float = 0.002,
                 device="cuda"):
        """Batches jobs for banks placed on ``device``."""
        self.device = resolve_device(device)
        _live_schedulers.add(self)
        self._max_batch = max_batch
        self._window_s = window_s
        # LRU of the mixed-filter path's stacked spectra, keyed by the
        # identities of the source tensors.  (The fused kernel's permuted
        # spectra are cached per bank by engine.stream.eager_h_perm.)
        self._placed: "OrderedDict[object, Tuple]" = OrderedDict()
        # Live carry batches per bank signature (guarded by _mutex).
        self._fused_parents: Dict[Tuple, list] = {}
        # Stream tokens recently seen by submit(): skip the coalescing
        # window when provably only one stream is pumping.
        self._stream_seen: Dict[object, float] = {}
        self._last_anon = 0.0
        self._mutex = threading.Lock()
        self._cv = threading.Condition(self._mutex)
        self._queues: Dict[Tuple, List[_Job]] = {}
        self._thread: threading.Thread | None = None
        self._stop = False
        # Counters read by the status page and the tests.
        self.steps = 0
        self.jobs = 0
        self.batched_jobs = 0
        self.fused_steps = 0  # fused pre-shaped steps
        self.fused_fast_steps = 0  # ... with a device-resident carry gather
        self.materialized = 0  # carry rows forced back to plain states
        self.coalesce_waits = 0  # times the window was actually paid
        self.total_step_s = 0.0
        self.last_step_s = 0.0
        self.last_batch = 0
        self.latency = LatencyStats()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="folve-device-scheduler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        # Drain anything still queued on the caller: a reader blocked in
        # future.result() must complete or see the error.
        while True:
            with self._cv:
                take = None
                for sig, q in self._queues.items():
                    if q:
                        take = q[: self._max_batch]
                        self._queues[sig] = q[len(take) :]
                        break
            if not take:
                break
            self._execute_or_fail(take)

    def submit(self, bank: FilterBank, state, x, n_valid, stream=None,
               quantize_bits=None) -> Future:
        """Queue one stream's chunk ``x`` [T, Cin, fragm]; resolves to
        ``(new_state, y)``.  ``stream``: optional identity of the
        submitting stream (lets a lone stream skip the window)."""
        if bank.device != self.device:
            raise ValueError(
                f"bank on {bank.device}, scheduler on {self.device}")
        if isinstance(state, FusedStateRef):
            with self._mutex:
                refs = self._fused_parents.get(_signature(bank), ())
                live = any(r() is state.parent for r in refs)
            if not live:
                # Superseded carry batch: materialize this row so the old
                # batch's device memory is released.
                self.materialized += 1
                state = _as_plain_state(state)
        job = _Job(bank, state, x, n_valid, quantize_bits)
        sig = _signature(bank) + (np.shape(x)[0],)
        with self._cv:
            now = time.monotonic()
            if stream is not None:
                self._stream_seen[stream] = now
            else:
                self._last_anon = now
            stopped = self._stop
            if not stopped:
                self._queues.setdefault(sig, []).append(job)
                self.jobs += 1
                self._cv.notify()
        if stopped:
            # Shutdown race (a pump still running while schedulers
            # stop): run inline.
            self._execute_or_fail([job])
            return job.future
        self.start()
        return job.future

    def _coalesce_worthwhile(self, now: float) -> bool:
        """Called with the lock held: pay the coalescing window unless
        provably a single known stream is active."""
        if sum(len(q) for q in self._queues.values()) > 1:
            return True
        active = 0
        for tok, ts in list(self._stream_seen.items()):
            if now - ts > 5.0:
                del self._stream_seen[tok]
            elif now - ts < 1.0:
                active += 1
        if now - self._last_anon < 1.0:
            return True
        return active != 1

    # -- scheduler thread --------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not any(self._queues.values()):
                    self._cv.wait()
                if self._stop:
                    return
                if self._coalesce_worthwhile(time.monotonic()):
                    # Hold until the deadline or a full batch: each
                    # submit() notifies, so one wait() would end early.
                    self.coalesce_waits += 1
                    deadline = time.monotonic() + self._window_s
                    while not self._stop and max(
                        (len(q) for q in self._queues.values()), default=0
                    ) < self._max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                if self._stop:
                    return
                sig, jobs = max(
                    ((s, q) for s, q in self._queues.items() if q),
                    key=lambda kv: len(kv[1]),
                )
                take = jobs[: self._max_batch]
                self._queues[sig] = jobs[len(take) :]
            self._execute_or_fail(take)

    def _execute_or_fail(self, jobs: List[_Job]) -> None:
        try:
            self._execute(jobs)
        except Exception as e:  # resolve the batch's futures with the error
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(e)

    def _record(self, t0: float, n: int, fused: bool = False) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.steps += 1
        self.fused_steps += int(fused)
        self.total_step_s += dt
        self.last_step_s = dt
        self.last_batch = n
        self.latency.record(dt)
        if n > 1:
            self.batched_jobs += n

    def _place(self, key, sources: tuple, make):
        """LRU of device layouts derived from ``sources`` (checked by
        identity so a recycled id never returns a stale entry)."""
        hit = self._placed.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], sources)):
            self._placed.move_to_end(key)
            return hit[1]
        value = make()
        self._placed[key] = (sources, value)
        while len(self._placed) > _PLACED_CAP:
            self._placed.popitem(last=False)
        return value

    def _execute(self, jobs: List[_Job]) -> None:
        n = len(jobs)
        # Row order inside a batch is free (each job resolves its own
        # future): sort by filter identity so mixed batches hit the
        # placed-stack cache regardless of arrival order.
        jobs = sorted(jobs, key=lambda j: id(j.bank.h_spec))
        bank0 = jobs[0].bank
        padded = _bucket(n, self._max_batch)
        all_jobs = jobs + [jobs[0]] * (padded - n)
        t_blocks = np.shape(jobs[0].x)[0]
        shared = all(j.bank.h_spec is bank0.h_spec for j in all_jobs)
        if shared and padded >= 2 and fused_serving_supported(bank0, t_blocks):
            self._execute_fused(jobs, all_jobs)
            return
        # The paths below take canonical states: materialize carry rows
        # (a path switch, rare).
        for job in jobs:
            job.state = _as_plain_state(job.state)
        if n == 1 and padded == 1:
            # Lone stream: the single-stream step, through the fused
            # kernel when the shape allows; quantization folded in.
            job = jobs[0]
            t0 = time.perf_counter()
            state, y = single_chunk_step(job.bank, job.state, job.x,
                                         int(job.n_valid))
            if job.quantize_bits is not None:
                y = _quantize(y, job.quantize_bits)
            self._record(t0, 1)
            job.future.set_result((state, y))
            return
        states = stack_states([j.state for j in all_jobs])
        x = torch.as_tensor(np.stack([np.asarray(j.x, np.float32)
                                      for j in all_jobs]), device=self.device)
        n_valid = [int(j.n_valid) for j in all_jobs]
        t0 = time.perf_counter()
        if shared:
            new_states, y = serving_chunk_step(bank0, states, x, n_valid)
        else:
            specs = tuple(j.bank.h_spec for j in all_jobs)
            h_spec = self._place(tuple(id(h) for h in specs), specs,
                                 lambda: torch.stack(specs))
            bank = FilterBank(h_spec=h_spec, fragm=bank0.fragm,
                              size=bank0.size)
            new_states, y = batched_chunk_step(bank, states, x, n_valid)
        self._record(t0, n)
        for i, job in enumerate(jobs):
            job.future.set_result((unstack_state(new_states, i), y[i]))

    def _execute_fused(self, jobs: List[_Job], all_jobs: List[_Job]) -> None:
        """Shared-filter batch through the fused kernel with the carry
        kept on the device.  Steady state (all states are rows of one
        live carry) gathers the rows with ``index_select``; fresh or
        mixed states are stacked and converted once."""
        bank0 = all_jobs[0].bank
        states = [j.state for j in all_jobs]
        parent = states[0].parent if isinstance(states[0], FusedStateRef) else None
        fast = parent is not None and all(
            isinstance(s, FusedStateRef) and s.parent is parent for s in states
        )
        x_h = np.stack([np.asarray(j.x, dtype=np.float32) for j in all_jobs])
        x5 = torch.as_tensor(stage_x_for_fused(bank0, x_h), device=self.device)
        nv = [int(j.n_valid) for j in all_jobs]
        t0 = time.perf_counter()
        if fast:
            idx = torch.as_tensor([s.idx for s in states], device=self.device)
            carry = FusedServingCarry(
                *(a.index_select(0, idx) for a in parent.carry))
            self.fused_fast_steps += 1
        else:
            carry = carry_from_states(
                bank0, stack_states([_as_plain_state(s) for s in states]))
        new_carry, y5 = fused_serving_step_pre(bank0, carry, x5, nv)
        s, t, cout = y5.shape[:3]
        y = y5.reshape(s, t, cout, bank0.fragm)
        self._record(t0, len(jobs), fused=True)
        new_parent = _FusedSlots(new_carry)
        with self._mutex:
            refs = self._fused_parents.setdefault(_signature(bank0), [])
            refs[:] = [r for r in refs if r() is not None][-7:]
            refs.append(weakref.ref(new_parent))
        for i, job in enumerate(jobs):
            job.future.set_result((FusedStateRef(new_parent, i), y[i]))
