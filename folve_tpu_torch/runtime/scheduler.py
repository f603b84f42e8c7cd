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
updates the gathered carry's hist ring in place; the gather is a new
buffer, so neither the parent batch nor job 0's row sees the writes of
replicated padding rows.

With a ``mesh`` (:func:`folve_tpu_torch.parallel.make_serving_mesh`),
batches whose banks split into the mesh's freq shards run the sharded
serving step instead; their state stays on the mesh's devices as a
:class:`_SlotStates` batch referenced by :class:`ShardedStateRef`, and
the next step gathers its rows there.
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
    unroll_ring,
    unstack_state,
)
from folve_tpu_torch.parallel.serving import (
    SPEC_H,
    SPEC_H_SHARED,
    ShardedArray,
    check_freq_shardable,
    make_sharded_serving_step,
)
from folve_tpu_torch.runtime.processor import _quantize
from folve_tpu_torch.utils.profiling import LatencyStats, span

_PLACED_CAP = 16
_STATE_FIELDS = ("hist_re", "hist_im", "tail", "max_abs")


def _signature(bank: FilterBank) -> Tuple:
    return tuple(bank.h_spec.shape) + (bank.fragm,)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Job:
    __slots__ = ("bank", "state", "x", "n_valid", "quantize_bits", "future",
                 "stream", "t_submit")

    def __init__(self, bank, state, x, n_valid, quantize_bits=None, stream=None):
        self.bank = bank
        self.state = state
        self.x = x
        self.n_valid = n_valid
        # The lone-stream path folds PCM quantization into the step;
        # batched paths resolve with float audio (callers check dtype).
        self.quantize_bits = quantize_bits
        self.future: Future = Future()
        self.stream = stream
        self.t_submit = time.perf_counter()


class _FusedSlots:
    """One fused step's output carry, kept on the device."""

    __slots__ = ("carry", "__weakref__")

    def __init__(self, carry: FusedServingCarry):
        self.carry = carry


class FusedStateRef:
    """Duck-typed :class:`StreamState` view into a :class:`_FusedSlots`
    batch.  Field access materializes the canonical layout, the hist
    unrolled by the carry's head (only path switches and resets ever
    do)."""

    __slots__ = ("parent", "idx")

    def __init__(self, parent: _FusedSlots, idx: int):
        self.parent = parent
        self.idx = idx

    def _hist(self, ring):
        # [P-1, Cin, cols, m1], oldest row first
        h = unroll_ring(ring[self.idx], self.parent.carry.head, 0)
        return h.transpose(-1, -2).reshape(h.shape[0], h.shape[1], -1)

    @property
    def hist_re(self):
        return self._hist(self.parent.carry.hist_re)

    @property
    def hist_im(self):
        return self._hist(self.parent.carry.hist_im)

    @property
    def tail(self):
        t = self.parent.carry.tail[self.idx]  # [Cout, rows, m2]
        return t.reshape(t.shape[0], -1)

    @property
    def max_abs(self):
        return self.parent.carry.max_abs[self.idx]


class _SlotStates:
    """One sharded step's output states (:class:`ShardedArray` objects), kept
    on the mesh's devices."""

    __slots__ = ("hist_re", "hist_im", "tail", "max_abs", "__weakref__")

    def __init__(self, hist_re, hist_im, tail, max_abs):
        self.hist_re = hist_re
        self.hist_im = hist_im
        self.tail = tail
        self.max_abs = max_abs


class ShardedStateRef:
    """Duck-typed :class:`StreamState` view of row ``idx`` of a
    :class:`_SlotStates` batch.  The next sharded step gathers the row on
    the devices; field access assembles it on one device (only path
    switches, resets and superseded batches ever do)."""

    __slots__ = ("parent", "idx")

    def __init__(self, parent: _SlotStates, idx: int):
        self.parent = parent
        self.idx = idx

    @property
    def hist_re(self):
        return self.parent.hist_re.row(self.idx)

    @property
    def hist_im(self):
        return self.parent.hist_im.row(self.idx)

    @property
    def tail(self):
        return self.parent.tail.row(self.idx)

    @property
    def max_abs(self):
        return self.parent.max_abs.row(self.idx)


def _as_plain_state(state):
    """Materialize a FusedStateRef or ShardedStateRef to a canonical
    StreamState."""
    if isinstance(state, (FusedStateRef, ShardedStateRef)):
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
                 device="cuda", mesh=None):
        """Batches jobs for banks placed on ``device``.  ``mesh``: an
        optional :class:`folve_tpu_torch.parallel.ServingMesh`; batches
        whose banks split into its freq shards run the sharded serving
        step on it, the rest the single-device step."""
        self.device = resolve_device(device)
        self._mesh = mesh
        self._sharded_steps: Dict[Tuple, object] = {}
        # Live state batches (_FusedSlots or _SlotStates) per batch kind
        # and bank signature, as weak references (guarded by _mutex).
        self._parents: Dict[Tuple, list] = {}
        _live_schedulers.add(self)
        self._max_batch = max_batch
        self._window_s = window_s
        # LRU of the mixed-filter path's stacked spectra, keyed by the
        # identities of the source tensors.  (The fused kernel's permuted
        # spectra are cached per bank by engine.stream.eager_h_perm.)
        self._placed: "OrderedDict[object, Tuple]" = OrderedDict()
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
        self.sharded_steps = 0  # steps on the mesh
        self.sharded_fast_steps = 0  # ... with the state gathered on the mesh
        self.total_step_s = 0.0
        self.last_step_s = 0.0
        self.last_batch = 0
        self.latency = LatencyStats()
        # Each job's wait from submit() to the batch that takes it.
        self.queue_wait = LatencyStats()

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
        if isinstance(state, (FusedStateRef, ShardedStateRef)):
            key = (type(state.parent),) + _signature(bank)
            with self._mutex:
                refs = self._parents.get(key, ())
                live = any(r() is state.parent for r in refs)
            if not live:
                # Superseded batch: materialize this row so the old
                # batch's device memory is released.
                state = _as_plain_state(state)
        job = _Job(bank, state, x, n_valid, quantize_bits, stream)
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
                    with span("sched.coalesce"):
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
        now = time.perf_counter()
        for job in jobs:
            self.queue_wait.record(now - job.t_submit)
        try:
            self._execute(jobs)
        except Exception as e:  # resolve the batch's futures with the error
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(e)

    def _record(self, t0: float, n: int, fused: bool = False) -> None:
        if self.device.type == "cuda":
            with span("sched.sync", step=self.steps):
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

    def _register_parent(self, bank: FilterBank, parent) -> None:
        """Record a new live state batch.  Several batches of one kind and
        signature may be live at once (queue overflow splits, edge-block
        chunk shapes); weak references let a batch die when no stream's
        state refers to it."""
        with self._mutex:
            refs = self._parents.setdefault(
                (type(parent),) + _signature(bank), [])
            refs[:] = [r for r in refs if r() is not None][-7:]
            refs.append(weakref.ref(parent))

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
        mesh = self._mesh
        if mesh is not None and not check_freq_shardable(
                bank0.fragm, bank0.bins, mesh.shape["freq"]):
            mesh = None  # bank too small for this freq split
        padded = _bucket(n, self._max_batch)
        if mesh is not None:
            # The stream axis splits the batch: pad to a multiple of it.
            rows = mesh.shape["stream"]
            padded = -(-max(padded, rows) // rows) * rows
        all_jobs = jobs + [jobs[0]] * (padded - n)
        if mesh is not None:
            self._execute_sharded(mesh, jobs, all_jobs)
            return
        t_blocks = np.shape(jobs[0].x)[0]
        shared = all(j.bank.h_spec is bank0.h_spec for j in all_jobs)
        if shared and padded >= 2 and fused_serving_supported(bank0, t_blocks):
            self._execute_fused(jobs, all_jobs)
            return
        # The paths below take canonical states: materialize carry rows
        # (a path switch, rare).
        for job in jobs:
            job.state = _as_plain_state(job.state)
        streams = [j.stream for j in jobs]
        if n == 1 and padded == 1:
            # Lone stream: the single-stream step, through the fused
            # kernel when the shape allows; quantization folded in.
            job = jobs[0]
            t0 = time.perf_counter()
            with span("sched.step", step=self.steps, streams=streams):
                state, y = single_chunk_step(job.bank, job.state, job.x,
                                             int(job.n_valid))
                if job.quantize_bits is not None:
                    y = _quantize(y, job.quantize_bits)
            self._record(t0, 1)
            job.future.set_result((state, y))
            return
        with span("sched.stage", step=self.steps, streams=streams):
            states = stack_states([j.state for j in all_jobs])
            x = torch.as_tensor(np.stack([np.asarray(j.x, np.float32)
                                          for j in all_jobs]), device=self.device)
            n_valid = [int(j.n_valid) for j in all_jobs]
        t0 = time.perf_counter()
        with span("sched.step", step=self.steps, streams=streams):
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
        streams = [j.stream for j in jobs]
        with span("sched.stage", step=self.steps, streams=streams):
            x_h = np.stack([np.asarray(j.x, dtype=np.float32) for j in all_jobs])
            x5 = torch.as_tensor(stage_x_for_fused(bank0, x_h), device=self.device)
            nv = [int(j.n_valid) for j in all_jobs]
        t0 = time.perf_counter()
        with span("sched.step", step=self.steps, streams=streams):
            if fast:
                idx = torch.as_tensor([s.idx for s in states], device=self.device)
                # The rows of one parent share its ring head.
                carry = FusedServingCarry(
                    *(getattr(parent.carry, f).index_select(0, idx)
                      for f in _STATE_FIELDS), head=parent.carry.head)
                self.fused_fast_steps += 1
            else:
                carry = carry_from_states(
                    bank0, stack_states([_as_plain_state(s) for s in states]))
            new_carry, y5 = fused_serving_step_pre(bank0, carry, x5, nv)
            s, t, cout = y5.shape[:3]
            y = y5.reshape(s, t, cout, bank0.fragm)
        self._record(t0, len(jobs), fused=True)
        new_parent = _FusedSlots(new_carry)
        self._register_parent(bank0, new_parent)
        for i, job in enumerate(jobs):
            job.future.set_result((FusedStateRef(new_parent, i), y[i]))

    def _placed_bank(self, mesh, h_spec):
        """Shared-bank spectra laid out over the mesh, cached so repeated
        steps do not move the filter again."""
        return self._place(("sharded", id(h_spec)), (h_spec,),
                           lambda: ShardedArray.place(mesh, h_spec,
                                                      SPEC_H_SHARED))

    def _placed_bank_stack(self, mesh, specs):
        """Per-stream filter stack laid out over the mesh, cached by the
        identities of its sources."""
        specs = tuple(specs)
        return self._place(("sharded",) + tuple(id(h) for h in specs), specs,
                           lambda: ShardedArray.place(
                               mesh, torch.stack([h.to(self.device)
                                                  for h in specs]), SPEC_H))

    def _execute_sharded(self, mesh, jobs: List[_Job],
                         all_jobs: List[_Job]) -> None:
        """One batch through the sharded serving step.

        Steady-state streams carry :class:`ShardedStateRef` views from the
        previous step, so their state stays on the mesh: the ``gather``
        step collects the referenced rows on the devices and only the
        audio leaves them.  Fresh or mixed batches stack their states and
        lay them out over the mesh once."""
        bank0 = all_jobs[0].bank
        shared = all(j.bank.h_spec is bank0.h_spec for j in all_jobs)
        states = [j.state for j in all_jobs]
        parent = states[0].parent if isinstance(states[0], ShardedStateRef) else None
        fast = parent is not None and all(
            isinstance(s, ShardedStateRef) and s.parent is parent for s in states
        )
        key = (bank0.fragm, shared, fast)
        step = self._sharded_steps.get(key)
        if step is None:
            step = make_sharded_serving_step(mesh, bank0.fragm,
                                             shared_bank=shared, gather=fast)
            self._sharded_steps[key] = step
        streams = [j.stream for j in jobs]
        with span("sched.stage", step=self.steps, streams=streams):
            x = np.stack([np.asarray(j.x, dtype=np.float32) for j in all_jobs])
            n_valid = np.asarray([int(j.n_valid) for j in all_jobs], dtype=np.int64)
            if shared:
                h_spec = self._placed_bank(mesh, bank0.h_spec)
            else:
                h_spec = self._placed_bank_stack(mesh, [j.bank.h_spec for j in all_jobs])
        t0 = time.perf_counter()
        with span("sched.step", step=self.steps, streams=streams):
            if fast:
                out = step(h_spec, parent.hist_re, parent.hist_im, parent.tail,
                           parent.max_abs, x, n_valid, [s.idx for s in states])
                self.sharded_fast_steps += 1
            else:
                st = stack_states([
                    StreamState(*(getattr(s, f).to(self.device) for f in _STATE_FIELDS))
                    for s in states])
                out = step(h_spec, st.hist_re, st.hist_im, st.tail, st.max_abs,
                           x, n_valid)
            new_re, new_im, new_tail, new_max, y = out
            y_host = y.gather("cpu")  # the audio leaves; the states stay
        self._record(t0, len(jobs))
        self.sharded_steps += 1
        new_parent = _SlotStates(new_re, new_im, new_tail, new_max)
        self._register_parent(bank0, new_parent)
        for i, job in enumerate(jobs):
            job.future.set_result((ShardedStateRef(new_parent, i), y_host[i]))
