"""Multi-host serving tier: data parallelism over hosts.

The port of ``folve_tpu/parallel/multihost.py``.  Its mesh has three
axes, ``(host, stream, freq)``:

* ``host``: pure data parallelism over hosts.  No tensor ever crosses
  this axis: each host row is a :class:`ServingMesh` of its own, whose
  one reduction (the freq sum of :mod:`folve_tpu_torch.parallel.serving`)
  runs between that host's devices.  Audio, state and filters stay with
  their host.
* ``stream`` and ``freq``: a host's :class:`ServingMesh`, driven by
  :func:`make_sharded_serving_step` as in one-controller serving.

The :class:`SlotServer` serves a fixed table of stream *slots* in global
ticks (one ``T``-block step per tick).  Every host fills its own slots'
input blocks, with silence and ``active=False`` for an empty or paused
slot: the step then carries that slot's state through unchanged, so a
stalled reader resumes bit for bit.  State stays on the devices between
ticks; only audio crosses a host's boundary, to and from its own process.

Several processes (one per host): the caller initializes
``torch.distributed`` (world size > 1) before it builds the mesh.  Each
process then holds only its own host row, built from its local devices,
and feeds and reads back only its own rows.  The one collective is an
``all_gather_object`` of the device counts when the mesh is built, so
the ``gloo`` backend does; :meth:`SlotServer.tick` and
:meth:`SlotServer.reset_slot` call no ``torch.distributed`` function.
One process (the tests, or one controller of several cards) splits its
device list into simulated hosts and drives them all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import distributed as dist

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.engine.rfft import get_plan
from folve_tpu_torch.parallel.serving import (
    ShardedArray,
    make_serving_mesh,
    make_sharded_serving_step,
)

# The stream dimension splits over (host, stream) jointly: host-major
# row blocks, so host h owns global rows [h*S_local, (h+1)*S_local).
SPEC_H = (("host", "stream"), None, None, None, None, "freq")
SPEC_H_SHARED = (None, None, None, None, "freq")
SPEC_HIST = (("host", "stream"), None, None, "freq")
SPEC_TAIL = (("host", "stream"), None, None)
SPEC_SCALAR = (("host", "stream"),)
SPEC_X = (("host", "stream"), None, None, None)
_ROWS = ("host", "stream")


def _multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


@dataclasses.dataclass(frozen=True)
class MultihostMesh:
    """Host rows of ``[stream][freq]`` device grids (the JAX ``Mesh``
    with axes ("host", "stream", "freq")).  ``hosts[h]`` is host row
    ``h``'s :class:`ServingMesh`, or None where another process drives
    that row."""

    hosts: tuple

    @property
    def local_hosts(self) -> tuple:
        """The host rows this process drives, in order."""
        return tuple(h for h, m in enumerate(self.hosts) if m is not None)

    @property
    def shape(self) -> dict:
        return {"host": len(self.hosts),
                **self.hosts[self.local_hosts[0]].shape}


def make_multihost_serving_mesh(
    n_hosts: Optional[int] = None,
    freq_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> MultihostMesh:
    """Devices factored into (host, stream, freq).

    ``devices`` (default: every CUDA card) are this process's.  With
    ``torch.distributed`` initialized over several processes, each
    process is one host row of its own devices, and the processes must
    expose equal device counts.  Otherwise ``n_hosts`` (default 1)
    splits the list into contiguous simulated hosts; a device may repeat.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if _multiprocess():
        world = dist.get_world_size()
        counts = [None] * world
        dist.all_gather_object(counts, len(devs))
        per_host = counts[0]
        if any(c != per_host for c in counts):
            raise ValueError("hosts expose unequal device counts")
        if n_hosts is not None and n_hosts != world:
            raise ValueError(f"{world} processes != n_hosts={n_hosts}")
        n_hosts = world
        groups = {dist.get_rank(): devs}
    else:
        if n_hosts is None:
            n_hosts = 1
        if len(devs) % n_hosts:
            raise ValueError(f"{len(devs)} devices not divisible by {n_hosts} hosts")
        per_host = len(devs) // n_hosts
        groups = {h: devs[h * per_host:(h + 1) * per_host] for h in range(n_hosts)}
    if per_host % freq_parallel:
        raise ValueError(
            f"{per_host} devices/host not divisible by freq_parallel={freq_parallel}"
        )
    return MultihostMesh(tuple(
        make_serving_mesh(devices=groups[h], freq_parallel=freq_parallel)
        if h in groups else None for h in range(n_hosts)))


def _serving_spec(spec: tuple) -> tuple:
    return tuple("stream" if a == _ROWS else a for a in spec)


class MultihostArray:
    """A global array split by host rows: ``parts[h]`` is host ``h``'s
    block, a :class:`ShardedArray` of that host's own
    :class:`ServingMesh`, for each host row this process drives."""

    def __init__(self, mesh: MultihostMesh, spec: tuple, parts: dict):
        self.mesh, self.spec, self.parts = mesh, spec, parts

    @classmethod
    def place(cls, mesh: MultihostMesh, array, spec: tuple) -> "MultihostArray":
        """Split ``array`` by ``spec`` over this process's host rows.  Its
        stream axis holds those hosts' rows, host-major (all ``S`` rows
        in one process, a process's own ``S_local`` rows in several); an
        array without one is placed whole on every host."""
        if isinstance(array, MultihostArray):
            if array.mesh != mesh or array.spec != spec:
                raise ValueError("array is sharded for another mesh or spec")
            return array
        hosts = mesh.local_hosts
        sspec = _serving_spec(spec)
        if _ROWS in spec:
            t = array if torch.is_tensor(array) else torch.as_tensor(np.asarray(array))
            axis = spec.index(_ROWS)
            if t.shape[axis] % len(hosts):
                raise ValueError(f"axis {axis} of {tuple(t.shape)} does not "
                                 f"split into {len(hosts)} hosts")
            blocks = t.chunk(len(hosts), axis)
        else:
            blocks = [array] * len(hosts)
        return cls(mesh, spec, {h: ShardedArray.place(mesh.hosts[h], b, sspec)
                                for h, b in zip(hosts, blocks)})

    def numpy(self) -> np.ndarray:
        """This process's rows, host-major, on the host."""
        return np.concatenate([self.parts[h].numpy() for h in self.mesh.local_hosts],
                              self.spec.index(_ROWS))


def _keep(active: ShardedArray, new: ShardedArray,
          old: Optional[ShardedArray]) -> ShardedArray:
    """``new`` where the slot is active, else ``old`` (zeros when None),
    selected part by part on the parts' own devices."""
    parts = []
    for r, row in enumerate(new.parts):
        act = active.parts[r][0]
        out = []
        for f, n in enumerate(row):
            m = act.to(n.device).view(-1, *([1] * (n.dim() - 1)))
            out.append(torch.where(m, n, old.parts[r][f] if old is not None
                                   else torch.zeros((), dtype=n.dtype, device=n.device)))
        parts.append(out)
    return ShardedArray(new.mesh, new.spec, parts)


def make_multihost_serving_step(mesh: MultihostMesh, fragm: int, *,
                                shared_bank: bool = False):
    """The global serving step over the (host, stream, freq) mesh.

    The contract of :func:`make_sharded_serving_step` plus a trailing
    ``active`` [S] bool: inactive slots pass their state through
    untouched and output silence.  Inputs are global arrays over this
    process's hosts (see :meth:`MultihostArray.place`) or
    :class:`MultihostArray`; returns ``(hist_re, hist_im, tail, max_abs,
    y)``, each a :class:`MultihostArray`.  Each host row runs its own
    sharded step on its own :class:`ServingMesh`."""
    freq = mesh.shape["freq"]
    plan = get_plan(2 * fragm)
    if plan.m1 % freq:
        raise ValueError(f"M1={plan.m1} not divisible by freq={freq}")
    specs_in = (SPEC_H_SHARED if shared_bank else SPEC_H, SPEC_HIST, SPEC_HIST,
                SPEC_TAIL, SPEC_SCALAR, SPEC_X, SPEC_SCALAR, SPEC_SCALAR)
    specs_out = (SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR, SPEC_X)
    steps = {h: make_sharded_serving_step(mesh.hosts[h], fragm,
                                          shared_bank=shared_bank)
             for h in mesh.local_hosts}

    def step(*inputs):
        placed = [MultihostArray.place(mesh, a, spec)
                  for a, spec in zip(inputs, specs_in)]
        out = [{} for _ in specs_out]
        for h in mesh.local_hosts:
            args = [a.parts[h] for a in placed]
            active = args[-1]
            new = steps[h](*args[:-1])
            # Frozen slot: the old state tensors themselves, so it
            # resumes bit for bit; its output is silence.
            for i, old in enumerate(args[1:5] + [None]):
                out[i][h] = _keep(active, new[i], old)
        return tuple(MultihostArray(mesh, spec, parts)
                     for spec, parts in zip(specs_out, out))

    return step


def host_rows(mesh: MultihostMesh, host: int, s_local: int) -> slice:
    """Global stream-row range owned by mesh host row ``host``."""
    del mesh
    return slice(host * s_local, (host + 1) * s_local)


def _zero_row(arr: ShardedArray, i: int) -> ShardedArray:
    """``arr`` with stream row ``i`` (of its own rows) set to zero."""
    q, local = divmod(i, arr.parts[0][0].shape[0])
    parts = [list(row) for row in arr.parts]
    parts[q] = [p.index_fill(0, torch.tensor([local], device=p.device), 0.0)
                for p in parts[q]]
    return ShardedArray(arr.mesh, arr.spec, parts)


class SlotServer:
    """Fixed slot-table lockstep server over a multi-host mesh.

    One instance per process in production (each process feeds only its
    ``host_index`` rows); one process may drive every simulated host.
    State stays on the devices between ticks, each host's on its own
    :class:`ServingMesh`."""

    def __init__(self, mesh: MultihostMesh, bank: FilterBank, s_local: int, t: int):
        self.mesh = mesh
        self.bank = bank
        self.s_local = s_local
        self.t = t
        self.n_hosts = mesh.shape["host"]
        s = self.n_hosts * s_local
        self.s_global = s
        p, cin, cout, _, k = bank.h_spec.shape
        self.cin, self.cout = cin, cout
        self._step = make_multihost_serving_step(mesh, bank.fragm,
                                                 shared_bank=True)
        # The process group is the caller's; this process holds only its
        # own rows when there are several.
        self._multiproc = _multiprocess()
        self.host_index = dist.get_rank() if self._multiproc else None
        n = s_local if self._multiproc else s
        put = lambda arr, spec: MultihostArray.place(mesh, arr, spec)
        self._h = put(bank.h_spec, SPEC_H_SHARED)
        self._hist_re = put(np.zeros((n, p - 1, cin, k), np.float32), SPEC_HIST)
        self._hist_im = put(np.zeros((n, p - 1, cin, k), np.float32), SPEC_HIST)
        self._tail = put(np.zeros((n, cout, bank.fragm), np.float32), SPEC_TAIL)
        self._max = put(np.zeros((n,), np.float32), SPEC_SCALAR)
        self.ticks = 0

    def reset_slot(self, row: int) -> None:
        """Zero one slot's convolution state (a new stream claims it).
        As the JAX package's ``.at[row].set(0.0)``: a negative row counts
        from the end once, and a row out of range changes nothing.
        Several processes: every process calls this with the same row in
        the same tick gap; a row of another process's host changes
        nothing here."""
        if row < 0:
            row += self.s_global
        if not 0 <= row < self.s_global:
            return
        host, local = divmod(row, self.s_local)
        if host not in self.mesh.local_hosts:
            return
        for name in ("_hist_re", "_hist_im", "_tail", "_max"):
            arr = getattr(self, name)
            parts = dict(arr.parts)
            parts[host] = _zero_row(parts[host], local)
            setattr(self, name, MultihostArray(self.mesh, arr.spec, parts))

    def tick(self, x_blocks: Dict[int, np.ndarray],
             n_valid: Optional[Dict[int, int]] = None) -> Dict[int, np.ndarray]:
        """Advance one global step.

        ``x_blocks``: global row -> [T, Cin, fragm] input block for the
        ACTIVE slots this tick (several processes: each passes only its
        own rows).  Returns row -> [T, Cout, fragm] convolved audio for
        those rows."""
        t, b = self.t, self.bank.fragm
        if self._multiproc:
            lo = host_rows(self.mesh, self.host_index, self.s_local)
            foreign = [r for r in x_blocks if not lo.start <= r < lo.stop]
            if foreign:
                raise ValueError(
                    f"process {self.host_index} owns rows "
                    f"[{lo.start},{lo.stop}) but was fed {foreign}"
                )
            n = self.s_local
        else:
            lo, n = slice(0, self.s_global), self.s_global
        x = np.zeros((n, t, self.cin, b), np.float32)
        nv = np.zeros((n,), np.int32)
        act = np.zeros((n,), bool)
        for row, blk in x_blocks.items():
            i = row - lo.start
            x[i] = blk
            nv[i] = (n_valid or {}).get(row, t * b)
            act[i] = True
        self._hist_re, self._hist_im, self._tail, self._max, y = self._step(
            self._h, self._hist_re, self._hist_im, self._tail, self._max,
            x, nv, act,
        )
        self.ticks += 1
        y_local = y.numpy()
        return {row: y_local[row - lo.start] for row in x_blocks}
