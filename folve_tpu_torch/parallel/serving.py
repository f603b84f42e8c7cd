"""Serving over a (stream, freq) mesh of devices, from one controller.

The port of ``folve_tpu/parallel/serving.py``.  The JAX package drives
every device of a 2-D mesh from one process with ``shard_map``; the port
does the same from one Python thread:

* ``stream`` axis: data parallelism over the batch of open streams.
  Streams do not interact, so this axis needs no communication.
* ``freq`` axis: the permuted [k1, k2] spectrum is split by k1 rows.  Each
  shard's forward transform, MAC and partial inverse run on its own
  device (:func:`folve_tpu_torch.engine.stream.shard_partial_step`), on
  its own rows of the filter spectra and of the FDL state.  The shards'
  partial inverses are then summed in a fixed shard order on the stream
  row's first freq device (the JAX package's ``psum``, the one reduction
  of the step, so the sum is deterministic), where the overlap-add and
  the clipping monitor run (:func:`finish_sharded_step`).  Partials move
  between devices as peer copies; they stand in for XLA's collective.

A mesh may repeat a device: the CPU tests serve on ``["cpu"] * 8`` (the
JAX tests' virtual CPU devices) and ``chip_smoke.py`` on four shards of
one card.  ``torch.distributed`` is left to a multi-host server.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.rfft import get_plan
from folve_tpu_torch.engine.stream import (
    finish_sharded_step,
    shard_partial_step,
)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """Devices in a ``[stream][freq]`` grid (the JAX ``Mesh`` with axes
    ("stream", "freq")); a device may appear more than once."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"stream": len(self.devices), "freq": len(self.devices[0])}


def make_serving_mesh(n_devices: Optional[int] = None, freq_parallel: int = 1,
                      devices: Optional[Sequence] = None) -> ServingMesh:
    """Devices factored into (stream, freq) axes: the first
    ``n_devices`` of ``devices`` (default: every CUDA card)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices requested, {len(devs)} given")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % freq_parallel:
        raise ValueError(
            f"{n} devices not divisible by freq_parallel={freq_parallel}")
    f = freq_parallel
    return ServingMesh(tuple(tuple(devs[r * f:(r + 1) * f]) for r in range(n // f)))


def check_freq_shardable(fragm: int, bins: int, freq_parallel: int) -> bool:
    """True when a bank of ``bins`` (global) frequency bins at block
    length ``fragm`` splits into ``freq_parallel`` k1-row shards."""
    plan = get_plan(2 * fragm)
    if plan.m1 % freq_parallel:
        return False
    cols = bins // plan.m1
    return bins == plan.m1 * cols and cols in (plan.m2, plan.m2 // 2 + 1)


# Layouts of the serving step's global arrays (the JAX package's
# PartitionSpecs): the bin axis splits over ``freq``, streams over
# ``stream``.  Arrays without a freq axis (the time-domain tail, the
# clipping max, audio) are replicated over freq.
SPEC_H = ("stream", None, None, None, None, "freq")
SPEC_H_SHARED = (None, None, None, None, "freq")
SPEC_HIST = ("stream", None, None, "freq")
SPEC_TAIL = ("stream", None, None)
SPEC_SCALAR = ("stream",)
SPEC_X = ("stream", None, None, None)


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (kernels launch on it)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class ShardedArray:
    """A global array laid out over a :class:`ServingMesh` by a spec.

    The axis named "stream" splits into one block per mesh row and the
    axis named "freq" into one block per mesh column; ``parts[r][f]``
    lies on ``mesh.devices[r][f]``.  An array without a freq axis is
    replicated over freq: it is kept once per row, on the row's first
    freq device (``parts[r] == [block]``), and :meth:`part` copies it to
    another freq device only where a shard reads it."""

    def __init__(self, mesh: ServingMesh, spec: tuple, parts: list):
        self.mesh, self.spec, self.parts = mesh, spec, parts

    @property
    def freq_sharded(self) -> bool:
        return "freq" in self.spec

    @classmethod
    def place(cls, mesh: ServingMesh, array, spec: tuple) -> "ShardedArray":
        """Split a global array (numpy, tensor, or already sharded) by
        ``spec`` over ``mesh``."""
        if isinstance(array, ShardedArray):
            if array.mesh != mesh or array.spec != spec:
                raise ValueError("array is sharded for another mesh or spec")
            return array
        t = torch.as_tensor(np.asarray(array) if not torch.is_tensor(array)
                            else array)
        if t.dim() != len(spec):
            raise ValueError(f"array of shape {tuple(t.shape)} for spec {spec}")
        rows, cols = mesh.shape["stream"], mesh.shape["freq"]
        for axis, n in (("stream", rows), ("freq", cols)):
            if axis in spec and t.shape[spec.index(axis)] % n:
                raise ValueError(f"axis {axis} of {tuple(t.shape)} does not "
                                 f"split into {n} blocks")
        parts = []
        for r in range(rows):
            block = (t.chunk(rows, spec.index("stream"))[r]
                     if "stream" in spec else t)
            if "freq" in spec:
                ax = spec.index("freq")
                parts.append([c.to(mesh.devices[r][f]).contiguous()
                              for f, c in enumerate(block.chunk(cols, ax))])
            else:
                parts.append([block.to(mesh.devices[r][0]).contiguous()])
        return cls(mesh, spec, parts)

    def part(self, r: int, f: int) -> torch.Tensor:
        """The block of mesh row ``r`` on ``mesh.devices[r][f]``."""
        if self.freq_sharded:
            return self.parts[r][f]
        return self.parts[r][0].to(self.mesh.devices[r][f])

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole array on one device."""
        rows = [torch.cat([p.to(device) for p in row], self.spec.index("freq"))
                if self.freq_sharded else row[0].to(device)
                for row in self.parts]
        if "stream" not in self.spec:
            return rows[0]
        return torch.cat(rows, self.spec.index("stream"))

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def _rows_per_part(self) -> int:
        return self.parts[0][0].shape[0]

    def row(self, i: int) -> torch.Tensor:
        """Stream row ``i`` (axis 0 is "stream") on its mesh row's first
        freq device."""
        per = self._rows_per_part()
        q, local = divmod(i, per)
        home = self.mesh.devices[q][0]
        pieces = [p[local].to(home) for p in self.parts[q]]
        if not self.freq_sharded:
            return pieces[0]
        return torch.cat(pieces, self.spec.index("freq") - 1)

    def take(self, idx: Sequence[int]) -> "ShardedArray":
        """Rows ``idx`` of the stream axis (axis 0), laid out over the
        mesh again: each block gathers its rows on its own device, with
        one ``index_select`` per source block (the state never leaves the
        devices)."""
        if self.spec[0] != "stream":
            raise ValueError("take needs a leading stream axis")
        rows = self.mesh.shape["stream"]
        if len(idx) % rows:
            raise ValueError(f"{len(idx)} rows over {rows} mesh rows")
        per_new, per_old = len(idx) // rows, self._rows_per_part()
        parts = []
        for r in range(rows):
            want = idx[r * per_new:(r + 1) * per_new]
            groups: dict = {}
            for pos, i in enumerate(want):
                q, local = divmod(int(i), per_old)
                groups.setdefault(q, ([], []))
                groups[q][0].append(pos)
                groups[q][1].append(local)
            row_parts = []
            for f in range(len(self.parts[0])):
                dev = self.mesh.devices[r][f]
                picked = {q: self.parts[q][f].index_select(
                    0, torch.tensor(loc, device=self.parts[q][f].device)).to(dev)
                          for q, (_, loc) in groups.items()}
                if len(groups) == 1:
                    row_parts.append(next(iter(picked.values())))
                    continue
                src = self.parts[0][f]
                out = torch.empty((per_new, *src.shape[1:]), dtype=src.dtype,
                                  device=dev)
                for q, (pos, _) in groups.items():
                    out[torch.tensor(pos, device=dev)] = picked[q]
                row_parts.append(out)
            parts.append(row_parts)
        return ShardedArray(self.mesh, self.spec, parts)


def shard_states_and_bank(mesh: ServingMesh, h_spec, hist_re, hist_im, tail,
                          max_abs, x, n_valid, *, shared_bank: bool = False):
    """Lay the serving step's global inputs out over ``mesh``."""
    place = lambda a, spec: ShardedArray.place(mesh, a, spec)
    return (
        place(h_spec, SPEC_H_SHARED if shared_bank else SPEC_H),
        place(hist_re, SPEC_HIST),
        place(hist_im, SPEC_HIST),
        place(tail, SPEC_TAIL),
        place(max_abs, SPEC_SCALAR),
        place(x, SPEC_X),
        place(n_valid, SPEC_SCALAR),
    )


def make_sharded_serving_step(mesh: ServingMesh, fragm: int, *,
                              shared_bank: bool = False, gather: bool = False):
    """Build the multi-device serving step for one block length.

    Inputs (global shapes; numpy, tensors or :class:`ShardedArray`):
      ``h_spec``  [S, P, Cin, Cout, 2, K]: per-stream filter spectra
                  ([P, Cin, Cout, 2, K] broadcast when ``shared_bank``)
      ``hist_re``/``hist_im``  [S, P-1, Cin, K]
      ``tail``    [S, Cout, fragm]
      ``max_abs`` [S]
      ``x``       [S, T, Cin, fragm]
      ``n_valid`` [S]
    ``K`` may be the full or the half-spectrum layout.

    Returns ``step(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid)
    -> (hist_re, hist_im, tail, max_abs, y)``, each a :class:`ShardedArray`.

    With ``gather``, the step takes a trailing ``idx`` [S] and the state
    arrays may hold a previous step's batch in any order and capacity:
    their rows are gathered on the devices, so a steady-state scheduler
    never moves convolution state through the host."""
    freq = mesh.shape["freq"]
    plan = get_plan(2 * fragm)
    if plan.m1 % freq:
        raise ValueError(f"M1={plan.m1} not divisible by freq={freq}")

    def step(*inputs):
        h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = (
            shard_states_and_bank(mesh, *inputs, shared_bank=shared_bank))
        out = [[] for _ in range(5)]
        for r in range(mesh.shape["stream"]):
            partials, new_re, new_im = [], [], []
            for f in range(freq):
                with _on(mesh.devices[r][f]):
                    p, nr, ni = shard_partial_step(
                        h_spec.part(r, f), fragm, hist_re.part(r, f),
                        hist_im.part(r, f), x.part(r, f), freq, f)
                partials.append(p)
                new_re.append(nr)
                new_im.append(ni)
            home = mesh.devices[r][0]
            with _on(home):
                # The freq reduction, in shard order on the home device.
                y2 = partials[0]
                for p in partials[1:]:
                    y2 = y2 + p.to(home)
                tl, mx, y = finish_sharded_step(
                    y2, tail.part(r, 0), max_abs.part(r, 0), n_valid.part(r, 0))
            for lst, v in zip(out, (new_re, new_im, [tl], [mx], [y])):
                lst.append(v)
        specs = (SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR, SPEC_X)
        return tuple(ShardedArray(mesh, spec, parts)
                     for spec, parts in zip(specs, out))

    if not gather:
        return step

    def gathered(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid, idx):
        idx = [int(i) for i in idx]
        return step(h_spec, hist_re.take(idx), hist_im.take(idx),
                    tail.take(idx), max_abs.take(idx), x, n_valid)

    return gathered
