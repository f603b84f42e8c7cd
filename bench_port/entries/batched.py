"""Drive ``engine.stream.batched_chunk_step``: a mixed batch, each stream
with its own filter of one shape, on the per-stream stack of spectra
that ``DeviceScheduler._execute`` builds (``torch.stack`` of each job's
``h_spec``), built once as its placement cache keeps it.  The split
route: kernels 2, 3 and 4 with the engine's own PyTorch ops."""

from __future__ import annotations

import torch

from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.engine.stream import (
    batched_chunk_step,
    init_state,
    stack_states,
)


class Driver:
    def __init__(self, setup):
        banks, assign = setup.banks, setup.assign
        ref = banks[assign[0]]
        self.bank = FilterBank(h_spec=torch.stack([banks[a].h_spec for a in assign]),
                               fragm=ref.fragm, size=ref.size)
        self.states = stack_states([init_state(banks[a], setup.device) for a in assign])
        self.n_valid = torch.full((setup.streams,), setup.blocks * ref.fragm,
                                  dtype=torch.int64, device=setup.device)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One step on ``x`` [S, T, Cin, fragm]; returns y [S, T, Cout, fragm]."""
        self.states, y = batched_chunk_step(self.bank, self.states, x, self.n_valid)
        return y

    def close(self) -> None:
        self.states = None
        self.bank = None
