"""Drive ``engine.stream.fused_serving_step_pre``: the scheduler's
steady-state fused step (kernel 1), many streams of one shared filter,
with the carry in the kernel's pre-shaped layout kept across steps."""

from __future__ import annotations

import torch

from folve_tpu_torch.engine.stream import (
    fused_carry_init,
    fused_serving_step_pre,
    fused_serving_supported,
    stage_x_for_fused,
)


class Driver:
    def __init__(self, setup):
        streams, blocks = setup.streams, setup.blocks
        if len(set(setup.assign)) != 1:
            raise ValueError("fused_pre drives one shared filter")
        self.bank = setup.banks[setup.assign[0]]
        if not fused_serving_supported(self.bank, blocks):
            raise ValueError("this filter does not take the fused route")
        self.carry = fused_carry_init(self.bank, streams)
        self.n_valid = torch.full((streams,), blocks * self.bank.fragm,
                                  dtype=torch.int64, device=setup.device)
        self.y_shape = (streams, blocks, self.bank.nout, self.bank.fragm)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One step on ``x`` [S, T, Cin, fragm]; returns y [S, T, Cout, fragm]."""
        self.carry, y5 = fused_serving_step_pre(
            self.bank, self.carry, stage_x_for_fused(self.bank, x), self.n_valid)
        return y5.reshape(self.y_shape)

    def close(self) -> None:
        self.carry = None
