"""Entry point on the flagship configuration, as ``__graft_entry__.entry``:
131,072-tap stereo partitioned convolution, batched serving of S = 8
streams x T = 8 blocks (BASELINE config 5), weights from a seed."""

from __future__ import annotations

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.engine.stream import (
    init_state,
    serving_chunk_step,
    stack_states,
)


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` runs one serving step; on CUDA it
    goes through the fused conv-step kernel."""
    dev = resolve_device(device)
    size = 131072
    rng = np.random.default_rng(0)
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / np.sqrt(size)
    bank = compile_filter_bank(ir, device=dev)  # fragm 8192, P = 16
    s, t = 8, 8
    states = stack_states([init_state(bank, device=dev) for _ in range(s)])
    x = torch.from_numpy(
        rng.standard_normal((s, t, 2, bank.fragm)).astype(np.float32)).to(dev)
    n_valid = torch.full((s,), t * bank.fragm, dtype=torch.int32, device=dev)

    def fn(bank, states, x, n_valid):
        return serving_chunk_step(bank, states, x, n_valid)

    return fn, (bank, states, x, n_valid)
