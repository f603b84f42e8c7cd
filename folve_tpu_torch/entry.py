"""Entry points as in ``__graft_entry__``: :func:`entry`, the flagship
configuration (131,072-tap stereo partitioned convolution, batched
serving of S = 8 streams x T = 8 blocks, BASELINE config 5, weights from
a seed), and :func:`dryrun_multichip`, the sharded serving step on a
mesh that repeats one device."""

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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded serving step (stream-data-parallel x
    frequency-parallel) on a mesh of ``n_devices`` entries, all of them
    ``device``, at tiny shapes, then the :class:`DeviceScheduler` on the
    same mesh over chained steps (so its on-mesh state gather runs), and
    hold it within 1e-5 of the single-device engine step.  On a card the
    shards run the row-window FFT kernels."""
    from folve_tpu_torch.engine.stream import chunk_step
    from folve_tpu_torch.parallel.serving import (
        make_serving_mesh,
        make_sharded_serving_step,
        shard_states_and_bank,
    )
    from folve_tpu_torch.runtime.scheduler import (
        DeviceScheduler,
        ShardedStateRef,
    )

    dev = resolve_device(device)
    freq = 2 if n_devices % 2 == 0 else 1
    mesh = make_serving_mesh(n_devices, freq_parallel=freq,
                             devices=[dev] * n_devices)
    fragm, size = 128, 512
    s = n_devices  # one stream per device is the minimum batch
    t = 2
    rng = np.random.default_rng(1)
    banks = []
    for _ in range(s):
        ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
        # Half-spectrum layout (the engine default) shards by k1 rows too.
        banks.append(compile_filter_bank(ir, fragm=fragm, size=size,
                                         device=dev))
    h_spec = torch.stack([b.h_spec for b in banks])
    st0 = init_state(banks[0], device=dev)
    z = lambda a: torch.zeros((s,) + tuple(a.shape), device=dev)
    x = rng.standard_normal((s, t, 2, fragm)).astype(np.float32)
    n_valid = np.full((s,), t * fragm, np.int64)
    step = make_sharded_serving_step(mesh, fragm)
    *_, y = step(*shard_states_and_bank(
        mesh, h_spec, z(st0.hist_re), z(st0.hist_im), z(st0.tail),
        torch.zeros(s, device=dev), x, n_valid))
    if tuple(y.gather().shape) != (s, t, 2, fragm):
        raise AssertionError(f"sharded step output {tuple(y.gather().shape)}")

    # The scheduler on the same mesh: mixed filters, chained steps so the
    # on-mesh ShardedStateRef gather runs, against the engine step.
    sched = DeviceScheduler(max_batch=s, window_s=0.05, device=dev,
                            mesh=mesh)
    sched.start()
    states = [init_state(b, device=dev) for b in banks]
    xs = rng.standard_normal((3, s, t, 2, fragm)).astype(np.float32)
    got = [[] for _ in range(s)]
    try:
        for r in range(xs.shape[0]):
            futs = [sched.submit(banks[i], states[i], xs[r, i], t * fragm)
                    for i in range(s)]
            for i, fut in enumerate(futs):
                states[i], y_i = fut.result(timeout=120)
                got[i].append(y_i.cpu().numpy())
        if not any(isinstance(st, ShardedStateRef) for st in states):
            raise AssertionError("on-mesh state path never engaged")
        if sched.sharded_steps == 0:
            raise AssertionError("no sharded step ran")
    finally:
        sched.stop()
    for i in range(s):
        st = init_state(banks[i], device=dev)
        for r in range(xs.shape[0]):
            st, ref = chunk_step(banks[i], st, xs[r, i], t * fragm)
            np.testing.assert_allclose(
                got[i][r], ref.cpu().numpy(), atol=1e-5,
                err_msg=f"scheduler output diverges (stream {i}, step {r})")
