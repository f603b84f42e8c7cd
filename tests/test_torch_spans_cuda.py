"""The span recorder on the card: device spans time their work with a
CUDA event pair, host spans do not.  Needs a CUDA device and skips
without one; imports no JAX, so it runs on a machine with the card
alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from folve_tpu_torch.engine import stream as ts
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.utils.profiling import span_stats


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the event pairs time the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_time_the_fused_step_and_host_spans_do_not(cuda):
    rng = np.random.default_rng(7)
    fragm, t, s = 1024, 4, 8
    ir = rng.standard_normal((2, 2, 4 * fragm - 3)).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=fragm, device=cuda)
    carry = ts.fused_carry_init(bank, s)
    x5 = ts.stage_x_for_fused(bank, torch.randn(s, t, 2, fragm, device=cuda))
    nv = torch.full((s,), t * fragm, device=cuda)
    carry, _ = ts.fused_serving_step_pre(bank, carry, x5, nv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(5):
            carry, _ = ts.fused_serving_step_pre(bank, carry, x5, nv)
        torch.cuda.synchronize()
    st = span_stats()
    step, kern, mon = st["engine.step"], st["kernel.conv_step_fused"], st["engine.monitor"]
    assert step["count"] == kern["count"] == mon["count"] == 5
    assert 0 < kern["device_ms"] < step["device_ms"] and mon["device_ms"] > 0
    assert step["self_device_ms"] == pytest.approx(
        step["device_ms"] - kern["device_ms"] - mon["device_ms"])
    for host_only in ("engine.prep", "engine.alloc", "engine.state"):
        assert st[host_only]["device_ms"] is None, host_only
        assert st[host_only]["host_ms"] > 0
