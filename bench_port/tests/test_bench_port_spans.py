"""The program's spans, as the benchmark reads them: a tiny traced cell
on the CPU gives the host metrics a number and the device metrics None,
and the benchmark's own reading of a trace is the same with the
program's spans merged into it as without them."""

import shutil

import bench_port_tiny
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import cells, harness
from bench_port.trace import read_chrome
from folve_tpu_torch.engine.filter_bank import compile_filter_bank
from folve_tpu_torch.engine.stream import init_state, serving_chunk_step, stack_states
from folve_tpu_torch.utils import profiling

SEED = 2**31 + 977
HOST = ("engine_host_ms_per_step", "launch_host_ms_per_step")
DEVICE = ("monitor_device_ms_per_step", "state_device_ms_per_step")
CELLS = [("santalucia205k_44k", "bulk_s256_t8"), ("demo65k_44k", "mixed2_s256_t8")]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_a_traced_tiny_cell_reads_the_host_metrics(config, traffic):
    cell = bench_port_tiny.tiny_cell(config, traffic, streams=2, blocks=1)
    out = harness.run_cell(cell, SEED, seconds=0.5, trace=True, device="cpu")
    metrics = out["result"]["metrics"]
    for name in HOST:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms", name
    stats = profiling.span_stats()
    assert stats["engine.step"]["count"] > 0
    assert {k for k in stats if k.startswith("kernel.")} == (
        {"kernel.conv_step_fused"} if traffic.startswith("bulk") else
        {"kernel.fft_real_half", "kernel.fdl_mac_split", "kernel.ifft_ola"})
    # On the CPU the plain versions allocate inside PyTorch's own ops, so
    # no step opens an engine.alloc span; no card, so no device ms.
    assert "engine.alloc" not in stats
    for name in ("alloc_host_ms_per_step",) + DEVICE:
        assert name not in metrics, name
        assert cells.load_metric(name).read({}, None) is None


def test_the_benchmark_reads_the_same_trace_with_the_program_spans_in_it(tmp_path):
    ir = np.random.default_rng(3).standard_normal((2, 2, 1000)).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=256, device="cpu")
    states = stack_states([init_state(bank, "cpu")] * 2)
    x = torch.zeros(2, 1, bank.ninp, bank.fragm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("enqueue"):
                states, _ = serving_chunk_step(bank, states, x, [bank.fragm] * 2)
        with torch.profiler.record_function("tail"):
            states, _ = serving_chunk_step(bank, states, x, [bank.fragm] * 2)
    plain, merged = tmp_path / "plain.json", tmp_path / "merged.json"
    prof.export_chrome_trace(str(plain))
    shutil.copy(plain, merged)
    profiling._merge_spans(str(merged))
    assert "engine.step" in merged.read_text()
    a, b = read_chrome(plain), read_chrome(merged)
    assert [s[0] for s in a.spans] == ["enqueue"] * 3 + ["tail"]
    assert a.spans == b.spans and a.device == b.device
