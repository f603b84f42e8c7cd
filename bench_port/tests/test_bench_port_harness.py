"""The harness end to end at a tiny shape on the CPU: its JSON last line,
the output check, the control through the harness's own ``correct``, and
``correct`` false under each fault a cell can have."""

import dataclasses
import json

import bench_port_tiny
import numpy as np
import pytest
import torch

from bench_port import cells, harness
from bench_port.run import report

SEED = 2**31 + 4321


def _run(cell, seconds=0.4, **kw):
    return harness.run_cell(cell, SEED, seconds=seconds, trace=kw.pop("trace", False),
                            device="cpu", **kw)


@pytest.mark.parametrize("config,traffic", [("santalucia205k_44k", "bulk_s256_t8"),
                                            ("demo65k_44k", "mixed2_s256_t8")])
def test_result_line(config, traffic, capsys):
    out = _run(bench_port_tiny.tiny_cell(config, traffic, streams=2, blocks=1), seconds=1.0)
    report(out)
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    # The 95th percentile needs 200 step times; a slow CPU may give fewer.
    want = {"realtime", "setup_s"} | ({"step_p95_ms"} if out["extra"]["step_samples"] >= 200
                                      else set())
    assert set(line["metrics"]) == want
    assert line["metrics"]["realtime"]["unit"] == "audio-s/s"
    assert line["checks"]["snr_db"]["value"] < -110
    assert line["checks"]["snr_db"]["limit"] == -90.0
    assert cap.err.strip().splitlines()[-1].startswith("bench_port: check snr_db")
    assert line["attempted"] == out["extra"]["steps"] * 2


def test_step_p95_needs_ten_samples_beyond_it():
    read = cells.load_metric("step_p95_ms").read
    assert read({"step_ms": [1.0] * 199}, None) is None
    assert read({"step_ms": [1.0] * 190 + [2.0] * 10}, None) == pytest.approx(1.05)


def test_trace_run_reports_per_layer_only():
    out = _run(bench_port_tiny.tiny_cell(), trace=True)
    res = out["result"]
    # No device here: only the host span's metric has something to read.
    assert set(res["metrics"]) <= {m["name"] for m in cells.load_benchmark()["per_layer"]}
    assert "enqueue_ms_per_step" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["correct"] is True


def test_mixed_cell_compares_streams_of_both_filters():
    out = _run(bench_port_tiny.tiny_cell("demo65k_44k", "mixed2_s256_t8"))
    idx = out["extra"]["streams_compared"]
    assert {s % 2 for s in idx} == {0, 1}


@pytest.mark.parametrize("config,traffic", [("demo65k_44k", "bulk_s256_t8"),
                                            ("demo65k_44k", "mixed2_s256_t8"),
                                            ("santalucia205k_44k", "live_s256_t1")])
def test_control_fails_the_limit_where_the_program_passes(config, traffic):
    """The control (``entries/control_tf32.py``: the reference on TF32
    operands) in the program's place reads not correct, by the output
    check alone; the program on the same seed reads correct."""
    cell = bench_port_tiny.tiny_cell(config, traffic)
    limit = cell.config["snr_limit_db"]
    prog = _run(cell)["result"]
    assert prog["correct"] is True
    assert prog["checks"]["snr_db"]["value"] < limit - 20
    ctl = dataclasses.replace(cell, traffic={**cell.traffic, "entry": "control_tf32"})
    res = _run(ctl)["result"]
    assert res["correct"] is False
    assert res["failed"] > 0
    assert limit < res["checks"]["snr_db"]["value"] < -40


def test_control_without_rounding_is_the_reference(monkeypatch):
    """With its rounding taken out, the control's carried overlap-save
    agrees with the reference far below the limit: what fails it is
    TF32 alone."""
    entry = cells.load_entry("control_tf32")
    monkeypatch.setattr(entry, "tf32", lambda x: x)
    monkeypatch.setattr(harness, "load_entry", lambda name: entry)
    cell = bench_port_tiny.tiny_cell("demo65k_44k", "mixed2_s256_t8")
    out = _run(cell)["result"]
    assert out["correct"] is True
    assert out["checks"]["snr_db"]["value"] < -140  # float32 output: about -150 dB


def test_control_rounds_as_the_reference_does():
    from bench_port import reference

    tf32 = cells.load_entry("control_tf32").tf32
    x = np.random.default_rng(3).standard_normal(10000).astype(np.float32)
    x[:4] = [1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0, 0.0]
    np.testing.assert_array_equal(tf32(torch.from_numpy(x)).numpy(), reference.tf32(x))


class _Faulty:
    """An entry whose step is broken underneath the harness."""

    def __init__(self, fault):
        self.fault = fault

    def load(self, name):
        real = cells.load_entry(name)
        fault = self.fault

        class Driver(real.Driver):
            def step(self, x):
                if fault == "state_unchanged":
                    keep = dict(vars(self))
                    y = super().step(x)
                    vars(self).update(keep)
                    return y
                y = super().step(x).clone()
                if fault == "half_batch":
                    y[y.shape[0] // 2:] = 0.0
                elif fault == "answer_altered":
                    y[:, 0, 0, 100] += 0.25
                return y

        return type("entry", (), {"Driver": Driver})


@pytest.mark.parametrize("traffic", ["bulk_s256_t8", "mixed2_s256_t8"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_each_fault_reads_incorrect(fault, traffic, monkeypatch):
    config = "demo65k_44k" if traffic.startswith("mixed") else "santalucia205k_44k"
    monkeypatch.setattr(harness, "load_entry", _Faulty(fault).load)
    out = _run(bench_port_tiny.tiny_cell(config, traffic))
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["snr_db"]["value"] > -90.0


def test_route_check_counts_launches_per_step():
    """On a card the traffic's launches per step are compared exactly; a
    route that skipped its kernel reads as not correct."""
    per = bench_port_tiny.tiny_cell().traffic["launches_per_step"]
    zero = {k: 0 for k in per}
    good = harness.route_checks({"launches_per_step": per}, zero,
                                {k: 5 * v for k, v in per.items()}, steps=5)
    assert all(c["ok"] for c in good.values())
    assert good["conv_step_fused_per_step"]["value"] == 1.0
    bad = harness.route_checks({"launches_per_step": per}, zero, zero, steps=5)
    assert not bad["conv_step_fused_per_step"]["ok"]
    assert bad["fdl_mac_split_per_step"]["ok"]


def test_sampled_streams_follow_the_seed():
    assign = [s % 2 for s in range(256)]
    a = harness.sample_streams(assign, 16, 11)
    assert a == harness.sample_streams(assign, 16, 11)
    assert a != harness.sample_streams(assign, 16, 12)
    assert sum(s % 2 for s in a) == 8 and len(set(a)) == 16


def test_ring_is_reproducible_and_below_full_scale():
    sig = cells.load_traffic("bulk_s256_t8")["signal"]
    from bench_port import generator

    a, peaks = generator.make_ring(sig, 2, 3, 2, 2, 256, 44100, 99, "cpu")
    b, _ = generator.make_ring(sig, 2, 3, 2, 2, 256, 44100, 99, "cpu")
    c, _ = generator.make_ring(sig, 2, 3, 2, 2, 256, 44100, 98, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert max(peaks) < 0.6 and min(peaks) > 0.05
    assert generator.sub_seed(2**33, 1) == generator.sub_seed(2**33, 1) < 2**63
