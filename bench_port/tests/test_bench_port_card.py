"""``run.py`` as the driver runs it: without a card it exits nonzero and
prints no result; on a card (decided inside the test) it prints a
correct result line."""

import json
import subprocess
import sys

import bench_port_tiny
import pytest
import torch

CMD = [sys.executable, "bench_port/run.py", "--workload",
       "santalucia205k_44k.bulk_s256_t8", "--seed", str(2**31 + 77), "--seconds", "2",
       "--trace", "0"]


def _run():
    return subprocess.run(CMD, capture_output=True, text=True, cwd=bench_port_tiny.ROOT,
                          timeout=1200)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown here")
    proc = _run()
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_runs_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _run()
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
