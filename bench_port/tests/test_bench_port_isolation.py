"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Top-level module names (the
part before the first dot) are compared whole: ``folve_tpu_torch``
begins with ``folve_tpu`` and is allowed."""

import ast
import json
import subprocess
import sys

import bench_port_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "folve_tpu"}
HERE = bench_port_tiny.ROOT / "bench_port"

_TINY_CELL = f"""
import json, sys
sys.path.insert(0, {str(HERE / 'tests')!r})
import bench_port_tiny
from bench_port import harness
bench_port_tiny.shrink_harness()
out = harness.run_cell(bench_port_tiny.tiny_cell(), 5, seconds=0.3, trace=False, device="cpu")
assert out["result"]["correct"], out["result"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=bench_port_tiny.ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_tiny_cell_loads_neither_jax_nor_the_jax_package():
    tops = _top_levels(_TINY_CELL)
    assert "folve_tpu_torch" in tops  # the program did run
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _top_levels(
        f"import json, sys; sys.path.insert(0, {str(bench_port_tiny.ROOT)!r})\n"
        "from bench_port import reference\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & (FORBIDDEN | {"folve_tpu_torch", "torch"})


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "generator.py", "trace.py", "cells.py"):
        assert "folve_tpu_torch" not in _imports(HERE / name), name
