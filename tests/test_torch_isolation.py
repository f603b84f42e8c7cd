"""The port stands alone: no module of folve_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; default-device entry
points raise without a card; chip_smoke.py fails without a card and
outside the repository."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "folve_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "folve_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_folve_tpu(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_package_module_was_checked():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("folve_tpu_torch/engine/stream.py",
                 "folve_tpu_torch/runtime/scheduler.py",
                 "folve_tpu_torch/engine/kernels/conv_step.py",
                 "folve_tpu_torch/parallel/__init__.py",
                 "folve_tpu_torch/parallel/serving.py", "chip_smoke.py",
                 "folve_tpu_torch/runtime/filesystem.py",
                 "folve_tpu_torch/runtime/handler.py",
                 "folve_tpu_torch/runtime/pool.py",
                 "folve_tpu_torch/filters/spectra_cache.py",
                 "folve_tpu_torch/audio/flac.py",
                 "folve_tpu_torch/utils/native_build.py"):
        assert must in names


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_default_device_entry_points_raise_without_card(no_card, tmp_path):
    from folve_tpu_torch.engine import compile_filter_bank, init_state
    from folve_tpu_torch.entry import entry
    from folve_tpu_torch.filters import compile_config_file
    from folve_tpu_torch.filters.spectra_cache import compile_with_cache
    from folve_tpu_torch.parallel import make_serving_mesh
    from folve_tpu_torch.runtime import (
        DeviceScheduler,
        FolveFilesystem,
        ProcessorPool,
        SoundProcessor,
    )

    ir = np.ones((1, 1, 64), np.float32)
    cfg = tmp_path / "f.conf"
    cfg.write_text("/convolver/new 1 1 64 64\n/impulse/dirac 1 1 1 0\n")
    bank = compile_filter_bank(ir, device="cpu")
    for call in (lambda: compile_filter_bank(ir), lambda: init_state(bank),
                 lambda: DeviceScheduler(), entry, make_serving_mesh,
                 lambda: compile_config_file(str(cfg), 44100),
                 lambda: SoundProcessor.create(str(cfg), 44100, 1),
                 FolveFilesystem, ProcessorPool,
                 lambda: compile_with_cache(str(cfg), 44100)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _run_chip_smoke(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card(no_card):
    res = _run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = _run_chip_smoke(tmp_path, {"PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
