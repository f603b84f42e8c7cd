"""Find a cell's configuration, traffic mix, entry and metrics by name.

``BENCHMARK.json`` names them; each lives in a file of its own:
``configs/<config>.json`` (the path the configuration's ``file`` gives),
``traffic/<traffic>.json``, ``entries/<entry>.py`` (named by the traffic
mix) and ``metrics/<metric>.py``.  A later cell needs new files and
entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / conf["file"]),
                traffic=load_traffic(w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def _load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """``metrics/<name>.py``: ``read(run, trace)`` gives the value, or
    None where the run has nothing to read."""
    return _load_module("metrics", name)


def load_entry(name: str):
    """``entries/<name>.py``: a ``Driver(banks, assign, streams, blocks,
    device)`` with ``step(x) -> y`` and ``close()``."""
    return _load_module("entries", name)
