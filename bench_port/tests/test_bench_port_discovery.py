"""``BENCHMARK.json`` and the files it names: every configuration,
traffic mix, entry and metric is found by name, in a file of its own."""

import re

import bench_port_tiny  # noqa: F401
import pytest

from bench_port import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_finds_its_files(name):
    cell = cells.find_cell(BENCH, name)
    assert cell.chips == 1
    assert cell.config["name"] == name.split(".")[0]
    entry = cells.load_entry(cell.traffic["entry"])
    assert hasattr(entry, "Driver")
    assert {m["name"] for m in cell.end_to_end} == {"realtime", "step_p95_ms", "setup_s"}
    assert len(cell.per_layer) == 5


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(cells.load_metric(name).read)


def test_names_units_and_moves():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + METRICS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] == "realtime"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
        assert 0.01 <= m["bound"] <= 0.25
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
    assert units == {"realtime": "audio-s/s", "step_p95_ms": "ms", "setup_s": "s"}


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/configs/")
        assert cells.load_json(cells.ROOT / c["file"])["reduced"] == c["reduced"] == []
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}


def test_a_missing_file_is_an_error_not_a_default():
    with pytest.raises(FileNotFoundError):
        cells.load_metric("no_such_metric")
    with pytest.raises(FileNotFoundError):
        cells.load_traffic("no_such_traffic")
    with pytest.raises(KeyError):
        cells.find_cell(BENCH, "no_such.cell")
