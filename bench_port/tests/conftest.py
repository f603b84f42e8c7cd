import bench_port_tiny
import pytest


@pytest.fixture(autouse=True)
def tiny_harness(monkeypatch):
    bench_port_tiny.shrink_harness(monkeypatch.setattr)
