"""The benchmark's reading of a trace, on a synthetic one."""

import json

import bench_port_tiny  # noqa: F401
import pytest

from bench_port.trace import Trace, is_torch_own, read_chrome, short_name

MS = 1e-3


def _trace():
    # Two steps of 1 ms on the device from t = 0, 0.1 ms idle between
    # them (host in "enqueue"), then the tail, whose records after its
    # first span are not the stretch's.
    device = [
        ("void (anonymous namespace)::mac_kernel<128, 128>(Args)", "kernel", 0.0, 0.8 * MS),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 0.8 * MS, 1.0 * MS),
        ("mac_kernel", "kernel", 1.1 * MS, 1.9 * MS),
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1.9 * MS, 2.1 * MS),
        ("mac_kernel", "kernel", 2.3 * MS, 3.0 * MS),  # the tail's
    ]
    spans = [("enqueue", -0.1 * MS, 0.0), ("enqueue", 0.95 * MS, 1.15 * MS),
             ("wait", 1.2 * MS, 2.1 * MS), ("tail", 2.2 * MS, 2.4 * MS)]
    return Trace(device=device, spans=spans)


def test_window_ends_where_the_tail_begins():
    tr = _trace()
    assert tr.steps == 2
    assert tr.window == pytest.approx((-0.1 * MS, 2.2 * MS))
    assert tr.busy_s == pytest.approx(1.0 * MS + 1.0 * MS)
    assert tr.device_s(torch_own=False) == pytest.approx(1.6 * MS)
    assert tr.device_s(torch_own=True) == pytest.approx(0.4 * MS)


def test_idle_gaps_are_labelled_by_the_open_host_span_and_include_the_end():
    gaps = sorted(_trace().idle_gaps(), key=lambda g: -g[1])
    assert [g[0] for g in gaps] == ["enqueue", "enqueue", "host"]
    assert [g[1] for g in gaps] == pytest.approx([0.1 * MS, 0.1 * MS, 0.1 * MS])


def test_breakdown_names_and_classes():
    b = _trace().breakdown()
    names = dict(b["device_ops"])
    assert names["mac_kernel"] == pytest.approx(1.6 * MS)
    assert "at::native::vectorized_elementwise_kernel" in names
    assert is_torch_own("Memset (Device)", "gpu_memset")
    assert is_torch_own("void at::native::reduce_kernel<512, 1>(x)", "kernel")
    assert not is_torch_own("void flat::mac_kernel(x)", "kernel")
    assert short_name("(anonymous namespace)::forward_kernel<128, 128>(A, B)") == "forward_kernel"


def test_read_chrome_keeps_device_work_and_the_benchmark_spans(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "enqueue", "ts": 10.0, "dur": 9.0},
          {"ph": "X", "cat": "user_annotation", "name": "enqueue", "ts": 8.0, "dur": 3.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 8.0, "dur": 1.0},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = read_chrome(path)
    assert tr.device == [("k", "kernel", pytest.approx(10e-6), pytest.approx(15e-6))]
    assert tr.spans == [("enqueue", pytest.approx(8e-6), pytest.approx(11e-6))]


@pytest.mark.parametrize("host_in", ["wait", "enqueue"])
def test_a_run_of_lost_records_is_cut_out(host_in):
    """The device cannot idle while the host waits for a queued step, nor
    while the host issues step after step: such a gap over 1 ms is lost
    records, and the longest stretch between them is analysed.  The
    records of steps 2 to 4 are lost, the host in a ``wait`` or in an
    ``enqueue`` span when they stop."""
    lead = 0.5 if host_in == "wait" else 0.05  # enqueue [k - lead, k - lead + 0.1)
    device, spans = [], []
    for k in range(10):  # steps of 1 ms, back to back, enqueued ahead
        spans += [("enqueue", (k - lead) * MS, (k - lead + 0.1) * MS),
                  ("wait", (k - lead + 0.1) * MS, (k + 1 - lead) * MS)]
        if not 2 <= k <= 4:
            device.append(("mac_kernel", "kernel", k * MS, (k + 1) * MS))
    tr = Trace(device=device, spans=spans)
    assert tr.lost == [pytest.approx((2 * MS, 5 * MS))]
    w0, w1 = tr.window
    assert (w0, w1) == pytest.approx((5 * MS, 10 * MS))
    # Steps count by their enqueue: after a cut the host is ahead of the
    # device by the steps in flight (up to ``ahead`` in a run).
    assert tr.steps == 4
    assert tr.busy_s == pytest.approx(5 * MS)
    assert tr.device_s(torch_own=False) == pytest.approx(5 * MS)
    assert tr.idle_gaps() == []


def test_a_host_stall_inside_one_call_stays_an_idle_gap():
    """The host stuck 3 ms inside one ``enqueue``: the device runs dry
    once the queued step ends, and that idle is real."""
    device = [("mac_kernel", "kernel", 0.0, 1 * MS), ("mac_kernel", "kernel", 4.1 * MS, 5 * MS)]
    spans = [("enqueue", -0.2 * MS, -0.1 * MS), ("enqueue", 0.9 * MS, 4.0 * MS),
             ("wait", 4.0 * MS, 4.05 * MS), ("enqueue", 4.05 * MS, 4.1 * MS)]
    tr = Trace(device=device, spans=spans)
    assert tr.lost == []
    assert tr.window == pytest.approx((-0.2 * MS, 5 * MS))
    assert ("enqueue", pytest.approx(3.1 * MS)) in tr.idle_gaps()
