"""The step's bound against counts made by hand for cells 1 and 3."""

import bench_port_tiny  # noqa: F401  (puts the repository on sys.path)
import pytest

from bench_port.roofline import PEAK_BYTES, PEAK_FP32, Step, fft_ops

K = 8193  # n/2 + 1 bins of a 16,384-point real transform
SPEC = 2 * 4 * K  # one complex spectrum of float32


def test_cell1_santalucia_bulk_t8():
    s = Step(streams=256, blocks=8, partitions=25, cin=2, cout=2, fragm=8192)
    parts = s.byte_parts()
    assert parts["x"] == 256 * 8 * 2 * 8192 * 4 == 134_217_728
    assert parts["y"] == 134_217_728
    assert parts["history_read"] == 256 * 24 * 2 * SPEC
    assert parts["history_written"] == 256 * 8 * 2 * SPEC
    assert parts["tail"] == 2 * 256 * 2 * 8192 * 4
    assert parts["filter_spectra"] == 25 * 2 * 2 * SPEC
    assert s.bytes == pytest.approx(1_382_417_184)
    ops = s.op_parts()
    assert ops["mac"] == 8 * 256 * 8 * 25 * 2 * 2 * K
    assert ops["fft"] == 256 * 8 * 4 * 2.5 * 16384 * 14
    b = s.bound()
    assert b["bound_by"] == "bytes"
    assert b["bytes_ms"] == pytest.approx(1e3 * 1_382_417_184 / 3.35e12)
    assert b["bound_ms"] == pytest.approx(0.41266, rel=1e-4)
    assert b["ops_ms"] == pytest.approx(1e3 * (ops["mac"] + ops["fft"]) / 67e12)


def test_cell3_santalucia_live_t1():
    s = Step(streams=256, blocks=1, partitions=25, cin=2, cout=2, fragm=8192)
    parts = s.byte_parts()
    assert parts["history_read"] == 256 * 24 * 2 * SPEC
    assert parts["history_written"] == 256 * 1 * 2 * SPEC  # min(T, P-1) = 1 row
    assert parts["x"] == parts["y"] == 256 * 1 * 2 * 8192 * 4
    assert s.bytes == pytest.approx(912_626_464)
    assert s.flops == pytest.approx(8 * 256 * 25 * 4 * K + 256 * 4 * fft_ops(16384))
    b = s.bound()
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(1e3 * 912_626_464 / PEAK_BYTES)
    assert b["ops_ms"] == pytest.approx(1e3 * s.flops / PEAK_FP32)


def test_history_written_caps_at_p_minus_1_and_filters_count_once_each():
    s = Step(streams=2, blocks=32, partitions=8, cin=2, cout=2, fragm=8192, filters=2)
    assert s.byte_parts()["history_written"] == 2 * 7 * 2 * SPEC
    assert s.byte_parts()["filter_spectra"] == 2 * 8 * 4 * SPEC


def test_fft_ops_is_the_textbook_count():
    assert fft_ops(16384) == 2.5 * 16384 * 14
