"""Tiny cells for the benchmark's CPU tests: the real configurations and
traffic mixes, cut to a few streams and a short response (P = 3 at
fragm 8192), run through the harness on the CPU with its policy cut
down (``HARNESS``, set by ``conftest.py`` or :func:`shrink_harness`)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import cells  # noqa: E402

MAXSIZE = 20000
HARNESS = {"RING": 3, "AHEAD": 2, "WARMUP_STEPS": 1, "SAMPLE_STREAMS": 4}


def shrink_harness(setattr_=setattr) -> None:
    """Cut the harness's ring, run-ahead, warm-up and sample to ``HARNESS``."""
    from bench_port import harness

    for k, v in HARNESS.items():
        setattr_(harness, k, v)


def tiny_cell(config: str = "santalucia205k_44k", traffic: str = "bulk_s256_t8",
              streams: int = 4, blocks: int = 2) -> cells.Cell:
    cfg = cells.load_json(cells.HERE / "configs" / f"{config}.json")
    for f in cfg["filters"]:
        f["convolver"]["maxsize"] = MAXSIZE
        f["ir"]["taps"] = min(f["ir"]["taps"], MAXSIZE - 100)
    trf = cells.load_traffic(traffic)
    trf.update(streams=streams, blocks=blocks)
    bench = cells.load_benchmark()
    return cells.Cell(name=f"{config}.{traffic}", chips=1, config=cfg, traffic=trf,
                      end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
