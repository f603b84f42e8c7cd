"""Run one cell of the benchmark of ``folve_tpu_torch`` once, on the card.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress and the compared numbers
with their limits on standard error, and one JSON object as the last
line of standard output.  Exits nonzero, with no result, without a CUDA
card (it never falls back to the CPU), or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches of any compiler the program may use stay inside the checkout, at
# fixed paths; the program's nvcc builds go to its own build/ there.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_port" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_port" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "folve_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port import cells, harness

    cell = cells.find_cell(cells.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    report(out)
    return 0


def report(out: dict) -> None:
    """Progress lines and the compared numbers (last) on standard error,
    then the result as the last line of standard output."""
    from bench_port.harness import log

    res, extra = out["result"], out["extra"]
    log(f"card: {extra['nvidia_smi']}")
    log(f"steps {extra['steps']}, step-time samples {extra['step_samples']}; "
        f"input peaks {extra['peaks']}")
    log(f"bound {extra['bound']}; bytes {extra['bytes']}; operations {extra['ops']}")
    log(f"set-up seconds since start, at the end of each phase: {extra['setup_phases_s']}")
    log(f"memory_peak_bytes {res['device']['memory_peak_bytes']}")
    log(f"streams compared {extra['streams_compared']} in {extra['judge_s']:.3f} s; "
        f"per-stream SNR dB {extra['per_stream_snr_db']}")
    for name, m in res["metrics"].items():
        log(f"metric {name} = {m['value']} {m['unit']}")
    for name, c in res["checks"].items():
        log(f"check {name} = {c['value']} limit {c['limit']} "
            f"{'ok' if extra['checks_ok'][name] else 'FAILED'}")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    sys.exit(main())
