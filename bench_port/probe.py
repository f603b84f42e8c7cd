"""Many runs of the benchmark's cells in one process, for the readings
that set its limits and for rehearsals; not part of a benchmark run.

    python3 bench_port/probe.py --workloads A,B --seeds 1,2,3 --seconds 2 \
        [--trace 1] [--entry control_tf32] [--sync-debug 1] [--out chiprun_out/x.jsonl]

Each (workload, seed) runs as ``run.py`` would run it, after the
kernels are loaded once.  ``--entry`` puts another entry in the
program's place: ``control_tf32`` is the control (the reference on
TF32-rounded operands), whose runs have to read not correct.
``--sync-debug 1`` runs the warm-up steps of each run under
``torch.cuda.set_sync_debug_mode("warn")`` and reports what the step
synchronizes.  One JSON line per run on standard output (and appended
to ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sync_debug_entry(load_entry, caught: list):
    """``load_entry`` whose Driver runs its first ``WARMUP_STEPS`` steps
    under ``torch.cuda.set_sync_debug_mode("warn")``, each warning's
    first line appended to ``caught`` with the step's number."""
    import torch

    from bench_port import harness

    def load(name):
        real = load_entry(name)

        class Driver(real.Driver):
            calls = 0

            def step(self, x):
                k, Driver.calls = Driver.calls, Driver.calls + 1
                if k >= harness.WARMUP_STEPS:
                    return super().step(x)
                with warnings.catch_warnings(record=True) as got:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        return super().step(x)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                        caught.extend((k, str(w.message).splitlines()[0]) for w in got)

        return type("entry", (), {"Driver": Driver})

    return load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--entry", default=None)
    ap.add_argument("--sync-debug", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from bench_port import cells, harness
    from bench_port.run import forbidden_modules

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_benchmark(ROOT)
    real_load = harness.load_entry
    for name in args.workloads.split(","):
        cell = cells.find_cell(bench, name, ROOT)
        if args.entry:
            cell = dataclasses.replace(cell, traffic={**cell.traffic, "entry": args.entry})
        for seed in (int(s) for s in args.seeds.split(",")):
            caught = []
            if args.sync_debug:
                harness.load_entry = sync_debug_entry(real_load, caught)
            t0 = time.perf_counter()
            out = harness.run_cell(cell, seed, args.seconds, bool(args.trace))
            harness.load_entry = real_load
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            line = {"workload": name, "seed": seed, "entry": cell.traffic["entry"],
                    "run_s": time.perf_counter() - t0, **out["result"],
                    "extra": {**out["extra"], "sync_warnings": caught}}
            text = json.dumps(line, default=float)
            print(text, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    bad = forbidden_modules()
    print(json.dumps({"forbidden_modules": bad}), flush=True)
    return 3 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
