"""The readings that a cell's correctness limits are set from, on the card,
at the cell's own size, in one process:

- the program's numbers on each seed (sound runs: the program as the
  configuration states it, from fresh weights, optimizer state, batches
  and jitter of that seed);
- the control's on each seed: the reference with its products rounded to
  float8 e4m3 put in the program's place;
- each planted fault's (``lib/faults.py``) on the first seeds.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--control 1] [--faults unchanged,half,answer] [--fault-seeds 3]

Prints one JSON line a reading. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.lib.bench import Bench
    from perfbench.run import set_environment

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    set_environment(bench.config(cell["config"]))
    from perfbench.lib import readings

    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for rec in readings.run(bench, args.workload, seeds, bool(args.control), faults,
                            args.fault_seeds, args.device):
        rec["t"] = time.time()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
