"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and metrics come from ``BENCHMARK.json``
at the root of the checkout and the files it names under ``perfbench/``
(``perfbench/lib/bench.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
which also end standard error. The run needs as many CUDA devices as the
cell asks for and exits non-zero, printing no result, without them; it also
exits non-zero, after the window, if the JAX package or JAX is loaded in
the process.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_kbs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``nerf_kbs_tpu_torch`` is the port, not the package)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(cfg: dict) -> None:
    """The host sampler's OpenMP thread count from the configuration, and
    every kernel cache inside the checkout, at fixed paths (the port's
    nvcc libraries already go to ``build/`` at the checkout's root)."""
    cache = ROOT / "perfbench" / "cache"
    os.environ["OMP_NUM_THREADS"] = str(cfg["omp_threads"])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench.lib.bench import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    set_environment(bench.config(cell["config"]))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from perfbench.lib import cell as cell_run

    out = cell_run.run(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return 3
    for line in out["notes"]:
        print(line, file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**out["result"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
