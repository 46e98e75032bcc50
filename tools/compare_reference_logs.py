"""Side by side, the logged metrics of reference runs (``metrics.jsonl`` of
the JAX package's runs and of ``tools/reference_runs_torch.sh``): for each
key, one row per step, one column per run, and each run's ratio to the
first run where the key is a loss; then every run's final ``eval_all_*``,
and the mean, sample standard deviation and range of the final
``eval_all_psnr`` of the runs after the first.

    python3 tools/compare_reference_logs.py [--steps 1000,2000] [--keys psnr,rgb_loss] \\
        JAX=outputs/r3sem/sem30k-flagship2/semantic-nerfw/metrics.jsonl \\
        port=outputs/reference_torch_omp1/sem30k-flagship2-s42/sem30k-flagship2/semantic-nerfw/metrics.jsonl

The first run is the reference of the ratios. A run's directory may stand
for its metrics.jsonl when it holds exactly one below it. Reads JSON only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

KEYS = ("psnr", "rgb_loss", "depth_loss", "semantics_loss", "interlevel_loss",
        "distortion_loss", "eval_batch_psnr", "eval_psnr")


def load(path: str) -> list[dict]:
    p = Path(path)
    if p.is_dir():
        found = sorted(p.rglob("metrics.jsonl"))
        if len(found) != 1:
            raise SystemExit(f"{path}: {len(found)} metrics.jsonl files below it")
        p = found[0]
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln.strip()]


def at(lines: list[dict], key: str, step: int):
    """The value of ``key`` logged at ``step`` (the last line that has it)."""
    vals = [ln[key] for ln in lines if ln.get("step") == step and key in ln]
    return vals[-1] if vals else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", help="label=path of a metrics.jsonl or its run directory")
    ap.add_argument("--steps", default="1000,2000,3000,4000,5000")
    ap.add_argument("--keys", default=",".join(KEYS))
    args = ap.parse_args(argv)
    runs = {}
    for item in args.runs:
        label, _, path = item.partition("=")
        runs[label] = load(path)
    steps = [int(s) for s in args.steps.split(",")]
    labels = list(runs)
    for key in args.keys.split(","):
        rows = [(s, [at(runs[lb], key, s) for lb in labels]) for s in steps]
        if not any(v is not None for _, vals in rows for v in vals):
            continue
        ratio = key.endswith("_loss")
        print(f"\n{key}" + (f" (ratio to {labels[0]})" if ratio else ""))
        print("step  " + "  ".join(f"{lb:>20}" for lb in labels))
        for s, vals in rows:
            cells = []
            for v in vals:
                if v is None:
                    cells.append(f"{'-':>20}")
                elif ratio and vals[0]:
                    cells.append(f"{v:>12.7g} ({v / vals[0]:.3f})")
                else:
                    cells.append(f"{v:>20.7g}")
            print(f"{s:<6}" + "  ".join(cells))
    print("\neval_all at each run's last eval_all line")
    psnrs = []
    for lb in labels:
        final = [ln for ln in runs[lb] if "eval_all_psnr" in ln]
        if final:
            f = final[-1]
            print(lb, f["step"], {k: f[k] for k in sorted(f) if k.startswith("eval_all_")})
            psnrs.append(f["eval_all_psnr"])
        else:
            print(lb, "none")
    rest = psnrs[1:] if len(psnrs) == len(labels) else []
    if len(rest) > 1:
        mean = sum(rest) / len(rest)
        sd = (sum((v - mean) ** 2 for v in rest) / (len(rest) - 1)) ** 0.5
        print(f"eval_all_psnr of the runs after {labels[0]}: mean {mean:.3f}, sd {sd:.3f}, "
              f"range {min(rest):.3f} to {max(rest):.3f}; {labels[0]} {psnrs[0]:.3f}")


if __name__ == "__main__":
    main()
