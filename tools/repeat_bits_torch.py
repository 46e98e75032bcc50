"""Where two training runs of the port from one seed part, on the card.

    OMP_NUM_THREADS=1 python3 tools/repeat_bits_torch.py OUT.json \\
        [--paths ilf050,sem30k-flagship2,run1,run2,run3,run7,run8] [--steps 20] [--diagnose]
    OMP_NUM_THREADS=1 python3 tools/repeat_bits_torch.py OUT.json --paths raft,segmenter,inpaint --steps 3
    python3 tools/repeat_bits_torch.py --compare-checksums A.json B.json

Writes chip_smoke.py's 8-frame 376x1241 street scene, then trains each path
(chip_smoke.repeat_trainer: the two reference protocols at full width and
16,384 rays, runs 1, 2, 3 and 7 at the smoke's 4,096 rays; run 8, the SUDS
stream, built here as the smoke's phase stream builds it; or the
preprocessing trainers, chip_smoke.preprocess_trainers, each a step) three times from
one seed: twice in this process and once in a child process. After every
step it compares every parameter group's parameters and Adam moments
(chip_smoke.state_checksums) and every logged loss, and at the end every
parameter and moment bit for bit. OUT.json gets, per path, the first step
at which each repeat parts from the first run and the groups and losses
that part there (null when none), each run's losses, and the first run's
checksums after every step (to compare two trees: ``--compare-checksums``).

``--compare-logs A B`` instead compares two runs' ``metrics.jsonl`` line for
line in every field but the time and rate ones (``is_time``) and prints the
lines and fields that differ (exit code 1 when any does).

``--compare-checksums A B`` compares two OUT.json files path by path,
step by step (chip_smoke.first_divergence on their first runs) and prints
where they part (exit code 1 when any path does).

``--diagnose`` also runs one step of each path in a child process under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and anomaly detection: every warning of
an operation that PyTorch knows to be nondeterministic, and every op that
sums into shared targets (SUMMING_OPS), with the port's source line of the
forward call that recorded it (a diagnostic only: the mode changes which
kernels run). The OpenMP thread count is pinned to one,
as the host sampler's draw depends on it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# aten ops that sum floats into shared targets, by how their CUDA kernels add
# outside the deterministic mode (index_put only with accumulate): the mode
# itself warns of none of these, it switches them to other kernels
SUMMING_OPS = {"scatter_add": "atomic adds on CUDA", "index_add": "atomic adds on CUDA",
               "scatter_reduce": "atomic adds on CUDA", "put_": "atomic adds on CUDA",
               "index_put": "sorted, then a run per index on CUDA (no atomics)"}
# metrics.jsonl fields that carry the host's time or rate, not the run's state


def is_time(key: str) -> bool:
    return key.endswith(("_s", "_sec", "_seconds", "_ms")) or "time" in key
PATHS = ("ilf050", "sem30k-flagship2", "run1", "run2", "run3", "run7", "run8")
# the preprocessing trainers (chip_smoke.preprocess_trainers, chip_smoke.trainer_record)
TRAINERS = ("raft", "segmenter", "inpaint")


def build(path: str, scene: str, out: str):
    """(trainer, close): the path's Trainer and what ends its datamanager."""
    if path != "run8":
        return cs.repeat_trainer(path, scene, out), lambda: None
    import dataclasses

    from nerf_kbs_tpu_torch.data.dataparsers.suds_metadata import SudsMetadataConfig
    from nerf_kbs_tpu_torch.data.stream import ChunkedStreamDataManager, StreamConfig
    from nerf_kbs_tpu_torch.engine.trainer import Trainer
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method

    parser = SudsMetadataConfig(metadata_path=cs._write_suds_metadata(scene))
    train, _ = parser.load_items("train")
    val, _ = parser.load_items("val")
    spec = nerfacto_tpu_method()
    mcfg = dataclasses.replace(spec.model_config(), num_images=len(train), flow_loss_mult=1e-3,
                               sky_loss_mult=0.1)
    tcfg = dataclasses.replace(spec.trainer, output_dir=out, method_name="nerfacto-tpu-stream")
    dm = ChunkedStreamDataManager(train, val, StreamConfig(
        load_random_subset=True, items_per_chunk=65536, with_flow=True, with_sky=True,
        train_num_rays_per_batch=4096))
    return Trainer(tcfg, mcfg, spec.optimizers, dm), dm.close


def run(path: str, scene: str, steps: int) -> tuple[list, list, float]:
    """(train_record, final_state, seconds) of one run of ``path``."""
    import torch

    if path in TRAINERS:
        t0 = time.perf_counter()
        rec, final = cs.trainer_record(path, steps)
        return rec, final, time.perf_counter() - t0
    trainer, close = build(path, scene, tempfile.mkdtemp(prefix=f"nkt_repeat_{path}_"))
    try:
        t0 = time.perf_counter()
        rec = cs.train_record(trainer, steps)
        seconds = time.perf_counter() - t0
        return rec, cs.final_state(trainer), seconds
    finally:
        close()
        del trainer
        torch.cuda.empty_cache()


def child(path: str, scene: str, steps: int, out: str) -> int:
    import torch

    rec, final, seconds = run(path, scene, steps)
    torch.save(final, out + ".pt")
    Path(out).write_text(json.dumps({"record": rec, "seconds": seconds}))
    return 0


def diagnose(paths: list, scene: str, out: str) -> int:
    """One step of each path under the deterministic-algorithms mode with
    warn_only: every operation that warns or sums into shared targets
    (SUMMING_OPS), with the innermost frame of the
    port in the forward call of the autograd node that ran it (anomaly
    detection keeps those), or in the Python stack for a forward op."""
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    found: dict = {}
    current = [None]

    def port_frame() -> tuple[str, str]:
        node = torch._C._current_autograd_node()
        if node is not None:
            tb = node.metadata.get("traceback_", [])
            text = "".join(tb) if isinstance(tb, list) else str(tb)
            where = f"backward ({node.name()})"
        else:
            text = "".join(traceback.format_stack())
            where = "forward"
        frames = [ln.strip() for ln in text.splitlines()
                  if ln.strip().startswith("File") and "nerf_kbs_tpu_torch" in ln]
        return where, frames[-1] if frames else ""

    class Warned(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = func(*args, **(kwargs or {}))
            msgs = [str(w.message).split(" does not")[0] for w in caught
                    if "deterministic" in str(w.message)]
            # and the ops that sum into shared targets, warned or not
            kind = [v for k, v in SUMMING_OPS.items() if k in str(func)]
            if not msgs and kind and ("index_put" not in str(func)
                                      or (kwargs or {}).get("accumulate")
                                      or (len(args) > 3 and args[3])):
                msgs = [f"(sums: {kind[0]})"]
            for m in msgs:
                key = (str(func), m, *port_frame())
                found.setdefault(key, set()).add(current[0])
            return result

    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.autograd.set_detect_anomaly(True, check_nan=False), Warned():
        for path in paths:
            current[0] = path
            run(path, scene, 1)
    Path(out).write_text(json.dumps([
        {"op": op, "warns": name, "where": where, "port_frame": frame, "paths": sorted(ps)}
        for (op, name, where, frame), ps in found.items()], indent=1))
    return 0


def compare_logs(a: str, b: str) -> int:
    la, lb = ([json.loads(ln) for ln in Path(p).read_text().splitlines() if ln.strip()]
              for p in (a, b))
    differ = []
    for i, (x, y) in enumerate(zip(la, lb)):
        keys = [k for k in sorted(set(x) | set(y))
                if not is_time(k) and x.get(k) != y.get(k)]
        if keys:
            differ.append({"line": i + 1, "step": x.get("step"),
                           "fields": {k: [x.get(k), y.get(k)] for k in keys}})
    compared = sorted({k for ln in la for k in ln if not is_time(k)})
    print(json.dumps({"lines": [len(la), len(lb)], "fields_compared": compared,
                      "lines_that_differ": len(differ), "first": differ[:5]}))
    return int(bool(differ) or len(la) != len(lb))


def compare_checksums(a: str, b: str) -> int:
    ra, rb = (json.loads(Path(p).read_text())["paths"] for p in (a, b))
    out = {}
    for path in sorted(set(ra) & set(rb)):
        out[path] = {"steps": [len(ra[path]["checksums"]), len(rb[path]["checksums"])],
                     "first_divergence": cs.first_divergence(
                         [{"state": c, "losses": x} for c, x in zip(ra[path]["checksums"],
                                                                  ra[path]["losses"][0])],
                         [{"state": c, "losses": x} for c, x in zip(rb[path]["checksums"],
                                                                  rb[path]["losses"][0])])}
    print(json.dumps(out))
    return int(any(v["first_divergence"] is not None for v in out.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_bits_torch: CUDA is not available")
    import nerf_kbs_tpu_torch  # noqa: F401  (sets allow_tf32 = False)

    paths = args.paths.split(",")
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(),
        "omp_num_threads": os.environ["OMP_NUM_THREADS"], "steps": args.steps, "paths": {}}
    with tempfile.TemporaryDirectory(prefix="nkt_repeat_") as tmp:
        scene = cs.phase_scene(tmp)
        for path in paths:
            first, final_a, sec_a = run(path, scene, args.steps)
            second, final_b, sec_b = run(path, scene, args.steps)
            out = str(Path(tmp) / f"{path}.json")
            subprocess.run([sys.executable, __file__, "--child", path, scene, str(args.steps),
                            out], check=True)
            third = json.loads(Path(out).read_text())
            final_c = torch.load(out + ".pt")
            res = {"seconds": [sec_a, sec_b, third["seconds"]]}
            for name, rec, final in (("same_process", second, final_b),
                                     ("second_process", third["record"], final_c)):
                res[name] = {"first_divergence": cs.first_divergence(first, rec),
                             "final_state_bit_identical": all(
                                 torch.equal(x, y) for x, y in zip(final_a, final))}
            res["losses"] = [[r["losses"] for r in first], [r["losses"] for r in second],
                             [r["losses"] for r in third["record"]]]
            res["checksums"] = [r["state"] for r in first]  # the first run's, step by step
            result["paths"][path] = res
            print(json.dumps({"path": path, **{k: v for k, v in res.items() if k != "losses"}}),
                  flush=True)
        if args.diagnose:
            out = str(Path(tmp) / "diagnose.json")
            env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
            subprocess.run([sys.executable, __file__, "--diagnose-child", ",".join(paths), scene,
                            out], check=True, env=env)
            result["diagnose"] = json.loads(Path(out).read_text())
            print(json.dumps({"diagnose": result["diagnose"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    # before torch and the host sampler load their OpenMP runtime
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--compare-logs"]:
        sys.exit(compare_logs(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--compare-checksums"]:
        sys.exit(compare_checksums(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--diagnose-child"]:
        sys.exit(diagnose(sys.argv[2].split(","), sys.argv[3], sys.argv[4]))
    sys.exit(main())
