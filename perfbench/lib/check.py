"""Whether the timed path trains correctly: the program's first steps held
against the plain reference (``perfbench/reference/nerf.py``).

Set-up makes the initial weights from the seed (``reference.init_params``)
and loads them into the program, then drives the program's trainer through
its first ``CHECK_STEPS`` steps with the window's own call and feed; those
steps' batches and jitters, the loss each step returned, Adam's first
moment after the first step and the weights after the last are kept. After
the window, with the program freed, the reference runs the same steps from
the same weights, batches and jitters. Three numbers are compared, each
with its limit from ``checks/<cell>.json``:

- ``loss_gap``: the largest relative gap between a step's total loss and
  the reference's;
- ``grad_gap_worst_leaf``: the first step's gradient as the optimizer
  takes it (Adam's first moment after one step, / (1 - beta1)), by the
  worst leaf: the gap between the program's norm and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap_median_leaf``: the change of the weights over the checked
  steps, by the median leaf: the median over the leaves of the gap between
  the program's norm of a leaf's change and the reference's, over the
  reference's. Leaves whose reference gradient is under a thousandth of the
  median leaf's are left out (they move under Adam by round-off alone). The
  worst leaf's change is a widest gap that swings from seed to seed with
  the sign flips of a small leaf's near-zero entries; it is reported on
  standard error, not compared.
"""

from __future__ import annotations

import statistics

import numpy as np

CHECK_STEPS = 3
WARMUP_STEPS = 3
ZERO_GRAD_SHARE = 1e-3


def capture(loop, init: dict) -> dict:
    """Load ``init`` into the program and run the checked steps through
    ``loop``; the state the comparison needs."""
    import torch

    program = loop.program
    program.load_params(init)
    out = {"init": {k: v.detach().clone() for k, v in init.items()},
           "start_step": loop.trainer.step, "batches": [], "jitters": [], "losses": []}
    for i in range(CHECK_STEPS):
        batch, jit = loop.draw()
        metrics = loop.step(batch, jit)
        out["batches"].append({k: np.array(v) for k, v in batch.items()})
        out["jitters"].append([t.clone() for t in jit])
        out["losses"].append(metrics["total_loss"].detach().clone())
        if i == 0:
            out["mu"] = {k: v.detach().clone() for k, v in program.first_moments().items()}
    out["params"] = {k: v.detach().clone() for k, v in program.params().items()}
    out["losses"] = [float(x) for x in torch.stack(out["losses"]).cpu()]
    return out


def run_reference(cap: dict, cfg: dict, cams: dict, device, rounding: str | None = None) -> dict:
    """The reference's steps from the captured inputs, its products'
    operands rounded as ``rounding`` says (the configuration's compute
    dtype by default; "fp8" for the control)."""
    import torch

    from perfbench.reference import nerf as ref

    rounding = rounding or stated_rounding(cfg, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in cap["batches"]]
    cams_t = {k: torch.as_tensor(v, device=device) for k, v in cams.items()}
    return ref.train_steps(cap["init"], cfg["model"], cfg["optimizers"], cams_t, batches,
                           cap["jitters"], cap["start_step"],
                           cfg["model_module"] == "semantic_nerfw", rnd=ref.Rounding(rounding))


def stated_rounding(cfg: dict, device) -> str:
    """The compute dtype the configuration states, as the program runs it
    on ``device``: the port rounds to bf16 on the card only."""
    return cfg["model"]["compute_dtype"] if getattr(device, "type", device) == "cuda" else "float32"


def _norms(tree: dict, keys) -> dict:
    return {k: float(np.linalg.norm(tree[k].detach().double().cpu().numpy().ravel()))
            for k in keys}


def _worst(p: dict, r: dict, keys) -> tuple:
    """(the largest |p_k - r_k| / max(r_k, median r), its leaf)."""
    med = statistics.median(r[k] for k in keys)
    gaps = {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _median_gap(p: dict, r: dict, keys) -> float:
    return statistics.median(abs(p[k] - r[k]) / max(r[k], 1e-30) for k in keys)


def numbers(prog: dict, ref_out: dict) -> dict:
    """The three compared numbers of a run (``prog``: from ``capture`` or a
    second reference run in the same form) against the reference's run."""
    from perfbench.reference.nerf import trainable

    keys = sorted(k for k in ref_out["grads"] if trainable(k))
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"],
                                                               ref_out["losses"])]
    g_ref = _norms(ref_out["grads"], keys)
    g_prog = _norms(prog["grads"], keys)
    grad_gap, grad_leaf = _worst(g_prog, g_ref, keys)
    med = statistics.median(g_ref.values())
    moving = [k for k in keys if g_ref[k] >= ZERO_GRAD_SHARE * med]
    init = prog["init"]
    d_ref = {k: float(np.linalg.norm((ref_out["params"][k] - init[k]).double().cpu().numpy()))
             for k in moving}
    d_prog = {k: float(np.linalg.norm((prog["params"][k] - init[k]).double().cpu().numpy()))
              for k in moving}
    delta_worst, delta_leaf = _worst(d_prog, d_ref, moving)
    return {"loss_gap": max(losses), "grad_gap_worst_leaf": grad_gap,
            "change_gap_median_leaf": _median_gap(d_prog, d_ref, moving),
            "_grad_leaf": grad_leaf, "_delta_leaf": delta_leaf, "_delta_worst": delta_worst,
            "_grad_median_leaf": _median_gap(g_prog, g_ref, keys),
            "_left_out": sorted(set(keys) - set(moving)), "_losses": prog["losses"],
            "_ref_losses": ref_out["losses"]}


def program_side(cap: dict) -> dict:
    """The captured program state in the form ``numbers`` reads."""
    return {"losses": cap["losses"], "init": cap["init"], "params": cap["params"],
            "grads": {k: v / 0.1 for k, v in cap["mu"].items()}}


def reference_side(cap: dict, out: dict) -> dict:
    return {"losses": out["losses"], "init": cap["init"], "params": out["params"],
            "grads": out["grads"]}


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}}) over the limits' names; a
    number that is not finite fails."""
    table = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return bool(ok), table
