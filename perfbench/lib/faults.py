"""Faults planted under the timed path, for the tests and the readings that
show the correctness check fails them. None is ever applied in a
benchmark run: ``perfbench/run.py`` takes no option that names one.

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half``: half of every batch left out, the mean taken over the rest;
- ``answer``: the rendered colour altered where the model produces it.
"""

from __future__ import annotations

import types

NAMES = ("unchanged", "half", "answer")


def apply(fault: str | None, loop) -> None:
    if fault is None:
        return
    trainer = loop.trainer
    if fault == "unchanged":
        trainer.optimizer.step = lambda: None
    elif fault == "half":
        step = loop.step

        def half_step(batch, jitters):
            n = len(batch["ray_indices"]) // 2
            return step({k: v[:n] for k, v in batch.items()}, [j[:n] for j in jitters])

        loop.step = half_step
    elif fault == "answer":
        model = trainer.model
        fields = {k: getattr(model, k) for k in dir(model) if not k.startswith("__")}

        def forward(*args, **kwargs):
            out = model.forward(*args, **kwargs)
            out["rgb"] = out["rgb"] + 0.01
            return out

        trainer.model = types.SimpleNamespace(**{**fields, "forward": forward})
    else:
        raise ValueError(f"unknown fault {fault!r} ({NAMES})")
