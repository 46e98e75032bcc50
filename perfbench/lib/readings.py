"""Readings of a training cell's compared numbers over many seeds in one process
(``tools/readings.py``): the program's, the control's and the planted
faults'. The program is built once; each reading starts it afresh from its
seed: new weights, zero optimizer state, the step counter at the
configuration's start, the datamanager's and the jitter's seeds."""

from __future__ import annotations

import gc

from perfbench.lib import check, faults as fault_lib
from perfbench.lib.program import flat_params
from perfbench.lib.trace import Tracer


def _reset(program, loop, cfg, seed: int, jitter_offset: int) -> None:
    import torch

    tr = program.trainer
    with torch.no_grad():
        for st in tr.optimizer.state.values():
            for t in [*flat_params(st["mu"]).values(), *flat_params(st["nu"]).values()]:
                t.zero_()
            st["count"] = 0
    tr.dm.config.seed = seed
    loop.gen.manual_seed(int(seed) + jitter_offset)
    tr.step = int(cfg["start_step"])


def _record(name: str, seed: int, side: str, nums: dict) -> dict:
    return {"cell": name, "seed": seed, "side": side,
            **{k: v for k, v in nums.items() if not k.startswith("_")},
            "grad_leaf": nums["_grad_leaf"], "delta_leaf": nums["_delta_leaf"],
            "grad_median_leaf": nums["_grad_median_leaf"], "delta_worst": nums["_delta_worst"],
            "losses": nums["_losses"], "ref_losses": nums["_ref_losses"]}


def run(bench, name: str, seeds: list, control: bool, faults: list, fault_seeds: int,
        device: str):
    import torch

    from perfbench.reference import nerf as ref

    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = bench.module("loops", traffic["kind"])
    program = kind.make_program(cfg, traffic, seeds[0], device, bench.root / "perfbench" / "cache")
    dev = program.device
    cams = program.cameras()
    trainer = program.trainer
    model, opt_step = trainer.model, trainer.optimizer.step

    plan = [(s, None) for s in seeds] + [(s, f) for f in faults for s in seeds[:fault_seeds]]
    for seed, fault in plan:
        loop = kind.Loop(program, traffic, cfg, seed, Tracer(False))
        _reset(program, loop, cfg, seed, kind.JITTER_SEED_OFFSET)
        trainer.model, trainer.optimizer.step = model, opt_step
        fault_lib.apply(fault, loop)
        init = ref.init_params(cfg["model"], program.num_images(), seed, dev)
        cap = check.capture(loop, init)
        del init, loop
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_out = check.run_reference(cap, cfg, cams, dev)
        nums = check.numbers(check.program_side(cap), check.reference_side(cap, ref_out))
        yield _record(name, seed, fault or "program", nums)
        if control and fault is None:
            ctl = check.run_reference(cap, cfg, cams, dev, rounding="fp8")
            nums = check.numbers(check.reference_side(cap, ctl),
                                 check.reference_side(cap, ref_out))
            yield _record(name, seed, "control", nums)
            del ctl
        del cap, ref_out
        gc.collect()
    trainer.model, trainer.optimizer.step = model, opt_step
