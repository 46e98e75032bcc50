"""Traffic of kind ``train``: the general generator of training steps. It
reads a mix's parameters (``traffic/<mix>.json``: ``rays_per_step``) and
drives the program in a closed loop of ``Trainer.train_step`` calls: each
step's batch is drawn by the program's host sampler (``next_train``), and
its sampler jitter, one uniform number a ray and a sampling round, by the
benchmark on the device from the seed, so that the reference can be handed
the same. Every step of a run has the same size; the seed changes which
pixels and which jitter.

What the harness (``lib/cell.py``) asks of a kind's module, found by the
kind's name under ``loops/``: ``make_program``, a ``Loop`` with ``capture``,
``warm_up``, ``run``, ``failed``, ``end_to_end`` and ``note``, and ``judge``.
"""

from __future__ import annotations

import time

from perfbench.lib import check
from perfbench.lib.program import Program

JITTER_SEED_OFFSET = 0x9E3779B9


def make_program(cfg: dict, traffic: dict, seed: int, device: str, cache) -> Program:
    return Program(cfg, int(traffic["rays_per_step"]), seed, device, cache=cache)


class Loop:
    def __init__(self, program, traffic: dict, cfg: dict, seed: int, tracer):
        import torch

        self.program = program
        self.trainer = program.trainer
        self.cfg = cfg
        self.rays = int(traffic["rays_per_step"])
        self.rounds = int(cfg["model"]["num_proposal_iterations"])
        self.tracer = tracer
        dev = self.trainer.device
        self.gen = torch.Generator(device=dev).manual_seed(int(seed) + JITTER_SEED_OFFSET)
        self.trainer.step = int(cfg["start_step"])
        self.losses: list = []

    def draw(self):
        """(the next step's batch, its jitters: one (R, 1) tensor a round
        and one for the initial sampler)."""
        import torch

        with self.tracer.span("batch_draw"):
            batch = self.trainer.dm.next_train(self.trainer.step)
        jit = torch.rand((self.rounds + 1, self.rays, 1), generator=self.gen,
                         device=self.trainer.device)
        return batch, list(jit.unbind(0))

    def step(self, batch, jitters) -> dict:
        with self.tracer.span("train_step"):
            return self.trainer.train_step(batch, jitters=jitters)

    def capture(self, seed: int) -> dict:
        """Set-up's part of the correctness check: the weights drawn from
        the seed, loaded, and the checked steps run through the window's
        own call and feed (``lib/check.py``)."""
        from perfbench.reference import nerf as ref

        init = ref.init_params(self.cfg["model"], self.program.num_images(), seed,
                               self.trainer.device)
        cap = check.capture(self, init)
        cap["cameras"] = self.program.cameras()
        return cap

    def warm_up(self) -> None:
        for _ in range(check.WARMUP_STEPS):
            self.step(*self.draw())
        self.losses.clear()

    def run(self, seconds: float) -> dict:
        """Steps back to back until ``seconds`` have passed on the host
        clock, then a synchronise: {'steps', 'window_s', 'rays'}. Each
        step's loss is kept (on the device) for a finiteness count."""
        import torch

        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            metrics = self.step(*self.draw())
            self.losses.append(metrics["total_loss"])
            n += 1
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        return {"steps": n, "window_s": time.perf_counter() - t0, "rays": n * self.rays}

    def failed(self) -> int:
        """Steps of the window whose loss is not finite."""
        import torch

        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    @staticmethod
    def end_to_end(window: dict) -> dict:
        """The window's end-to-end readings: all rays of all steps over all
        of its time."""
        return {"train_rays_per_s": window["rays"] / window["window_s"]}

    def note(self, window: dict) -> str:
        return f"{window['steps']} steps of {self.rays} rays in {window['window_s']:.6f} s"


def judge(cap: dict, cfg: dict, device, limits: dict) -> tuple:
    """After the window, with the program freed: the reference's steps from
    the captured inputs against the program's. (correct, {name: {value,
    limit}}, a line for standard error)."""
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ref_out = check.run_reference(cap, cfg, cap["cameras"], device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    nums = check.numbers(check.program_side(cap), check.reference_side(cap, ref_out))
    correct, table = check.verdict(nums, limits)
    note = (f"reference: {time.perf_counter() - t0:.3f} s, peak {peak} bytes; losses "
            f"{nums['_losses']} against {nums['_ref_losses']}; worst gradient leaf "
            f"{nums['_grad_leaf']}, worst change leaf {nums['_delta_leaf']} "
            f"({nums['_delta_worst']!r}); left out of the change {nums['_left_out']}")
    return correct, table, note
