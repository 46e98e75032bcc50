#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_kbs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:
1. device: the card (nvidia-smi name and power limit), then the four kernel
   sources (each with a wgmma body for the flagship widths, a WMMA body for
   other widths and an f32 body; the two fused-MLP sources also a wgmma body
   for the field's base widths) are built from csrc/ into build/ (one nvcc
   per source, started together), with ptxas' registers and spills of every
   wgmma kernel;
2. kernel parity: each kernel against its plain PyTorch version on the card,
   both bases and both compute dtypes, at the main paths' shapes and a
   ragged N, and every wgmma body also at N below and around one tile, one
   block's tiles and all resident tiles; the two backward kernels also with
   and without the position gradient, every output compared, and a repeat of
   the launch must give the same bits; times of each kernel and its plain
   version at the main paths' operating point (tri basis, bf16, no position
   gradient), the wgmma body and the WMMA body in turns, and the backwards'
   passes apart; the two backwards also with dx at the same shapes (the
   ``*_dx`` records, which the camera optimizer's steps launch). A kernel's
   time (ms) is the CUDA-event time of back-to-back calls of its wrapper;
   the device time of every kernel the wrapper launches
   (device_ms, torch.profiler) stands beside it and is smaller where the host
   cannot enqueue the wrapper's launches as fast as they run;
3. the serving slice: nerfacto-tpu at full width in bf16 with seeded weights renders
   a 376x1241 camera through Renderer.render_camera in 1<<15-ray chunks; the
   launch counts must show 2 proposal-field and 1 field launches per chunk,
   all through their wgmma bodies;
   the frame time is the median of 5 more renders; then the frame with all
   wgmma bodies, with the field kernel's WMMA body and with the two
   proposal-field kernels' WMMA bodies in turns; a profiler pass gives the
   device time by kernel, once more with the proposal-field kernels' WMMA
   bodies; a small camera rendered in f32 on the card must
   match the CPU plain path; the viewer answers /status, /render and /orbit
   with PNGs;
4. the training slice: 22 steps of the bench's train step (full-width bf16
   nerfacto-tpu, 16,384 random pixels of 32 cameras of 376x1241 and random
   colours per step, forward -> loss -> backward -> per-group Adam) with the
   launch counts 2 / 1 / 2 / 1 per step (all through their wgmma
   bodies) and the median step time of the last
   20; the same three turns of bodies; Trainer.train(30) at full width on the
   synthetic sphere scene (loss
   finite and falling, metrics.jsonl, eval_image, checkpoint save and load);
   a profiler pass over one step, once more with the proposal-field kernels'
   WMMA bodies; 3 steps in f32 on the card against the
   same 3 steps on the CPU plain path;
5. kernels A and C at the nerfacto field's base widths (H = 128, (256, 128,
   128, 16)), which the semantics path runs through their base-width wgmma
   bodies: held against their plain versions in both bases and dtypes (C
   with and without dx, repeats bit-identical) at run 2's train-step shape
   and a ragged N, every launch on the base-width counters; the wgmma bodies
   also at N below and around one tile and past the card's resident tiles
   (against the plain versions and the WMMA bodies) and A at one run-2 eval
   chunk; timed at the train-step shape, the wgmma and WMMA bodies in turns,
   C with and without dx (part of phase 2);
6. the street scene: the port's writer makes an 8-frame 376x1241
   KITTI-layout scene (frames, depth, semantics, masks, forward flow),
   timed;
7. the two CLI runs, through nerf_kbs_tpu_torch.engine.cli.main in-process:
   nerfacto-tpu (kernels A, B, C, D on their wgmma bodies) and semantic-nerfw
   with nerfacto-tpu's model fields, depth, semantics and masks (the
   proposals on A / C's wgmma bodies, the base MLP on their base-width wgmma
   bodies, no WMMA body), 30
   steps of 4,096 rays each, then eval_all_images and a checkpoint; each
   prints steps, step times, rays/s, the first and last loss, the eval
   metrics and the launch counts, which must equal 30 x the per-step counts
   plus the eval chunks x the per-chunk counts; --eval-only from run 1's
   checkpoint must reproduce its final metrics; run 2's depth term at each
   step (the alignment's det, scale and shift in f32 as used and in f64,
   and whether the rendered depth carries a gradient); the eval time of
   each split; a profile of one run-2 step, whose launch counts must be
   run 2's per-step counts; 3 f32 steps of run 2's configuration at a
   reduced width against the CPU plain path;
8. run 3, semantic-nerfw as registered (the hash field, 16 levels of a 2^19
   table from 16 to 2048, proposals 5 levels of 2^17, (256, 96) -> 48
   samples, appearance embedding 32, bf16) with depth, semantics and masks,
   through cli.main on the same scene and window: 30 steps of 4,096 rays,
   eval_all_images and a checkpoint on the non-fused path, with no fused
   kernel launched; its step time and rays/s, the eval time of the split,
   the peak memory of a step and of an eval chunk, and a profile of one step
   by device kernel and by op (the gathers, the table scatter-adds, the MLP
   products, the glue);
9. the other hash presets as registered at full width (nerfacto and
   nerfacto-big on the scene, synthetic-nerfacto on the sphere scene): 3
   steps each, finite losses, no fused kernel launched, step times and peak
   memory;
10. 3 f32 steps on the card against the CPU plain path, at reduced widths, of
   semantic-nerfw as registered and of nerfacto-tpu with predicted normals
   and the scene contraction disabled (the second-order backward of the
   normals on the card);
11. the vKITTI scene: the port's writer makes an 8-frame 375x1242 Virtual
   KITTI 2 scene (quality-97 JPEG frames, 16-bit PNG depth), timed, and the
   vKITTI parser and the datamanager load it, timed (the NumPy JPEG decoder);
12. the last three registry paths through cli.main at full width, 30 steps
   of 4,096 rays each, eval_all_images and a checkpoint, none of them
   launching a fused kernel: run 4, vanilla-nerf as registered (temporal
   distortion, aabb collider, 64 + 128 samples, 8 x 256 MLP with a skip at
   layer 4, f32, RAdam with the clip) on the vKITTI scene, with --eval-only
   from its checkpoint reproducing its final metrics; run 5, test-nerfacto
   as registered (hash nerfacto, bf16) on a transforms.json of the street
   scene's frames; run 6, semantic-nerfw as registered with the NeRF-W
   transient path and 20 steps of the eval appearance fit, on the street
   scene with depth, semantics and masks (the transient loss terms finite,
   fit_psnr and fit_psnr_right in the eval). For each: the median step time,
   the eval time of the split, the peak memory of a step and of an eval
   chunk, a profile of one step, and 3 f32 steps at a reduced width on the
   card against the CPU plain path;
13. run 7, nerfacto-tpu with --model.camera_optimizer SO3xR3 through
   cli.main on the street scene (30 steps of 4,096 rays, bf16, eval of the
   split): launch counts A 2 / B 1 / C 2 / D 1 a step with every C and D
   launch on dx, the regularizer in every step, the tangents moved after 30
   steps, the step-0 gradient of the tangents finite and non-zero, a
   profile of one step, and 3 f32 steps at a reduced width card against
   CPU with the tangents compared; one step of run 2's configuration with
   the camera optimizer (the base MLP's C launch on its dx branch); run 7b,
   semantic-nerfw as registered (hash field) with the camera optimizer, 3
   f32 steps card against CPU;
14. run 8, the SUDS stream: sky masks from the scene's semantic colours and
   a metadata.json over its frames (2 held out), SudsMetadataConfig ->
   ChunkedStreamDataManager (random-subset chunks of 65,536 rows, flow and
   sky rows) -> Trainer with nerfacto-tpu at full width in bf16,
   flow_loss_mult 1e-3 and sky_loss_mult 0.1, 30 steps of 4,096 rays: the
   launch counts, the finite flow and sky terms, the chunk loads and each
   chunk build's host time against the steps it overlapped, the eval of the
   held-out frames, a profile of one step, and 3 f32 steps card against CPU
   on the same stream batches;
15. a {"kernels": [...]} line, each record's "launches" counted per
   "launches_per" (a frame, a bench step, a run-2 or a run-7 step, a run-2
   step with the camera optimizer), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without CUDA, or run from a directory without the port, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

HERE = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s

# kernel vs plain version on the card: f32 differs only in summation order
# and in proj = B^T x (up to ~1600 rad for sincos, so ~2e-4 rad of phase);
# bf16 can also flip single bf16 roundings of activations (2^-8 relative)
TOLERANCE = {("tri", False): 1e-3, ("sincos", False): 5e-3,
             ("tri", True): 5e-2, ("sincos", True): 5e-2}


# backward outputs, each relative to the largest magnitude of the reference
# tensor. Two things differ between a kernel and its plain version beyond
# summation order. (1) In bf16 single roundings of dh and of activations flip.
# (2) A pre-activation within rounding (~1e-7) of zero takes the other side
# of the relu mask: a few such points among the ~3e8 unit evaluations of a
# field launch, in f32 as in bf16. At such a point the per-point outputs (dx,
# dfeats) differ by a whole unit's share, so they are held to BWD_TOLERANCE at
# all but PER_POINT_OUTLIERS of their elements. A weight gradient here is a
# zero-mean sum over ~10^6 points (g is random), of magnitude ~sqrt(N) times
# one point's, so each such point moves it by ~1e-3 of its magnitude: weight
# and bias gradients are held to SUM_TOLERANCE. The last layers' gradients
# pass no mask and agree to ~1e-6 in f32.
BWD_TOLERANCE = {("tri", False): 2e-3, ("sincos", False): 5e-3,
                 ("tri", True): 5e-2, ("sincos", True): 5e-2}
SUM_TOLERANCE = 2e-2
PER_POINT_OUTLIERS = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# thread-instructions a second of the f32 pipes: SMs x 128 lanes x the SM
# clock nvidia-smi reports as the card's maximum; set by phase_device
ALU = {"per_s": None}


def bound(n_bytes: float, flops: float, alu_ops: float, bf16: bool) -> dict:
    """The least time the card could take: the largest of the bytes over the
    memory rate, the matrix FLOPs over the tensor-core peak and the scalar f32
    instructions (``alu_ops``) over the instruction rate of the f32 pipes;
    ``bound_by`` names which: bytes, operations (the tensor cores') or alu.
    The first two alone stay on the record as ``bound_ms_bytes_or_tensor``,
    the bound of runs that had no ALU term."""
    t = {"bytes": n_bytes / H100_BYTES,
         "operations": flops / (H100_BF16_FLOPS if bf16 else H100_F32_FLOPS),
         "alu": alu_ops / ALU["per_s"]}
    by = max(t, key=t.get)
    return {"bound_ms": t[by] * 1e3, "bound_by": by,
            "bound_ms_bytes_or_tensor": max(t["bytes"], t["operations"]) * 1e3,
            "bound_ms_alu": t["alu"] * 1e3}


def alu_ops_per_point(kernel: str, h_freqs: int, hidden_cols: int, out_dim: int = 1,
                      need_dx: bool = False) -> float:
    """Scalar f32 instructions a point that the function itself defines, in
    the tri basis: its arithmetic outside the matrix products and the
    roundings at its cast points, one instruction per lane and clock (a
    rounding to bf16 packs two values and counts half per value). What only a
    body's design needs (shared-memory stores, shuffles, address arithmetic,
    loop control) is left out.
    - The encoding, per frequency: the projection (1 mul, 2 fma), tri_s (add,
      floor, sub, sub under abs, fma: 5), tri_c (floor, sub, sub, fma: 4), the
      rounding of s and of c (2 x 0.5): 13.
    - A hidden column forward: bias add, max, its rounding: 2.5.
    - A hidden column backward: the mask's select, the bias-gradient add, the
      rounding of dh: 2.5.
    - The proposal chain's width-1 layer per hidden column, in f32 on the
      rounded activation: forward the activation back in f32 and an fma (2),
      and one add of b_1 a point; backward (whose forward product nothing
      needs) the activation back in f32, the dW_1 fma and the product w_1 g
      (3, with the column's 2.5 forward and 2.5 backward: 8), and one add of
      db_1 a point.
    - A chain whose last layer is wider than 1 (the base MLP that the
      semantics path runs alone, out_dim 16) runs that layer on the tensor
      cores: forward a bias add per output column (1), backward the rounding
      of g and its bias-gradient add per output column (1.5).
    - The field's other columns: the 16 base outputs' bias add and their
      rounding (1.5), the 16 feats' rounding (0.5), ~10 for each of 3
      sigmoids; backward g rgb (1 - rgb) (3 each), the rounding and the
      bias-gradient add of the 3 rgb gradients and of the 16 base-output
      gradients (1.5 each).
    - A backward with dx (``need_dx``), per frequency: the slopes of tri_s
      and tri_c (a compare and a select each: 4), dproj = ds s' + dc c' (a
      mul and an fma: 2) and its 3 fma into dx = B dproj: 9."""
    enc = 13.0 * h_freqs
    if need_dx:
        enc += 9.0 * h_freqs
    if kernel == "fourier_mlp_fwd":
        if out_dim > 1:
            return enc + hidden_cols * 2.5 + out_dim * 1.0
        return enc + hidden_cols * (2.5 + 2) + 1
    if kernel == "fourier_mlp_bwd":
        if out_dim > 1:
            return enc + hidden_cols * (2.5 + 2.5) + out_dim * 1.5
        return enc + hidden_cols * (2.5 + 2.5 + 3) + 1
    field_fwd = enc + hidden_cols * 2.5 + 16 * 1.5 + 16 * 0.5 + 3 * 10
    if kernel == "fourier_field_fwd":
        return field_fwd
    return field_fwd + hidden_cols * 2.5 + 3 * 3 + (3 + 16) * 1.5


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from nerf_kbs_tpu_torch.ops import _kernels

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ALU["per_s"] = sms * 128 * clock_mhz * 1e6

    t0 = time.perf_counter()
    paths = _kernels.build()
    build_s = time.perf_counter() - t0
    # registers, stack and spills of every wgmma kernel
    regs = {}
    for n, log in _kernels.build_logs.items():
        name = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties" in ln:
                name = ln.split("_Z")[-1][:60]
            if ("wgmma" in name or "nkt_field_dw" in name) and ("registers" in ln or "spill" in ln):
                regs.setdefault(n, []).append(
                    f"{name}: " + ln.replace("ptxas info    : ", "").strip())
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "sms": sms,
          "max_sm_clock_mhz": clock_mhz, "alu_instructions_per_s": ALU["per_s"],
          "build_s": build_s, "libs": [str(p.name) for p in paths.values()],
          "ptxas": regs})


def _weights(cfg_mlp, gen, dev):
    from nerf_kbs_tpu_torch.ops.mlp import mlp_init

    import torch

    p = mlp_init(cfg_mlp, gen, dev)
    # nonzero biases, as trained weights have: with zero biases the kernels
    # and cuBLAS can agree bit for bit and the check would not see the bias
    bs = [(torch.randn(b.shape, generator=gen) * 0.1).to(dev) for b in p["b"]]
    return p["w"], bs


def phase_kernels():
    """Returns the per-kernel records for the final JSON line."""
    import math

    import torch

    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.ops import fused_field as ff
    from nerf_kbs_tpu_torch.ops.encoding import fourier_encoding_init, sh_encoding

    dev = torch.device("cuda")
    cfg = nerfacto_tpu_method().model_config()
    gen = torch.Generator().manual_seed(1)
    pcfg, fcfg = cfg.proposal_field(0), cfg.field
    pB = fourier_encoding_init(pcfg.fourier, gen, dev)
    pws, pbs = _weights(pcfg.mlp, gen, dev)
    fB = fourier_encoding_init(fcfg.fourier, gen, dev)
    bws, bbs = _weights(fcfg.base_mlp, gen, dev)
    rws, rbs = _weights(fcfg.rgb_mlp, gen, dev)
    chunk = 1 << 15
    n_a0 = chunk * cfg.num_proposal_samples_per_ray[0]  # proposal round 0
    n_a1 = chunk * cfg.num_proposal_samples_per_ray[1]  # proposal round 1
    n_b = chunk * cfg.num_nerf_samples_per_ray

    def positions(n):
        return torch.rand(3, n, generator=gen).to(dev)  # contracted, in [0, 1]^3

    def feats(n):
        d = torch.randn(n, 3, generator=gen)
        return sh_encoding(d / d.norm(dim=-1, keepdim=True)).T.contiguous().to(dev)

    def a_call(basis, bf16, x):
        B = pB * (2 * math.pi) if basis == "sincos" else pB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=pcfg.mlp.dims, bf16=bf16,
                               basis=basis)
        return (lambda: ff.fourier_mlp(spec, x, B, pws, pbs),
                lambda: ff.fourier_mlp_reference(x, B, pws, pbs, basis, bf16))

    def b_call(basis, bf16, x, fe):
        B = fB * (2 * math.pi) if basis == "sincos" else fB
        spec = ff.FusedFieldSpec(h_freqs=B.shape[1], feat_dim=fe.shape[0],
                                 base_dims=fcfg.base_mlp.dims, rgb_dims=fcfg.rgb_mlp.dims,
                                 bf16=bf16, basis=basis)
        return (lambda: ff.fourier_field_mlp(spec, x, fe, B, bws, bbs, rws, rbs),
                lambda: ff.fourier_field_reference(x, fe, B, bws, bbs, rws, rbs, basis, bf16))

    def c_call(basis, bf16, need_dx, x, g):
        B = pB * (2 * math.pi) if basis == "sincos" else pB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=pcfg.mlp.dims, bf16=bf16,
                               basis=basis, need_dx=need_dx)

        def flat(res):
            dx, dws, dbs = res
            return ([] if dx is None else [dx]) + list(dws) + list(dbs)

        return (lambda: flat(ff._mlp_backward(spec, x, B, pws, pbs, g)),
                lambda: flat(ff.fourier_mlp_backward_reference(x, B, pws, pbs, g, basis, bf16,
                                                               need_dx)))

    def d_call(basis, bf16, need_dx, x, fe, g):
        B = fB * (2 * math.pi) if basis == "sincos" else fB
        spec = ff.FusedFieldSpec(h_freqs=B.shape[1], feat_dim=fe.shape[0],
                                 base_dims=fcfg.base_mlp.dims, rgb_dims=fcfg.rgb_mlp.dims,
                                 bf16=bf16, basis=basis, need_dx=need_dx)

        def flat(res):
            dx, dfe, dbw, dbb, drw, drb = res
            return ([] if dx is None else [dx]) + [dfe, *dbw, *dbb, *drw, *drb]

        return (lambda: flat(ff._field_backward(spec, x, fe, B, bws, bbs, rws, rbs, g)),
                lambda: flat(ff.fourier_field_backward_reference(x, fe, B, bws, bbs, rws, rbs, g,
                                                                 basis, bf16, need_dx)))

    def wmma_body(kern, name):
        """The same call with kernel ``name`` sent through its WMMA body (the
        flagship widths take the wgmma body otherwise)."""
        def call():
            ff.FORCE_WMMA = frozenset({WRAPPER[name]})
            try:
                return kern()
            finally:
                ff.FORCE_WMMA = frozenset()
        return call

    def device_ms(fn, reps):
        """Device time of one call: every kernel the wrapper launches, summed
        under torch.profiler over ``reps`` calls; and that time by kernel. The
        profiler now and then loses device events of a pass; then some
        kernel's count is no multiple of ``reps`` and the pass is repeated."""
        fn()

        def work():
            for _ in range(reps):
                fn()
        for _ in range(5):
            events = device_events(work)[1]
            if all(count % reps == 0 for _, _, count in events):
                by_name = {name: us / 1e3 / reps for name, us, _ in events}
                return sum(by_name.values()), by_name
        raise RuntimeError("the profiler lost device events in five passes running")

    def rel_err(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)

    def outliers(got, want, tol):
        """Share of elements further than tol (relative to the reference's
        largest magnitude) from the reference."""
        return float(((got - want).abs() > tol * want.abs().max()).float().mean())

    train_rays = 16384  # the bench's batch
    n_c0 = train_rays * cfg.num_proposal_samples_per_ray[0]
    n_c1 = train_rays * cfg.num_proposal_samples_per_ray[1]
    n_d = train_rays * cfg.num_nerf_samples_per_ray
    bwd_cases = [("fourier_mlp_bwd", n) for n in (n_c1, 1_000_003)]
    bwd_cases += [("fourier_field_bwd", n) for n in (n_d, 1_000_003)]
    for name, n in bwd_cases:
        x = positions(n)
        fe = feats(n) if name == "fourier_field_bwd" else None
        g = torch.randn(1 if fe is None else 4, n, generator=gen).to(dev)
        for basis in ("tri", "sincos"):
            for bf16 in (True, False):
                for need_dx in (False, True):
                    kern, plain = (c_call(basis, bf16, need_dx, x, g) if fe is None
                                   else d_call(basis, bf16, need_dx, x, fe, g))
                    got, want, again = kern(), plain(), kern()
                    torch.cuda.synchronize()
                    check(len(got) == len(want), f"{name}: {len(got)} outputs, want {len(want)}")
                    check(all(bool(torch.isfinite(t).all()) for t in got),
                          f"{name}: non-finite kernel output")
                    tol = BWD_TOLERANCE[(basis, bf16)]
                    # per-point outputs (dx, dfeats) have n columns
                    per_point = [a.shape[-1] == n for a in got]
                    errs = [rel_err(a, b) for a, b in zip(got, want)]
                    out = [outliers(a, b, tol) for a, b, pp in zip(got, want, per_point) if pp]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    emit({"phase": "parity", "kernel": name, "n": n, "basis": basis,
                          "dtype": "bf16" if bf16 else "f32", "need_dx": need_dx,
                          "body": "wgmma" if bf16 else "f32",
                          "outputs": len(got), "tol": tol, "sum_tol": SUM_TOLERANCE,
                          "max_rel_err": max(e for e, pp in zip(errs, per_point) if not pp),
                          "last_layer_rel_err": errs[-1],
                          "per_point_max_rel_err": max([e for e, pp in zip(errs, per_point)
                                                        if pp], default=None),
                          "per_point_outlier_share": max(out, default=None),
                          "repeat_bit_identical": same})
                    check(all(e <= SUM_TOLERANCE for e, pp in zip(errs, per_point) if not pp),
                          f"{name} n={n} {basis} bf16={bf16} need_dx={need_dx}: rel errs {errs}")
                    check(all(o <= PER_POINT_OUTLIERS for o in out),
                          f"{name} n={n} {basis} bf16={bf16} need_dx={need_dx}: outliers {out}")
                    check(same, f"{name} n={n} {basis} bf16={bf16}: a repeat gave other bits")
                    del got, want, again
        del x, fe, g
        torch.cuda.empty_cache()

    cases = [("fourier_mlp_fwd", n) for n in (n_a1, 1_000_003)]
    cases += [("fourier_field_fwd", n) for n in (n_b, 1_000_003)]
    for name, n in cases:
        x = positions(n)
        fe = feats(n) if name == "fourier_field_fwd" else None
        for basis in ("tri", "sincos"):
            for bf16 in (True, False):
                kern, plain = a_call(basis, bf16, x) if fe is None else b_call(basis, bf16, x, fe)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
                err = float((got - want).abs().max())
                tol = TOLERANCE[(basis, bf16)]
                emit({"phase": "parity", "kernel": name, "n": n, "basis": basis,
                      "dtype": "bf16" if bf16 else "f32", "body": "wgmma" if bf16 else "f32",
                      "max_abs_err": err, "tol": tol,
                      "max_abs_ref": float(want.abs().max())})
                check(err <= tol, f"{name} n={n} {basis} bf16={bf16}: err {err} > {tol}")
                del got, want
        del x, fe
        torch.cuda.empty_cache()

    ran = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(ran == {"fourier_mlp": 4, "fourier_mlp_wgmma": 4, "fourier_field_mlp": 4,
                  "fourier_field_mlp_wgmma": 4, "fourier_mlp_bwd": 16,
                  "fourier_mlp_bwd_wgmma": 16, "fourier_field_mlp_bwd": 16,
                  "fourier_field_mlp_bwd_wgmma": 16}, f"parity launches {ran}")

    # the wgmma bodies below and around one tile and one block's tiles (a
    # block runs several tiles at once). The forward is held to its plain
    # version as above. The backward's weight gradients are sums over few
    # points here, so a single relu-mask flip (see BWD_TOLERANCE's note) moves
    # one by percents: the last rgb layer's gradients, which pass no mask, are
    # held to the plain version, and every output to the WMMA body, which
    # rounds and masks at the same places and differs in summation order only
    for n in (1, 63, 64, 65, 64 * 3 + 1):
        x, fe = positions(n), feats(n)
        g = torch.randn(4, n, generator=gen).to(dev)
        for basis in ("tri", "sincos"):
            before = dict(ff.LAUNCHES)
            kern, plain = b_call(basis, True, x, fe)
            err = float((kern() - plain()).abs().max())
            check(err <= TOLERANCE[(basis, True)], f"fourier_field_fwd n={n} {basis}: err {err}")
            errs = {}
            for need_dx in (False, True):
                kern, plain = d_call(basis, True, need_dx, x, fe, g)
                got, want, again = kern(), plain(), kern()
                old = wmma_body(kern, "fourier_field_bwd")()
                check(all(bool(torch.isfinite(t).all()) for t in got),
                      f"fourier_field_bwd n={n}: non-finite output")
                errs[need_dx] = {"last_layer_vs_plain": max(rel_err(got[-4], want[-4]),
                                                            rel_err(got[-1], want[-1])),
                                 "all_vs_plain": max(rel_err(a, b) for a, b in zip(got, want)),
                                 "all_vs_wmma_body": max(rel_err(a, b)
                                                         for a, b in zip(got, old))}
                check(errs[need_dx]["last_layer_vs_plain"] <= SUM_TOLERANCE
                      and errs[need_dx]["all_vs_wmma_body"] <= SUM_TOLERANCE,
                      f"fourier_field_bwd n={n} {basis} need_dx={need_dx}: {errs[need_dx]}")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fourier_field_bwd n={n} {basis}: a repeat gave other bits")
            moved = {k: ff.LAUNCHES[k] - before[k] for k in ff.LAUNCHES if ff.LAUNCHES[k] != before[k]}
            check(moved == {"fourier_field_mlp_wgmma": 1, "fourier_field_mlp_bwd_wgmma": 4,
                            "fourier_field_mlp_bwd": 2}, f"edge launches {moved}")
            emit({"phase": "parity_edge", "n": n, "basis": basis, "dtype": "bf16",
                  "fwd_max_abs_err": err, "tol": TOLERANCE[(basis, True)],
                  "bwd_rel_err": {"no_dx": errs[False], "dx": errs[True]},
                  "sum_tol": SUM_TOLERANCE, "repeat_bit_identical": True})

    # the same for the two proposal-field kernels: a block of the forward
    # runs 2 tiles at once, one of the backward 4, and the last size gives the
    # resident warpgroups of a 132-SM card a second and a third tile (the
    # backward's two tile buffers in turn, the prefetch across tiles). db_1,
    # the sum of g, passes no mask and is held to the plain version
    for n in (1, 63, 64, 65, 64 * 2 + 1, 64 * 3 + 1, 64 * 4 + 1, 64 * 132 * 8 + 1):
        x = positions(n)
        g = torch.randn(1, n, generator=gen).to(dev)
        for basis in ("tri", "sincos"):
            before = dict(ff.LAUNCHES)
            kern, plain = a_call(basis, True, x)
            got, want = kern(), plain()
            err = float((got - want).abs().max())
            err_old = float((got - wmma_body(kern, "fourier_mlp_fwd")()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= TOLERANCE[(basis, True)]
                  and err_old <= TOLERANCE[(basis, True)],
                  f"fourier_mlp_fwd n={n} {basis}: err {err}, vs WMMA body {err_old}")
            errs = {}
            for need_dx in (False, True):
                kern, plain = c_call(basis, True, need_dx, x, g)
                got, want, again = kern(), plain(), kern()
                old = wmma_body(kern, "fourier_mlp_bwd")()
                check(all(bool(torch.isfinite(t).all()) for t in got),
                      f"fourier_mlp_bwd n={n}: non-finite output")
                errs[need_dx] = {"last_layer_vs_plain": rel_err(got[-1], want[-1]),
                                 "all_vs_plain": max(rel_err(a, b) for a, b in zip(got, want)),
                                 "all_vs_wmma_body": max(rel_err(a, b)
                                                         for a, b in zip(got, old))}
                check(errs[need_dx]["last_layer_vs_plain"] <= SUM_TOLERANCE
                      and errs[need_dx]["all_vs_wmma_body"] <= SUM_TOLERANCE,
                      f"fourier_mlp_bwd n={n} {basis} need_dx={need_dx}: {errs[need_dx]}")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fourier_mlp_bwd n={n} {basis}: a repeat gave other bits")
            moved = {k: ff.LAUNCHES[k] - before[k] for k in ff.LAUNCHES if ff.LAUNCHES[k] != before[k]}
            check(moved == {"fourier_mlp_wgmma": 1, "fourier_mlp": 1, "fourier_mlp_bwd_wgmma": 4,
                            "fourier_mlp_bwd": 2}, f"edge launches {moved}")
            emit({"phase": "parity_edge", "kernels": "fourier_mlp_fwd, fourier_mlp_bwd", "n": n,
                  "basis": basis, "dtype": "bf16", "fwd_max_abs_err": err,
                  "fwd_vs_wmma_body": err_old, "tol": TOLERANCE[(basis, True)],
                  "bwd_rel_err": {"no_dx": errs[False], "dx": errs[True]},
                  "sum_tol": SUM_TOLERANCE, "repeat_bit_identical": True})

    # times at the main path's operating point (tri, bf16) and shapes; the
    # inputs stay warm in L2 between launches (x of proposal round 0 is 38 MB).
    # ms is the CUDA-event time of back-to-back calls, the wgmma body (the main
    # path's) and the WMMA body in turns; device_ms is the device time of one
    # call (every kernel the wrapper launches, torch.profiler), the smaller
    # where the host cannot enqueue a call as fast as it runs
    def both_ms(fn, reps):
        """(CUDA-event ms, profiler device ms, device ms by kernel) of fn."""
        ev = time_ms(fn, reps)
        dv, by_name = device_ms(fn, reps)
        return ev, dv, by_name

    records = []
    a_mac = 3 * pB.shape[1] + sum(a * b for a, b in zip(pcfg.mlp.dims, pcfg.mlp.dims[1:]))
    b_mac = 3 * fB.shape[1] + sum(a * b for dims in (fcfg.base_mlp.dims, fcfg.rgb_mlp.dims)
                                  for a, b in zip(dims, dims[1:]))
    a_w = sum(t.numel() for t in (*pws, *pbs)) + pB.numel()
    b_w = sum(t.numel() for t in (*bws, *bbs, *rws, *rbs)) + fB.numel()
    a_hidden = sum(pcfg.mlp.dims[1:-1])
    b_hidden = sum(fcfg.base_mlp.dims[1:-1]) + sum(fcfg.rgb_mlp.dims[1:-1])
    for name, n, per_point_bytes, w_floats, mac, alu, src, line in (
        ("fourier_mlp_fwd", n_a0, 12 + 4, a_w, a_mac,
         alu_ops_per_point("fourier_mlp_fwd", pB.shape[1], a_hidden), "fourier_mlp_fwd.cu", 329),
        ("fourier_field_fwd", n_b, 12 + 64 + 16, b_w, b_mac,
         alu_ops_per_point("fourier_field_fwd", fB.shape[1], b_hidden), "fourier_field_fwd.cu",
         677),
    ):
        x = positions(n)
        kern, plain = (a_call("tri", True, x) if name == "fourier_mlp_fwd"
                       else b_call("tri", True, x, feats(n)))
        want = plain()
        err = float((kern() - want).abs().max())
        old = wmma_body(kern, name)
        err_old = float((old() - want).abs().max())
        check(err_old <= TOLERANCE[("tri", True)], f"{name} WMMA body: err {err_old}")
        del want
        turns = [both_ms(old, 5), both_ms(kern, 20), both_ms(kern, 20), both_ms(old, 5)]
        by_name = turns[1][2]
        ev, dv = [t[0] for t in turns], [t[1] for t in turns]
        plain_ms = time_ms(plain, 3)
        rec = {"name": name, "route": "cuda", "source": f"nerf_kbs_tpu_torch/csrc/{src}",
               "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
               "max_abs_err": err, "ms": (ev[1] + ev[2]) / 2, "plain_ms": plain_ms,
               **bound(n * per_point_bytes + 4 * w_floats, 2.0 * n * mac, n * alu, bf16=True),
               "library_ms": None, "n_points": n, "basis": "tri", "dtype": "bf16",
               "alu_instructions_per_point": alu, "body": "wgmma",
               "wmma_body_ms": (ev[0] + ev[3]) / 2, "wmma_body_max_abs_err": err_old,
               "turns_ms": ev, "device_ms": (dv[1] + dv[2]) / 2,
               "wmma_body_device_ms": (dv[0] + dv[3]) / 2, "device_turns_ms": dv,
               "body_kernel_ms": sum(v for k, v in by_name.items() if "wgmma_kernel" in k)}
        emit({"phase": "timing", **rec})
        records.append(rec)
        del x
        torch.cuda.empty_cache()

    # the backward kernels at the train step's shapes, no position gradient
    # (the flagship's sampling is detached). Least work: the recompute (all of
    # it for the field; the hidden layers for the MLP, whose last layer's
    # output nothing needs), dW of every layer, W . dh of every layer but the
    # first of the chain that starts at the encoding
    def macs(dims):
        return [a * b for a, b in zip(dims, dims[1:])]

    pm, bm, rm = macs(pcfg.mlp.dims), macs(fcfg.base_mlp.dims), macs(fcfg.rgb_mlp.dims)
    c_mac = 3 * pB.shape[1] + sum(pm[:-1]) + sum(pm) + sum(pm[1:])
    d_mac = b_mac + sum(bm) + sum(rm) + sum(bm[1:]) + sum(rm)
    for name, n, per_point_bytes, w_floats, mac, alu, src, line in (
        ("fourier_mlp_bwd", n_c0, 12 + 4, 2 * a_w, c_mac,
         alu_ops_per_point("fourier_mlp_bwd", pB.shape[1], a_hidden), "fourier_mlp_bwd.cu", 381),
        ("fourier_field_bwd", n_d, 12 + 64 + 16 + 64, 2 * b_w, d_mac,
         alu_ops_per_point("fourier_field_bwd", fB.shape[1], b_hidden), "fourier_field_bwd.cu",
         707),
    ):
        x = positions(n)
        is_c = name == "fourier_mlp_bwd"
        g = torch.randn(1 if is_c else 4, n, generator=gen).to(dev)
        kern, plain = (c_call("tri", True, False, x, g) if is_c
                       else d_call("tri", True, False, x, feats(n), g))
        got, want = kern(), plain()
        # weight and bias gradients; the per-point dfeats goes by its outliers
        err = max(rel_err(a, b) for a, b in zip(got, want) if a.shape[-1] != n)
        out = max([outliers(a, b, BWD_TOLERANCE[("tri", True)])
                   for a, b in zip(got, want) if a.shape[-1] == n], default=None)
        old = wmma_body(kern, name)
        err_old = max(rel_err(a, b) for a, b in zip(old(), want) if a.shape[-1] != n)
        check(err_old <= SUM_TOLERANCE, f"{name} WMMA body: rel err {err_old}")
        del got, want
        turns = [both_ms(old, 3), both_ms(kern, 10), both_ms(kern, 10), both_ms(old, 3)]
        by_name = turns[1][2]
        ev, dv = [t[0] for t in turns], [t[1] for t in turns]
        # the launch's passes apart
        body_kernel = "fourier_mlp_bwd_wgmma_kernel" if is_c else "fourier_field_bwd_wgmma_kernel"
        extra = {"per_point_pass_ms": sum(v for k, v in by_name.items() if body_kernel in k),
                 "reduction_ms": sum(v for k, v in by_name.items() if "nkt_reduce_partials" in k),
                 "other_kernels_ms": sum(v for k, v in by_name.items()
                                         if not any(m in k for m in (body_kernel, "nkt_field_dw",
                                                                     "nkt_reduce_partials")))}
        if not is_c:
            extra.update({"weight_gradient_passes_ms": sum(v for k, v in by_name.items()
                                                           if "nkt_field_dw" in k),
                          "scratch_bytes": ff._field_scratch_bytes(n, 16)})
        plain_ms = time_ms(plain, 2)
        rec = {"name": name, "route": "cuda", "source": f"nerf_kbs_tpu_torch/csrc/{src}",
               "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
               "max_abs_err": err,
               "err_is": "weight and bias gradients, relative to each one's largest magnitude",
               "per_point_outlier_share": out, "ms": (ev[1] + ev[2]) / 2,
               "plain_ms": plain_ms,
               **bound(n * per_point_bytes + 4 * w_floats, 2.0 * n * mac, n * alu, bf16=True),
               "library_ms": None, "n_points": n, "basis": "tri", "dtype": "bf16",
               "need_dx": False, "alu_instructions_per_point": alu, "body": "wgmma",
               "wmma_body_ms": (ev[0] + ev[3]) / 2, "wmma_body_max_rel_err": err_old,
               "turns_ms": ev, "device_ms": (dv[1] + dv[2]) / 2,
               "wmma_body_device_ms": (dv[0] + dv[3]) / 2, "device_turns_ms": dv, **extra}
        emit({"phase": "timing", **rec})
        records.append(rec)
        del x, g
        torch.cuda.empty_cache()

    # the same two backward kernels with dx (need_dx), which the camera
    # optimizer turns on in every backward launch of a step (run 7): the same
    # shapes as the no-dx records, the wgmma bodies, so that the two compare
    # directly. The extra work the function defines: the ds / dc products
    # against W0 (2H x hidden_1 MACs a point), the (3 x H) product with B^T,
    # the dx write (12 bytes a point) and the slopes of the encoding
    for name, n, per_point_bytes, w_floats, mac, alu, src, line in (
        ("fourier_mlp_bwd", n_c0, 12 + 4 + 12, 2 * a_w, c_mac + pm[0] + 3 * pB.shape[1],
         alu_ops_per_point("fourier_mlp_bwd", pB.shape[1], a_hidden, need_dx=True),
         "fourier_mlp_bwd.cu", 381),
        ("fourier_field_bwd", n_d, 12 + 64 + 16 + 64 + 12, 2 * b_w,
         d_mac + bm[0] + 3 * fB.shape[1],
         alu_ops_per_point("fourier_field_bwd", fB.shape[1], b_hidden, need_dx=True),
         "fourier_field_bwd.cu", 707),
    ):
        x = positions(n)
        is_c = name == "fourier_mlp_bwd"
        g = torch.randn(1 if is_c else 4, n, generator=gen).to(dev)
        kern, plain = (c_call("tri", True, True, x, g) if is_c
                       else d_call("tri", True, True, x, feats(n), g))
        got, want = kern(), plain()
        err = max(rel_err(a, b) for a, b in zip(got, want) if a.shape[-1] != n)
        out = max(outliers(a, b, BWD_TOLERANCE[("tri", True)])
                  for a, b in zip(got, want) if a.shape[-1] == n)
        check(err <= SUM_TOLERANCE and out <= PER_POINT_OUTLIERS,
              f"{name} with dx: rel err {err}, outliers {out}")
        del got, want
        turns = [both_ms(kern, 10), both_ms(kern, 10)]
        plain_ms = time_ms(plain, 2)
        nodx = next(r for r in records if r["name"] == name)
        rec = {"name": f"{name}_dx", "route": "cuda",
               "source": f"nerf_kbs_tpu_torch/csrc/{src}",
               "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
               "max_abs_err": err,
               "err_is": "weight and bias gradients, relative to each one's largest magnitude",
               "per_point_outlier_share": out, "ms": (turns[0][0] + turns[1][0]) / 2,
               "plain_ms": plain_ms,
               **bound(n * per_point_bytes + 4 * w_floats, 2.0 * n * mac, n * alu, bf16=True),
               "library_ms": None, "n_points": n, "basis": "tri", "dtype": "bf16",
               "need_dx": True, "alu_instructions_per_point": alu, "body": "wgmma",
               "turns_ms": [t[0] for t in turns],
               "device_ms": (turns[0][1] + turns[1][1]) / 2,
               "device_turns_ms": [t[1] for t in turns],
               "no_dx_device_ms": nodx["device_ms"], "no_dx_bound_ms": nodx["bound_ms"]}
        emit({"phase": "timing", **rec})
        records.append(rec)
        del x, g
        torch.cuda.empty_cache()

    # kernels A and C at the nerfacto field's base widths (H = 128, (256, 128,
    # 128, 16)): the semantics path runs the base MLP alone in them, through
    # their base-width wgmma bodies. Parity in both bases and dtypes (C with
    # and without dx) at run 2's train-step shape (4096 rays x 48 samples) and
    # a ragged N; the wgmma bodies at the edge N values and A at one eval
    # chunk; then times at the train-step shape, tri, bf16, the wgmma and
    # WMMA bodies in turns, C with and without dx
    hB = fB  # the field's frequencies, (3, 128)
    base_dims = fcfg.base_mlp.dims
    n_base = 4096 * cfg.num_nerf_samples_per_ray

    def base_a(basis, bf16, x):
        B = hB * (2 * math.pi) if basis == "sincos" else hB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=base_dims, bf16=bf16, basis=basis)
        return (lambda: ff.fourier_mlp(spec, x, B, bws, bbs),
                lambda: ff.fourier_mlp_reference(x, B, bws, bbs, basis, bf16))

    def base_c(basis, bf16, need_dx, x, g):
        B = hB * (2 * math.pi) if basis == "sincos" else hB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=base_dims, bf16=bf16, basis=basis,
                               need_dx=need_dx)

        def flat(res):
            dx, dws, dbs = res
            return ([] if dx is None else [dx]) + list(dws) + list(dbs)

        return (lambda: flat(ff._mlp_backward(spec, x, B, bws, bbs, g)),
                lambda: flat(ff.fourier_mlp_backward_reference(x, B, bws, bbs, g, basis, bf16,
                                                               need_dx)))

    ff.reset_launches()
    for n in (n_base, 100_003):
        x = positions(n)
        g = torch.randn(base_dims[-1], n, generator=gen).to(dev)
        for basis in ("tri", "sincos"):
            for bf16 in (True, False):
                kern, plain = base_a(basis, bf16, x)
                got, want = kern(), plain()
                err = float((got - want).abs().max())
                tol = TOLERANCE[(basis, bf16)]
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"fourier_mlp_fwd base widths n={n} {basis} bf16={bf16}: err {err}")
                emit({"phase": "parity", "kernel": "fourier_mlp_fwd", "widths": "base",
                      "dims": list(base_dims), "n": n, "basis": basis,
                      "dtype": "bf16" if bf16 else "f32", "body": "base_wgmma" if bf16 else "f32",
                      "max_abs_err": err, "tol": tol, "max_abs_ref": float(want.abs().max())})
                for need_dx in (False, True):
                    kern, plain = base_c(basis, bf16, need_dx, x, g)
                    got, want, again = kern(), plain(), kern()
                    check(all(bool(torch.isfinite(t).all()) for t in got),
                          "fourier_mlp_bwd base widths: non-finite output")
                    tol = BWD_TOLERANCE[(basis, bf16)]
                    per_point = [a.shape[-1] == n for a in got]
                    errs = [rel_err(a, b) for a, b in zip(got, want)]
                    out = [outliers(a, b, tol) for a, b, pp in zip(got, want, per_point) if pp]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    emit({"phase": "parity", "kernel": "fourier_mlp_bwd", "widths": "base",
                          "dims": list(base_dims), "n": n, "basis": basis,
                          "dtype": "bf16" if bf16 else "f32", "need_dx": need_dx,
                          "body": "base_wgmma" if bf16 else "f32", "sum_tol": SUM_TOLERANCE,
                          "max_rel_err": max(e for e, pp in zip(errs, per_point) if not pp),
                          "last_layer_rel_err": errs[-1],
                          "per_point_outlier_share": max(out, default=None),
                          "repeat_bit_identical": same})
                    check(all(e <= SUM_TOLERANCE for e, pp in zip(errs, per_point) if not pp),
                          f"fourier_mlp_bwd base n={n} {basis} bf16={bf16} dx={need_dx}: {errs}")
                    check(all(o <= PER_POINT_OUTLIERS for o in out),
                          f"fourier_mlp_bwd base n={n} {basis} bf16={bf16}: outliers {out}")
                    check(same, f"fourier_mlp_bwd base n={n}: a repeat gave other bits")
                    del got, want, again
        del x, g
        torch.cuda.empty_cache()
    # bf16 on the base-width wgmma bodies; f32 on the f32 bodies, which count
    # under the kernels' plain keys
    ran = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(ran == {"fourier_mlp_base_wgmma": 4, "fourier_mlp": 4,
                  "fourier_mlp_bwd_base_wgmma": 16, "fourier_mlp_bwd": 16},
          f"base-width launches {ran}")

    # the base-width bodies below and around one tile and past the tiles the
    # card holds at once (2 x 2 warpgroups an SM in the forward, 2 in the
    # backward's per-point pass), held as the proposal widths' above: the
    # forward to its plain version and to the WMMA body; the backward's last
    # layer (dW_2, db_2: no mask) to the plain version and every output to
    # the WMMA body, which rounds and masks at the same places
    for n in (1, 63, 64, 65, 64 * 3 + 1, 64 * 132 * 4 + 1):
        x = positions(n)
        g = torch.randn(base_dims[-1], n, generator=gen).to(dev)
        for basis in ("tri", "sincos"):
            before = dict(ff.LAUNCHES)
            kern, plain = base_a(basis, True, x)
            got, want = kern(), plain()
            err = float((got - want).abs().max())
            err_old = float((got - wmma_body(kern, "fourier_mlp_fwd")()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= TOLERANCE[(basis, True)]
                  and err_old <= TOLERANCE[(basis, True)],
                  f"fourier_mlp_fwd base n={n} {basis}: err {err}, vs WMMA body {err_old}")
            errs = {}
            for need_dx in (False, True):
                kern, plain = base_c(basis, True, need_dx, x, g)
                got, want, again = kern(), plain(), kern()
                old = wmma_body(kern, "fourier_mlp_bwd")()
                check(all(bool(torch.isfinite(t).all()) for t in got),
                      f"fourier_mlp_bwd base n={n}: non-finite output")
                last = [int(need_dx) + 2, int(need_dx) + 5]  # dW_2, db_2
                errs[need_dx] = {"last_layer_vs_plain": max(rel_err(got[i], want[i]) for i in last),
                                 "all_vs_plain": max(rel_err(a, b) for a, b in zip(got, want)),
                                 "all_vs_wmma_body": max(rel_err(a, b)
                                                         for a, b in zip(got, old))}
                check(errs[need_dx]["last_layer_vs_plain"] <= SUM_TOLERANCE
                      and errs[need_dx]["all_vs_wmma_body"] <= SUM_TOLERANCE,
                      f"fourier_mlp_bwd base n={n} {basis} need_dx={need_dx}: {errs[need_dx]}")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fourier_mlp_bwd base n={n} {basis}: a repeat gave other bits")
            moved = {k: ff.LAUNCHES[k] - before[k] for k in ff.LAUNCHES if ff.LAUNCHES[k] != before[k]}
            check(moved == {"fourier_mlp_base_wgmma": 1, "fourier_mlp": 1,
                            "fourier_mlp_bwd_base_wgmma": 4, "fourier_mlp_bwd": 2},
                  f"base edge launches {moved}")
            emit({"phase": "parity_edge", "kernels": "fourier_mlp_fwd, fourier_mlp_bwd",
                  "widths": "base", "n": n, "basis": basis, "dtype": "bf16",
                  "fwd_max_abs_err": err, "fwd_vs_wmma_body": err_old,
                  "tol": TOLERANCE[(basis, True)],
                  "bwd_rel_err": {"no_dx": errs[False], "dx": errs[True]},
                  "sum_tol": SUM_TOLERANCE, "repeat_bit_identical": True})
        del x, g
        torch.cuda.empty_cache()

    # A at one eval chunk of run 2 (1 << 16 rays x 48 samples)
    n_chunk = (1 << 16) * cfg.num_nerf_samples_per_ray
    x = positions(n_chunk)
    for basis in ("tri", "sincos"):
        kern, plain = base_a(basis, True, x)
        got = kern()
        err = float((got - plain()).abs().max())
        err_old = float((got - wmma_body(kern, "fourier_mlp_fwd")()).abs().max())
        emit({"phase": "parity", "kernel": "fourier_mlp_fwd", "widths": "base",
              "dims": list(base_dims), "n": n_chunk, "basis": basis, "dtype": "bf16",
              "body": "base_wgmma", "max_abs_err": err, "vs_wmma_body": err_old,
              "tol": TOLERANCE[(basis, True)]})
        check(bool(torch.isfinite(got).all()) and err <= TOLERANCE[(basis, True)]
              and err_old <= TOLERANCE[(basis, True)],
              f"fourier_mlp_fwd base n={n_chunk} {basis}: err {err}, vs WMMA body {err_old}")
        del got
    del x
    torch.cuda.empty_cache()

    bm_all = macs(base_dims)
    base_hidden = sum(base_dims[1:-1])
    base_w = sum(t.numel() for t in (*bws, *bbs)) + fB.numel()
    c_base_mac = 3 * fB.shape[1] + sum(bm_all[:-1]) + sum(bm_all) + sum(bm_all[1:])
    for name, need_dx, per_point_bytes, w_floats, mac, src, line in (
        ("fourier_mlp_fwd", False, 12 + 4 * base_dims[-1], base_w,
         3 * fB.shape[1] + sum(bm_all), "fourier_mlp_fwd.cu", 329),
        ("fourier_mlp_bwd", False, 12 + 4 * base_dims[-1], 2 * base_w, c_base_mac,
         "fourier_mlp_bwd.cu", 381),
        # with dx: d_enc = W_0 . dh_0 (2H x 128 MACs a point), B . dproj, and
        # the dx write
        ("fourier_mlp_bwd", True, 12 + 4 * base_dims[-1] + 12, 2 * base_w,
         c_base_mac + bm_all[0] + 3 * fB.shape[1], "fourier_mlp_bwd.cu", 381),
    ):
        x = positions(n_base)
        is_c = name == "fourier_mlp_bwd"
        g = torch.randn(base_dims[-1], n_base, generator=gen).to(dev)
        kern, plain = base_c("tri", True, need_dx, x, g) if is_c else base_a("tri", True, x)
        old = wmma_body(kern, name)
        got, want, prev = kern(), plain(), old()
        if is_c:
            err = max(rel_err(a, b) for a, b in zip(got, want) if a.shape[-1] != n_base)
            err_old = max(rel_err(a, b) for a, b in zip(prev, want) if a.shape[-1] != n_base)
            out = max([outliers(a, b, BWD_TOLERANCE[("tri", True)])
                       for a, b in zip(got, want) if a.shape[-1] == n_base], default=None)
            check(err <= SUM_TOLERANCE and err_old <= SUM_TOLERANCE
                  and (out is None or out <= PER_POINT_OUTLIERS),
                  f"{name} base dx={need_dx}: rel err {err}, WMMA body {err_old}, outliers {out}")
        else:
            err = float((got - want).abs().max())
            err_old = float((prev - want).abs().max())
            check(err <= TOLERANCE[("tri", True)] and err_old <= TOLERANCE[("tri", True)],
                  f"{name} base: err {err}, WMMA body {err_old}")
        del got, want, prev
        reps = 10 if is_c else 20
        turns = [both_ms(old, 3), both_ms(kern, reps), both_ms(kern, reps), both_ms(old, 3)]
        by_name = turns[1][2]
        ev, dv = [t[0] for t in turns], [t[1] for t in turns]
        plain_ms = time_ms(plain, 3)
        alu = alu_ops_per_point(name, fB.shape[1], base_hidden, base_dims[-1], need_dx=need_dx)
        body_kernel = f"{name}_base_wgmma_kernel"
        rec = {"name": f"{name}_base" + ("_dx" if need_dx else ""), "route": "cuda",
               "source": f"nerf_kbs_tpu_torch/csrc/{src}",
               "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
               "max_abs_err": err,
               **({"err_is": "weight and bias gradients, relative to each one's largest "
                             "magnitude", "per_point_outlier_share": out,
                   "need_dx": need_dx} if is_c else {}),
               "ms": (ev[1] + ev[2]) / 2, "plain_ms": plain_ms,
               **bound(n_base * per_point_bytes + 4 * w_floats, 2.0 * n_base * mac,
                       n_base * alu, bf16=True),
               "library_ms": None, "n_points": n_base, "dims": list(base_dims),
               "h_freqs": fB.shape[1], "basis": "tri", "dtype": "bf16", "body": "base_wgmma",
               "alu_instructions_per_point": alu, "wmma_body_ms": (ev[0] + ev[3]) / 2,
               "wmma_body_max_err": err_old, "turns_ms": ev,
               "device_ms": (dv[1] + dv[2]) / 2, "wmma_body_device_ms": (dv[0] + dv[3]) / 2,
               "device_turns_ms": dv,
               "body_kernel_ms": sum(v for k, v in by_name.items() if body_kernel in k),
               "device_ms_by_kernel": {k[:60]: v for k, v in by_name.items()}}
        if is_c:
            rec.update({
                "per_point_pass_ms": rec.pop("body_kernel_ms"),
                "weight_gradient_passes_ms": sum(v for k, v in by_name.items()
                                                 if "nkt_field_dw" in k),
                "reduction_ms": sum(v for k, v in by_name.items()
                                    if "nkt_reduce_partials" in k),
                "scratch_bytes": ff._mlp_base_scratch_bytes(n_base)})
        emit({"phase": "timing", **rec})
        records.append(rec)
        del x, g
        torch.cuda.empty_cache()
    return records


# kernel name -> its wrapper's name in fused_field.KERNELS, and the launch
# counter of the body the main paths run (the wgmma body of all four)
WRAPPER = {"fourier_mlp_fwd": "fourier_mlp", "fourier_field_fwd": "fourier_field_mlp",
           "fourier_mlp_bwd": "fourier_mlp_bwd", "fourier_field_bwd": "fourier_field_mlp_bwd"}
COUNTER = {k: f"{v}_wgmma" for k, v in WRAPPER.items()}
# the turns of bodies a path is run with: every kernel's wgmma body, the field
# kernels' WMMA bodies (the proposal-field kernels on wgmma), and the
# proposal-field kernels' WMMA bodies (the field kernels on wgmma)
BODY_TURNS = {"wgmma": frozenset(), "wmma": frozenset({"fourier_field_mlp",
                                                       "fourier_field_mlp_bwd"}),
              "mlp_wmma": frozenset({"fourier_mlp", "fourier_mlp_bwd"})}


def body_turns(ff, work, reps: int) -> dict:
    """Seconds of ``work()`` under each of BODY_TURNS, each taken twice in a
    mirrored order, ``reps`` calls a turn."""
    turns = {k: [] for k in BODY_TURNS}
    for body in ("wmma", "mlp_wmma", "wgmma", "wgmma", "mlp_wmma", "wmma"):
        ff.FORCE_WMMA = BODY_TURNS[body]
        try:
            for _ in range(reps):
                t0 = time.perf_counter()
                work()
                turns[body].append(time.perf_counter() - t0)
        finally:
            ff.FORCE_WMMA = frozenset()
    return turns


def _png(url: str) -> int:
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
        check(resp.headers["Content-Type"] == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n",
              f"{url}: not a PNG")
        return len(body)


def device_events(work, by_op: bool = False):
    """One call of ``work`` under torch.profiler: (wall microseconds, the
    device-side entries (kernels, copies) with their self device time in
    microseconds and call counts, longest first). An aten:: op's entry repeats
    the time of the kernels it launched and is left out; with ``by_op`` the
    ops' entries come instead (each with the device time of the kernels it
    launched itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
              if dev_us(e) > 0 and str(e.device_type).endswith("CUDA") != by_op]
    return wall_us, sorted(events, key=lambda e: e[1], reverse=True)


# op names of the non-fused field's work, for the by-op profile's groups
OP_GROUPS = (("table scatter-adds", ("index_add", "IndexSelectBackward", "index_put")),
             ("gathers", ("index_select", "aten::index", "gather")),
             ("MLP products", ("mm", "addmm", "matmul", "bmm", "linear")))


def phase_profile(work, n_rays: int, what: str = "frame", top: int = 12,
                  by_op: bool = False) -> None:
    """Where the time of one call of ``work`` goes (a frame, a train step):
    device time by kernel name and the device's busy share of the wall time;
    with ``by_op`` also by the op that launched it, in OP_GROUPS and the rest
    (glue). The profiler's own overhead inflates the wall time somewhat."""
    wall_us, events = device_events(work)
    busy = sum(us for _, us, _ in events)
    rec = {"phase": "profile", "of": what, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": max(0.0, 1.0 - busy / wall_us), "rays": n_rays,
           "top": [{"name": name[:80], "calls": count, "device_ms": us / 1e3, "share": us / busy}
                   for name, us, count in events[:top]]}
    if by_op:
        _, ops = device_events(work, by_op=True)
        groups = {g: 0.0 for g, _ in OP_GROUPS} | {"glue": 0.0}
        for name, us, _ in ops:
            g = next((g for g, keys in OP_GROUPS if any(k in name for k in keys)), "glue")
            groups[g] += us / 1e3
        rec["by_op"] = [{"op": name[:80], "calls": count, "device_ms": us / 1e3}
                        for name, us, count in ops[:top]]
        rec["by_op_group_ms"] = groups
    emit(rec)


def phase_slice(records):
    import dataclasses

    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
    from nerf_kbs_tpu_torch.data.synthetic import orbit_cameras
    from nerf_kbs_tpu_torch.engine.render import Renderer
    from nerf_kbs_tpu_torch.engine.viewer import ViewerServer
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.models import nerfacto
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    spec = nerfacto_tpu_method()
    cfg = dataclasses.replace(spec.model_config(), num_images=32)
    check(cfg.compute_dtype == "bfloat16", "mixed precision must give bf16 compute")
    params = nerfacto.init(cfg, seed=0)
    box = np.array([[-1.0] * 3, [1.0] * 3])
    h, w = 376, 1241
    cams = DataparserOutputs([], orbit_cameras(32, h=h, w=w), box).cameras()
    chunk = spec.trainer.eval_num_rays_per_chunk
    renderer = Renderer(params, cfg, cams, step=30000, eval_num_rays_per_chunk=chunk)
    renderer.render_camera(1)  # warm-up: library load, allocator, cuBLAS
    torch.cuda.synchronize()

    ff.reset_launches()
    t0 = time.perf_counter()
    out = renderer.render_camera(0)  # ends in a copy to the host
    dt = time.perf_counter() - t0
    launches = dict(ff.LAUNCHES)
    n_chunks = -(-h * w // chunk)
    rgb = out["rgb"]
    check(rgb.shape == (h, w, 3), f"rgb shape {rgb.shape}")
    check(bool(np.isfinite(rgb).all()), "non-finite rgb")
    check(float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0, "rgb outside [0, 1]")
    check(bool(np.isfinite(out["depth"]).all()), "non-finite depth")
    check(launches == {**dict.fromkeys(ff.LAUNCHES, 0), "fourier_mlp_wgmma": 2 * n_chunks,
                       "fourier_field_mlp_wgmma": n_chunks},
          f"launches {launches} for {n_chunks} chunks")
    for rec in records:
        if rec["name"] in COUNTER and not rec["name"].endswith("_bwd"):
            rec["launches"] = launches[COUNTER[rec["name"]]]
            rec["launches_per"] = "376x1241 frame"
    # the frame time: median of repeated renders of the same camera
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        renderer.render_camera(0)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    # the same frame under each turn of bodies (host time varies from run to
    # run: compare within this run only)
    turns = body_turns(ff, lambda: renderer.render_camera(0), 3)
    emit({"phase": "slice_bodies", "render_s": turns,
          "median_render_s": {k: sorted(v)[len(v) // 2] for k, v in turns.items()}})
    emit({"phase": "slice", "method": "nerfacto-tpu", "compute_dtype": cfg.compute_dtype,
          "image": [h, w], "chunk_rays": chunk, "chunks": n_chunks, "launches": launches,
          "first_render_s": dt, "render_s": times, "median_render_s": med,
          "rays_per_s": h * w / med, "ms_per_chunk": med * 1e3 / n_chunks,
          "rgb_mean": float(rgb.mean()), "accumulation_mean": float(out["accumulation"].mean())})

    phase_profile(lambda: renderer.render_camera(4), h * w)
    ff.FORCE_WMMA = BODY_TURNS["mlp_wmma"]
    try:
        phase_profile(lambda: renderer.render_camera(4), h * w, what="frame, mlp_wmma bodies")
    finally:
        ff.FORCE_WMMA = frozenset()

    # the whole path on the card (kernels, f32) against the CPU plain path
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    small = DataparserOutputs([], orbit_cameras(4, h=24, w=32), box).cameras()
    r_gpu = Renderer(params, cfg32, small, step=30000, eval_num_rays_per_chunk=256)
    r_cpu = Renderer(params, cfg32, small, step=30000, eval_num_rays_per_chunk=256,
                     device="cpu")
    ff.reset_launches()
    got, want = r_gpu.render_camera(2), r_cpu.render_camera(2)
    check(ff.LAUNCHES["fourier_field_mlp"] == 3, f"small render launches {ff.LAUNCHES}")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in ("rgb", "accumulation")}
    emit({"phase": "slice_vs_cpu", "camera": [24, 32], "max_abs_err": errs, "tol": 1e-3})
    check(all(e <= 1e-3 for e in errs.values()), f"card vs CPU render: {errs}")

    viewer = ViewerServer(renderer, port=0).start()
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        with urllib.request.urlopen(base + "/status", timeout=60) as resp:
            status = json.loads(resp.read())
        t0 = time.perf_counter()
        sizes = {
            "render": _png(base + "/render?cam=3"),
            "render_depth": _png(base + "/render?cam=5&kind=depth"),
            "orbit": _png(base + "/orbit?theta=0.7&phi=0.3&radius=1.6&size=128"),
        }
        emit({"phase": "viewer", "status": status, "png_bytes": sizes,
              "seconds": time.perf_counter() - t0})
    finally:
        viewer.close()


def phase_train(records):
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.cameras.cameras import generate_rays
    from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
    from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager, orbit_cameras
    from nerf_kbs_tpu_torch.engine.optimizers import build_optimizer, tree_leaves
    from nerf_kbs_tpu_torch.engine.trainer import Trainer, mark_trainable
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.models import nerfacto
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    dev = torch.device("cuda")
    spec = nerfacto_tpu_method()
    cfg = dataclasses.replace(spec.model_config(), num_images=32)
    check(cfg.compute_dtype == "bfloat16" and cfg.stop_grad_sampling, "flagship train config")

    # (1) the bench's step: random pixels of 32 KITTI-sized cameras, random
    # colours, step 500 of the schedules, the registry's optimizers
    h, w, batch_rays, n_steps, warm = 376, 1241, 16384, 22, 2
    params = nerfacto.init(cfg, seed=0)
    mark_trainable(params)
    opt = build_optimizer(spec.optimizers, nerfacto.param_groups(params))
    cams = DataparserOutputs([], orbit_cameras(32, h=h, w=w),
                             np.array([[-1.0] * 3, [1.0] * 3])).cameras()
    gen = torch.Generator(device=dev).manual_seed(1)
    start = [t.detach().clone() for t in tree_leaves(params)]

    def bench_step():
        idx = torch.stack([torch.randint(0, hi, (batch_rays,), generator=gen, device=dev)
                           for hi in (32, h, w)], dim=-1).to(torch.int32)
        batch = {"ray_indices": idx,
                 "image": torch.rand(batch_rays, 3, generator=gen, device=dev)}
        rays = generate_rays(cams, idx)
        out = nerfacto.forward(params, cfg, rays, step=500, train=True, generator=gen)
        total, _ = nerfacto.loss(cfg, out, batch, train=True)
        opt.zero_grad()
        total.backward()
        opt.step()
        return total.detach()

    ff.reset_launches()
    times, losses = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = bench_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = dict(ff.LAUNCHES)
    check(launches == {**dict.fromkeys(ff.LAUNCHES, 0), "fourier_mlp_wgmma": 2 * n_steps,
                       "fourier_field_mlp_wgmma": n_steps, "fourier_mlp_bwd_wgmma": 2 * n_steps,
                       "fourier_field_mlp_bwd_wgmma": n_steps},
          f"train launches {launches} for {n_steps} steps")
    check(all(np.isfinite(losses)), f"non-finite train loss {losses}")
    for rec in records:
        if rec["name"] not in COUNTER:  # the base-width records: phase_cli
            continue
        # per step: the counts are exact multiples of n_steps (checked above)
        if rec["name"].endswith("_bwd"):
            rec["launches"] = launches[COUNTER[rec["name"]]] // n_steps
            rec["launches_per"] = "16,384-ray train step"
            rec["bench_launches"] = launches[COUNTER[rec["name"]]]
        else:
            rec["train_launches"] = launches[COUNTER[rec["name"]]] // n_steps
    moved = {}
    for (path, now), was in zip(_leaf_paths(params), start):
        moved[path] = bool((now.detach() != was).any())
    frozen = [p for p in moved if p.endswith("fourier_B")]
    check(len(frozen) == 3 and not any(moved[p] for p in frozen), f"fourier_B moved: {moved}")
    check(all(m for p, m in moved.items() if p not in frozen), f"parameters stood still: {moved}")
    med = sorted(times[warm:])[(n_steps - warm) // 2]
    emit({"phase": "train_step", "method": "nerfacto-tpu", "compute_dtype": cfg.compute_dtype,
          "rays": batch_rays, "steps": n_steps, "warm_up": warm, "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "step_ms": times, "median_step_ms": med, "rays_per_s": batch_rays / (med * 1e-3),
          "loss_first": losses[0], "loss_last": losses[-1],
          "lr": opt.learning_rate("fields"), "parameters_moved": sum(moved.values()),
          "parameters_frozen": len(frozen)})

    # the same step under each turn of bodies
    def synced_step():
        bench_step()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    turns = {k: [t * 1e3 for t in v] for k, v in body_turns(ff, synced_step, 6).items()}
    emit({"phase": "train_step_bodies", "step_ms": turns,
          "median_step_ms": {k: sorted(v)[len(v) // 2] for k, v in turns.items()}})

    # (3) where one step's time goes
    phase_profile(bench_step, batch_rays, what="train_step")
    ff.FORCE_WMMA = BODY_TURNS["mlp_wmma"]
    try:
        phase_profile(bench_step, batch_rays, what="train_step, mlp_wmma bodies")
    finally:
        ff.FORCE_WMMA = frozenset()
    del params, opt, start
    torch.cuda.empty_cache()

    # (2) the trainer on the synthetic sphere scene, full width
    out_dir = tempfile.mkdtemp(prefix="nkt_smoke_")
    tcfg = dataclasses.replace(spec.trainer, output_dir=out_dir, log_every=1,
                               steps_per_save=10**9, steps_per_eval_image=10**9,
                               steps_per_eval_batch=10**9)
    dm = SyntheticDataManager(num_cameras=12, h=64, w=64,
                              rays_per_batch=spec.datamanager.train_num_rays_per_batch)
    mcfg = dataclasses.replace(spec.model_config(), num_images=12)
    trainer = Trainer(tcfg, mcfg, spec.optimizers, dm)
    ff.reset_launches()
    t0 = time.perf_counter()
    last = trainer.train(30)
    train_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in (trainer.out_dir / "metrics.jsonl").read_text().splitlines()]
    totals = [ln["total_loss"] for ln in lines if "total_loss" in ln]
    check(len(totals) == 30 and all(np.isfinite(totals)), f"trainer losses {totals}")
    first, end = float(np.mean(totals[:5])), float(np.mean(totals[-5:]))
    check(end < first, f"trainer loss did not fall: first five {first}, last five {end}")
    check(ff.LAUNCHES["fourier_field_mlp_bwd_wgmma"] == 30
          and ff.LAUNCHES["fourier_mlp_bwd_wgmma"] == 60,
          f"trainer launches {ff.LAUNCHES}")
    em = trainer.eval_image(0)
    check(np.isfinite(em["psnr"]), f"eval_image {em}")
    ckpt = trainer.save_checkpoint()
    again = Trainer(dataclasses.replace(tcfg, load_dir=str(trainer.out_dir),
                                        experiment_name="reloaded"), mcfg, spec.optimizers, dm)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(again.params),
                                                 tree_leaves(trainer.params)))
    check(again.step == 30 and same, "checkpoint did not load back the parameters")
    emit({"phase": "trainer", "steps": 30, "rays_per_batch": dm.rays_per_batch,
          "loss_first_five": first, "loss_last_five": end, "loss_step_1": totals[0],
          "loss_step_30": totals[-1], "psnr_step_30": last["psnr"], "seconds": train_s,
          "rays_per_sec_last_step": last["rays_per_sec"], "eval_image": em,
          "checkpoint": Path(ckpt).name, "reloaded_step": again.step})
    del trainer, again
    torch.cuda.empty_cache()

    # (4) three f32 steps on the card (kernels) against the CPU plain path:
    # same seeds, same batches, same jitter (drawn on the CPU in both)
    cfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
    small = SyntheticDataManager(num_cameras=12, h=64, w=64, rays_per_batch=256)
    runs = {}
    for where in ("cuda", "cpu"):
        t = Trainer(dataclasses.replace(tcfg, experiment_name=f"f32_{where}"), cfg32,
                    spec.optimizers, small, device=where)
        runs[where] = [float(t.train_step(t._to_device(small.next_train(s)))["total_loss"])
                       for s in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    # f32 on both sides; the first Adam steps move every weight by ~lr, so
    # differences in summation order grow a little from step to step
    emit({"phase": "train_vs_cpu", "rays": 256, "losses_card": runs["cuda"],
          "losses_cpu": runs["cpu"], "max_rel_diff": rel, "tol": 2e-3})
    check(rel <= 2e-3, f"card vs CPU f32 train steps: {runs}")


# the scene's image size: the KITTI dataparser's default, the size the serving
# frame measures
SCENE_HW = (376, 1241)


def phase_scene(out_dir: str) -> str:
    """The port's KITTI-layout dynamic street scene at SCENE_HW, 8 frames,
    written by nerf_kbs_tpu_torch.data.synthetic_kitti (NumPy ray tracing, the
    port's PNG encoder), with the forward flow of the first 7 frames (from
    each frame's one trace)."""
    from nerf_kbs_tpu_torch.data.synthetic_kitti import write_dynamic_dataset

    import numpy as np

    h, w = SCENE_HW
    t0 = time.perf_counter()
    scene = write_dynamic_dataset(Path(out_dir) / "scene", n_frames=8, h=h, w=w)
    seconds = time.perf_counter() - t0
    depths = [np.load(f) for f in sorted((scene / "depth").glob("*.npy"))]
    flows = [np.load(f) for f in sorted((scene / "flow_fwd").glob("*.npy"))]
    check(len(flows) == 7 and all(f.shape == (h, w, 3) and np.isfinite(f).all() for f in flows),
          f"{len(flows)} flow files")
    emit({"phase": "scene", "frames": 8, "image": [h, w], "seconds": seconds,
          "flow_files": len(flows), "flow_valid_share": [float(f[..., 2].mean()) for f in flows],
          "flow_max_px": [float(np.abs(f[..., :2]).max()) for f in flows],
          "bytes": sum(f.stat().st_size for f in scene.rglob("*") if f.is_file()),
          "depth_max_m": [float(d.max()) for d in depths],
          "pixels_over_1000_m": [int((d > 1000.0).sum()) for d in depths],
          "sky_pixels": [int((d == 0).sum()) for d in depths]})
    return str(scene)


# the two CLI runs: nerfacto-tpu on the fully fused path, and semantic-nerfw on
# the fused Fourier path with depth, semantics and masks (nerfacto-tpu's model
# fields), both from the scene on disk, 8 frames, 6 train and 2 eval
def _run_argv(scene: str, out: str) -> list:
    return ["--dataparser.data_dir", scene, "--dataparser.first_frame", "0",
            "--dataparser.last_frame", "8", "--dataparser.train_split_fraction", "0.75",
            "--trainer.max_num_iterations", "30", "--trainer.output_dir", out,
            "--trainer.log_every", "1", "--dataparser.image_height", str(SCENE_HW[0]),
            "--dataparser.image_width", str(SCENE_HW[1])]


# run 2's launches per train step and per eval chunk: the proposal fields on
# A / C's wgmma bodies (2 each), the base MLP on their base-width ones (1)
RUN2_STEP = {"fourier_mlp_wgmma": 2, "fourier_mlp_base_wgmma": 1, "fourier_mlp_bwd_wgmma": 2,
             "fourier_mlp_bwd_base_wgmma": 1}
RUN2_CHUNK = {"fourier_mlp_wgmma": 2, "fourier_mlp_base_wgmma": 1}
RUN2_MODEL = ["--model.field_type", "fourier", "--model.hidden_dim", "128",
              "--model.num_layers", "3", "--model.base_res", "4", "--model.max_res", "256",
              "--model.fourier_basis", "tri", "--model.num_proposal_samples_per_ray", "96,32",
              "--model.stop_grad_sampling", "true", "--model.interlevel_ray_fraction", "0.5",
              "--model.appearance_embedding_dim", "0"]


def _run2_data(scene: str) -> list:
    return ["--dataparser.semantics_dir", f"{scene}/sem", "--dataparser.mask_dir",
            f"{scene}/mask", "--dataparser.depth_unit_scale_factor", "1.0"]


def _cli_run(cli, ff, method: str, argv: list, out: str, per_step: dict,
             per_chunk: dict, phase: str | None = None, hw: tuple = SCENE_HW) -> dict:
    """cli.main in-process: 30 steps, eval_all_images, a checkpoint. The
    launch counts of the whole call must be 30 x per_step plus 2 eval images
    x ceil(H * W / chunk) chunks x per_chunk, chunk being the method's
    eval_num_rays_per_chunk and H x W the scene's ``hw`` (no launch at all
    when both are empty)."""
    spec = cli.apply_overrides(cli.method_registry[method](), _pairs(argv))
    chunk = spec.trainer.eval_num_rays_per_chunk
    import numpy as np

    ff.reset_launches()
    t0 = time.perf_counter()
    cli.main([method] + argv)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    chunks = 2 * -(-hw[0] * hw[1] // chunk)
    want = {k: 30 * per_step.get(k, 0) + chunks * per_chunk.get(k, 0)
            for k in set(per_step) | set(per_chunk)}
    check(launches == want, f"{method}: launches {launches}, want {want}")
    lines = [json.loads(ln) for ln in
             (Path(out) / "exp" / method / "metrics.jsonl").read_text().splitlines()]
    steps = [ln for ln in lines if "total_loss" in ln]
    check(len(steps) == 30, f"{method}: {len(steps)} logged steps")
    terms = [k for k in steps[0] if k.endswith("_loss")]
    check(all(np.isfinite(ln[k]) for ln in steps for k in terms), f"{method}: non-finite loss")
    rays = spec.datamanager.train_num_rays_per_batch
    step_ms = [rays / ln["rays_per_sec"] * 1e3 for ln in steps]
    med = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    final = {k[len("eval_all_"):]: v for k, v in lines[-1].items() if k.startswith("eval_all_")}
    check(final.get("num_images") == 2 and all(np.isfinite(v) for v in final.values()),
          f"{method}: eval {final}")
    rec = {"phase": phase or f"cli_{method.replace('-', '_')}", "method": method, "steps": 30,
           "rays_per_batch": rays, "wall_s": wall, "step_ms": step_ms,
           "median_step_ms": med, "rays_per_s": rays / (med * 1e-3),
           "loss_first": steps[0]["total_loss"], "loss_last": steps[-1]["total_loss"],
           "loss_terms": {k: [ln[k] for ln in steps] for k in terms}, "eval_all": final,
           "launches": launches, "eval_chunks": chunks,
           "launches_per_step": per_step, "launches_per_eval_chunk": per_chunk}
    emit(rec)
    return rec


def _depth_alignment_spy():
    """Wraps ops.losses.normalized_depth_scale_and_shift, the closed-form
    alignment of the training depth term (the trainer's eval imports its own
    reference and is not seen), and keeps each call's inputs and outputs on
    the card, so the step makes no extra sync. Returns (calls, summary,
    restore); summary() gives per call the f32 det as the term computed it,
    the same system in f64, the scale and shift used, the spread of the
    rendered depth and whether it carries a gradient."""
    import torch

    from nerf_kbs_tpu_torch.ops import losses as L

    real = L.normalized_depth_scale_and_shift
    calls = []

    def spy(pred, gt, mask):
        scale, shift = real(pred, gt, mask)
        calls.append((pred.requires_grad, *(t.detach().clone() for t in (pred, gt, mask)),
                      scale.detach(), shift.detach()))
        return scale, shift

    def summary():
        rows = []
        for grad, pred, gt, mask, scale, shift in calls:
            a00, a01, a11 = (torch.sum(mask * pred * pred, -1), torch.sum(mask * pred, -1),
                             torch.sum(mask, -1))
            p, g, m = pred.double(), gt.double(), mask.double()
            d00, d01, d11 = (m * p * p).sum(-1), (m * p).sum(-1), m.sum(-1)
            e0, e1 = (m * p * g).sum(-1), (m * g).sum(-1)
            det64 = d00 * d11 - d01 * d01
            mean = d01 / d11
            rows.append({
                "det": float(a00 * a11 - a01 * a01), "det_f64": float(det64),
                "det_f64_rel": float(det64 / (d00 * d11)),
                "scale": float(scale), "shift": float(shift),
                "scale_f64": float((d11 * e0 - d01 * e1) / det64) if det64 > 0 else 0.0,
                "shift_f64": float((-d01 * e0 + d00 * e1) / det64) if det64 > 0 else 0.0,
                "depth_mean": float(mean),
                "depth_std": float((d00 / d11 - mean ** 2).clamp_min(0).sqrt()),
                "depth_min": float(pred.min()), "depth_max": float(pred.max()),
                "target_rms": float(((m * g * g).sum() / d11).sqrt()), "rays": float(d11),
                "target_max": float((m * g).max()),
                "targets_over_1000": int(((m > 0) & (g > 1000.0)).sum()),
                "depth_has_gradient": grad})
        return rows

    L.normalized_depth_scale_and_shift = spy
    return calls, summary, lambda: setattr(L, "normalized_depth_scale_and_shift", real)


def phase_cli(records, scene: str) -> None:
    import tempfile

    import torch

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    out = tempfile.mkdtemp(prefix="nkt_cli_")
    # run 1: kernels A and C at the proposal widths, B and D at the field's,
    # all on their wgmma bodies; eval chunks of 1 << 15 rays
    argv1 = _run_argv(scene, out)
    r1 = _cli_run(cli, ff, "nerfacto-tpu", argv1, out,
                  per_step={"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1,
                            "fourier_mlp_bwd_wgmma": 2, "fourier_field_mlp_bwd_wgmma": 1},
                  per_chunk={"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1})

    # --eval-only from run 1's checkpoint reproduces its final metrics
    ckpt_dir = str(Path(out) / "exp" / "nerfacto-tpu")
    ff.reset_launches()
    t0 = time.perf_counter()
    cli.main(["nerfacto-tpu"] + argv1 + ["--eval-only", "true", "--trainer.load_dir", ckpt_dir])
    eval_only_s = time.perf_counter() - t0
    lines = (Path(ckpt_dir) / "metrics.jsonl").read_text().splitlines()
    again = {k[len("eval_all_"):]: v for k, v in json.loads(lines[-1]).items()
             if k.startswith("eval_all_")}
    check(again == r1["eval_all"], f"--eval-only gave {again}, training ended at {r1['eval_all']}")
    check({k: v for k, v in ff.LAUNCHES.items() if v} ==
          {k: v - 30 * {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1}.get(k, 0)
           for k, v in r1["launches"].items() if "bwd" not in k},
          f"--eval-only launches {ff.LAUNCHES}")
    # the eval time of the split: eval_all_images of a trainer built from the
    # checkpoint, timed warm
    spec = cli.apply_overrides(cli.method_registry["nerfacto-tpu"](),
                               {"trainer.load_dir": ckpt_dir, **_pairs(argv1)})
    trainer = cli.build_trainer(spec)
    trainer.eval_all_images()
    t0 = time.perf_counter()
    trainer.eval_all_images()
    split_s = time.perf_counter() - t0
    emit({"phase": "cli_eval_only", "method": "nerfacto-tpu", "matches_training_end": True,
          "eval_all": again, "call_s": eval_only_s, "eval_all_images_s": split_s,
          "eval_images": 2, "ms_per_image": split_s * 1e3 / 2})
    del trainer
    torch.cuda.empty_cache()

    # run 2: semantic-nerfw; the proposal fields on A / C's wgmma bodies, the
    # base MLP on their base-width wgmma bodies at (256, 128, 128, 16); eval
    # chunks of 1 << 16 rays (the method's)
    argv2 = argv1 + RUN2_MODEL + _run2_data(scene)
    per_step2, per_chunk2 = RUN2_STEP, RUN2_CHUNK
    calls, summary, restore = _depth_alignment_spy()
    try:
        r2 = _cli_run(cli, ff, "semantic-nerfw", argv2, out, per_step2, per_chunk2)
    finally:
        restore()
    check({"masked_psnr", "depth_mse", "semantic_accuracy"} <= set(r2["eval_all"]),
          f"semantic-nerfw eval {r2['eval_all']}")
    # the depth term of each of run 2's steps: its alignment, and whether any
    # gradient of it can reach a parameter (the rendered depth must carry one)
    rows = summary()
    check(len(rows) == 30, f"depth term ran {len(rows)} times in 30 steps")
    singular = [i for i, r in enumerate(rows) if r["scale"] == 0.0 and r["shift"] == 0.0]
    parsed = cli.apply_overrides(cli.method_registry["semantic-nerfw"](), _pairs(argv2))
    emit({"phase": "cli_semantic_nerfw_depth", "steps": len(rows),
          "dataparser_scale": parsed.dataparser.parse("train").dataparser_scale,
          "singular_steps": len(singular), "singular_at": singular,
          "steps_with_depth_gradient": sum(r["depth_has_gradient"] for r in rows),
          "stop_grad_sampling": True, "depth_loss": r2["loss_terms"]["depth_loss"],
          "alignment": rows})
    del calls
    spec = cli.apply_overrides(cli.method_registry["semantic-nerfw"](),
                               {"trainer.load_dir": str(Path(out) / "exp" / "semantic-nerfw"),
                                **_pairs(argv2)})
    trainer = cli.build_trainer(spec)
    trainer.eval_all_images()
    t0 = time.perf_counter()
    trainer.eval_all_images()
    split_s = time.perf_counter() - t0
    emit({"phase": "cli_eval_split", "method": "semantic-nerfw", "eval_all_images_s": split_s,
          "eval_images": 2, "ms_per_image": split_s * 1e3 / 2})

    # one run-2 step under the profiler: the heads' products, the split
    # kernel's calls, the glue
    batch = trainer._to_device(trainer.dm.next_train(1000))
    ff.reset_launches()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    one_step = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(one_step == per_step2, f"one semantic-nerfw step launched {one_step}")
    # the base-width records count per run-2 step, as the others per frame or step
    for rec in records:
        if rec["name"].endswith("_base"):
            counter = f"{WRAPPER[rec['name'][:-len('_base')]]}_base_wgmma"
            rec["launches"] = one_step[counter]
            rec["launches_per"] = "4,096-ray run-2 train step"
            rec["launches_per_eval_chunk"] = per_chunk2.get(counter, 0)
            rec["run2_launches"] = r2["launches"][counter]
    phase_profile(lambda: trainer.train_step(batch), 4096, what="semantic-nerfw train step",
                  top=25)
    del trainer
    torch.cuda.empty_cache()

    # run 2's configuration at a reduced width in f32: 3 steps on the card
    # (the kernels' f32 bodies) against the same 3 steps on the CPU plain path
    _card_vs_cpu(cli, "semantic-nerfw", argv2 + REDUCED_FOURIER, "cli_semantic_nerfw_vs_cpu")


# reduced widths for the f32 steps on the CPU, 256 rays a step
REDUCED = ["--model.hidden_dim", "32", "--model.num_proposal_samples_per_ray", "32,16",
           "--model.num_nerf_samples_per_ray", "16", "--datamanager.train_num_rays_per_batch",
           "256", "--trainer.mixed_precision", "false"]
REDUCED_FOURIER = REDUCED + ["--model.fourier_num_levels", "4",
                             "--model.fourier_features_per_level", "16"]
REDUCED_HASH = REDUCED + ["--model.num_levels", "8", "--model.log2_hashmap_size", "15",
                          "--model.max_res", "256"]


# the camera optimizer, card against CPU: the tangents' gradient of the
# first step, where both sides start from the same parameters, is held to
# 2e-3 of its largest magnitude (as the losses). The last step's gradient
# and the tangents after 3 steps are recorded: on semantic-nerfw's hash path
# the samples follow the proposal densities through the sampler's bins and
# the hash cells, whose position derivatives jump at every edge, so the
# rounding-level parameter differences of two updates (the card's table
# gradient sums with atomics) move the third step's tangent gradient by
# 0.7% on an H100; and Adam (eps 1e-8) turns a gradient component
# near eps into an update of lr g / (|g| + eps), so a tangent moves by a
# visible share of lr where its gradient does
TANGENT_GRAD_TOL = 2e-3


def _card_vs_cpu(cli, method: str, argv: list, phase: str, checked_steps: int = 3,
                 tangents: bool = False) -> None:
    """3 f32 steps of ``method`` on the card against the same 3 steps on the
    CPU plain path: same seeds, batches and jitter (drawn on the CPU in
    both); the losses of the first ``checked_steps`` must agree to 2e-3 (the
    others are recorded); with ``tangents`` the camera optimizer's
    tangents are compared too (see TANGENT_GRAD_TOL)."""
    import dataclasses

    spec = cli.apply_overrides(cli.method_registry[method](), _pairs(argv))
    runs, tang = {}, {}
    for where in ("cuda", "cpu"):
        t = cli.build_trainer(dataclasses.replace(
            spec, trainer=dataclasses.replace(spec.trainer, experiment_name=f"f32_{where}")),
            device=where)
        check(t.model_config.compute_dtype == "float32", "f32 steps")
        runs[where] = []
        for s in range(3):
            runs[where].append(float(t.train_step(t._to_device(t.dm.next_train(s)))["total_loss"]))
            if tangents and s == 0:
                first = t.params["camera_opt"].grad.cpu()
        if tangents:
            tang[where] = (t.params["camera_opt"].detach().cpu(), first,
                           t.params["camera_opt"].grad.cpu(),
                           t.optimizer.learning_rate("camera_opt"))
    rels = [abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"])]
    rel = max(rels[:checked_steps])
    rec = {"phase": phase, "method": method, "rays": 256, "losses_card": runs["cuda"],
           "losses_cpu": runs["cpu"], "rel_diff_per_step": rels, "checked_steps": checked_steps,
           "max_rel_diff": rel, "tol": 2e-3}
    if tangents:
        (t_gpu, g_gpu, last_gpu, lr), (t_cpu, g_cpu, last_cpu, _) = tang["cuda"], tang["cpu"]
        scale = float(g_cpu.abs().max())
        rec.update({"tangent_grad_max_abs": scale, "tangent_grad_tol": TANGENT_GRAD_TOL,
                    "tangent_grad_rel_diff": float((g_gpu - g_cpu).abs().max()) / scale,
                    "last_tangent_grad_rel_diff": float((last_gpu - last_cpu).abs().max())
                    / float(last_cpu.abs().max()),
                    "tangent_max_abs": float(t_cpu.abs().max()),
                    "tangent_max_diff_in_lr": float((t_gpu - t_cpu).abs().max()) / lr})
    emit(rec)
    check(rel <= 2e-3, f"{phase}: card vs CPU f32 steps: {runs}")
    check(not tangents or (scale > 0 and rec["tangent_grad_rel_diff"] <= TANGENT_GRAD_TOL),
          f"{phase}: card vs CPU tangent gradients: {rec}")


def _peak_mib(work) -> float:
    """Peak device memory allocated during ``work()``, in MiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    work()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def _measure_run(cli, ff, method: str, argv: list, out: str, run: dict, phase: str,
                 what: str, hw: tuple = SCENE_HW) -> dict:
    """After a _cli_run of ``method``: a trainer from its checkpoint, the
    eval time of the split (eval_all_images, warm), the peak memory of a
    train step and of one eval chunk (the first chunk of eval camera 0), and
    a profile of one step by kernel and by op; no fused kernel may launch in
    any of it."""
    import torch

    from nerf_kbs_tpu_torch.cameras.cameras import generate_rays

    spec = cli.apply_overrides(cli.method_registry[method](),
                               {"trainer.load_dir": str(Path(out) / "exp" / method),
                                **_pairs(argv)})
    trainer = cli.build_trainer(spec)
    ff.reset_launches()
    trainer.eval_all_images()
    t0 = time.perf_counter()
    trainer.eval_all_images()
    split_s = time.perf_counter() - t0
    batch = trainer._to_device(trainer.dm.next_train(1000))
    step_mib = _peak_mib(lambda: trainer.train_step(batch))
    chunk = trainer.config.eval_num_rays_per_chunk
    h, w = hw
    rr, cc = torch.meshgrid(torch.arange(h, device=trainer.device),
                            torch.arange(w, device=trainer.device), indexing="ij")
    idx = torch.stack([torch.zeros_like(rr), rr, cc], -1).reshape(-1, 3)[:chunk].to(torch.int32)

    @torch.no_grad()
    def eval_chunk():
        rays = generate_rays(trainer.eval_cameras, idx)
        trainer.model.forward(trainer.params, trainer.model_config, rays, step=trainer.step)

    chunk_mib = _peak_mib(eval_chunk)
    check(not any(ff.LAUNCHES.values()), f"{phase}: fused kernels launched {ff.LAUNCHES}")
    rec = {"phase": phase, "method": method,
           "field_type": getattr(trainer.model_config, "field_type", None),
           "median_step_ms": run["median_step_ms"], "rays_per_s": run["rays_per_s"],
           "eval_all_images_s": split_s, "eval_images": 2, "ms_per_image": split_s * 1e3 / 2,
           "eval_chunk_rays": chunk, "peak_mib_train_step": step_mib,
           "peak_mib_eval_chunk": chunk_mib,
           "params_mib": sum(t.numel() * 4 for t in _leaf_values(trainer.params)) / 2**20}
    emit(rec)
    rays = batch["ray_indices"].shape[0]
    phase_profile(lambda: trainer.train_step(batch), rays, top=25, by_op=True, what=what)
    check(not any(ff.LAUNCHES.values()), f"{phase} profile: fused kernels launched {ff.LAUNCHES}")
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_hash(scene: str) -> None:
    """Run 3 (semantic-nerfw as registered), the other hash presets and the
    f32 card-against-CPU checks of the non-fused path; see the module
    docstring. No fused kernel may launch in any of them."""
    import tempfile

    import numpy as np
    import torch

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.models import nerfacto
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    def no_launches(what):
        check(not any(ff.LAUNCHES.values()), f"{what}: fused kernels launched {ff.LAUNCHES}")

    out = tempfile.mkdtemp(prefix="nkt_hash_")
    argv3 = _run_argv(scene, out) + _run2_data(scene)
    spec = cli.apply_overrides(cli.method_registry["semantic-nerfw"](), _pairs(argv3))
    model = spec.model_config()
    check(model.field_type == "hash" and model.compute_dtype == "bfloat16"
          and not nerfacto.uses_fused_path(model), f"run 3 config {model}")
    r3 = _cli_run(cli, ff, "semantic-nerfw", argv3, out, per_step={}, per_chunk={},
                  phase="cli_run3_semantic_nerfw_hash")
    check({"masked_psnr", "depth_mse", "semantic_accuracy"} <= set(r3["eval_all"]),
          f"run 3 eval {r3['eval_all']}")

    _measure_run(cli, ff, "semantic-nerfw", argv3, out, r3, "cli_run3_memory_and_eval",
                 "run 3 train step (semantic-nerfw, hash)")

    # the other hash presets as registered, full width, 3 steps each
    for method in ("nerfacto", "nerfacto-big", "synthetic-nerfacto"):
        argv = ["--trainer.output_dir", out]
        if cli.method_registry[method]().dataparser is not None:
            argv = _run_argv(scene, out)
        trainer = cli.build_trainer(cli.apply_overrides(cli.method_registry[method](),
                                                        _pairs(argv)))
        cfg = trainer.model_config
        check(cfg.field_type == "hash" and not nerfacto.uses_fused_path(cfg), f"{method} config")
        ff.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for s in range(3):
            b = trainer._to_device(trainer.dm.next_train(s))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(b)["total_loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(losses)), f"{method}: losses {losses}")
        no_launches(method)
        emit({"phase": "hash_preset", "method": method, "rays": b["ray_indices"].shape[0],
              "compute_dtype": cfg.compute_dtype, "num_levels": cfg.num_levels,
              "log2_hashmap_size": cfg.log2_hashmap_size, "max_res": cfg.max_res,
              "samples": [*cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray],
              "hidden_dim": cfg.hidden_dim, "losses": losses, "step_ms": times,
              "peak_mib": torch.cuda.max_memory_allocated() / 2**20})
        del trainer
        torch.cuda.empty_cache()

    # the non-fused path in f32, card against CPU
    ff.reset_launches()
    _card_vs_cpu(cli, "semantic-nerfw", argv3 + REDUCED_HASH, "cli_run3_vs_cpu")
    _card_vs_cpu(cli, "nerfacto-tpu", _run_argv(scene, out) + REDUCED_FOURIER + [
        "--model.predict_normals", "true", "--model.disable_scene_contraction", "true"],
        "normals_uncontracted_vs_cpu")
    no_launches("the f32 steps of the non-fused path")


# the Virtual KITTI 2 scene of run 4: vKITTI 2's frame size
VKITTI_HW = (375, 1242)


def phase_vkitti_scene(out_dir: str) -> str:
    """The port's vKITTI-layout scene at VKITTI_HW, 8 frames (NumPy ray
    tracing, the port's JPEG and 16-bit PNG encoders), timed; then the
    vKITTI parser and the datamanager load it, timed (the NumPy JPEG decoder
    and the 16-bit PNG decoder)."""
    import numpy as np

    from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager
    from nerf_kbs_tpu_torch.data.dataparsers.vkitti import VKittiDataParserConfig
    from nerf_kbs_tpu_torch.data.synthetic_kitti import write_vkitti_dataset
    from nerf_kbs_tpu_torch.utils.jpeg import decode_jpeg

    h, w = VKITTI_HW
    t0 = time.perf_counter()
    scene = write_vkitti_dataset(Path(out_dir) / "vkitti", n_frames=8, h=h, w=w)
    write_s = time.perf_counter() - t0
    cfg = VKittiDataParserConfig(data_dir=str(scene), train_split_fraction=0.75, use_depth=True)
    t0 = time.perf_counter()
    dm = InMemoryDataManager(cfg.parse("train"), cfg.parse("val"))
    load_s = time.perf_counter() - t0
    frame = scene / "frames" / "rgb" / "Camera_0" / "rgb_00000.jpg"
    t0 = time.perf_counter()
    decode_jpeg(frame.read_bytes())
    decode_ms = (time.perf_counter() - t0) * 1e3
    images = np.concatenate([dm.train_assets["images"], dm.eval_assets["images"]])
    depths = np.concatenate([dm.train_assets["depths"], dm.eval_assets["depths"]])
    check(images.shape == (8, h, w, 3) and depths.shape == (8, h, w)
          and np.isfinite(depths).all() and depths.max() > 0, f"vKITTI scene {images.shape}")
    jpgs = sorted((scene / "frames" / "rgb" / "Camera_0").glob("*.jpg"))
    pngs = sorted((scene / "frames" / "depth" / "Camera_0").glob("*.png"))
    emit({"phase": "vkitti_scene", "frames": 8, "image": [h, w], "write_s": write_s,
          "load_s": load_s, "jpeg_decode_ms_one_frame": decode_ms,
          "jpeg_bytes": sum(f.stat().st_size for f in jpgs),
          "depth_png_bytes": sum(f.stat().st_size for f in pngs),
          "mean_rgb": float(images.mean()), "depth_max_scene_units": float(depths.max())})
    return str(scene)


def _write_transforms_json(scene: str) -> str:
    """A transforms.json beside the street scene's frames: the cam0 poses
    turned to OpenGL camera-to-world, P2's intrinsics, the frame size and
    the depth .npy of each frame. Returns the scene directory."""
    import numpy as np

    root = Path(scene)
    p2 = [ln for ln in (root / "calib.txt").read_text().splitlines() if ln.startswith("P2:")]
    P = np.array(p2[0].split()[1:], np.float64).reshape(3, 4)
    frames = []
    for i, row in enumerate(np.loadtxt(root / "00.txt").reshape(-1, 3, 4)):
        c2w = np.eye(4)
        c2w[:3] = row
        c2w[:3, 1:3] *= -1.0  # OpenCV camera axes -> OpenGL
        frames.append({"file_path": f"00/{i:06}.png", "transform_matrix": c2w.tolist(),
                       "depth_file_path": f"depth/{i:06}.npy"})
    h, w = SCENE_HW
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": P[0, 0], "fl_y": P[1, 1], "cx": P[0, 2], "cy": P[1, 2], "w": w, "h": h,
         "frames": frames}))
    return str(root)


# reduced widths of the f32 card-against-CPU steps of vanilla-nerf. With the
# registered 10 position frequencies the training gradient is ill-conditioned
# (the fine samples move with the coarse field, and the field's spatial
# derivative grows with 2^9 pi): rounding-level differences in the first
# step's gradient grow into ~1e-3 of the loss by step 3, so the 3-step check
# runs at 4 frequencies, and the 10-frequency steps check the first loss
# only (before any update) and record the rest.
REDUCED_VANILLA = ["--model.mlp_layer_width", "64", "--model.num_coarse_samples", "16",
                   "--model.num_importance_samples", "16", "--model.pos_frequencies", "4",
                   "--datamanager.train_num_rays_per_batch", "256",
                   "--trainer.mixed_precision", "false"]
STEPS = ["--trainer.max_num_iterations", "30", "--trainer.log_every", "1"]


def phase_registry(scene: str, vkitti: str) -> None:
    """Runs 4, 5 and 6 (see the module docstring); no fused kernel may
    launch in any of them."""
    import numpy as np

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    out = tempfile.mkdtemp(prefix="nkt_registry_")

    # run 4: vanilla-nerf as registered on the vKITTI scene
    argv4 = ["--dataparser.data_dir", vkitti, "--dataparser.train_split_fraction", "0.75",
             "--trainer.output_dir", out] + STEPS
    model = cli.apply_overrides(cli.method_registry["vanilla-nerf"](), _pairs(argv4)).model
    check(model.enable_temporal_distortion and model.collider == "aabb"
          and model.skip_connections == (4,) and model.mlp_layer_width == 256
          and model.num_coarse_samples + model.num_importance_samples == 192
          and model.compute_dtype == "float32", f"run 4 config {model}")
    r4 = _cli_run(cli, ff, "vanilla-nerf", argv4, out, per_step={}, per_chunk={},
                  phase="cli_run4_vanilla_nerf", hw=VKITTI_HW)
    ckpt_dir = str(Path(out) / "exp" / "vanilla-nerf")
    cli.main(["vanilla-nerf"] + argv4 + ["--eval-only", "true", "--trainer.load_dir", ckpt_dir])
    lines = (Path(ckpt_dir) / "metrics.jsonl").read_text().splitlines()
    again = {k[len("eval_all_"):]: v for k, v in json.loads(lines[-1]).items()
             if k.startswith("eval_all_")}
    check(again == r4["eval_all"], f"run 4 --eval-only gave {again}, training {r4['eval_all']}")
    _measure_run(cli, ff, "vanilla-nerf", argv4, out, r4, "cli_run4_memory_and_eval",
                 "run 4 train step (vanilla-nerf)", hw=VKITTI_HW)

    # run 5: test-nerfacto as registered on a transforms.json of the street scene
    argv5 = ["--dataparser.data", _write_transforms_json(scene), "--trainer.output_dir", out]
    argv5 += STEPS
    model = cli.apply_overrides(cli.method_registry["test-nerfacto"](), _pairs(argv5))
    check(model.model_config().field_type == "hash"
          and model.model_config().compute_dtype == "bfloat16", "run 5 config")
    r5 = _cli_run(cli, ff, "test-nerfacto", argv5, out, per_step={}, per_chunk={},
                  phase="cli_run5_test_nerfacto")
    _measure_run(cli, ff, "test-nerfacto", argv5, out, r5, "cli_run5_memory_and_eval",
                 "run 5 train step (test-nerfacto, hash)")

    # run 6: semantic-nerfw as registered with the NeRF-W transient path and
    # the eval appearance fit
    argv6 = (_run_argv(scene, out) + _run2_data(scene)
             + ["--model.use_transient_embedding", "true",
                "--trainer.eval_fit_appearance_steps", "20"])
    r6 = _cli_run(cli, ff, "semantic-nerfw", argv6, out, per_step={}, per_chunk={},
                  phase="cli_run6_semantic_nerfw_transient")
    check({"uncertainty_loss", "density_loss", "rgb_loss"} <= set(r6["loss_terms"]),
          f"run 6 loss terms {sorted(r6['loss_terms'])}")
    check({"fit_psnr", "fit_psnr_right"} <= set(r6["eval_all"])
          and all(np.isfinite(r6["eval_all"][k]) for k in ("fit_psnr", "fit_psnr_right")),
          f"run 6 eval {r6['eval_all']}")
    _measure_run(cli, ff, "semantic-nerfw", argv6, out, r6, "cli_run6_memory_and_eval",
                 "run 6 train step (semantic-nerfw, transient)")

    # the three in f32 at reduced widths, card against CPU
    ff.reset_launches()
    _card_vs_cpu(cli, "vanilla-nerf", argv4 + REDUCED_VANILLA, "cli_run4_vs_cpu")
    _card_vs_cpu(cli, "vanilla-nerf", argv4 + REDUCED_VANILLA + ["--model.pos_frequencies", "10"],
                 "cli_run4_vs_cpu_10_frequencies", checked_steps=1)
    _card_vs_cpu(cli, "test-nerfacto", argv5 + REDUCED_HASH, "cli_run5_vs_cpu")
    _card_vs_cpu(cli, "semantic-nerfw", argv6 + REDUCED_HASH, "cli_run6_vs_cpu")
    check(not any(ff.LAUNCHES.values()), f"runs 4-6 f32 steps launched {ff.LAUNCHES}")


def _dx_spy(ff):
    """Counts the calls of the two backward wrappers by their spec's
    need_dx: ({wrapper: [calls without dx, calls with dx]}, restore)."""
    real = {"_mlp_backward": ff._mlp_backward, "_field_backward": ff._field_backward}
    calls = {"fourier_mlp_bwd": [0, 0], "fourier_field_mlp_bwd": [0, 0]}

    def spy(attr, key):
        def call(spec, *args):
            calls[key][int(spec.need_dx)] += 1
            return real[attr](spec, *args)
        return call

    ff._mlp_backward = spy("_mlp_backward", "fourier_mlp_bwd")
    ff._field_backward = spy("_field_backward", "fourier_field_mlp_bwd")
    return calls, lambda: [setattr(ff, k, v) for k, v in real.items()]


CAMERA_OPT = ["--model.camera_optimizer", "SO3xR3"]
# per train step and per eval chunk of nerfacto-tpu: A 2, B 1, C 2, D 1
FUSED_STEP = {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1, "fourier_mlp_bwd_wgmma": 2,
              "fourier_field_mlp_bwd_wgmma": 1}
FUSED_CHUNK = {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1}


def phase_camera_opt(records, scene: str) -> None:
    """Run 7: nerfacto-tpu with the camera optimizer through cli.main (every
    backward launch with dx); run 7b: semantic-nerfw as registered with it,
    3 f32 steps card against CPU. See the module docstring."""
    import numpy as np
    import torch

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    out = tempfile.mkdtemp(prefix="nkt_camopt_")
    argv7 = _run_argv(scene, out) + CAMERA_OPT
    calls, restore = _dx_spy(ff)
    try:
        r7 = _cli_run(cli, ff, "nerfacto-tpu", argv7, out, FUSED_STEP, FUSED_CHUNK,
                      phase="cli_run7_camera_opt")
    finally:
        restore()
    check(calls == {"fourier_mlp_bwd": [0, 60], "fourier_field_mlp_bwd": [0, 30]},
          f"run 7 backward calls [no dx, dx]: {calls}")
    lines = [json.loads(ln) for ln in
             (Path(out) / "exp" / "nerfacto-tpu" / "metrics.jsonl").read_text().splitlines()]
    reg = [ln["camera_opt_regularizer"] for ln in lines if "camera_opt_regularizer" in ln]
    check(len(reg) == 30 and all(np.isfinite(reg)), f"run 7 regularizer {reg}")

    # the tangents after 30 steps, from the checkpoint; the eval of the split
    spec = cli.apply_overrides(cli.method_registry["nerfacto-tpu"](),
                               {"trainer.load_dir": str(Path(out) / "exp" / "nerfacto-tpu"),
                                **_pairs(argv7)})
    trainer = cli.build_trainer(spec)
    tangents = trainer.params["camera_opt"].detach()
    check(trainer.step == 30 and bool(torch.isfinite(tangents).all())
          and float(tangents[:, :3].abs().max()) > 0 and float(tangents[:, 3:].abs().max()) > 0,
          f"run 7 tangents {tangents}")
    trainer.eval_all_images()
    t0 = time.perf_counter()
    trainer.eval_all_images()
    split_s = time.perf_counter() - t0
    del trainer

    # step 0 from tangent 0: the gradient reaches every camera's tangents
    fresh = cli.build_trainer(cli.apply_overrides(cli.method_registry["nerfacto-tpu"](),
                                                  _pairs(argv7)))
    batch = fresh._to_device(fresh.dm.next_train(0))
    ff.reset_launches()
    calls, restore = _dx_spy(ff)
    try:
        fresh.train_step(batch)
        torch.cuda.synchronize()
    finally:
        restore()
    one_step = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(one_step == FUSED_STEP and calls == {"fourier_mlp_bwd": [0, 2],
                                               "fourier_field_mlp_bwd": [0, 1]},
          f"one run-7 step launched {one_step}, backward calls {calls}")
    # at step 0 the coarse-to-fine window is closed, so the field does not
    # depend on position yet and the translations get no gradient; the
    # rotations do, through the view directions' SH features. From step 1
    # the first level opens a little and the translations get a small one
    # (the 30-step run above checks that they moved)
    grad = fresh.params["camera_opt"].grad.clone()
    check(bool(torch.isfinite(grad).all()) and float(grad[:, 3:].abs().max()) > 0,
          f"run 7 step-0 tangent gradient {grad}")
    fresh.train_step(fresh._to_device(fresh.dm.next_train(1)))
    grad1 = fresh.params["camera_opt"].grad
    check(bool(torch.isfinite(grad1).all()), f"run 7 step-1 tangent gradient {grad1}")
    for rec in records:
        if rec["name"].endswith("_dx") and "_base" not in rec["name"]:
            wrapper = WRAPPER[rec["name"][:-len("_dx")]]
            rec["launches"] = one_step[f"{wrapper}_wgmma"]
            rec["launches_per"] = "4,096-ray run-7 train step"
            rec["run7_launches"] = r7["launches"][f"{wrapper}_wgmma"]
    emit({"phase": "cli_run7_tangents", "steps": 30, "cameras": int(tangents.shape[0]),
          "translation_max_abs": float(tangents[:, :3].abs().max()),
          "rotation_max_abs_rad": float(tangents[:, 3:].abs().max()),
          "regularizer_first": reg[0], "regularizer_last": reg[-1],
          "step0_grad_translation_max_abs": float(grad[:, :3].abs().max()),
          "step0_grad_rotation_max_abs": float(grad[:, 3:].abs().max()),
          "step1_grad_translation_max_abs": float(grad1[:, :3].abs().max()),
          "step1_grad_rotation_max_abs": float(grad1[:, 3:].abs().max()),
          "eval_all_images_s": split_s, "eval_images": 2, "ms_per_image": split_s * 1e3 / 2,
          "launches_per_step": one_step, "backward_calls_per_step_no_dx_dx": calls})
    phase_profile(lambda: fresh.train_step(batch), 4096,
                  what="run 7 train step (camera optimizer, C and D with dx)", top=16)
    del fresh
    # the same step of run 1 (no camera optimizer, no dx), for the difference
    base = cli.build_trainer(cli.apply_overrides(cli.method_registry["nerfacto-tpu"](),
                                                 _pairs(_run_argv(scene, out))))
    batch = base._to_device(base.dm.next_train(0))
    base.train_step(batch)
    phase_profile(lambda: base.train_step(batch), 4096,
                  what="run 1 train step (beside run 7's)", top=16)
    del base
    torch.cuda.empty_cache()

    # one step of run 2's configuration with the camera optimizer: the base
    # MLP's C launch takes the base-width body's dx branch there
    run2 = cli.build_trainer(cli.apply_overrides(
        cli.method_registry["semantic-nerfw"](),
        _pairs(_run_argv(scene, out) + RUN2_MODEL + _run2_data(scene) + CAMERA_OPT)))
    batch = run2._to_device(run2.dm.next_train(0))
    real, seen = ff._mlp_backward, []

    def spy(spec, *args):
        seen.append((tuple(spec.layer_dims), spec.need_dx))
        return real(spec, *args)

    ff.reset_launches()
    ff._mlp_backward = spy
    try:
        run2.train_step(batch)
        torch.cuda.synchronize()
    finally:
        ff._mlp_backward = real
    one_step = {k: v for k, v in ff.LAUNCHES.items() if v}
    base_calls = [dx for dims, dx in seen if dims == tuple(run2.model_config.field.base_mlp.dims)]
    check(one_step == RUN2_STEP and base_calls == [True],
          f"one run-2 step with the camera optimizer launched {one_step}, backward calls {seen}")
    for rec in records:
        if rec["name"] == "fourier_mlp_bwd_base_dx":
            rec["launches"] = one_step["fourier_mlp_bwd_base_wgmma"]
            rec["launches_per"] = "4,096-ray run-2 train step with --model.camera_optimizer SO3xR3"
    emit({"phase": "cli_run2_camera_opt_step", "launches": one_step,
          "backward_calls_dims_need_dx": [[list(d), dx] for d, dx in seen]})
    del run2
    torch.cuda.empty_cache()

    # f32 at a reduced width, card against CPU, the tangents compared too;
    # run 7b: semantic-nerfw as registered (the hash field) with it
    ff.reset_launches()
    _card_vs_cpu(cli, "nerfacto-tpu", _run_argv(scene, out) + CAMERA_OPT + REDUCED_FOURIER,
                 "cli_run7_vs_cpu", tangents=True)
    check(ff.LAUNCHES["fourier_field_mlp_bwd"] == 3, f"run 7 f32 launches {ff.LAUNCHES}")
    ff.reset_launches()
    _card_vs_cpu(cli, "semantic-nerfw",
                 _run_argv(scene, out) + _run2_data(scene) + CAMERA_OPT + REDUCED_HASH,
                 "cli_run7b_vs_cpu", tangents=True)
    check(not any(ff.LAUNCHES.values()), f"run 7b launched {ff.LAUNCHES}")


# run 8's stream: the train frames of the scene but frames 3 and 7 (held
# out), their poses about their mean and in units of SUDS_SCALE metres
SUDS_VAL = (3, 7)
SUDS_SCALE = 20.0


def _write_suds_metadata(scene: str) -> str:
    """Sky masks from the scene's semantic colours (sky/000000.png) and a
    metadata.json over its 8 frames in the format SudsMetadataConfig reads:
    OpenGL camera-to-world about the cameras' mean in SUDS_SCALE-metre
    units, P2's intrinsics, times, depth, static masks, sky masks and the
    forward flow with its neighbour. Returns its path."""
    import numpy as np

    from nerf_kbs_tpu_torch.data.synthetic_kitti import SEMANTIC_CLASSES, SEMANTIC_COLORS
    from nerf_kbs_tpu_torch.utils.images import decode_png, encode_png_u8

    root = Path(scene)
    (root / "sky").mkdir(exist_ok=True)
    sky = SEMANTIC_COLORS[SEMANTIC_CLASSES.index("sky")]
    p2 = [ln for ln in (root / "calib.txt").read_text().splitlines() if ln.startswith("P2:")]
    P = np.array(p2[0].split()[1:], np.float64).reshape(3, 4)
    poses = np.loadtxt(root / "00.txt").reshape(-1, 3, 4)
    origin = poses[:, :, 3].mean(0)
    h, w = SCENE_HW
    frames = []
    for i, row in enumerate(poses):
        sem = decode_png((root / "sem" / f"{i:06}.png").read_bytes())
        (root / "sky" / f"{i:06}.png").write_bytes(
            encode_png_u8((np.all(sem == sky, -1) * 255).astype(np.uint8)))
        c2w = row.copy()
        c2w[:, 1:3] *= -1.0  # OpenCV camera axes -> OpenGL
        c2w[:, 3] = (c2w[:, 3] - origin) / SUDS_SCALE
        fr = {"rgb_path": str(root / "00" / f"{i:06}.png"), "c2w": c2w.tolist(), "W": w, "H": h,
              "intrinsics": [P[0, 0], P[1, 1], P[0, 2], P[1, 2]], "image_index": i,
              "time": i / (len(poses) - 1), "video_id": 0,
              "depth_path": str(root / "depth" / f"{i:06}.npy"),
              "mask_path": str(root / "mask" / f"{i:06}.png"),
              "sky_mask_path": str(root / "sky" / f"{i:06}.png"), "is_val": i in SUDS_VAL}
        if i + 1 < len(poses):
            fr["forward_flow_path"] = str(root / "flow_fwd" / f"{i:06}.npy")
            fr["forward_neighbor_index"] = i + 1
        frames.append(fr)
    path = root / "metadata.json"
    path.write_text(json.dumps({"origin": origin.tolist(), "pose_scale_factor": SUDS_SCALE,
                                "scene_bounds": [[-1.0] * 3, [1.0] * 3], "frames": frames}))
    return str(path)


def phase_stream(scene: str) -> None:
    """Run 8: the SUDS stream (metadata.json -> ChunkedStreamDataManager with
    random-subset chunks of 65,536 rows, flow and sky rows) -> Trainer with
    nerfacto-tpu at full width in bf16, flow_loss_mult 1e-3 and
    sky_loss_mult 0.1, 30 steps of 4,096 rays; the chunk builds (host time,
    on the stream's thread) against the steps they overlap; the eval of the
    2 held-out frames; 3 f32 steps card against CPU on the same batches."""
    import dataclasses

    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.data.dataparsers.suds_metadata import SudsMetadataConfig
    from nerf_kbs_tpu_torch.data.stream import ChunkedStreamDataManager, StreamConfig
    from nerf_kbs_tpu_torch.engine.trainer import Trainer
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    class TimedStream(ChunkedStreamDataManager):
        """The stream with each chunk build's interval and each batch's
        request time recorded (host clock)."""

        def __init__(self, *args):
            self.builds, self.requests, self.swaps = [], [], 0
            super().__init__(*args)

        def _build_chunk(self):
            t0 = time.perf_counter()
            chunk = super()._build_chunk()
            self.builds.append((t0, time.perf_counter()))
            return chunk

        def next_train(self, step):
            self.requests.append(time.perf_counter())
            before = self._chunk
            batch = super().next_train(step)
            self.swaps += self._chunk is not before
            return batch

    t0 = time.perf_counter()
    parser = SudsMetadataConfig(metadata_path=_write_suds_metadata(scene))
    train, _ = parser.load_items("train")
    val, _ = parser.load_items("val")
    write_s = time.perf_counter() - t0
    spec = nerfacto_tpu_method()
    mcfg = dataclasses.replace(spec.model_config(), num_images=len(train), flow_loss_mult=1e-3,
                               sky_loss_mult=0.1)
    out = tempfile.mkdtemp(prefix="nkt_stream_")
    tcfg = dataclasses.replace(spec.trainer, output_dir=out, method_name="nerfacto-tpu-stream",
                               log_every=1, steps_per_save=10**9, steps_per_eval_image=10**9,
                               steps_per_eval_batch=10**9, steps_per_eval_all_images=10**9)
    scfg = StreamConfig(load_random_subset=True, items_per_chunk=65536, with_flow=True,
                        with_sky=True, train_num_rays_per_batch=4096)
    dm = TimedStream(train, val, scfg)
    try:
        trainer = Trainer(tcfg, mcfg, spec.optimizers, dm)
        ff.reset_launches()
        t_start = time.perf_counter()
        trainer.train(30)
        wall = time.perf_counter() - t_start
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        check(launches == {k: 30 * v for k, v in FUSED_STEP.items()},
              f"run 8 launches {launches}")
        lines = [json.loads(ln) for ln in (trainer.out_dir / "metrics.jsonl").read_text()
                 .splitlines()]
        steps = [ln for ln in lines if "total_loss" in ln]
        check(len(steps) == 30, f"run 8: {len(steps)} logged steps")
        terms = [k for k in steps[0] if k.endswith("_loss")]
        check({"flow_loss", "sky_loss"} <= set(terms)
              and all(np.isfinite(ln[k]) for ln in steps for k in terms),
              f"run 8 loss terms {terms}")
        check(dm.swaps >= 2 and len(dm.builds) >= 2, f"run 8: {dm.swaps} chunk loads")
        step_ms = [4096 / ln["rays_per_sec"] * 1e3 for ln in steps]
        med = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
        # a step overlaps a build when the build ran between its batch request
        # and the next one
        ends = dm.requests[1:30] + [t_start + wall]
        overlap = [any(b0 < e and b1 > s0 for b0, b1 in dm.builds)
                   for s0, e in zip(dm.requests[:30], ends)]
        during = [t for t, o in zip(step_ms[2:], overlap[2:]) if o]
        apart = [t for t, o in zip(step_ms[2:], overlap[2:]) if not o]
        trainer.eval_all_images()
        t0 = time.perf_counter()
        final = trainer.eval_all_images()
        split_s = time.perf_counter() - t0
        check(final["num_images"] == 2 and all(np.isfinite(v) for v in final.values()),
              f"run 8 eval {final}")
        emit({"phase": "cli_run8_stream", "method": "nerfacto-tpu", "steps": 30,
              "rays_per_batch": 4096, "train_frames": len(train), "eval_frames": len(val),
              "items_per_chunk": scfg.items_per_chunk, "metadata_and_sky_s": write_s,
              "wall_s": wall, "step_ms": step_ms, "median_step_ms": med,
              "rays_per_s": 4096 / (med * 1e-3), "chunk_loads": dm.swaps,
              "chunk_builds": len(dm.builds),
              "chunk_build_s": [b1 - b0 for b0, b1 in dm.builds],
              "steps_overlapping_a_build": sum(overlap),
              "median_step_ms_during_build": sorted(during)[len(during) // 2] if during else None,
              "median_step_ms_apart": sorted(apart)[len(apart) // 2] if apart else None,
              "loss_terms": {k: [ln[k] for ln in steps] for k in terms},
              "flow_loss_last": steps[-1]["flow_loss"], "sky_loss_last": steps[-1]["sky_loss"],
              "eval_all": final, "eval_all_images_s": split_s, "launches": launches})
        batch = trainer._to_device(dm.next_train(30))
        phase_profile(lambda: trainer.train_step(batch), 4096, what="run 8 train step (stream)")
        del trainer
    finally:
        dm.close()
    torch.cuda.empty_cache()

    # 3 f32 steps at a reduced width on the same stream batches, card
    # against CPU
    small = TimedStream(train, val, dataclasses.replace(scfg, train_num_rays_per_batch=256))
    try:
        batches = [small.next_train(s) for s in range(3)]
        cfg32 = dataclasses.replace(mcfg, compute_dtype="float32", hidden_dim=32,
                                    num_proposal_samples_per_ray=(32, 16),
                                    num_nerf_samples_per_ray=16, fourier_num_levels=4,
                                    fourier_features_per_level=16)
        runs = {}
        for where in ("cuda", "cpu"):
            t = Trainer(dataclasses.replace(tcfg, experiment_name=f"f32_{where}"), cfg32,
                        spec.optimizers, small, device=where)
            runs[where] = [{k: float(v) for k, v in t.train_step(t._to_device(b)).items()}
                           for b in batches]
    finally:
        small.close()
    rels = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
            for a, b in zip(runs["cuda"], runs["cpu"])]
    emit({"phase": "cli_run8_vs_cpu", "rays": 256,
          "losses_card": [m["total_loss"] for m in runs["cuda"]],
          "losses_cpu": [m["total_loss"] for m in runs["cpu"]],
          "flow_loss_card": [m["flow_loss"] for m in runs["cuda"]],
          "flow_loss_cpu": [m["flow_loss"] for m in runs["cpu"]],
          "sky_loss_card": [m["sky_loss"] for m in runs["cuda"]],
          "sky_loss_cpu": [m["sky_loss"] for m in runs["cpu"]],
          "rel_diff_per_step": rels, "max_rel_diff": max(rels), "tol": 2e-3})
    check(max(rels) <= 2e-3, f"run 8 card vs CPU f32 steps: {rels}")


def _pairs(argv: list) -> dict:
    """--k v pairs of an argv list as override paths."""
    return {k[2:]: v for k, v in zip(argv[::2], argv[1::2])}


def _leaf_values(tree):
    return [t for _, t in _leaf_paths(tree)]


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (HERE / "nerf_kbs_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script ({HERE})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import nerf_kbs_tpu_torch  # noqa: F401  (sets allow_tf32 = False)

    phase_device()
    records = phase_kernels()
    phase_slice(records)
    phase_train(records)
    with tempfile.TemporaryDirectory(prefix="nkt_scene_") as tmp:
        scene = phase_scene(tmp)
        phase_cli(records, scene)
        phase_hash(scene)
        phase_registry(scene, phase_vkitti_scene(tmp))
        phase_camera_opt(records, scene)
        phase_stream(scene)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_kbs_tpu", "PIL", "cv2")]
    check(not bad, f"imported {bad}")
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
