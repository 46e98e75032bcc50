#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_kbs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:
1. device: the card (nvidia-smi name and power limit), then the five kernel
   sources (the four fused-field kernels, each with a wgmma body for the
   flagship widths, a WMMA body for other widths and an f32 body, the two
   fused-MLP sources also a wgmma body for the field's base widths; and the
   fixed-order segment sums with their radix sort) are built from csrc/ into
   build/ (one nvcc per source, started together), with ptxas' registers
   and spills of every wgmma kernel, of the segment sums and of the sort;
2. kernel parity: each kernel against its plain PyTorch version on the card
   (the hash grid's at the hash-train-16k step's three fields, hash_grid_records),
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
4. the training slice: 22 steps of bench_torch.py's train step, built from
   bench_torch (full-width bf16 nerfacto-tpu, 16,384 random pixels of 32
   cameras of 376x1241 and random colours per step, forward -> loss ->
   backward -> per-group Adam) with the
   launch counts 2 / 1 / 2 / 1 per step (all through their wgmma
   bodies) and the median step time of the last
   20; the same three turns of bodies; Trainer.train(30) at full width on the
   synthetic sphere scene (loss
   finite and falling, metrics.jsonl, eval_image, checkpoint save and load);
   a profiler pass over one step, once more with the proposal-field kernels'
   WMMA bodies; 3 steps in f32 on the card against the
   same 3 steps on the CPU plain path; then (phase bench_torch) the port's
   bench entry point, bench_torch.py, at a cut depth: bench_method("fourier",
   16384, steps=3, inner=5) with A 2 / B 1 / C 2 / D 1 launches a step and
   bench_render(65536, steps=2, inner=2) with A 2 / B 1 a chunk and
   bench_method("hash", 4096, steps=2, inner=2) with no kernel launch, the
   rays/s printed with the card's name and power limit and beside the
   rays/s of this phase's bench step and of the serving frame, and the
   device's busy share of one bench step and of one render chunk (a
   profiler pass over a chunk built by bench_torch.make_render_chunk);
5. kernels A and C at the nerfacto field's base widths (H = 128, (256, 128,
   128, 16)), which the semantics path runs through their base-width wgmma
   bodies: held against their plain versions in both bases and dtypes (C
   with and without dx, repeats bit-identical) at run 2's train-step shape
   and a ragged N, every launch on the base-width counters; the wgmma bodies
   also at N below and around one tile and past the card's resident tiles
   (against the plain versions and the WMMA bodies) and A at one run-2 eval
   chunk; timed at the train-step shape, the wgmma and WMMA bodies in turns,
   C with and without dx; the same for A and C at sem30k-flagship2's 2-layer
   base (tools/reference_runs_torch.sh; (256, 128, 16), the same base-width
   wgmma bodies at one hidden layer), timed at its train step, 16,384 rays x
   48 samples, tri, bf16, no dx (the *_base2 records) (part of phase 2);
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
   reduced width against the CPU plain path; after run 1 (phase
   live_viewer) run 1 again with --trainer.vis viewer+tensorboard and
   --viewer-port: a client thread reads the page, /status, /render (rgb and
   depth), /orbit and /latest while training runs and drives a websocket
   session (status pushes, poses answered with PNGs, ping, close); the launch
   counts must be run 1's plus the viewer's chunks x (2 A + 1 B) on the wgmma
   bodies, the losses run 1's to the bit (else within the spread of two
   runs without the viewer), /render?cam=0 after training the trainer's own
   render, and the event file one record per metrics.jsonl line with valid
   CRCs; then --eval-only with --trainer.require_lpips true on seeded LPIPS
   checkpoints (one image's LPIPS card against CPU, the device ms of a
   call), and --render-only with --render-focal-mult 2 --render-pos-shift
   0.1,0,0 --render-frame-range 0,1 (9 frames of 376x1241);
8. data parallel training (phase parallel): run 1's configuration through
   engine.cli.build_trainer, 5 steps without a process group and at world
   size 1 on NCCL in this process (the losses bit for bit, launches 2 / 1 /
   2 / 1 and 2 all-reduces a step); then two ranks on the one card over
   gloo, subprocesses of this script (``--dp-rank``), each drawing half of
   the 4,096 rays a step with its own seed: nerfacto-tpu 5 steps and the
   rank-strided eval_all_images, semantic-nerfw with run 2's model fields,
   depth, semantics and masks 3 steps. The ranks' losses and parameters must
   be equal bit for bit and their launches a step run 1's (run 2's); their
   collectives a step, the gloo gradient and metrics all-reduces alone and
   one profiled step are printed; one process on the concatenated batches
   must match them within DP_LOSS_RTOL and DP_EVAL_ATOL; kernels A to D
   are held against their plain versions at one rank's point counts;
9. the host sampler (phase native_sampler): sample_ray_batch on the street
   scene's train assets (6 x 376 x 1241 with depth and masks, 4,096 rays):
   the gathered pixels, the same draws again for a seed and others for
   another, and its host ms against the NumPy draw;
10. run 3, semantic-nerfw as registered (the hash field, 16 levels of a 2^19
   table from 16 to 2048, proposals 5 levels of 2^17, (256, 96) -> 48
   samples, appearance embedding 32, bf16) with depth, semantics and masks,
   through cli.main on the same scene and window: 30 steps of 4,096 rays,
   eval_all_images and a checkpoint on the non-fused path, with no fused
   kernel launched; its step time and rays/s, the eval time of the split,
   the peak memory of a step and of an eval chunk, and a profile of one step
   by device kernel and by op (the gathers, the table scatter-adds, the MLP
   products, the glue);
11. the other hash presets as registered at full width (nerfacto and
   nerfacto-big on the scene, synthetic-nerfacto on the sphere scene): 3
   steps each, finite losses, no fused kernel launched, step times and peak
   memory;
12. 3 f32 steps on the card against the CPU plain path, at reduced widths, of
   semantic-nerfw as registered and of nerfacto-tpu with predicted normals
   and the scene contraction disabled (the second-order backward of the
   normals on the card);
13. the vKITTI scene: the port's writer makes an 8-frame 375x1242 Virtual
   KITTI 2 scene (quality-97 JPEG frames, 16-bit PNG depth), timed, and the
   vKITTI parser and the datamanager load it, timed (the NumPy JPEG decoder);
14. the last three registry paths through cli.main at full width, 30 steps
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
   card against the CPU plain path (for vanilla-nerf at 10 position
   frequencies also each f32 run's distance from an f64 CPU run); one
   --render-only frame of run 4's configuration at a reduced width card
   against CPU, its temporal distortion reading the cameras' times; then
   (phase launchers_torch) the four root launchers train_torch.py,
   train_nerf_torch.py, train_nerfacto_torch.py and train_z1_torch.py, each
   a program of its own with no method argument (so semantic-nerfw,
   vanilla-nerf, nerfacto and test-nerfacto as registered) on run 3's, run
   4's, the hash presets' and run 5's scene, 2 steps each, all four started
   together: exit code 0, 2 logged steps, the eval of the split;
15. run 7, nerfacto-tpu with --model.camera_optimizer SO3xR3 through
   cli.main on the street scene (30 steps of 4,096 rays, bf16, eval of the
   split): launch counts A 2 / B 1 / C 2 / D 1 a step with every C and D
   launch on dx, the regularizer in every step, the tangents moved after 30
   steps, the step-0 gradient of the tangents finite and non-zero, a
   profile of one step, and 3 f32 steps at a reduced width card against
   CPU with the tangents compared; one step of run 2's configuration with
   the camera optimizer (the base MLP's C launch on its dx branch); run 7b,
   semantic-nerfw as registered (hash field) with the camera optimizer, 3
   f32 steps card against CPU, with each run's distance from an f64 CPU run;
16. run 8, the SUDS stream: sky masks from the scene's semantic colours and
   a metadata.json over its frames (2 held out), SudsMetadataConfig ->
   ChunkedStreamDataManager (random-subset chunks of 65,536 rows, flow and
   sky rows) -> Trainer with nerfacto-tpu at full width in bf16,
   flow_loss_mult 1e-3 and sky_loss_mult 0.1, 30 steps of 4,096 rays: the
   launch counts, the finite flow and sky terms, the chunk loads and each
   chunk build's host time against the steps it overlapped, the eval of the
   held-out frames, a profile of one step, and 3 f32 steps card against CPU
   on the same stream batches;
17. the preprocessing pipeline (process_data/) on the street scene,
   f32 with TF32 off, no fused kernel launched (checked): the motion-mask
   driver at 640x192 (seeded monodepth2 and RAFT at 20 iterations, the
   trained segmenter of outputs/segmenter3), its seconds a frame pair, host
   share and peak memory and each network's ms a call; the host pieces of
   a pair (frame decode and BICUBIC resize, PNG encodes, dilation); the
   flow extraction both ways (14 RAFT calls); the inpainting driver at
   432x240 (window 10, stride 4) on the combined masks and on the scene's
   true moving masks, pixels far from the masks equal to the frames' own
   JPEG round trip; COLMAP text model -> build_kitti_metadata ->
   SudsMetadataConfig.load_items of both splits; the exact motion chain of
   tools/demo_motion_pipeline.py at 8 frames of 188x621, its mean IoU
   within 0.005 of the JAX package's 0.9684; every network card against CPU
   in f32, and the driver's first pair on the CPU against the card's; one
   step of each preprocessing trainer (RAFT at 640x192 with 12 iterations,
   the segmenter, the inpainter at 432x240 with T = 10) card against CPU,
   its ms and peak memory;
18. the reference operating point (phase reference_runs): the two
   protocols of tools/reference_runs_torch.sh (the JAX package's 30k-step
   runs), read from the script and cut to the street scene (split 6 / 2)
   and to 750 steps of ilf050 (nerfacto-tpu) and 450 of sem30k-flagship2
   (semantic-nerfw, tri Fourier field), the anneal and the cadences cut in
   proportion, 16,384 rays a step, through cli.main: the launch counts of
   each run (A 2 / B 1 / C 2 / D 1 a step for ilf050; A 2 + 1 on the
   base-width wgmma body for the 2-layer base, C likewise, for
   sem30k-flagship2; no WMMA body), every
   logged loss finite, and the final PSNR of the split at least 2 dB above
   the eval images' PSNR against their own mean colour (a run stalled at the
   background fails); then a profile of one sem30k-flagship2 step; then
   (phase reference_vs_cpu) both protocols at full width, f32, 256 rays, 3
   steps on the card against the CPU plain path, the Fourier window open
   from step 2: the total and every logged loss term per step, the
   semantics and interlevel terms apart;
19. (phase repeat_bits) ilf050 and sem30k-flagship2 at full width (100
   steps each, reference_argv), runs 3 and 7 (20 steps each) and the three
   preprocessing trainers (RAFT, the segmenter, the inpainter: 3 steps
   each), each trained twice from one seed in this process: every
   parameter, Adam moment and logged loss equal bit for bit after every
   step (state_checksums, module_checksums, and torch.equal at the end),
   and the segment sums' launches a step by call site and by wrapper
   (REPEAT_SEGMENT_SUMS) and the hash grid's (REPEAT_HASH_GRID: run 3 and
   run 7b, semantic-nerfw's hash field with the camera optimizer, 20 steps
   each); then the fixed-order segment sums
   (csrc/segment_sum.cu: the short-row kernel for the interlevel bounds and
   the pdf sampler's brackets and running maximum, the radix sort and the
   by-key kernel for the hash table's gradient) against their plain versions
   in f64 (long runs, empty runs, one-element rows, a shared index row, a
   run across many tiles) and, in f32, at each call site's inputs (the
   field's and a proposal field's keys), a repeat bit-identical, timed
   against the plain version and scatter_add_; the radix sort against
   torch.sort(stable=True), and a field's whole table gradient against
   index_add_'s;
20. the port's tools (phase tools_torch): the nine tools/*_torch.py as
   programs, started together at cut sizes (the orbit scene at 64x64, 50 to
   200 steps; regen_data_torch at 3 frames of 94x310): their JAX twins'
   committed result keys, the studies' launches a step (A 2 / B 1 / C 2 /
   D 1, C and D all with dx in the camera arms) and an eval chunk (A 2 / B
   1) from their '# launches' lines, and that they learn (see
   phase_tools_torch);
21. a {"kernels": [...]} line, each record's "launches" counted per
   "launches_per" (a frame, a bench step, a run-2 or a run-7 step, a run-2
   step with the camera optimizer; A to D also with
   "parallel_launches_per_rank_step" and "per_rank_n_max_err", and the
   studies' launches a step), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without CUDA, or run from a directory without the port, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import math
import os
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
            if (any(k in name for k in ("wgmma", "nkt_field_dw", "segment_", "radix_"))
                    and ("registers" in ln or "spill" in ln)):
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

    # kernels A and C at the base widths, H = 128: the nerfacto field's base
    # MLP (256, 128, 128, 16), which the semantics path runs alone in them
    # (run 2), and sem30k-flagship2's 2-layer base (256, 128, 16)
    # (tools/reference_runs_torch.sh: semantic-nerfw's split field), both
    # through their base-width wgmma bodies. Parity in both bases and dtypes
    # (C with and without dx) at run 2's train-step shape and a ragged N; the
    # wgmma bodies at the edge N values and A at one eval chunk; then times
    # tri, bf16, the wgmma and WMMA bodies in turns: the 3-layer base at run
    # 2's train step (C with and without dx), the 2-layer base at
    # sem30k-flagship2's (16,384 rays x 48 samples; no dx: its sampling is
    # detached and it has no camera optimizer)
    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli

    hB = fB  # the field's frequencies, (3, 128)
    base_dims = fcfg.base_mlp.dims
    n_base = 4096 * cfg.num_nerf_samples_per_ray
    sem = cli.apply_overrides(cli.method_registry["semantic-nerfw"](),
                              protocol_argv("sem30k-flagship2", "out")[1]).model
    base2 = sem.field.base_mlp
    check(base2.dims[0] == 2 * fB.shape[1] and base2.dims == (256, 128, 16),
          f"sem30k-flagship2's base MLP {base2.dims}")
    b2ws, b2bs = _weights(base2, gen, dev)
    n_b2 = 16384 * sem.num_nerf_samples_per_ray
    # widths name -> (dims, weights, biases)
    chains = {"base": (base_dims, bws, bbs), "base2": (base2.dims, b2ws, b2bs)}

    def base_a(basis, bf16, x, widths="base"):
        dims, ws, bs = chains[widths]
        B = hB * (2 * math.pi) if basis == "sincos" else hB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=dims, bf16=bf16, basis=basis)
        return (lambda: ff.fourier_mlp(spec, x, B, ws, bs),
                lambda: ff.fourier_mlp_reference(x, B, ws, bs, basis, bf16))

    def base_c(basis, bf16, need_dx, x, g, widths="base"):
        dims, ws, bs = chains[widths]
        B = hB * (2 * math.pi) if basis == "sincos" else hB
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=dims, bf16=bf16, basis=basis,
                               need_dx=need_dx)

        def flat(res):
            dx, dws, dbs = res
            return ([] if dx is None else [dx]) + list(dws) + list(dbs)

        return (lambda: flat(ff._mlp_backward(spec, x, B, ws, bs, g)),
                lambda: flat(ff.fourier_mlp_backward_reference(x, B, ws, bs, g, basis, bf16,
                                                               need_dx)))

    ff.reset_launches()
    for widths, (dims, _, _) in chains.items():
        for n in (n_base, 100_003):
            x = positions(n)
            g = torch.randn(dims[-1], n, generator=gen).to(dev)
            for basis in ("tri", "sincos"):
                for bf16 in (True, False):
                    kern, plain = base_a(basis, bf16, x, widths)
                    got, want = kern(), plain()
                    err = float((got - want).abs().max())
                    tol = TOLERANCE[(basis, bf16)]
                    check(bool(torch.isfinite(got).all()) and err <= tol,
                          f"fourier_mlp_fwd {widths} widths n={n} {basis} bf16={bf16}: err {err}")
                    emit({"phase": "parity", "kernel": "fourier_mlp_fwd", "widths": widths,
                          "dims": list(dims), "n": n, "basis": basis,
                          "dtype": "bf16" if bf16 else "f32",
                          "body": "base_wgmma" if bf16 else "f32",
                          "max_abs_err": err, "tol": tol, "max_abs_ref": float(want.abs().max())})
                    for need_dx in (False, True):
                        kern, plain = base_c(basis, bf16, need_dx, x, g, widths)
                        got, want, again = kern(), plain(), kern()
                        check(all(bool(torch.isfinite(t).all()) for t in got),
                              f"fourier_mlp_bwd {widths} widths: non-finite output")
                        tol = BWD_TOLERANCE[(basis, bf16)]
                        per_point = [a.shape[-1] == n for a in got]
                        errs = [rel_err(a, b) for a, b in zip(got, want)]
                        out = [outliers(a, b, tol) for a, b, pp in zip(got, want, per_point)
                               if pp]
                        same = all(torch.equal(a, b) for a, b in zip(got, again))
                        emit({"phase": "parity", "kernel": "fourier_mlp_bwd", "widths": widths,
                              "dims": list(dims), "n": n, "basis": basis,
                              "dtype": "bf16" if bf16 else "f32", "need_dx": need_dx,
                              "body": "base_wgmma" if bf16 else "f32",
                              "sum_tol": SUM_TOLERANCE,
                              "max_rel_err": max(e for e, pp in zip(errs, per_point) if not pp),
                              "last_layer_rel_err": errs[-1],
                              "per_point_outlier_share": max(out, default=None),
                              "repeat_bit_identical": same})
                        check(all(e <= SUM_TOLERANCE for e, pp in zip(errs, per_point) if not pp),
                              f"fourier_mlp_bwd {widths} n={n} {basis} bf16={bf16} "
                              f"dx={need_dx}: {errs}")
                        check(all(o <= PER_POINT_OUTLIERS for o in out),
                              f"fourier_mlp_bwd {widths} n={n} {basis} bf16={bf16}: "
                              f"outliers {out}")
                        check(same, f"fourier_mlp_bwd {widths} n={n}: a repeat gave other bits")
                        del got, want, again
            del x, g
            torch.cuda.empty_cache()
    # bf16 on the base-width wgmma bodies; f32 on the f32 bodies, which count
    # under the kernels' plain keys
    ran = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(ran == {"fourier_mlp_base_wgmma": 8, "fourier_mlp": 8,
                  "fourier_mlp_bwd_base_wgmma": 32, "fourier_mlp_bwd": 32},
          f"base-width launches {ran}")

    # the base-width bodies below and around one tile and past the tiles the
    # card holds at once (at most 6 warpgroups an SM in either pass), held as
    # the proposal widths' above: the forward to its plain version and to the
    # WMMA body; the backward's last layer (its dW and db: no mask) to the
    # plain version and every output to the WMMA body, which rounds and masks
    # at the same places
    for widths, (dims, _, _) in chains.items():
        depth = len(dims) - 1
        for n in (1, 63, 64, 65, 64 * 3 + 1, 64 * 132 * 6 + 1):
            x = positions(n)
            g = torch.randn(dims[-1], n, generator=gen).to(dev)
            for basis in ("tri", "sincos"):
                before = dict(ff.LAUNCHES)
                kern, plain = base_a(basis, True, x, widths)
                got, want = kern(), plain()
                err = float((got - want).abs().max())
                err_old = float((got - wmma_body(kern, "fourier_mlp_fwd")()).abs().max())
                check(bool(torch.isfinite(got).all()) and err <= TOLERANCE[(basis, True)]
                      and err_old <= TOLERANCE[(basis, True)],
                      f"fourier_mlp_fwd {widths} n={n} {basis}: err {err}, "
                      f"vs WMMA body {err_old}")
                errs = {}
                for need_dx in (False, True):
                    kern, plain = base_c(basis, True, need_dx, x, g, widths)
                    got, want, again = kern(), plain(), kern()
                    old = wmma_body(kern, "fourier_mlp_bwd")()
                    check(all(bool(torch.isfinite(t).all()) for t in got),
                          f"fourier_mlp_bwd {widths} n={n}: non-finite output")
                    # the last layer's dW and db
                    last = [int(need_dx) + depth - 1, int(need_dx) + 2 * depth - 1]
                    errs[need_dx] = {
                        "last_layer_vs_plain": max(rel_err(got[i], want[i]) for i in last),
                        "all_vs_plain": max(rel_err(a, b) for a, b in zip(got, want)),
                        "all_vs_wmma_body": max(rel_err(a, b) for a, b in zip(got, old))}
                    check(errs[need_dx]["last_layer_vs_plain"] <= SUM_TOLERANCE
                          and errs[need_dx]["all_vs_wmma_body"] <= SUM_TOLERANCE,
                          f"fourier_mlp_bwd {widths} n={n} {basis} need_dx={need_dx}: "
                          f"{errs[need_dx]}")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"fourier_mlp_bwd {widths} n={n} {basis}: a repeat gave other bits")
                moved = {k: ff.LAUNCHES[k] - before[k] for k in ff.LAUNCHES
                         if ff.LAUNCHES[k] != before[k]}
                check(moved == {"fourier_mlp_base_wgmma": 1, "fourier_mlp": 1,
                                "fourier_mlp_bwd_base_wgmma": 4, "fourier_mlp_bwd": 2},
                      f"{widths} edge launches {moved}")
                emit({"phase": "parity_edge", "kernels": "fourier_mlp_fwd, fourier_mlp_bwd",
                      "widths": widths, "dims": list(dims), "n": n, "basis": basis,
                      "dtype": "bf16", "fwd_max_abs_err": err, "fwd_vs_wmma_body": err_old,
                      "tol": TOLERANCE[(basis, True)],
                      "bwd_rel_err": {"no_dx": errs[False], "dx": errs[True]},
                      "sum_tol": SUM_TOLERANCE, "repeat_bit_identical": True})
            del x, g
            torch.cuda.empty_cache()

    # A at one eval chunk of run 2 and of sem30k-flagship2 (1 << 16 rays x 48
    # samples)
    n_chunk = (1 << 16) * cfg.num_nerf_samples_per_ray
    x = positions(n_chunk)
    for widths, (dims, _, _) in chains.items():
        for basis in ("tri", "sincos"):
            kern, plain = base_a(basis, True, x, widths)
            got = kern()
            err = float((got - plain()).abs().max())
            err_old = float((got - wmma_body(kern, "fourier_mlp_fwd")()).abs().max())
            emit({"phase": "parity", "kernel": "fourier_mlp_fwd", "widths": widths,
                  "dims": list(dims), "n": n_chunk, "basis": basis, "dtype": "bf16",
                  "body": "base_wgmma", "max_abs_err": err, "vs_wmma_body": err_old,
                  "tol": TOLERANCE[(basis, True)]})
            check(bool(torch.isfinite(got).all()) and err <= TOLERANCE[(basis, True)]
                  and err_old <= TOLERANCE[(basis, True)],
                  f"fourier_mlp_fwd {widths} n={n_chunk} {basis}: err {err}, "
                  f"vs WMMA body {err_old}")
            del got
    del x
    torch.cuda.empty_cache()

    H = fB.shape[1]
    ff.reset_launches()
    for widths, need_dx_cases, n_pts in (("base", (False, True), n_base),
                                         ("base2", (False,), n_b2)):
        dims, ws, bs = chains[widths]
        bm_all = macs(dims)
        hidden = sum(dims[1:-1])
        w_floats = sum(t.numel() for t in (*ws, *bs)) + fB.numel()
        c_mac = 3 * H + sum(bm_all[:-1]) + sum(bm_all) + sum(bm_all[1:])
        items = [("fourier_mlp_fwd", False, 12 + 4 * dims[-1], w_floats, 3 * H + sum(bm_all),
                  "fourier_mlp_fwd.cu", 329)]
        for need_dx in need_dx_cases:
            # with dx: d_enc = W_0 . dh_0 (2H x 128 MACs a point), B . dproj,
            # and the dx write
            items.append(("fourier_mlp_bwd", need_dx, 12 + 4 * dims[-1] + 12 * need_dx,
                          2 * w_floats, c_mac + (bm_all[0] + 3 * H) * need_dx,
                          "fourier_mlp_bwd.cu", 381))
        for name, need_dx, per_point_bytes, wf, mac, src, line in items:
            x = positions(n_pts)
            is_c = name == "fourier_mlp_bwd"
            g = torch.randn(dims[-1], n_pts, generator=gen).to(dev)
            kern, plain = (base_c("tri", True, need_dx, x, g, widths) if is_c
                           else base_a("tri", True, x, widths))
            old = wmma_body(kern, name)
            got, want, prev = kern(), plain(), old()
            if is_c:
                err = max(rel_err(a, b) for a, b in zip(got, want) if a.shape[-1] != n_pts)
                err_old = max(rel_err(a, b) for a, b in zip(prev, want) if a.shape[-1] != n_pts)
                out = max([outliers(a, b, BWD_TOLERANCE[("tri", True)])
                           for a, b in zip(got, want) if a.shape[-1] == n_pts], default=None)
                check(err <= SUM_TOLERANCE and err_old <= SUM_TOLERANCE
                      and (out is None or out <= PER_POINT_OUTLIERS),
                      f"{name} {widths} dx={need_dx}: rel err {err}, WMMA body {err_old}, "
                      f"outliers {out}")
            else:
                err = float((got - want).abs().max())
                err_old = float((prev - want).abs().max())
                check(err <= TOLERANCE[("tri", True)] and err_old <= TOLERANCE[("tri", True)],
                      f"{name} {widths}: err {err}, WMMA body {err_old}")
            del got, want, prev
            reps = 10 if is_c else 20
            turns = [both_ms(old, 3), both_ms(kern, reps), both_ms(kern, reps), both_ms(old, 3)]
            by_name = turns[1][2]
            ev, dv = [t[0] for t in turns], [t[1] for t in turns]
            plain_ms = time_ms(plain, 3)
            alu = alu_ops_per_point(name, H, hidden, dims[-1], need_dx=need_dx)
            body_kernel = f"{name}_base_wgmma_kernel"
            rec = {"name": f"{name}_{widths}" + ("_dx" if need_dx else ""), "route": "cuda",
                   "source": f"nerf_kbs_tpu_torch/csrc/{src}",
                   "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
                   "max_abs_err": err,
                   **({"err_is": "weight and bias gradients, relative to each one's largest "
                                 "magnitude", "per_point_outlier_share": out,
                       "need_dx": need_dx} if is_c else {}),
                   "ms": (ev[1] + ev[2]) / 2, "plain_ms": plain_ms,
                   **bound(n_pts * per_point_bytes + 4 * wf, 2.0 * n_pts * mac, n_pts * alu,
                           bf16=True),
                   "library_ms": None, "n_points": n_pts, "dims": list(dims),
                   "h_freqs": H, "basis": "tri", "dtype": "bf16", "body": "base_wgmma",
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
                    "scratch_bytes": ff._mlp_base_scratch_bytes(n_pts, dims)})
            emit({"phase": "timing", **rec})
            records.append(rec)
            del x, g
            torch.cuda.empty_cache()
    ran = {k: v for k, v in ff.LAUNCHES.items() if v}
    check(set(ran) == {"fourier_mlp", "fourier_mlp_bwd", "fourier_mlp_base_wgmma",
                       "fourier_mlp_bwd_base_wgmma"}, f"the base widths' timing launched {ran}")
    return records + hash_grid_records()


# the hash fields of a hash-train-16k step (semantic-nerfw as registered,
# 16,384 rays): (name, levels, log2 T, base and max resolution, points, the
# positions' gradient on)
HASH_GRID_FIELDS = (("field", 16, 19, 16, 2048, 16384 * 48, True),
                    ("proposal0", 5, 17, 16, 128, 16384 * 256, False),
                    ("proposal1", 5, 17, 16, 256, 16384 * 96, True))


def hash_grid_records() -> list:
    """The hash grid's kernels (csrc/hash_grid.cu) at the hash-train-16k
    step's three fields: the forward and the backward's emit against their
    plain versions on the card (the same arithmetic and order: bit for bit)
    and against the plain encoding (ops/encoding.py hash_encoding_plain: the
    encoding within 8 ulps of the largest |entry|, the table's gradient
    within 1e-5 of each slot's sum of |terms| plus 1e-6 of the largest, the
    positions' within 1e-5 of the largest); a repeat bit-identical; timed
    (CUDA events, back to back, and the profiler's device time) against the
    plain encoding, alone and as a forward and backward."""
    import torch

    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops.encoding import HashEncodingConfig, hash_encoding_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    recs = []
    for field, L, log2_t, base, top, n, dx in HASH_GRID_FIELDS:
        cfg = HashEncodingConfig(num_levels=L, features_per_level=2, log2_hashmap_size=log2_t,
                                 base_resolution=base, max_resolution=top)
        F, T = cfg.features_per_level, cfg.table_size
        table = (torch.rand(F * L * T, device=dev, generator=gen) - 0.5) * 2e-4
        pts = torch.rand(n, 3, device=dev, generator=gen)
        pts[: n // 100, 0] = 1.0  # far faces
        cot = torch.randn(n, cfg.output_dim, device=dev, generator=gen)
        hg.reset_launches()
        enc, keys, entries = hg.hash_grid_fwd(table, pts, cfg, True)
        vals, dpos = hg.hash_grid_bwd(entries, pts, cot, cfg, True, dx)
        grad = hg.table_gradient(keys, vals, cfg)
        again = hg.hash_grid_fwd(table, pts, cfg, True)
        again_b = hg.hash_grid_bwd(entries, pts, cot, cfg, True, dx)
        check(hg.LAUNCHES == {"hash_grid_fwd": 2, "hash_grid_bwd": 2,
                              "hash_grid_bwd_dx": 2 * dx}, f"hash grid launches {hg.LAUNCHES}")
        ref_enc, ref_keys = hg.hash_grid_fwd_reference(entries, pts, cfg, True)
        ref_vals, ref_dpos = hg.hash_grid_bwd_reference(entries, pts, cot, cfg, True, dx)
        same = {"fwd": torch.equal(enc, ref_enc) and torch.equal(keys, ref_keys),
                "vals": torch.equal(vals, ref_vals),
                "dpos": not dx or torch.equal(dpos, ref_dpos),
                "repeat": torch.equal(enc, again[0]) and torch.equal(keys, again[1])
                and torch.equal(vals, again_b[0]) and (not dx or torch.equal(dpos, again_b[1]))}
        del ref_enc, ref_keys, ref_vals, ref_dpos, again, again_b
        check(all(same.values()), f"hash_grid {field}: bits against the plain versions {same}")
        tb = table.clone().requires_grad_()
        p = pts.clone().requires_grad_(dx)
        plain = hash_encoding_plain(tb, p, cfg)
        torch.autograd.backward(plain, cot)
        err_enc = float((enc - plain).abs().max())
        check(err_enc <= 8 * 2.0**-24 * float(table.abs().max()), f"hash_grid {field}: {err_enc}")
        tb2 = table.clone().requires_grad_()
        torch.autograd.backward(hash_encoding_plain(tb2, pts, cfg), cot.abs())
        err_grad = float(((grad - tb.grad).abs() - 1e-5 * tb2.grad).max())
        check(err_grad <= 1e-6 * float(tb.grad.abs().max()),
              f"hash_grid {field}: table gradient off by {err_grad} past the slots' limits")
        err_dx = float((dpos - p.grad).abs().max()) / float(p.grad.abs().max()) if dx else None
        check(not dx or err_dx <= 1e-5, f"hash_grid {field}: positions' gradient {err_dx}")
        del plain, tb, tb2, p, vals, grad, dpos

        def fwd():
            hg.hash_grid_fwd(table, pts, cfg, True)

        def bwd():
            hg.hash_grid_bwd(entries, pts, cot, cfg, True, dx)

        def table_grad():
            hg.table_gradient(keys, v, cfg)

        def step(encode):
            tb = table.clone().requires_grad_()
            p = pts.clone().requires_grad_(dx)
            torch.autograd.backward(encode(tb, p, cfg), cot)

        def plain_fwd():
            with torch.no_grad():
                hash_encoding_plain(table, pts, cfg)

        v, _ = hg.hash_grid_bwd(entries, pts, cot, cfg, True, False)
        points, pl = n, n * L
        for name, fn, plain_fn, n_bytes in (
                ("hash_grid_fwd", fwd, plain_fwd,
                 12 * points + 4 * F * L * T + 4 * pl * F + 32 * pl),
                ("hash_grid_bwd" + ("_dx" if dx else ""), bwd, None,
                 12 * points + 4 * pl * F + 32 * pl * F + (4 * F * L * T + 12 * points) * dx),
                ("hash_grid_table_gradient", table_grad, None,
                 4 * (F * 8 * pl + 8 * pl + F * L * T)),
                ("hash_grid_step", lambda: step(hg.hash_grid), lambda: step(hash_encoding_plain),
                 None)):
            ms = time_ms(fn, 5)
            _, events = device_events(lambda: [fn() for _ in range(5)])
            rec = {"name": f"{name}.{field}", "route": "cuda",
                   "source": "nerf_kbs_tpu_torch/csrc/hash_grid.cu",
                   "replaces": "nerf_kbs_tpu/ops/encoding.py hash_encoding_apply (XLA, not "
                               "Pallas)",
                   "launches": 1 if name.endswith(("_fwd", "_bwd", "_bwd_dx")) else None,
                   "launches_per": "hash-train-16k step (a hash field each)",
                   "levels": L, "table_size": T, "features_per_level": F, "n_points": n,
                   "need_dx": dx, "ms": ms,
                   "device_ms": sum(us for _, us, _ in events) / 5e3,
                   "device_ms_by_kernel": {k[:60]: us / 5e3 for k, us, _ in events},
                   "plain_ms": time_ms(plain_fn, 3) if plain_fn else None,
                   "max_abs_err": {"hash_grid_fwd": err_enc}.get(name),
                   "bit_identical_to_plain_versions": same}
            if n_bytes is not None:
                rec.update(bound(n_bytes, 0.0, 0.0, bf16=False))
            emit({"phase": "timing", **rec})
            recs.append(rec)
        del table, pts, cot, enc, keys, entries, v
        torch.cuda.empty_cache()
    return recs

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
    launched itself). The program's spans (``nkt.*``, ``utils/profiling.py``)
    are ranges over the kernels, not device work, and are left out."""
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
              if dev_us(e) > 0 and str(e.device_type).endswith("CUDA") != by_op
              and not e.key.startswith("nkt.")]
    return wall_us, sorted(events, key=lambda e: e[1], reverse=True)


# op names of the non-fused field's work, for the by-op profile's groups
OP_GROUPS = (("table scatter-adds", ("index_add", "IndexSelectBackward", "index_put")),
             ("gathers", ("index_select", "aten::index", "gather")),
             ("MLP products", ("mm", "addmm", "matmul", "bmm", "linear")))


def phase_profile(work, n_rays: int, what: str = "frame", top: int = 12,
                  by_op: bool = False) -> dict:
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
    return rec


def phase_slice(records) -> float:
    """The serving slice (see the module docstring); returns the frame's
    rays/s."""
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

    viewer = ViewerServer(renderer, port=0)
    viewer.start_background()
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
        viewer.shutdown()
    return h * w / med


def phase_train(records) -> tuple:
    """The training slice (see the module docstring); returns the bench
    step's rays/s at its median step time and the profile of one step."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import bench_torch
    from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
    from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves
    from nerf_kbs_tpu_torch.engine.trainer import Trainer, mark_trainable
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.models import nerfacto
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    dev = torch.device("cuda")
    spec = nerfacto_tpu_method()

    # (1) bench_torch.py's step: random pixels of its 32 KITTI-sized
    # cameras, random colours, step 500 of the schedules, its Adam
    batch_rays, n_steps, warm = 16384, 22, 2
    cfg = bench_torch.bench_config("fourier", dev)
    check(cfg.compute_dtype == "bfloat16" and cfg.stop_grad_sampling, "flagship train config")
    params = nerfacto.init(cfg, seed=0, device=dev)
    mark_trainable(params)
    opt = bench_torch.bench_optimizer(params, dev)
    train_step = bench_torch.make_train_step(cfg, params, opt, bench_torch.bench_cameras(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    start = [t.detach().clone() for t in tree_leaves(params)]

    def bench_step():
        idx = bench_torch._random_ray_indices(gen, (batch_rays,))
        return train_step(idx, torch.rand(batch_rays, 3, generator=gen, device=dev),
                          generator=gen)

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
    step_profile = phase_profile(bench_step, batch_rays, what="train_step")
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
    return batch_rays / (med * 1e-3), step_profile


# bench_torch.py at a cut depth: its train bench (16,384 rays, rounds of 5
# steps, 2 warm-up rounds and 3 timed ones), its render bench (65,536-ray
# chunks, rounds of 2 chunks, 1 warm-up round and 3 timed ones) and its
# hash-grid parity point (4,096 rays, rounds of 2 steps)
BENCH_TRAIN = {"batch_size": 16384, "steps": 3, "inner": 5}
BENCH_RENDER = {"batch_size": 65536, "steps": 2, "inner": 2}
BENCH_HASH = {"batch_size": 4096, "steps": 2, "inner": 2}


def phase_bench_torch(records, smoke_train_rays_per_s: float, step_profile: dict,
                      smoke_frame_rays_per_s: float) -> None:
    """bench_torch.py, the port's bench entry point, through bench_method
    and bench_render on the card: the launch counts of each (A 2, B 1, C 2,
    D 1 a step; A 2, B 1 a chunk; none on the hash path), the rays/s beside
    the card's name and power limit and beside the smoke's own bench step
    (built from bench_torch in phase_train) and serving frame, and the
    device's busy share of the wall time of one render chunk and of one
    step (``step_profile``, phase_train's profile of the bench step)."""
    import torch

    import bench_torch
    from nerf_kbs_tpu_torch.models import nerfacto
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    runs = {}
    for what, field, kw, per_unit, warm in (
            ("train", "fourier", BENCH_TRAIN, bench_torch.FUSED_STEP, 2),
            ("render", None, BENCH_RENDER, bench_torch.FUSED_CHUNK, 1),
            ("hash", "hash", BENCH_HASH, {}, 2)):
        units = (warm + 3 * max(kw["steps"] // kw["inner"], 1)) * kw["inner"]
        ff.reset_launches()
        t0 = time.perf_counter()
        rate = (bench_torch.bench_render(**kw) if field is None
                else bench_torch.bench_method(field, **kw))
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        check(launches == {k: units * v for k, v in per_unit.items()},
              f"bench_torch {what}: launches {launches} for {units}")
        runs[what] = {"rays_per_s": rate, "units": units, "launches": launches,
                      "seconds": seconds, **kw}
        for rec in records:  # per step or chunk: exact multiples (checked above)
            if COUNTER.get(rec["name"]) in launches:
                rec[f"bench_torch_{what}_launches"] = launches[COUNTER[rec["name"]]] // units
                rec[f"bench_torch_{what}_launches_per"] = (
                    "16,384-ray bench_torch step" if what == "train"
                    else "65,536-ray bench_torch render chunk")

    # one render chunk as bench_render builds it, after a warm-up chunk
    dev = torch.device("cuda")
    cfg = bench_torch.bench_config("fourier", dev)
    chunk = bench_torch.make_render_chunk(cfg, nerfacto.init(cfg, seed=0, device=dev),
                                          bench_torch.bench_cameras(dev))
    idx = bench_torch._random_ray_indices(torch.Generator(device=dev).manual_seed(0),
                                          (2, BENCH_RENDER["batch_size"]))
    chunk(idx[0])
    render_profile = phase_profile(lambda: chunk(idx[1]), BENCH_RENDER["batch_size"],
                                   what="bench_render chunk")
    busy = {what: {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}
            for what, prof in (("train_step", step_profile), ("render_chunk", render_profile))}
    emit({"phase": "bench_torch", "nvidia_smi": smi,
          "train_rays_per_s": runs["train"]["rays_per_s"],
          "render_rays_per_s": runs["render"]["rays_per_s"],
          "hash_rays_per_s": runs["hash"]["rays_per_s"],
          "smoke_train_step_rays_per_s": smoke_train_rays_per_s,
          "smoke_frame_rays_per_s": smoke_frame_rays_per_s, "profiled": busy,
          "train": runs["train"], "render": runs["render"], "hash": runs["hash"]})


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
    phase_live_viewer(cli, ff, scene, r1)
    phase_lpips(cli, argv1, ckpt_dir, r1)
    phase_render_overrides(cli, ff, argv1, ckpt_dir)
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


# ---------------------------------------------------------------------------
# data parallel training (phase parallel) and the host sampler (phase
# native_sampler)
# ---------------------------------------------------------------------------

# run 1's launches per train step: A and C at the proposal widths, B and D at
# the field's, all on their wgmma bodies
RUN1_STEP = {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1, "fourier_mlp_bwd_wgmma": 2,
             "fourier_field_mlp_bwd_wgmma": 1}
DP_STEPS = {"nerfacto-tpu": 5, "semantic-nerfw": 3}
DP_WORLD = 2
# world 2 against one process on the concatenated batch, in bf16: each rank's
# kernels sum the weight gradients over half the points and gloo adds the
# halves, so the f32 sums round in another order. The losses' relative
# distance read 8.4e-8 to 1.7e-6 over 5 steps (H100, PERF.md). The first
# step's reduced gradients are held to one process's: their largest
# elementwise distance relative to the step's largest gradient element, and
# the ratio of their norms. Adam's update ignores a uniform scale of the
# gradient, so the losses alone would not show a wrong division by the
# world. nerfacto-tpu's per-point gradients are the same bits in both runs
# (its losses are means over equal local batches: the scales are powers of
# 2) and its weight gradients are f32 sums in the kernels; read 2.4e-7.
# semantic-nerfw's split field runs the rgb and semantic heads as bf16
# matrix products, whose weight gradients come out in bf16: each rank rounds
# its half-batch sum to bf16 before gloo adds the halves, one process rounds
# the whole sum once. Read 1.0e-3, at the rgb head's last weight, and norms
# 8.7e-5 apart (H100, PERF.md).
DP_LOSS_RTOL = 1e-5
DP_GRAD_RTOL = {"nerfacto-tpu": 1e-5, "semantic-nerfw": 5e-3}
DP_GRAD_NORM_RTOL = 1e-3
DP_EVAL_ATOL = {"psnr": 0.05, "psnr_right": 0.05, "ssim": 2e-3}


def _dp_argv(scene: str, out: str, method: str) -> list:
    argv = _run_argv(scene, out)
    return argv + RUN2_MODEL + _run2_data(scene) if method == "semantic-nerfw" else argv


class _Collectives:
    """Counts the calls of torch.distributed's collectives while installed."""

    NAMES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "barrier")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.count, self.real = dist, {}, {n: getattr(dist, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(dist, n, self._wrap(n))

    def _wrap(self, name):
        def call(*a, **k):
            self.count[name] = self.count.get(name, 0) + 1
            return self.real[name](*a, **k)
        return call

    def take(self) -> dict:
        out, self.count = self.count, {}
        return out

    def remove(self) -> None:
        for n, fn in self.real.items():
            setattr(self.dist, n, fn)


def _dp_steps(trainer, steps: int, batches=None, collectives=None) -> dict:
    """``steps`` train steps (the datamanager's batches unless given), each
    synchronised: per step the loss terms, wall ms, launches and
    collectives."""
    import torch

    from nerf_kbs_tpu_torch.ops import fused_field as ff

    rec = {"losses": [], "step_ms": [], "launches": [], "collectives": [], "batch_sums": []}
    for step in range(steps):
        batch = trainer.dm.next_train(step) if batches is None else batches[step]
        rec["batch_sums"].append(int(batch["ray_indices"].astype("int64").sum()))
        if collectives is not None:
            collectives.take()
        ff.reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append({k: v for k, v in ff.LAUNCHES.items() if v})
        rec["collectives"].append(collectives.take() if collectives is not None else {})
        rec["losses"].append({k: float(v) for k, v in m.items()})
    rec["median_step_ms"] = sorted(rec["step_ms"][1:])[len(rec["step_ms"][1:]) // 2]
    return rec


class _FirstGradients:
    """While installed, keeps the gradients that the trainer's first
    ``all_reduce_grads`` call of each ``take`` leaves behind (the reduced
    gradients, before the update), as host tensors (None where a leaf has
    none)."""

    def __init__(self):
        from nerf_kbs_tpu_torch.engine import trainer as trainer_mod

        self.module, self.real, self.grads = trainer_mod, trainer_mod.all_reduce_grads, None
        trainer_mod.all_reduce_grads = self._call

    def _call(self, mesh, params):
        self.real(mesh, params)
        if self.grads is None:
            self.grads = [None if t.grad is None else t.grad.detach().float().cpu()
                          for t in _leaf_values(params) if getattr(t, "requires_grad", False)]

    def take(self) -> list:
        out, self.grads = self.grads, None
        return out

    def remove(self) -> None:
        self.module.all_reduce_grads = self.real


def _grad_distance(got: list, want: list) -> dict:
    """The largest elementwise distance of two gradient lists over the
    largest element of ``want`` (and the leaf where it lies), and the ratio
    of their norms."""
    import torch

    check([g is None for g in got] == [w is None for w in want], "other leaves have gradients")
    pairs = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if w is not None]
    scale = max(float(w.abs().max()) for _, _, w in pairs)
    errs = [(float((g - w).abs().max()), i, w) for i, g, w in pairs]
    err, leaf, w = max(errs, key=lambda e: e[0])
    norm = (torch.sqrt(sum((g.double() ** 2).sum() for _, g, _ in pairs))
            / torch.sqrt(sum((w.double() ** 2).sum() for _, _, w in pairs)))
    return {"max_abs_err": err, "largest": scale, "rel": err / max(scale, 1e-30),
            "norm_ratio": float(norm), "worst_leaf": {"index": leaf, "shape": list(w.shape),
                                                      "largest": float(w.abs().max())}}


def _params_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in _leaf_values(params):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_worker(rank: int, port: str, scene: str, out: str) -> int:
    """One rank of the two-process run (``chip_smoke.py --dp-rank``): joins
    the gloo group at localhost:port on the one card, trains nerfacto-tpu
    (DP_STEPS, then eval_all_images) and semantic-nerfw with depth,
    semantics and masks on its share of the batch, times the gradient
    all-reduce, and writes its results to ``out``."""
    import torch

    sys.path.insert(0, str(HERE))
    import nerf_kbs_tpu_torch  # noqa: F401
    import nerf_kbs_tpu_torch.methods  # noqa: F401
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.parallel import mesh as M
    from nerf_kbs_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    info = multihost.initialize(f"localhost:{port}", DP_WORLD, rank)
    coll = _Collectives()
    first = _FirstGradients()
    res = {"rank": rank, "init": info, "init_s": time.perf_counter() - t0,
           "backend": torch.distributed.get_backend()}
    for method, steps in DP_STEPS.items():
        spec = cli.apply_overrides(cli.method_registry[method](),
                                   _pairs(_dp_argv(scene, f"{out}/{method}", method)))
        trainer = cli.build_trainer(spec)
        first.take()
        rec = _dp_steps(trainer, steps, collectives=coll)
        torch.save(first.take(), Path(out, f"rank{rank}_{method}_grads.pt"))
        rec.update({"device": str(trainer.device), "world": trainer.mesh.world,
                    "rays_per_rank": trainer.dm.config.train_num_rays_per_batch,
                    "params": _params_digest(trainer.params)})
        if method == "nerfacto-tpu":
            t1 = time.perf_counter()
            rec["eval_all"] = trainer.eval_all_images()
            rec["eval_all_s"] = time.perf_counter() - t1
            rec["eval_collectives"] = coll.take()
            # the gradient all-reduce alone (the last step's gradients)
            leaves = [p for p in _leaf_values(trainer.params) if p.requires_grad]
            rec["grad_allreduce_ms"] = time_ms(lambda: M.all_reduce_grads(trainer.mesh,
                                                                          trainer.params), 10)
            rec["grad_allreduce_bytes"] = 4 * sum(p.numel() for p in leaves)
            metrics = rec["losses"][-1]
            rec["metrics_allreduce_ms"] = time_ms(lambda: M.mean_over_ranks(trainer.mesh, {
                k: torch.tensor(v, device=trainer.device) for k, v in metrics.items()}), 10)
            # one step under the profiler: the card's busy share of a rank's step
            wall_us, events = device_events(lambda: trainer.train_step(trainer.dm.next_train(99)))
            busy = sum(us for _, us, _ in events)
            rec["profiled_step"] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                                    "device_idle_share": max(0.0, 1.0 - busy / wall_us)}
            coll.take()
        res[method] = rec
        del trainer
        torch.cuda.empty_cache()
    coll.remove()
    first.remove()
    res["foreign_modules"] = [m for m in sys.modules if m.split(".")[0] in
                              ("jax", "jaxlib", "flax", "optax", "nerf_kbs_tpu")]
    torch.distributed.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def _rank_batches(dm, step: int, world: int) -> dict:
    """The global batch of ``step`` that ``world`` ranks draw (rank r with
    the seed seed + 7919 r and 1 / world of the rays, as
    engine.cli.build_trainer gives them), concatenated in rank order."""
    import dataclasses

    import numpy as np

    cfg = dm.config
    parts = []
    try:
        for r in range(world):
            dm.config = dataclasses.replace(
                cfg, train_num_rays_per_batch=cfg.train_num_rays_per_batch // world,
                seed=cfg.seed + 7919 * r)
            parts.append(dm.next_train(step))
    finally:
        dm.config = cfg
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _kernels_at_rank_n(records, rank_n: dict) -> dict:
    """Kernels A to D against their plain versions at the point counts of
    one rank's step of each two-process run (``rank_n``: method -> (its
    spec, a rank's rays)), at the run's widths, on seeded weights (tri basis,
    bf16, no position gradient, as the path runs them): A and C at every
    proposal round's N; at the NeRF samples' N, B and D for nerfacto-tpu, A
    and C at the base widths for semantic-nerfw's split field."""
    import torch

    from nerf_kbs_tpu_torch.ops import fused_field as ff
    from nerf_kbs_tpu_torch.ops.encoding import fourier_encoding_init, sh_encoding

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)

    def rel(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)

    def outliers(got, want):
        tol = BWD_TOLERANCE[("tri", True)]
        return float(((got - want).abs() > tol * want.abs().max()).float().mean())

    def mlp_pair(name, fcfg_fourier, mlp_cfg, n):
        """A and C of one Fourier MLP at N = n: A's largest distance (abs),
        C's weight gradients' (rel)."""
        check(fcfg_fourier.basis == "tri", f"basis {fcfg_fourier.basis}: the check holds tri")
        B = fourier_encoding_init(fcfg_fourier, gen, dev)
        ws, bs = _weights(mlp_cfg, gen, dev)
        spec = ff.FusedMLPSpec(h_freqs=B.shape[1], layer_dims=mlp_cfg.dims, bf16=True,
                               basis="tri")
        x = torch.rand(3, n, generator=gen).to(dev)
        err = float((ff.fourier_mlp(spec, x, B, ws, bs)
                     - ff.fourier_mlp_reference(x, B, ws, bs, "tri", True)).abs().max())
        check(err <= TOLERANCE[("tri", True)], f"fourier_mlp_fwd{name} at n={n}: err {err}")
        found.setdefault(f"fourier_mlp_fwd{name}", {})[n] = err
        g = torch.randn(mlp_cfg.dims[-1], n, generator=gen).to(dev)
        _, dws, dbs = ff._mlp_backward(spec, x, B, ws, bs, g)
        _, rws_, rbs_ = ff.fourier_mlp_backward_reference(x, B, ws, bs, g, "tri", True, False)
        err = max(rel(a, b) for a, b in zip([*dws, *dbs], [*rws_, *rbs_]))
        check(err <= SUM_TOLERANCE, f"fourier_mlp_bwd{name} at n={n}: rel err {err}")
        found.setdefault(f"fourier_mlp_bwd{name}", {})[n] = err

    found = {}
    for spec, rays in rank_n.values():
        cfg = spec.model_config()
        for i, samples in enumerate(cfg.num_proposal_samples_per_ray):
            pcfg = cfg.proposal_field(i)
            mlp_pair("", pcfg.fourier, pcfg.mlp, rays * samples)
        fcfg = cfg.field
        n = rays * cfg.num_nerf_samples_per_ray
        if fcfg.use_semantics:  # the split field: the base MLP alone in A and C
            mlp_pair("_base", fcfg.fourier, fcfg.base_mlp, n)
            continue
        check(fcfg.fourier.basis == "tri", f"basis {fcfg.fourier.basis}: the check holds tri")
        fB = fourier_encoding_init(fcfg.fourier, gen, dev)
        (bws, bbs), (rws, rbs) = _weights(fcfg.base_mlp, gen, dev), _weights(fcfg.rgb_mlp, gen,
                                                                             dev)
        x = torch.rand(3, n, generator=gen).to(dev)
        d = torch.randn(n, 3, generator=gen)
        fe = sh_encoding(d / d.norm(dim=-1, keepdim=True)).T.contiguous().to(dev)
        fspec = ff.FusedFieldSpec(h_freqs=fB.shape[1], feat_dim=fe.shape[0],
                                  base_dims=fcfg.base_mlp.dims, rgb_dims=fcfg.rgb_mlp.dims,
                                  bf16=True, basis="tri")
        err = float((ff.fourier_field_mlp(fspec, x, fe, fB, bws, bbs, rws, rbs)
                     - ff.fourier_field_reference(x, fe, fB, bws, bbs, rws, rbs, "tri",
                                                  True)).abs().max())
        check(err <= TOLERANCE[("tri", True)], f"fourier_field_fwd at n={n}: err {err}")
        found.setdefault("fourier_field_fwd", {})[n] = err
        g = torch.randn(4, n, generator=gen).to(dev)
        got = ff._field_backward(fspec, x, fe, fB, bws, bbs, rws, rbs, g)[1:]
        want = ff.fourier_field_backward_reference(x, fe, fB, bws, bbs, rws, rbs, g, "tri", True,
                                                   False)[1:]
        err = max(rel(a, b) for a, b in zip(_leaf_values(list(got[1:])),
                                             _leaf_values(list(want[1:]))))
        out = outliers(got[0], want[0])
        check(err <= SUM_TOLERANCE and out <= PER_POINT_OUTLIERS,
              f"fourier_field_bwd at n={n}: rel err {err}, dfeats outliers {out}")
        found.setdefault("fourier_field_bwd", {})[n] = err
    for rec in records:
        if rec["name"] in found:
            rec["per_rank_n_max_err"] = {str(k): v for k, v in found[rec["name"]].items()}
    torch.cuda.empty_cache()
    return found


def phase_parallel(records, scene: str) -> None:
    """Data parallel training through engine.cli.build_trainer: world size
    1 on NCCL in this process against no process group (bit for bit), then
    two ranks on the one card over gloo (subprocesses of this script,
    ``--dp-rank``) against one process on the concatenated batch, and
    kernels A to D at one rank's point counts."""
    import torch
    import torch.distributed as dist

    import nerf_kbs_tpu_torch.methods  # noqa: F401
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.parallel import multihost

    out = tempfile.mkdtemp(prefix="nkt_dp_")
    method = "nerfacto-tpu"
    steps = DP_STEPS[method]
    spec = cli.apply_overrides(cli.method_registry[method](),
                               _pairs(_dp_argv(scene, f"{out}/solo", method)))
    solo = _dp_steps(cli.build_trainer(spec), steps)
    backend = multihost.choose_backend(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    coll = _Collectives()
    try:
        trainer = cli.build_trainer(spec)
        check(trainer.mesh.group is not None and trainer.mesh.world == 1, "world-1 mesh")
        world1 = _dp_steps(trainer, steps, collectives=coll)
        del trainer
    finally:
        coll.remove()
        dist.destroy_process_group()
    losses = [m["total_loss"] for m in solo["losses"]]
    check([m["total_loss"] for m in world1["losses"]] == losses,
          f"world 1 on {backend}: losses {world1['losses']} against {solo['losses']}")
    check(all(ln == RUN1_STEP for ln in world1["launches"] + solo["launches"]),
          f"launches {world1['launches']}")
    check(world1["collectives"] == [{"all_reduce": 2}] * steps,
          f"world-1 collectives {world1['collectives']}")
    emit({"phase": "parallel_world1", "backend": backend, "method": method, "steps": steps,
          "rays_per_batch": spec.datamanager.train_num_rays_per_batch,
          "losses_bit_equal": True, "losses": losses, "launches_per_step": world1["launches"][0],
          "collectives_per_step": world1["collectives"][0], "step_ms": world1["step_ms"],
          "median_step_ms": world1["median_step_ms"], "no_group_step_ms": solo["step_ms"],
          "no_group_median_step_ms": solo["median_step_ms"]})
    torch.cuda.empty_cache()

    # two ranks on the one card
    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), "--dp-rank", str(r),
                               port, scene, out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(DP_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
    ranks = [json.loads(Path(out, f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    check(all(r["backend"] == "gloo" and not r["foreign_modules"] for r in ranks),
          f"ranks: {[(r['backend'], r['foreign_modules']) for r in ranks]}")
    for r in ranks:
        emit({"phase": "parallel_rank", "rank": r["rank"], "backend": r["backend"],
              "init_s": r["init_s"], **{m: {k: v for k, v in r[m].items() if k != "params"}
                                        for m in DP_STEPS}})

    # one process on the concatenated batches
    rank_n = {}
    for method, steps in DP_STEPS.items():
        spec = cli.apply_overrides(cli.method_registry[method](),
                                   _pairs(_dp_argv(scene, f"{out}/ref", method)))
        trainer = cli.build_trainer(spec)
        batches = [_rank_batches(trainer.dm, s, DP_WORLD) for s in range(steps)]
        first = _FirstGradients()
        try:
            ref = _dp_steps(trainer, steps, batches)
            want_grads = first.take()
        finally:
            first.remove()
        a, b = ranks[0][method], ranks[1][method]
        check(a["losses"] == b["losses"] and a["params"] == b["params"],
              f"{method}: the ranks differ: {a['losses']} / {b['losses']}")
        grads = [torch.load(Path(out, f"rank{r}_{method}_grads.pt")) for r in range(DP_WORLD)]
        check(all((g is None and h is None) or torch.equal(g, h)
                  for g, h in zip(grads[0], grads[1])), f"{method}: the ranks' gradients differ")
        grad = _grad_distance(grads[0], want_grads)
        check(grad["rel"] <= DP_GRAD_RTOL[method]
              and abs(grad["norm_ratio"] - 1.0) <= DP_GRAD_NORM_RTOL,
              f"{method}: world 2 vs 1 first gradients {grad}")
        rank_n[method] = (spec, a["rays_per_rank"])
        check([x + y for x, y in zip(a["batch_sums"], b["batch_sums"])] == ref["batch_sums"],
              f"{method}: the ranks drew other batches than the reference")
        per_rank = RUN2_STEP if method == "semantic-nerfw" else RUN1_STEP
        check(all(ln == per_rank for r in ranks for ln in r[method]["launches"]),
              f"{method}: rank launches {[r[method]['launches'] for r in ranks]}")
        rel = [abs(g["total_loss"] - w["total_loss"]) / abs(w["total_loss"])
               for g, w in zip(a["losses"], ref["losses"])]
        check(max(rel) <= DP_LOSS_RTOL, f"{method}: world 2 vs 1 loss rel {rel}")
        rec = {"phase": "parallel_vs_one_process", "method": method, "steps": steps,
               "world": DP_WORLD, "rays_per_rank": a["rays_per_rank"],
               "loss_rel_err": rel, "loss_rtol": DP_LOSS_RTOL,
               "first_grad_vs_one_process": grad, "grad_rtol": DP_GRAD_RTOL[method],
               "grad_norm_rtol": DP_GRAD_NORM_RTOL,
               "world2_losses": [m["total_loss"] for m in a["losses"]],
               "world1_losses": [m["total_loss"] for m in ref["losses"]],
               "rank_median_step_ms": [r[method]["median_step_ms"] for r in ranks],
               "one_process_median_step_ms": ref["median_step_ms"],
               "collectives_per_step": a["collectives"][0],
               "launches_per_rank_step": a["launches"][0]}
        if method == "nerfacto-tpu":
            want = trainer.eval_all_images()
            diff = {k: abs(a["eval_all"][k] - want[k]) for k in DP_EVAL_ATOL if k in want}
            check(a["eval_all"] == b["eval_all"] and a["eval_all"]["num_images"] == 2,
                  f"eval: {a['eval_all']} / {b['eval_all']}")
            check(all(diff[k] <= DP_EVAL_ATOL[k] for k in diff), f"eval world 2 vs 1: {diff}")
            rec.update({"eval_world2": a["eval_all"], "eval_world1": want, "eval_diff": diff,
                        "eval_atol": DP_EVAL_ATOL, "eval_collectives": a["eval_collectives"],
                        "grad_allreduce_ms": [r[method]["grad_allreduce_ms"] for r in ranks],
                        "grad_allreduce_bytes": a["grad_allreduce_bytes"],
                        "no_group_median_step_ms": solo["median_step_ms"],
                        "subprocess_wall_s": wall})
            for k in records:
                if k["name"] in COUNTER:
                    k["parallel_launches_per_rank_step"] = a["launches"][0].get(
                        COUNTER[k["name"]], 0)
        emit(rec)
        del trainer
        torch.cuda.empty_cache()
    found = _kernels_at_rank_n(records, rank_n)
    emit({"phase": "parallel_kernels_at_rank_n", "max_err": {
        k: {str(n): e for n, e in v.items()} for k, v in found.items()}})


def numpy_draw(images, batch: int, seed: int, depths=None) -> dict:
    """The plain version of the host sampler's draw: uniform (camera, row,
    column) from a NumPy generator, the pixels' rgb in [0, 1] and depth. Its
    random streams differ from the sampler's; it is timed beside it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, h, w, _ = images.shape
    cam, row, col = rng.integers(0, n, batch), rng.integers(0, h, batch), rng.integers(0, w, batch)
    out = {"ray_indices": np.stack([cam, row, col], -1).astype(np.int32),
           "image": images[cam, row, col].astype(np.float32) / 255.0}
    if depths is not None:
        out["depth_image"] = depths[cam, row, col].astype(np.float32)[:, None]
    return out


def phase_native_sampler(scene: str) -> None:
    """The host sampler on the street scene's train assets (6 frames of
    376x1241 with depth, 4,096 rays, as the datamanager calls it): the right
    pixels, deterministic at this process's thread count, other draws for
    another seed; host ms against ``numpy_draw``, on the card's host."""
    import os

    import numpy as np

    import nerf_kbs_tpu_torch.methods  # noqa: F401
    from nerf_kbs_tpu_torch import native
    from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager
    from nerf_kbs_tpu_torch.engine import cli

    spec = cli.apply_overrides(cli.method_registry["semantic-nerfw"](),
                               _pairs(_dp_argv(scene, tempfile.mkdtemp(), "semantic-nerfw")))
    t0 = time.perf_counter()
    dm = InMemoryDataManager(spec.dataparser.parse("train"), spec.dataparser.parse("val"),
                             spec.datamanager)
    load_s = time.perf_counter() - t0
    a = dm.train_assets
    imgs, depths = a["images"], a["depths"]
    t0 = time.perf_counter()
    check(native.available(), "native sampler")
    build_s = time.perf_counter() - t0
    b = 4096
    got = native.sample_ray_batch(imgs, b, seed=5, depths=depths)
    cam, row, col = got["ray_indices"].T.astype(np.int64)
    check(got["ray_indices"].shape == (b, 3) and cam.max() < imgs.shape[0]
          and row.max() < imgs.shape[1] and col.max() < imgs.shape[2], "indices out of range")
    # the library scales by the f32 reciprocal of 255
    inv255 = np.float32(1.0) / np.float32(255.0)
    check(np.array_equal(got["image"], imgs[cam, row, col].astype(np.float32) * inv255)
          and np.array_equal(got["depth_image"][:, 0], depths[cam, row, col]),
          "the sampler gathered other pixels")
    again = native.sample_ray_batch(imgs, b, seed=5, depths=depths)
    other = native.sample_ray_batch(imgs, b, seed=6, depths=depths)
    check(all(np.array_equal(got[k], again[k]) for k in got), "not deterministic")
    check(not np.array_equal(got["ray_indices"], other["ray_indices"]), "seed ignored")
    plain = numpy_draw(imgs, b, 5, depths)
    check(set(plain) == set(got) and all(plain[k].shape == got[k].shape for k in got),
          "the plain draw's layout")

    def median_ms(fn, reps=21):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return sorted(ts)[reps // 2]

    emit({"phase": "native_sampler", "clock": "host (the card's machine), not the device",
          "frames": list(imgs.shape), "rays": b, "os_cpu_count": os.cpu_count(),
          "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
          "assets_load_s": load_s, "build_or_load_s": build_s,
          "native_ms": median_ms(lambda: native.sample_ray_batch(imgs, b, 1, depths=depths)),
          "numpy_ms": median_ms(lambda: numpy_draw(imgs, b, 1, depths)),
          "next_train_ms": median_ms(lambda: dm.next_train(3))})


# ---------------------------------------------------------------------------
# the live viewer during run 1, LPIPS, the render overrides (phase cli)
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str) -> tuple:
    """(status, content type, body) of a GET; an HTTP error is an answer."""
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers["Content-Type"], e.read()


def ws_client_frame(payload: bytes, opcode: int = 0x1, fin: bool = True,
                    mask: bytes = b"\x0a\x0b\x0c\x0d", length=None) -> bytes:
    """An RFC-6455 client frame: masked unless ``mask`` is empty;
    ``length`` claims another payload length than the payload's."""
    import struct

    n = len(payload) if length is None else length
    head = bytes([(0x80 if fin else 0) | opcode])
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 1 << 16:
        head += bytes([mbit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack(">Q", n)
    body = bytes(c ^ mask[i & 3] for i, c in enumerate(payload)) if mask else payload
    return head + (mask or b"") + body


class WSClient:
    """A scripted RFC-6455 client of the viewer: masked frames out,
    unmasked frames in. ``pipelined`` bytes go out in the same write as the
    upgrade request; ``key`` is the key sent and ``head`` the server's
    answer, a 101."""

    def __init__(self, port: int, pipelined: bytes = b"", timeout: float = 300):
        import base64
        import socket

        self.s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self.key = base64.b64encode(b"nkt-chip-smoke!!").decode()
        self.s.sendall((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                        f"Connection: Upgrade\r\nSec-WebSocket-Key: {self.key}\r\n"
                        "Sec-WebSocket-Version: 13\r\n\r\n").encode() + pipelined)
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += self.s.recv(4096)
        self.head, leftover = resp.split(b"\r\n\r\n", 1)
        check(b" 101 " in self.head.split(b"\r\n")[0] + b" ",
              f"websocket upgrade: {self.head[:80]}")
        self.buf = bytearray(leftover)

    def _read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.s.recv(1 << 16)
            check(bool(chunk), "the viewer closed the websocket mid-frame")
            self.buf.extend(chunk)
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    def recv(self) -> tuple:
        """(opcode, payload) of the next frame, which must be unmasked."""
        import struct

        hdr = self._read(2)
        check(not hdr[1] & 0x80, "the viewer sent a masked frame")
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        return hdr[0] & 0x0F, self._read(n)

    def send(self, payload: bytes, opcode: int = 0x1, fin: bool = True) -> None:
        self.s.sendall(ws_client_frame(payload, opcode, fin))

    def close(self) -> None:
        self.s.close()


def _crc32c_bitwise(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected 0x82F63B78) bit by bit, independent of
    the writer's table."""
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _event_records(path: Path) -> list:
    """The payloads of a TFRecord event file; every length and payload CRC
    must hold."""
    import struct

    data, out = path.read_bytes(), []
    while data:
        (n,) = struct.unpack("<Q", data[:8])
        check(struct.unpack("<I", data[8:12])[0] == _crc32c_bitwise(data[:8])
              and struct.unpack("<I", data[12 + n:16 + n])[0]
              == _crc32c_bitwise(data[12:12 + n]), f"{path.name}: bad CRC")
        out.append(data[12:12 + n])
        data = data[16 + n:]
    return out


LIVE_POSES = 3
LIVE_POSE_SIZE = 128
LIVE_ORBIT_SIZE = 192


def phase_live_viewer(cli, ff, scene: str, run1: dict) -> None:
    """Run 1 again through cli.main with --trainer.vis viewer+tensorboard
    and --viewer-port: a client thread waits for step 1 (the trainer is held
    there until the client has read /, /status and opened a websocket), then
    while training runs on reads /render?cam=0, its depth, /orbit and
    /latest (no dumps yet), sends poses over the websocket and reads the PNGs
    and the status pushes, pings and closes. The launch counts must be run
    1's plus the viewer's chunks x (2 A + 1 B), all wgmma; the 30 losses run
    1's to the bit; after training, /render?cam=0 the trainer's own render of
    camera 0, and /latest an eval dump; the event file one record per
    metrics.jsonl line with valid CRCs."""
    import math
    import threading

    import numpy as np

    from nerf_kbs_tpu_torch.engine.trainer import Trainer
    from nerf_kbs_tpu_torch.utils import images

    out = tempfile.mkdtemp(prefix="nkt_live_")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    gate, at_step_1 = threading.Event(), threading.Event()
    real_step = Trainer.train_step

    def gated(self, batch, jitters=None):
        res = real_step(self, batch, jitters)
        if self.step == 1:
            at_step_1.set()
            gate.wait(300)
        return res

    seen: dict = {"errors": []}

    def client():
        try:
            check(at_step_1.wait(300), "the live run never reached step 1")
            code, ctype, _ = _http(base + "/")
            check((code, ctype) == (200, "text/html"), f"GET / answered {code} {ctype}")
            seen["status"] = json.loads(_http(base + "/status")[2])
            ws = WSClient(port)
            op, payload = ws.recv()
            check(op == 0x1, f"first websocket frame opcode {op}")
            steps = [json.loads(payload)["step"]]
            gate.set()  # training runs on while the client renders
            frames = {}
            for name, path, shape in (
                    ("render", "/render?cam=0", SCENE_HW),
                    ("render_depth", "/render?cam=0&kind=depth", SCENE_HW),
                    ("orbit", f"/orbit?theta=0.7&phi=0.3&radius=1.6&size={LIVE_ORBIT_SIZE}",
                     (LIVE_ORBIT_SIZE,) * 2)):
                t0 = time.perf_counter()
                code, ctype, body = _http(base + path)
                ms = (time.perf_counter() - t0) * 1e3
                check((code, ctype) == (200, "image/png"), f"GET {path} answered {code}")
                check(images.decode_png(body).shape == (*shape, 3), f"GET {path}: bad PNG")
                frames[name] = {"ms": ms, "bytes": len(body),
                                "step_after": json.loads(_http(base + "/status")[2])["step"]}
            code, _, _ = _http(base + "/latest")
            frames["latest_during_training"] = code
            pose_ms = []
            for k in range(LIVE_POSES):
                t0 = time.perf_counter()
                ws.send(json.dumps({"type": "pose", "theta": 0.3 * k, "phi": 0.3,
                                    "size": LIVE_POSE_SIZE}).encode())
                while True:
                    op, payload = ws.recv()
                    if op == 0x1:
                        steps.append(json.loads(payload)["step"])
                        continue
                    check(op == 0x2 and images.decode_png(payload).shape
                          == (LIVE_POSE_SIZE, LIVE_POSE_SIZE, 3), "pose: bad PNG frame")
                    pose_ms.append((time.perf_counter() - t0) * 1e3)
                    break
            deadline = time.monotonic() + 600
            while steps[-1] < 30 and time.monotonic() < deadline:
                op, payload = ws.recv()
                if op == 0x1:
                    steps.append(json.loads(payload)["step"])
            ws.send(b"nkt", opcode=0x9)
            while (frame := ws.recv())[0] == 0x1:
                pass
            check(frame == (0xA, b"nkt"), f"ping answered {frame[:1]}")
            ws.send(b"\x03\xe8", opcode=0x8)
            check(ws.recv() == (0x8, b"\x03\xe8"), "close not echoed")
            ws.close()
            seen.update(steps=steps, frames=frames, pose_ms=pose_ms)
        except BaseException as e:  # reported by the main thread
            seen["errors"].append(repr(e))
            gate.set()

    thread = threading.Thread(target=client, daemon=True)
    Trainer.train_step = gated
    thread.start()
    ff.reset_launches()
    t0 = time.perf_counter()
    try:
        viewer = cli.main(["nerfacto-tpu"] + _run_argv(scene, out)
                          + ["--trainer.vis", "viewer+tensorboard", "--viewer-port", str(port)])
    finally:
        Trainer.train_step = real_step
        gate.set()
    wall = time.perf_counter() - t0
    thread.join(timeout=900)
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    try:
        check(not thread.is_alive() and not seen["errors"], f"live viewer client: {seen}")
        steps = seen["steps"]
        chunk = viewer.trainer.config.eval_num_rays_per_chunk
        viewer_chunks = (2 * math.ceil(SCENE_HW[0] * SCENE_HW[1] / chunk)
                         + math.ceil(LIVE_ORBIT_SIZE ** 2 / chunk)
                         + LIVE_POSES * math.ceil(LIVE_POSE_SIZE ** 2 / chunk))
        want = dict(run1["launches"])
        for k, per_chunk in (("fourier_mlp_wgmma", 2), ("fourier_field_mlp_wgmma", 1)):
            want[k] = want.get(k, 0) + per_chunk * viewer_chunks
        lines = [json.loads(ln) for ln in
                 (viewer.trainer.out_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [ln["total_loss"] for ln in lines if "total_loss" in ln]
        run1_losses = run1["loss_terms"]["total_loss"]
        step_ms = [4096 / ln["rays_per_sec"] * 1e3 for ln in lines if "total_loss" in ln]
        rec = {"phase": "live_viewer", "method": "nerfacto-tpu", "steps": len(losses),
               "wall_s": wall, "status_at_step_1": seen["status"], "pushed_steps": steps,
               "http": seen["frames"], "viewer_ms_a_frame": seen["frames"]["render"]["ms"],
               "pose_ms": seen["pose_ms"], "launches": launches, "launches_want": want,
               "viewer_chunks": viewer_chunks, "losses_equal_run1_bits": losses == run1_losses,
               "step_ms": step_ms, "median_step_ms": sorted(step_ms[2:])[len(step_ms[2:]) // 2],
               "run1_median_step_ms": run1["median_step_ms"]}
        if losses != run1_losses:
            # then two runs without the viewer set the spread the live run is held to
            tmp = tempfile.mkdtemp(prefix="nkt_run1_again_")
            again = _cli_run(cli, ff, "nerfacto-tpu", _run_argv(scene, tmp), tmp,
                             run1["launches_per_step"], run1["launches_per_eval_chunk"],
                             phase="cli_nerfacto_tpu_again")
            rec.update({"run1_repeat_spread": max(
                abs(a - b) / abs(b) for a, b in zip(again["loss_terms"]["total_loss"],
                                                    run1_losses)),
                "live_max_rel_diff": max(abs(a - b) / abs(b)
                                         for a, b in zip(losses, run1_losses))})
        emit(rec)
        check(steps == sorted(steps) and len(set(steps)) >= 2 and steps[0] == 1
              and steps[-1] == 30, f"pushed steps {steps}")
        check(launches == want, f"live run launches {launches}, want {want}")
        check(len(losses) == 30 and (losses == run1_losses
                                     or rec["live_max_rel_diff"] <= rec["run1_repeat_spread"]),
              f"live run losses {losses} against run 1's {run1_losses}")
        # after training: the viewer's frame is the trainer's own render
        code, _, body = _http(base + "/render?cam=0")
        own = images.to_uint8(viewer.trainer.render_camera(0)["rgb"])
        check(code == 200 and np.array_equal(images.decode_png(body), own),
              "/render?cam=0 differs from the trainer's render of camera 0")
        viewer.trainer.eval_image(0)  # an eval dump for /latest
        dump = sorted((viewer.trainer.out_dir / "eval_images").glob("*_rgb.png"))[-1]
        check(_http(base + "/latest")[2] == dump.read_bytes(), "/latest is not the eval dump")
        (events,) = list((viewer.trainer.out_dir / "tensorboard").iterdir())
        n_records = len(_event_records(events))
        emit({"phase": "live_viewer_after_training", "final_render_equals_trainer": True,
              "latest_after_eval": dump.name, "metrics_lines": len(lines),
              "event_records": n_records})
        check(n_records == len(lines) + 1, f"{n_records} event records, {len(lines)} lines")
    finally:
        viewer.shutdown()


def write_lpips_checkpoints(out: Path) -> None:
    """The seeded LPIPS checkpoint pair in the official layout (values not
    perceptual), written by ``tools/make_lpips_ckpt.py`` itself."""
    import runpy

    argv = sys.argv
    sys.argv = ["make_lpips_ckpt.py", str(out)]
    try:
        runpy.run_path(str(HERE / "tools" / "make_lpips_ckpt.py"), run_name="__main__")
    finally:
        sys.argv = argv


LPIPS_TOL = 1e-4


def phase_lpips(cli, argv1: list, ckpt_dir: str, run1: dict) -> None:
    """--eval-only --trainer.require_lpips true from run 1's checkpoint with
    seeded official-layout LPIPS checkpoints: lpips finite and the other
    metrics run 1's; one eval image's LPIPS on the card against the CPU in
    f32; the device ms of one LPIPS call (seeded weights: a path check, not a
    perceptual score)."""
    import os

    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.utils.lpips import load_lpips

    lp = Path(tempfile.mkdtemp(prefix="nkt_lpips_"))
    write_lpips_checkpoints(lp)
    os.environ["NKT_LPIPS_DIR"] = str(lp)
    try:
        t0 = time.perf_counter()
        cli.main(["nerfacto-tpu"] + argv1 + ["--eval-only", "true", "--trainer.load_dir",
                                            ckpt_dir, "--trainer.require_lpips", "true"])
        call_s = time.perf_counter() - t0
        last = json.loads((Path(ckpt_dir) / "metrics.jsonl").read_text().splitlines()[-1])
        final = {k[len("eval_all_"):]: v for k, v in last.items() if k.startswith("eval_all_")}
        check(np.isfinite(final.get("lpips", np.nan)), f"--eval-only with LPIPS: {final}")
        check({k: v for k, v in final.items() if k != "lpips"} == run1["eval_all"],
              f"LPIPS changed the other metrics: {final}")
        spec = cli.apply_overrides(cli.method_registry["nerfacto-tpu"](),
                                   {"trainer.load_dir": ckpt_dir, **_pairs(argv1)})
        trainer = cli.build_trainer(spec)
        pred = torch.as_tensor(trainer.render_camera(0)["rgb"], device=trainer.device)
        gt = torch.as_tensor(np.asarray(trainer.dm.eval_image(0)["image"], np.float32),
                             device=trainer.device)
        card_model, cpu_model = load_lpips(trainer.device), load_lpips(device="cpu")
        card = float(card_model(pred, gt))
        cpu = float(cpu_model(pred.cpu(), gt.cpu()))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        card_model(pred, gt)
        start.record()
        for _ in range(5):
            card_model(pred, gt)
        end.record()
        torch.cuda.synchronize()
        rec = {"phase": "cli_lpips", "weights": "seeded official layout (not perceptual)",
               "eval_all_lpips": final["lpips"], "eval_only_s": call_s,
               "image": list(SCENE_HW), "lpips_card": card, "lpips_cpu": cpu,
               "rel_diff": abs(card - cpu) / abs(cpu), "tol": LPIPS_TOL,
               "lpips_call_ms": start.elapsed_time(end) / 5}
        emit(rec)
        check(rec["rel_diff"] <= LPIPS_TOL, f"LPIPS card vs CPU: {card} vs {cpu}")
    finally:
        del os.environ["NKT_LPIPS_DIR"]


def phase_render_overrides(cli, ff, argv1: list, ckpt_dir: str) -> None:
    """--render-only from run 1's checkpoint with --render-focal-mult 2
    --render-pos-shift 0.1,0,0 --render-frame-range 0,1: the two eval cameras
    give 8 interpolated frames and the last camera's, each 376x1241, whose
    launch counts are 15 chunks' of A and B a frame."""
    import math

    from nerf_kbs_tpu_torch.utils import images

    out = Path(tempfile.mkdtemp(prefix="nkt_overrides_"))
    ff.reset_launches()
    t0 = time.perf_counter()
    cli.main(["nerfacto-tpu"] + argv1 + ["--render-only", "true", "--render-dir", str(out),
                                        "--trainer.load_dir", ckpt_dir,
                                        "--render-focal-mult", "2", "--render-pos-shift",
                                        "0.1,0,0", "--render-frame-range", "0,1"])
    seconds = time.perf_counter() - t0
    frames = sorted(out.glob("rgb_*.png"))
    shapes = {images.decode_png(p.read_bytes()).shape for p in frames}
    chunks = len(frames) * math.ceil(SCENE_HW[0] * SCENE_HW[1] / (1 << 15))
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    emit({"phase": "cli_render_overrides", "frames": len(frames), "shapes": sorted(shapes),
          "seconds": seconds, "launches": launches})
    check(len(frames) == 9 and shapes == {(*SCENE_HW, 3)},
          f"override frames {len(frames)} {shapes}")
    check(launches == {"fourier_mlp_wgmma": 2 * chunks, "fourier_field_mlp_wgmma": chunks},
          f"override launches {launches}")


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
# 0.7% on an H100 (the CPU's own f32 run moves it 0.72% from the f64 run,
# tools/cpu_drift_study.py); and Adam (eps 1e-8) turns a gradient component
# near eps into an update of lr g / (|g| + eps), so a tangent moves by a
# visible share of lr where its gradient does
TANGENT_GRAD_TOL = 2e-3


def to_f64(trainer) -> None:
    """Every parameter, optimizer moment and camera of a CPU ``trainer`` in
    float64, which the plain path carries through (the f64 reference of
    the narrowed checks, and of tools/cpu_drift_study.py)."""
    import dataclasses

    import torch

    from nerf_kbs_tpu_torch.cameras.cameras import Cameras
    from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves, tree_map

    with torch.no_grad():
        for p in tree_leaves(trainer.params):
            p.data = p.data.double()
    for st in trainer.optimizer.state.values():
        st["mu"] = tree_map(lambda t: t.double(), st["mu"])
        st["nu"] = tree_map(lambda t: t.double(), st["nu"])

    def cams(c):
        return Cameras(**{f.name: v.double() if v is not None and v.is_floating_point() else v
                          for f in dataclasses.fields(c) for v in [getattr(c, f.name)]})

    trainer.train_cameras = cams(trainer.train_cameras)
    trainer.eval_cameras = cams(trainer.eval_cameras)


def _card_vs_cpu(cli, method: str, argv: list, phase: str, checked_steps: int = 3,
                 tangents: bool = False, f64: bool = False, terms: tuple = ()) -> None:
    """3 f32 steps of ``method`` on the card against the same 3 steps on the
    CPU plain path: same seeds, batches and jitter (drawn on the CPU in
    both); the losses of the first ``checked_steps`` must agree to 2e-3 (the
    others are recorded); with ``tangents`` the camera optimizer's
    tangents are compared too (see TANGENT_GRAD_TOL). With ``f64`` the CPU
    runs the 3 steps once more in float64, and each f32 run's distance from
    it is recorded per step (losses, and tangent gradients). Each logged
    loss term named in ``terms`` is recorded per step on both sides and
    held to 2e-3 too."""
    import dataclasses

    spec = cli.apply_overrides(cli.method_registry[method](), _pairs(argv))
    runs, tang, grads, parts = {}, {}, {}, {}
    for where in ("cuda", "cpu") + (("f64",) if f64 else ()):
        t = cli.build_trainer(dataclasses.replace(
            spec, trainer=dataclasses.replace(spec.trainer, experiment_name=f"f32_{where}")),
            device="cpu" if where == "f64" else where)
        check(t.model_config.compute_dtype == "float32", "f32 steps")
        if where == "f64":
            to_f64(t)
        runs[where], grads[where], parts[where] = [], [], []
        for s in range(3):
            m = t.train_step(t._to_device(t.dm.next_train(s)))
            runs[where].append(float(m["total_loss"]))
            parts[where].append({k: float(m[k]) for k in terms})
            if tangents:
                grads[where].append(t.params["camera_opt"].grad.cpu().double())
        if tangents:
            tang[where] = (t.params["camera_opt"].detach().cpu(), grads[where][0].float(),
                           grads[where][-1].float(), t.optimizer.learning_rate("camera_opt"))
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
    # relative to the term, or to 1e-6 where it is smaller (the interlevel
    # term starts near 1e-10, where the proposals still equal the field)
    term_rels = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                     for a, b in zip(parts["cuda"], parts["cpu"])] for k in terms}
    for k in terms:
        rec[f"{k}_card"] = [p[k] for p in parts["cuda"]]
        rec[f"{k}_cpu"] = [p[k] for p in parts["cpu"]]
        rec[f"{k}_rel_diff_per_step"] = term_rels[k]
    if f64:
        rec["losses_f64"] = runs["f64"]
        for k in terms:
            rec[f"{k}_f64"] = [p[k] for p in parts["f64"]]
        for where in ("cuda", "cpu"):
            label = "card" if where == "cuda" else "cpu"
            rec[f"rel_diff_{label}_vs_f64"] = [abs(a - b) / abs(b)
                                               for a, b in zip(runs[where], runs["f64"])]
            if tangents:
                rec[f"tangent_grad_rel_{label}_vs_f64"] = [
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(grads[where], grads["f64"])]
    emit(rec)
    check(rel <= 2e-3, f"{phase}: card vs CPU f32 steps: {runs}")
    for k in terms:
        check(max(term_rels[k][:checked_steps]) <= 2e-3,
              f"{phase}: card vs CPU {k}: {rec[f'{k}_card']} against {rec[f'{k}_cpu']}")
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
    # at 10 position frequencies the third step is ill-conditioned at f32
    # rounding: the CPU's own f32 run ends it 6.6e-3 from the f64 run
    # (tools/cpu_drift_study.py), so steps 1 and 2 are held
    _card_vs_cpu(cli, "vanilla-nerf", argv4 + REDUCED_VANILLA + ["--model.pos_frequencies", "10"],
                 "cli_run4_vs_cpu_10_frequencies", checked_steps=2, f64=True)
    _vanilla_frame_vs_cpu(cli, ff, argv4)
    _card_vs_cpu(cli, "test-nerfacto", argv5 + REDUCED_HASH, "cli_run5_vs_cpu")
    _card_vs_cpu(cli, "semantic-nerfw", argv6 + REDUCED_HASH, "cli_run6_vs_cpu")
    check(not any(ff.LAUNCHES.values()), f"runs 4-6 f32 steps launched {ff.LAUNCHES}")


# the four root launchers of the port, each with its default method and no
# method argument, on the scene of that method's run (runs 3, 4, 5 and
# nerfacto's hash preset), 2 steps each at the method's own widths
LAUNCHER_STEPS = 2


def phase_launchers_torch(scene: str, vkitti: str) -> None:
    """Each train*_torch.py launcher as its own program (all four started
    together, 2 OpenMP threads each, on the one card): exit code 0, 2 logged
    steps with finite losses and the eval of the split in metrics.jsonl."""
    import numpy as np
    import torch

    out = Path(tempfile.mkdtemp(prefix="nkt_launchers_"))
    steps = ["--trainer.max_num_iterations", str(LAUNCHER_STEPS), "--trainer.log_every", "1"]

    def kitti(run_out):  # _run_argv with this phase's step count
        argv = _run_argv(scene, run_out)
        argv[argv.index("--trainer.max_num_iterations") + 1] = str(LAUNCHER_STEPS)
        return argv

    runs = {  # launcher: (its default method, its output directory, argv)
        "train_torch.py": ("semantic-nerfw", out / "a", kitti(str(out / "a")) + _run2_data(scene)),
        "train_nerf_torch.py": ("vanilla-nerf", out / "b", [
            "--dataparser.data_dir", vkitti, "--dataparser.train_split_fraction", "0.75",
            "--trainer.output_dir", str(out / "b")] + steps),
        "train_nerfacto_torch.py": ("nerfacto", out / "c", kitti(str(out / "c"))),
        "train_z1_torch.py": ("test-nerfacto", out / "d", [
            "--dataparser.data", _write_transforms_json(scene),
            "--trainer.output_dir", str(out / "d")] + steps),
    }
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    torch.cuda.empty_cache()  # this process's cached blocks, for the four
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(HERE / name)] + argv, cwd=HERE, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (_, _, argv) in runs.items()}
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=900)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for name, (method, run_out, _) in runs.items():
        p = procs[name]
        check(p.returncode == 0, f"{name} exited {p.returncode}:\n{logs[name][-4000:]}")
        lines = [json.loads(ln) for ln in
                 (run_out / "exp" / method / "metrics.jsonl").read_text().splitlines()]
        losses = [ln["total_loss"] for ln in lines if "total_loss" in ln]
        final = {k[len("eval_all_"):]: v for k, v in lines[-1].items()
                 if k.startswith("eval_all_")}
        check(len(losses) == LAUNCHER_STEPS and all(np.isfinite(losses)),
              f"{name}: logged losses {losses}")
        check(final.get("num_images") == 2 and all(np.isfinite(v) for v in final.values()),
              f"{name}: eval {final}")
        results.append({"launcher": name, "method": method, "rc": p.returncode,
                        "losses": losses, "eval_all": final})
    emit({"phase": "launchers_torch", "steps": LAUNCHER_STEPS, "concurrent": len(runs),
          "wall_s": time.perf_counter() - t0, "runs": results})


def _vanilla_frame_vs_cpu(cli, ff, argv4: list) -> None:
    """One --render-only frame of run 4's configuration at a reduced width
    (REDUCED_VANILLA), card against CPU: render_trajectory over the first
    eval camera (--render-frame-range 0,0) at a quarter of its size, f32,
    the same seeded parameters with the temporal distortion's last layer
    (zero at init) given seeded values on both, so the cameras' times move
    the frame; the decoded frames within one level of 255, and the card's
    frame must change without the times."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.engine.render import render_trajectory
    from nerf_kbs_tpu_torch.utils import images

    spec = cli.apply_overrides(cli.method_registry["vanilla-nerf"](),
                               _pairs(argv4 + REDUCED_VANILLA))
    frames, out = {}, Path(tempfile.mkdtemp(prefix="nkt_vanilla_frame_"))
    ff.reset_launches()
    for where in ("cuda", "cpu"):
        t = cli.build_trainer(spec, device=where)
        check(t.model_config.enable_temporal_distortion and t.eval_cameras.times is not None,
              "run 4's frame needs the temporal distortion and the cameras' times")
        w = t.params["temporal_distortion"]["w"][-1]
        with torch.no_grad():
            w.copy_(0.2 * torch.randn(w.shape, generator=torch.Generator().manual_seed(3)))
        t0 = time.perf_counter()
        (path,) = render_trajectory(t, str(out / where), frame_range=(0, 0), downscale=4)
        frames[where] = (images.decode_png(Path(path).read_bytes()).astype(int),
                         time.perf_counter() - t0)
        if where == "cuda":
            t.eval_cameras.times = None
            (untimed,) = render_trajectory(t, str(out / "untimed"), frame_range=(0, 0),
                                           downscale=4)
            moved = images.decode_png(Path(untimed).read_bytes()).astype(int)
    levels = int(np.abs(frames["cuda"][0] - frames["cpu"][0]).max())
    rec = {"phase": "cli_run4_render_frame_vs_cpu", "frame": list(frames["cuda"][0].shape),
           "max_level_diff": levels, "tol_levels": 1, "card_s": frames["cuda"][1],
           "cpu_s": frames["cpu"][1],
           "levels_moved_without_times": int(np.abs(moved - frames["cuda"][0]).max())}
    emit(rec)
    check(levels <= 1, f"run 4 frame card vs CPU: {rec}")
    check(rec["levels_moved_without_times"] > 1, f"the times do not reach the frame: {rec}")
    check(not any(ff.LAUNCHES.values()), f"run 4's frame launched {ff.LAUNCHES}")


CAMERA_OPT = ["--model.camera_optimizer", "SO3xR3"]


def phase_camera_opt(records, scene: str) -> None:
    """Run 7: nerfacto-tpu with the camera optimizer through cli.main (every
    backward launch with dx); run 7b: semantic-nerfw as registered with it,
    3 f32 steps card against CPU. See the module docstring."""
    import numpy as np
    import torch

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from bench_torch import FUSED_CHUNK, FUSED_STEP
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    out = tempfile.mkdtemp(prefix="nkt_camopt_")
    argv7 = _run_argv(scene, out) + CAMERA_OPT
    r7 = _cli_run(cli, ff, "nerfacto-tpu", argv7, out, FUSED_STEP, FUSED_CHUNK,
                  phase="cli_run7_camera_opt")
    # every backward launch of the 30 steps ran its dx branch (C 60, D 30)
    dx7 = {k: v for k, v in ff.DX_LAUNCHES.items() if v}
    check(dx7 == {k: 30 * v for k, v in FUSED_STEP.items() if "_bwd" in k},
          f"run 7 backward launches with dx: {dx7}")
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
    fresh.train_step(batch)
    torch.cuda.synchronize()
    one_step = {k: v for k, v in ff.LAUNCHES.items() if v}
    dx_step = {k: v for k, v in ff.DX_LAUNCHES.items() if v}
    check(one_step == FUSED_STEP and dx_step == {"fourier_mlp_bwd_wgmma": 2,
                                                 "fourier_field_mlp_bwd_wgmma": 1},
          f"one run-7 step launched {one_step}, with dx {dx_step}")
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
          "launches_per_step": one_step, "dx_launches_per_step": dx_step})
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
    ff.reset_launches()
    run2.train_step(batch)
    torch.cuda.synchronize()
    one_step = {k: v for k, v in ff.LAUNCHES.items() if v}
    dx_step = {k: v for k, v in ff.DX_LAUNCHES.items() if v}
    # every backward launch ran its dx branch, the base-width body's included
    check(one_step == RUN2_STEP and dx_step == {k: v for k, v in one_step.items() if "_bwd" in k},
          f"one run-2 step with the camera optimizer launched {one_step}, with dx {dx_step}")
    for rec in records:
        if rec["name"] == "fourier_mlp_bwd_base_dx":
            rec["launches"] = one_step["fourier_mlp_bwd_base_wgmma"]
            rec["launches_per"] = "4,096-ray run-2 train step with --model.camera_optimizer SO3xR3"
    emit({"phase": "cli_run2_camera_opt_step", "launches": one_step, "dx_launches": dx_step})
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
                 "cli_run7b_vs_cpu", tangents=True, f64=True)
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

    from bench_torch import FUSED_STEP
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


# ---------------------------------------------------------------------------
# the preprocessing pipeline (process_data/): motion masks, flows, inpainting,
# COLMAP -> metadata.json, and the exact motion chain
# ---------------------------------------------------------------------------

# the JAX package's defaults: the motion-mask and flow working size, the
# inpainter's
PRE_HW = (192, 640)
INPAINT_HW = (240, 432)
INPAINT_WINDOW, INPAINT_STRIDE = 10, 4
# tools/demo_motion_pipeline.py at its defaults, and its recorded mean IoU
# (outputs/motion_pipeline_demo/result.json)
CHAIN = {"frames": 8, "h": 188, "w": 621, "th": 0.3}
JAX_CHAIN_IOU = 0.9683959286159285
CHAIN_IOU_TOL = 0.005
SEGMENTER = HERE / "outputs" / "segmenter3" / "segmenter.npz"
# card against CPU, f32, the same weights, as a share of the output's
# largest magnitude: the single-pass networks to 1e-4 (cuDNN's and MKL's f32
# sums differ in order); RAFT to 1e-3, because its 20 recurrent iterations
# re-sample the correlation pyramid at the coordinates the previous ones
# moved, so the order differences of one pass feed the next
VS_CPU_TOL = {"depth": 1e-4, "pose": 1e-4, "raft": 1e-3, "segmenter": 1e-4, "inpaint": 1e-4}
MASK_SHARE_TOL = 1e-3


def _intrinsics(scene: str) -> tuple:
    """The scene's P2 intrinsics (fx, fy, cx, cy) at its own size."""
    from nerf_kbs_tpu_torch.cameras.poses import intrinsics_from_projection, read_kitti_calib

    return intrinsics_from_projection(read_kitti_calib(str(Path(scene) / "calib.txt"))["P2"])[:4]


def _motion_cfg(scene: str, out: str):
    from nerf_kbs_tpu_torch.process_data.motion_mask_driver import MotionMaskConfig

    fx, fy, cx, cy = _intrinsics(scene)
    return MotionMaskConfig(image_path=str(Path(scene) / "00"), output_path=out, camera="custom",
                            fx=fx, fy=fy, cx=cx, cy=cy, segmenter_ckpt=str(SEGMENTER),
                            width=PRE_HW[1], height=PRE_HW[0])


def _net_times(name: str, fn, reps: int = 5) -> dict:
    """CUDA-event ms of back-to-back calls, the device ms of one call
    (torch.profiler, every kernel it launched) and its longest kernels."""
    ms = time_ms(fn, reps)
    wall_us, events = device_events(fn)
    return {"net": name, "ms": ms, "device_ms": sum(us for _, us, _ in events) / 1e3,
            "launches": sum(c for _, _, c in events), "wall_ms_profiled": wall_us / 1e3,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, us, c in events[:6]]}


# the driver's stages, by the function that does each
DRIVER_STAGES = {"build_networks": "network set-up (seeded weights, checkpoint)",
                 "load_frame": "frame read and resize", "_predict_depth": "depth",
                 "predict_pose": "pose", "compute_flow": "raft", "pose2flow": "rigid flow",
                 "moving_probability": "moving probability", "predict": "segmenter",
                 "extract_instances": "instance votes", "per_object_fusion": "fusion",
                 "_write_png": "png encodes and writes",
                 "flow_to_image": "flow colour coding", "render_mask_on_image": "overlay"}


def _host_breakdown(work) -> dict:
    """Wall seconds of one call of ``work`` by driver stage (cumulative time
    of each stage's function under cProfile, which adds a cost to every
    Python call and so inflates the stages that make many: RAFT's), the
    rest under "other"."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(work)
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    out = {}
    for (_, _, fn), (_, _, _, cum, _) in stats.items():
        if fn in DRIVER_STAGES:
            out[DRIVER_STAGES[fn]] = out.get(DRIVER_STAGES[fn], 0.0) + cum
    out["other"] = total - sum(out.values())
    out["total"] = total
    return out


def phase_preprocess_motion_mask(scene: str, out_dir: str) -> str:
    """motion_mask_driver.run over the scene's 8 frames at 640x192: seeded
    monodepth2 (ResNet-18) and RAFT (20 iterations), the trained segmenter
    (outputs/segmenter3), the camera from the scene's P2. A warm-up run
    writes the outputs, a second is timed, a third is profiled (host share
    = 1 - device busy / wall) with the peak memory; then each network's
    ms a call at the driver's shapes."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.device import resolve_device
    from nerf_kbs_tpu_torch.process_data import motion_mask_driver as drv
    from nerf_kbs_tpu_torch.utils.images import png_size

    out = str(Path(out_dir) / "motion")
    cfg = _motion_cfg(scene, out)
    t0 = time.perf_counter()
    res = drv.run(cfg)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drv.run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = _peak_mib(lambda: drv.run(cfg))
    prof_wall_us, events = device_events(lambda: drv.run(cfg))
    busy_ms = sum(us for _, us, _ in events) / 1e3
    host_s = _host_breakdown(lambda: drv.run(cfg))
    pairs = res["frames"]
    check(pairs == 7, f"{pairs} frame pairs")
    for sub in ("moving_prob", "hard_mask", "combined_mask", "rendered", "cam_flow",
                "depth_show"):
        files = sorted((Path(out) / sub).glob("*.png"))
        check(len(files) == 7 and all(png_size(f.read_bytes()[:24]) == (PRE_HW[1], PRE_HW[0])
                                      for f in files), f"motion/{sub}: {len(files)} files")
    poses = np.load(Path(out) / "poses.npy")
    check(poses.shape == (7, 4, 4) and np.isfinite(poses).all()
          and np.array_equal(poses[:, 3], np.tile([0, 0, 0, 1.0], (7, 1))),
          f"poses.npy {poses.shape}")

    dev = resolve_device(None)
    m2, raft, seg = drv.build_networks(cfg, dev)
    h, w = PRE_HW
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(2, 3, h, w, device=dev, generator=g)
    seg_in = torch.rand(1, 6, h, w, device=dev, generator=g)
    with torch.no_grad():
        nets = [_net_times("depth (batch 2, the flip pair)", lambda: m2.predict_disparity(x)),
                _net_times("pose", lambda: m2.predict_pose(x[:1], x[1:])),
                _net_times("raft (20 iterations)", lambda: raft.compute_flow(x[:1], x[1:])),
                _net_times("segmenter", lambda: seg(seg_in))]
    emit({"phase": "preprocess_motion_mask", "frames": 8, "pairs": pairs, "image": list(PRE_HW),
          "precision": "f32 (TF32 off)", "first_run_s": first_s, "wall_s": wall_s,
          "s_per_pair": wall_s / pairs, "profiled_wall_s": prof_wall_us / 1e6,
          "device_busy_ms": busy_ms, "host_share": max(0.0, 1.0 - busy_ms * 1e3 / prof_wall_us),
          "peak_mib": peak, "dynamic_pixels": res["dynamic_pixels"],
          "host_breakdown_s_per_pair": {k: v / pairs for k, v in host_s.items()}, "nets": nets})
    return out


def phase_preprocess_host_io(scene: str) -> None:
    """The host pieces of a frame pair on one core: decode + BICUBIC resize
    of a 376x1241 frame, the PNG encode of a 640x192 mask and of an RGB
    overlay, and the dilation of a 240x432 mask."""
    import numpy as np

    from nerf_kbs_tpu_torch.process_data.motion_mask import dilate_mask
    from nerf_kbs_tpu_torch.process_data.motion_mask_driver import load_frame
    from nerf_kbs_tpu_torch.utils.images import encode_png_u8, read_image, resize_bicubic

    frame = Path(scene) / "00" / "000000.png"
    px = read_image(frame, "RGB")
    rng = np.random.default_rng(0)
    mask = (rng.random(PRE_HW) > 0.9).astype(np.uint8) * 255
    rgb = rng.integers(0, 256, PRE_HW + (3,), dtype=np.uint8)

    def host_ms(fn, reps=3):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    emit({"phase": "preprocess_host_io", "frame": list(SCENE_HW),
          "load_frame_ms": host_ms(lambda: load_frame(frame, PRE_HW[1], PRE_HW[0])),
          "decode_png_ms": host_ms(lambda: read_image(frame, "RGB")),
          "resize_bicubic_ms": host_ms(lambda: resize_bicubic(px, PRE_HW[1], PRE_HW[0])),
          "encode_png_mask_ms": host_ms(lambda: encode_png_u8(mask)),
          "encode_png_rgb_ms": host_ms(lambda: encode_png_u8(rgb)),
          "dilate_mask_ms": host_ms(lambda: dilate_mask(mask[:INPAINT_HW[0], :INPAINT_HW[1]] > 0))})


def phase_preprocess_flows(scene: str, out_dir: str) -> str:
    """raft_driver.extract_flows over the 8 frames, both directions: 14 RAFT
    calls at 640x192, 20 iterations, seeded."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.process_data.raft_driver import FlowExtractConfig, extract_flows

    out = str(Path(out_dir) / "flows")
    cfg = FlowExtractConfig(image_dir=str(Path(scene) / "00"), output_dir=out,
                            width=PRE_HW[1], height=PRE_HW[0])
    extract_flows(cfg)
    t0 = time.perf_counter()
    res = extract_flows(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fwd = sorted((Path(out) / "flow_fwd").glob("*.npy"))
    bwd = sorted((Path(out) / "flow_bwd").glob("*.npy"))
    viz = sorted((Path(out) / "flow_viz").glob("*.png"))
    flows = [np.load(f) for f in fwd + bwd]
    check(res["pairs"] == 7 and len(fwd) == len(bwd) == len(viz) == 7
          and all(f.shape == PRE_HW + (2,) and f.dtype == np.float32 and np.isfinite(f).all()
                  for f in flows), f"flows: {len(fwd)} / {len(bwd)} / {len(viz)}")
    check([f.stem for f in fwd] == [f"{i:06}" for i in range(7)]
          and [f.stem for f in bwd] == [f"{i:06}" for i in range(1, 8)], "flow file names")
    emit({"phase": "preprocess_flows", "pairs": 7, "raft_calls": 14, "wall_s": wall_s,
          "ms_per_call": wall_s / 14 * 1e3, "flow_abs_max_px": float(max(np.abs(f).max()
                                                                         for f in flows))})
    return out


def _inpaint_run(gen, scene: str, masks: Path, out: str) -> dict:
    """inpaint.run (once to warm, once timed) and the check of its 8 JPEGs:
    pixels more than 32 px (in both axes) from the dilated mask must equal
    the input frame's own JPEG round trip exactly. The composite keeps the
    frame outside the mask, JPEG codes each 16x16 MCU alone, and the
    decoder's chroma upsampling reads the next MCU's samples: 32 px covers a
    pixel's MCU and its neighbours."""
    import numpy as np
    import torch
    from scipy import ndimage

    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    cfg = inp.InpaintDriverConfig(image_dir=str(Path(scene) / "00"), mask_dir=str(masks),
                                  output_dir=out, width=INPAINT_HW[1], height=INPAINT_HW[0],
                                  window=INPAINT_WINDOW, neighbor_stride=INPAINT_STRIDE)
    inp.run(cfg, generator=gen)
    t0 = time.perf_counter()
    written = inp.run(cfg, generator=gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(len(written) == 8 and all(Path(p).name == f"rgb_{i:05d}.jpg"
                                    for i, p in enumerate(written)), f"{len(written)} JPEGs")
    frames, dilated, _ = inp.load_frames_and_masks(cfg)
    far = np.stack([ndimage.maximum_filter(m, size=65, mode="constant") == 0 for m in dilated])
    worst = 0
    for i, p in enumerate(written):
        got = decode_jpeg(Path(p).read_bytes()).astype(int)
        ref = decode_jpeg(encode_jpeg((frames[i] * 255).astype(np.uint8), quality=95)).astype(int)
        check(got.shape == INPAINT_HW + (3,), f"{p}: {got.shape}")
        if far[i].any():
            worst = max(worst, int(np.abs(got - ref)[far[i]].max()))
    check(worst == 0, f"inpaint: pixels far from the mask moved by {worst}")
    return {"wall_s": wall_s, "hole_share": float(dilated.mean()),
            "far_share_checked": float(far.mean()), "far_max_diff": worst,
            "frames": frames, "dilated": dilated}


def phase_preprocess_inpaint(scene: str, motion: str, out_dir: str) -> str:
    """inpaint.run at 432x240, window 10, stride 4, seeded: on the 8 frames
    and the combined masks (the last pair's mask stands for the last frame,
    which ends no pair), timed a window; then on the scene's true moving
    masks, whose dilation leaves most of the frame to check (the seeded
    networks' masks, dilated, may cover all of it). Then the generator's
    ms a call."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.device import resolve_device
    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.utils.images import decode_png, encode_png_u8

    combined = Path(out_dir) / "inpaint_masks"
    true = Path(out_dir) / "inpaint_true_masks"
    combined.mkdir(parents=True, exist_ok=True)
    true.mkdir(parents=True, exist_ok=True)
    for i in range(8):
        (combined / f"{i:06}.png").write_bytes(
            (Path(motion) / "combined_mask" / f"{min(i, 6):06}.png").read_bytes())
        static = decode_png((Path(scene) / "mask" / f"{i:06}.png").read_bytes())
        (true / f"{i:06}.png").write_bytes(encode_png_u8(((static == 0) * 255).astype(np.uint8)))
    dev = resolve_device(None)
    gen = inp.seeded_generator(0).to(dev).eval()
    out = str(Path(out_dir) / "fill_img")
    run = _inpaint_run(gen, scene, combined, out)
    run_true = _inpaint_run(gen, scene, true, str(Path(out_dir) / "fill_img_true"))
    check(run_true["far_share_checked"] > 0.01,
          f"true masks leave {run_true['far_share_checked']} of the frames to check")
    windows = len(inp.window_plan(8, INPAINT_STRIDE, INPAINT_WINDOW))
    ids = inp.window_plan(8, INPAINT_STRIDE, INPAINT_WINDOW)[0]
    clip = torch.as_tensor(run["frames"][ids], device=dev).permute(0, 3, 1, 2)[None]
    mclip = torch.as_tensor(run["dilated"][ids], device=dev)[None]
    with torch.no_grad():
        net = _net_times("inpaint generator (T = 10)", lambda: gen(clip, mclip))
    emit({"phase": "preprocess_inpaint", "frames": 8, "image": list(INPAINT_HW),
          "windows": windows, "wall_s": run["wall_s"], "s_per_window": run["wall_s"] / windows,
          **{k: run[k] for k in ("hole_share", "far_share_checked", "far_max_diff")},
          "true_masks": {k: run_true[k] for k in ("wall_s", "hole_share", "far_share_checked",
                                                  "far_max_diff")},
          "nets": [net]})
    return out


def _write_colmap_text_model(scene: str, sparse: Path) -> None:
    """A COLMAP text model of the scene's poses (00.txt, camera -> world,
    OpenCV) and P2 intrinsics: one PINHOLE camera, each image's
    world -> camera quaternion and translation, named by its frame."""
    import numpy as np

    sparse.mkdir(parents=True, exist_ok=True)
    fx, fy, cx, cy = _intrinsics(scene)
    h, w = SCENE_HW
    (sparse / "cameras.txt").write_text(f"1 PINHOLE {w} {h} {fx} {fy} {cx} {cy}\n")
    lines = []
    for i, row in enumerate(np.loadtxt(Path(scene) / "00.txt").reshape(-1, 3, 4)):
        R = row[:, :3].T
        t = -R @ row[:, 3]
        # rotation matrix -> quaternion (w, x, y, z); the scene's rotations
        # are small, so w is far from 0
        qw = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
        q = [qw, (R[2, 1] - R[1, 2]) / (4 * qw), (R[0, 2] - R[2, 0]) / (4 * qw),
             (R[1, 0] - R[0, 1]) / (4 * qw)]
        lines += [f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} 1 {i:06}.png", ""]
    (sparse / "images.txt").write_text("\n".join(lines))


def phase_preprocess_metadata(scene: str, motion: str, flows: str, out_dir: str) -> None:
    """COLMAP -> metadata.json: a text model of the scene's poses, the
    scene's frames, the smoke's flows and combined masks and the scene
    writer's depth under the asset templates (motion/<seq>/{flow_fwd,
    flow_bwd, depth_npy, motion_mask}, fill_img/<seq>), build_kitti_metadata
    with every 4th frame held out, then SudsMetadataConfig.load_items of
    both splits: frame counts and the neighbours."""
    import shutil

    import numpy as np

    from nerf_kbs_tpu_torch.data.dataparsers.suds_metadata import SudsMetadataConfig
    from nerf_kbs_tpu_torch.process_data.colmap_io import read_model
    from nerf_kbs_tpu_torch.process_data.metadata import KittiMetadataConfig, build_kitti_metadata

    root = Path(out_dir) / "metadata"
    seq = "0000"
    sparse = root / "colmap" / "0"
    _write_colmap_text_model(scene, sparse)
    cams, imgs = read_model(str(sparse))
    check(len(cams) == 1 and len(imgs) == 8, f"COLMAP model: {len(cams)} / {len(imgs)}")
    assets = root / "motion" / seq
    shutil.copytree(Path(scene) / "00", root / "fill_img" / seq)
    shutil.copytree(Path(flows) / "flow_fwd", assets / "flow_fwd")
    shutil.copytree(Path(flows) / "flow_bwd", assets / "flow_bwd")
    shutil.copytree(Path(scene) / "depth", assets / "depth_npy")
    shutil.copytree(Path(motion) / "combined_mask", assets / "motion_mask")
    t0 = time.perf_counter()
    items = build_kitti_metadata(KittiMetadataConfig(
        colmap_sparse_dir=str(sparse), image_dir=str(root / "fill_img"),
        motion_dir=str(root / "motion"), sequence=seq, output_path=str(root / "metadata.json"),
        test_every=4))
    build_s = time.perf_counter() - t0
    meta = json.loads((root / "metadata.json").read_text())
    train, _ = SudsMetadataConfig(metadata_path=str(root / "metadata.json")).load_items("train")
    val, _ = SudsMetadataConfig(metadata_path=str(root / "metadata.json")).load_items("val")
    check(len(items) == 8 and len(train) == 7 and len(val) == 1 and val[0].image_index == 4,
          f"splits {len(train)} / {len(val)}")
    # metadata.json's neighbours skip the held-out frame 4; the train split
    # renumbers them by position among its own 7 frames
    raw = [(fr["forward_neighbor_index"], fr["backward_neighbor_index"]) for fr in meta["frames"]]
    check(raw == list(zip([1, 2, 3, 5, 5, 6, 7, 7], [0, 0, 1, 2, 3, 3, 5, 6])),
          f"metadata.json neighbours {raw}")
    fwd = [it.forward_neighbor_index for it in train]
    bwd = [it.backward_neighbor_index for it in train]
    check(fwd == [1, 2, 3, 4, 5, 6, 6] and bwd == [0, 0, 1, 2, 3, 4, 5],
          f"train neighbours fwd {fwd} bwd {bwd}")
    c2w = np.stack([np.asarray(it.c2w) for it in train + val])
    check(np.abs(c2w[:, :, 3]).max() <= 1.0 and meta["pose_scale_factor"] > 0,
          "poses not normalised")
    check(all(Path(it.forward_flow_path).exists() for it in train if it.image_index < 7),
          "forward flow files")
    emit({"phase": "preprocess_metadata", "frames": len(items), "train": len(train),
          "val": len(val), "build_s": build_s, "pose_scale_factor": meta["pose_scale_factor"],
          "forward_neighbours": fwd, "backward_neighbours": bwd})


def phase_preprocess_exact_chain() -> None:
    """tools/demo_motion_pipeline.py's chain at its defaults on the card:
    its mean IoU within CHAIN_IOU_TOL of the JAX package's recorded one."""
    from nerf_kbs_tpu_torch.process_data.exact_chain import exact_motion_chain

    t0 = time.perf_counter()
    res = exact_motion_chain(CHAIN["frames"], CHAIN["h"], CHAIN["w"], CHAIN["th"])
    seconds = time.perf_counter() - t0
    emit({"phase": "preprocess_exact_chain", **CHAIN, "mean_iou": res["mean_iou"],
          "jax_mean_iou": JAX_CHAIN_IOU, "tol": CHAIN_IOU_TOL,
          "per_frame_iou": res["per_frame_iou"],
          "median_static_flow_err_px": res["median_static_flow_err_px"], "seconds": seconds,
          "seconds_device_ops": res["seconds_ops"]})
    check(abs(res["mean_iou"] - JAX_CHAIN_IOU) <= CHAIN_IOU_TOL,
          f"exact chain mean IoU {res['mean_iou']} against {JAX_CHAIN_IOU}")


def phase_preprocess_vs_cpu(scene: str, motion: str, out_dir: str) -> None:
    """Each network's f32 forward on the card against the same module on the
    CPU, the same weights and inputs, at the driver's sizes: depth (the flip
    pair at 640x192), pose, RAFT (20 iterations), the segmenter, one inpaint
    window (432x240, T = 10); then the driver's first pair on the CPU
    against the card run's outputs (masks by the share of pixels that
    differ)."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.device import resolve_device
    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.process_data import motion_mask_driver as drv
    from nerf_kbs_tpu_torch.utils.images import decode_png

    cfg = _motion_cfg(scene, str(Path(out_dir) / "motion_cpu"))
    h, w = PRE_HW
    g = torch.Generator().manual_seed(1)
    frames = torch.rand(2, 3, h, w, generator=g)
    seg_in = torch.rand(1, 6, h, w, generator=g)
    ih, iw = INPAINT_HW
    clip = torch.rand(1, INPAINT_WINDOW, 3, ih, iw, generator=g)
    holes = (torch.rand(1, INPAINT_WINDOW, ih, iw, generator=g) > 0.8).float()

    def outputs(dev):
        m2, raft, seg = drv.build_networks(cfg, dev)
        gen = inp.seeded_generator(0).to(dev).eval()
        x = frames.to(dev)
        with torch.no_grad():
            return {"depth": m2.predict_disparity(x), "pose": m2.predict_pose(x[:1], x[1:]),
                    "raft": raft.compute_flow(x[:1], x[1:]), "segmenter": seg(seg_in.to(dev)),
                    "inpaint": gen(clip.to(dev), holes.to(dev))}

    card = {k: v.cpu() for k, v in outputs(resolve_device(None)).items()}
    cpu = outputs(torch.device("cpu"))
    rows = []
    for name, tol in VS_CPU_TOL.items():
        diff = float((card[name] - cpu[name]).abs().max())
        scale = float(cpu[name].abs().max())
        rows.append({"net": name, "max_abs_diff": diff, "scale": scale, "rel_diff": diff / scale,
                     "rel_tol": tol})
    t0 = time.perf_counter()
    drv.run(cfg, max_frames=2, device="cpu")
    cpu_pair_s = time.perf_counter() - t0
    shares = {}
    for sub in ("hard_mask", "combined_mask"):
        a = decode_png((Path(motion) / sub / "000000.png").read_bytes())
        b = decode_png((Path(cfg.output_path) / sub / "000000.png").read_bytes())
        shares[sub] = float((a != b).mean())
    prob_levels = int(np.abs(
        decode_png((Path(motion) / "moving_prob" / "000000.png").read_bytes()).astype(int)
        - decode_png((Path(cfg.output_path) / "moving_prob" / "000000.png").read_bytes())).max())
    pose_diff = float(np.abs(np.load(Path(motion) / "poses.npy")[:1]
                             - np.load(Path(cfg.output_path) / "poses.npy")).max())
    emit({"phase": "preprocess_vs_cpu", "nets": rows, "mask_share_differing": shares,
          "mask_share_tol": MASK_SHARE_TOL, "moving_prob_max_level_diff": prob_levels,
          "pose_matrix_max_diff": pose_diff, "cpu_pair_s": cpu_pair_s})
    for r in rows:
        check(r["rel_diff"] <= r["rel_tol"], f"{r['net']} card vs CPU: {r['rel_diff']}")
    check(max(shares.values()) <= MASK_SHARE_TOL, f"driver masks card vs CPU: {shares}")


# card against CPU, two f32 steps of each trainer (``_train_vs_cpu``):
# relative differences of the first and second losses, and relative L2
# distances of the first step's gradients (RAFT's after the clip) and of the
# parameters' change over both steps, that change also over the entries
# whose first gradient is above 1e-3 of its tensor's largest ("steady"; the
# first Adam step is ~lr x sign(g), so a gradient within rounding of zero
# may flip its entry, and the second step starts from parameters that
# differ there). Each tolerance is about 8x the largest reading of the three
# trainers on the H100 (1.7e-7, 6.3e-5, 8.4e-6, 1.4e-2, 5.8e-3; PERF.md)
TRAIN_VS_CPU_TOL = {"loss_1": 2e-6, "grad_1": 5e-4, "loss_2": 1e-4, "update_2": 0.12,
                    "update_2_steady": 0.05}
RAFT_TRAIN_ITERS = 12


def _instance_map(h: int, w: int):
    """Three box instances, two of them touching, on an (h, w) map."""
    import numpy as np

    lbl = np.zeros((h, w), np.int32)
    lbl[h // 8:h // 2, w // 10:w // 4] = 1
    lbl[h // 3:3 * h // 4, w // 4:w // 2] = 2
    lbl[h // 2:7 * h // 8, 3 * w // 5:4 * w // 5] = 3
    return lbl


def _rel_l2(got: list, want: list) -> float:
    """||got - want|| / ||want|| over all the tensors together, in f64."""
    import torch

    num = sum(float(torch.sum((g.double().cpu() - w.double()) ** 2)) for g, w in zip(got, want))
    den = sum(float(torch.sum(w.double() ** 2)) for w in want)
    return (num / den) ** 0.5


def _train_vs_cpu(make) -> dict:
    """Two steps of one trainer on the card and on the CPU from the same
    weights (``make(device)`` -> (module, step), step() -> the loss before
    its update); then a third card step timed with its peak memory. The
    first Adam step moves each parameter by about lr in its gradient's
    sign, so the gradients and the second step (whose moments carry the
    gradients' size) are compared as well as the losses."""
    import torch

    from nerf_kbs_tpu_torch.device import resolve_device

    card_model, card_step = make(resolve_device(None))
    t0 = time.perf_counter()
    cpu_model, cpu_step = make(torch.device("cpu"))
    params = list(zip(card_model.parameters(), cpu_model.parameters()))
    start = [q.detach().clone() for _, q in params]
    same_start = all(torch.equal(p.detach().cpu(), q) for (p, _), q in zip(params, start))
    loss_1 = (float(card_step()), float(cpu_step()))
    trained = [(i, p.grad.detach().cpu(), q.grad) for i, (p, q) in enumerate(params)
               if q.grad is not None]
    grad_1 = _rel_l2([g for _, g, _ in trained], [h for _, _, h in trained])
    steady = {i: h.abs() > 1e-3 * h.abs().max() for i, _, h in trained}
    loss_2 = (float(card_step()), float(cpu_step()))
    cpu_s = time.perf_counter() - t0
    moved = [(p.detach().cpu() - q0, q.detach() - q0) for (p, q), q0 in zip(params, start)]
    update_2 = _rel_l2([a for a, _ in moved], [b for _, b in moved])
    update_2_steady = _rel_l2([moved[i][0][m] for i, m in steady.items()],
                              [moved[i][1][m] for i, m in steady.items()])
    steady_share = (sum(int(m.sum()) for m in steady.values())
                    / sum(q.numel() for _, q in params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    peak = _peak_mib(card_step)
    ms = (time.perf_counter() - t0) * 1e3
    return {"same_start": same_start, "loss_card": loss_1[0], "loss_cpu": loss_1[1],
            "loss_2_card": loss_2[0], "loss_2_cpu": loss_2[1],
            "rel": {"loss_1": abs(loss_1[0] - loss_1[1]) / abs(loss_1[1]), "grad_1": grad_1,
                    "loss_2": abs(loss_2[0] - loss_2[1]) / abs(loss_2[1]),
                    "update_2": update_2, "update_2_steady": update_2_steady},
            "steady_share": steady_share,
            "tol": TRAIN_VS_CPU_TOL, "card_step_ms": ms, "peak_mib": peak,
            "cpu_two_steps_s": cpu_s,
            "finite": all(math.isfinite(x) for x in loss_1 + loss_2)}


def preprocess_trainers() -> dict:
    """``make(device)`` -> (module, step) of each preprocessing trainer, from
    seeded weights and inputs (step() -> the loss before its update): RAFT at
    PRE_HW, RAFT_TRAIN_ITERS iterations, batch 1; the segmenter at PRE_HW;
    the inpainter at INPAINT_HW, T = INPAINT_WINDOW."""
    import torch

    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.process_data import raft_driver as rd
    from nerf_kbs_tpu_torch.process_data.networks import init_weights
    from nerf_kbs_tpu_torch.process_data.networks import segmenter as seg

    g = torch.Generator().manual_seed(5)
    h, w = PRE_HW
    img1 = torch.rand(1, 3, h, w, generator=g)
    raft_batch = {"img1": img1, "img2": torch.roll(img1, 3, dims=3),
                  "flow": 3.0 * torch.randn(1, 2, h, w, generator=g),
                  "valid": (torch.rand(1, h, w, generator=g) > 0.1).float()}
    lbl = _instance_map(h, w)
    fg, off, valid = seg.make_targets(lbl)
    seg_batch = {"x": torch.rand(1, 6, h, w, generator=g), "fg": torch.from_numpy(fg[None]),
                 "off": torch.from_numpy(off[None]).permute(0, 3, 1, 2),
                 "valid": torch.from_numpy(valid[None]),
                 "w": torch.from_numpy(seg.boundary_weight(lbl)[None])}
    ih, iw = INPAINT_HW
    frames = torch.rand(1, INPAINT_WINDOW, 3, ih, iw, generator=g)
    masks = inp.random_stroke_masks(torch.Generator().manual_seed(6), INPAINT_WINDOW, ih, iw)[None]

    def raft_step(dev):
        cfg = rd.RaftTrainConfig(iters=RAFT_TRAIN_ITERS)
        raft, tx = rd.make_raft_train_state(cfg, device=dev)
        step = rd.make_raft_train_step(raft, tx, cfg)
        batch = {k: v.to(dev) for k, v in raft_batch.items()}
        return raft, lambda: step(batch)[0]

    def segmenter_step(dev):
        model = init_weights(seg.InstanceSegmenter(), torch.Generator().manual_seed(7)).to(dev)
        step = seg.make_segmenter_train_step(model)
        batch = {k: v.to(dev) for k, v in seg_batch.items()}
        return model, lambda: step(batch)[0]

    def inpaint_step(dev):
        gen = inp.seeded_generator(0).to(dev).train()
        step = inp.make_inpaint_train_step(gen)
        f, m = frames.to(dev), masks.to(dev)
        return gen, lambda: step(f, m)

    return {"raft": raft_step, "segmenter": segmenter_step, "inpaint": inpaint_step}


def phase_preprocess_train() -> None:
    """Each preprocessing trainer in f32 on the card against the CPU, on
    the same seeded weights and inputs (the masks passed in), two steps
    (``_train_vs_cpu``): RAFT at 640x192, 12 iterations, batch 1 (the
    sequence loss under AdamW with the one-cycle rate and the global-norm
    clip); the segmenter at 640x192 (Adam, boundary-weighted targets of an
    instance map); the inpainter at 432x240, T = 10 (Adam, random stroke
    masks). On the card the ms of a third step and its peak memory; and the
    memory counters of ``utils/profiling.device_memory_stats`` under the
    JAX package's keys."""
    from nerf_kbs_tpu_torch.utils import profiling

    rows = [{"trainer": name, **_train_vs_cpu(make)}
            for name, make in preprocess_trainers().items()]
    mem = profiling.device_memory_stats()
    emit({"phase": "preprocess_train_vs_cpu", "raft_hw": list(PRE_HW),
          "raft_iters": RAFT_TRAIN_ITERS, "inpaint_hw": list(INPAINT_HW),
          "inpaint_window": INPAINT_WINDOW, "trainers": rows, "device_memory_stats": mem})
    for r in rows:
        check(r["finite"] and r["same_start"]
              and all(r["rel"][k] <= TRAIN_VS_CPU_TOL[k] for k in TRAIN_VS_CPU_TOL),
              f"{r['trainer']} train steps card vs CPU: {r}")
    check(mem is not None and sorted(mem) == ["bytes_in_use", "bytes_limit", "peak_bytes_in_use"]
          and 0 <= mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"]
          and mem["peak_bytes_in_use"] > 0,
          f"device_memory_stats on the card: {mem}")


def phase_preprocess(scene: str, out_dir: str) -> None:
    """The preprocessing phases on the street scene; no fused kernel may
    launch in them."""
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    ff.reset_launches()
    motion = phase_preprocess_motion_mask(scene, out_dir)
    phase_preprocess_host_io(scene)
    flows = phase_preprocess_flows(scene, out_dir)
    phase_preprocess_inpaint(scene, motion, out_dir)
    phase_preprocess_metadata(scene, motion, flows, out_dir)
    phase_preprocess_exact_chain()
    phase_preprocess_vs_cpu(scene, motion, out_dir)
    phase_preprocess_train()
    moved = {k: v for k, v in ff.LAUNCHES.items() if v}
    emit({"phase": "preprocess_fused_launches", "launches": moved})
    check(not moved, f"the preprocessing phases launched fused kernels: {moved}")


# ---------------------------------------------------------------------------
# the port's tools (tools/*_torch.py) as programs
# ---------------------------------------------------------------------------

# outputs/field_ab/tri_ab.json's overrides: the study_field tri arm
TRI_AB = ["max_res=64", "base_res=4", "hidden_dim=128", "num_layers=3",
          "num_proposal_samples_per_ray=[128,48]", "fourier_basis=tri",
          "fourier_anneal_steps=1500", "stop_grad_sampling=true"]
# the studies' orbit scene cut from 128 x 128 and 28 + 4 cameras
TOOL_SCENE = ["--img", "64", "--cams", "12", "--eval-cams", "2"]
# kernel by launch counter (any body)
KERNEL_OF = {"fourier_mlp": "A", "fourier_field_mlp": "B", "fourier_mlp_bwd": "C",
             "fourier_field_mlp_bwd": "D"}
STUDY_STEP = {"A": 2, "B": 1, "C": 2, "D": 1}
STUDY_CHUNK = {"A": 2, "B": 1}
# study_camera_opt at the cut size: the frozen arm's recovered reprojection
# error at most CAMOPT_RECOVERY of the injected one, its pretrained field's
# eval PSNR at most CAMOPT_FIELD_DB under the opt arm's
CAMOPT_RECOVERY = 0.7
CAMOPT_FIELD_DB = 1.0
# each tool: its argv at the phase's cut sizes (``out`` its directory) and
# the committed result of its JAX twin whose keys it must write
TOOL_RUNS = {
    "study_field": (lambda out: ["--steps", "100", "--eval-every", "50", "--scan-steps", "25",
                                 "--name", "tri_ab_cut", *TOOL_SCENE, *TRI_AB],
                    "field_ab/tri_ab.json"),
    # the window opens in the first third of the pretraining, as the JAX
    # frozen arm's fourier_anneal_steps=1000 of 3000 (tools/tpu_queue_aa.sh);
    # a 2-layer base MLP, the point of frozen.json's run (its tool set no
    # num_layers, whose default was 2): at the registry's 3 layers the
    # pretraining may stay at the white background
    "study_camera_opt": (lambda out: ["--arms", "opt,frozen", "--steps", "200",
                                      "--eval-every", "100", "--scan-steps", "50",
                                      "--out", str(out / "camopt.json"), *TOOL_SCENE,
                                      "fourier_anneal_steps=60", "num_layers=2"],
                         "camopt_study/frozen.json"),
    "study_vanilla": (lambda out: ["--steps", "50", "--eval-every", "50", *TOOL_SCENE],
                      "vanilla_orbit/result.json"),
    "study_flow": (lambda out: ["--steps", "50", "--frames", "10", "--h", "94", "--w", "310",
                                "--data", str(out / "kitti_syn_flow")], None),
    "train_segmenter": (lambda out: ["--scenes", "4", "--eval-scenes", "1", "--frames", "3",
                                     "--steps", "100", "--out", str(out)],
                        "segmenter3/result.json"),
    "tune_decoder": (lambda out: ["--ckpt", str(SEGMENTER), "--tune-scenes", "1",
                                  "--eval-scenes", "1", "--frames", "2", "--out", str(out)],
                     "segmenter_decoder/result.json"),
    "validate_inpaint": (lambda out: ["--steps", "100", "--size", "64", "--frames", "12",
                                      "--out", str(out)], "inpaint_validation/result.json"),
    "demo_motion_pipeline": (lambda out: ["--out", str(out)],
                             "motion_pipeline_demo/result.json"),
    "regen_data": (lambda out: ["--root", str(out), "--frames", "3", "--h", "94",
                                "--w", "310"], None),
}


def _by_kernel(counts: dict) -> dict:
    """Launch counts of fused_field.LAUNCHES keys (any body) by kernel, A to D."""
    out: dict = {}
    for k, v in counts.items():
        kernel = KERNEL_OF[k.replace("_base_wgmma", "").replace("_wgmma", "")]
        out[kernel] = out.get(kernel, 0) + v
    return out


def _tool_launches(log: str) -> dict:
    """A tool's '# launches' lines by phase name."""
    return {d["name"]: d for d in (json.loads(ln[len("# launches "):])
                                   for ln in log.splitlines() if ln.startswith("# launches "))}


def _per_unit(summary: dict) -> dict:
    """(train launches by kernel per step, of them with dx per step, eval
    launches by kernel per chunk), each None where the counts are not a
    whole multiple."""
    def per(counts, units):
        by = _by_kernel(counts)
        return {k: v // units for k, v in by.items()} if units and all(
            v % units == 0 for v in by.values()) else None

    return (per(summary["train"], summary["train_steps"]),
            per(summary["train_dx"], summary["train_steps"]),
            per(summary["eval"], summary["eval_chunks"]))


def phase_tools_torch(records) -> None:
    """Each port tool (TOOL_RUNS) as a program of its own at a cut size, all
    started together (1 OpenMP thread each) on the one card, each in a
    directory of its own: exit code 0; the key set of its JAX twin's
    committed result; the studies' fused launches a step (A 2 / B 1 / C 2 /
    D 1, every C and D launch with dx in the camera arms) and an eval chunk
    (A 2 / B 1); and that each study learns: study_field's last eval PSNR
    above its first; study_camera_opt's frozen arm pretrained to a field
    that learned (CAMOPT_FIELD_DB), then recovering the poses to at most
    CAMOPT_RECOVERY of the injected reprojection error with its eval PSNR
    unmoved by the camera-only phase, the opt arm ending below the injected
    error; the trained inpainter above the untrained one; the segmenter's
    held-out scores finite, study_flow's depth errors finite, the motion
    demo's mean IoU within CHAIN_IOU_TOL of the JAX tool's, regen_data's
    three datasets written."""
    import numpy as np

    # every tool writes into the phase's directory, removed at its end
    with tempfile.TemporaryDirectory(prefix="nkt_tools_") as tmp:
        root = Path(tmp)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs, outs = {}, {}
        t0 = time.perf_counter()
        try:
            for name, (argv, _) in TOOL_RUNS.items():
                out = root / name
                out.mkdir()
                outs[name] = out
                with open(out / "log.txt", "w") as log:
                    procs[name] = subprocess.Popen(
                        [sys.executable, str(HERE / "tools" / f"{name}_torch.py"), *argv(out)],
                        cwd=out, env=env, stdout=log, stderr=subprocess.STDOUT)
            seconds = {}
            for name, p in procs.items():
                p.wait(timeout=900)
                seconds[name] = time.perf_counter() - t0
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = {name: (outs[name] / "log.txt").read_text() for name in procs}
        for name, p in procs.items():
            check(p.returncode == 0, f"tools/{name}_torch.py exited {p.returncode}:\n"
                                     f"{logs[name][-4000:]}")

        def last_json(name):
            return [json.loads(ln) for ln in logs[name].splitlines() if ln.startswith("{")][-1]

        results = {
            "study_field": last_json("study_field"),
            "study_camera_opt": json.loads(
                (outs["study_camera_opt"] / "camopt.json").read_text()),
            "study_vanilla": last_json("study_vanilla"),
            "study_flow": last_json("study_flow"),
            **{n: json.loads((outs[n] / "result.json").read_text())
               for n in ("train_segmenter", "tune_decoder", "validate_inpaint",
                         "demo_motion_pipeline")},
        }
        keys_ok = {}
        for name, (_, committed) in TOOL_RUNS.items():
            if committed is not None:
                # the committed keys; a result committed before its tool gained
                # a key lacks that one
                want = set(json.loads((HERE / "outputs" / committed).read_text()))
                keys_ok[name] = want <= set(results[name])
        regen = sorted(str(p.relative_to(outs["regen_data"] / "outputs"))
                       for p in (outs["regen_data"] / "outputs").iterdir())

    field = results["study_field"]
    field_launches = _tool_launches(logs["study_field"])["tri_ab_cut"]
    cam_launches = _tool_launches(logs["study_camera_opt"])
    per_step = {n: _per_unit(d) for n, d in
                [("study_field", field_launches)] + list(cam_launches.items())}
    arms = {a["arm"]: a for a in results["study_camera_opt"]["arms"]}
    seg = results["train_segmenter"]["heldout_touching"]
    inp = results["validate_inpaint"]
    flow = results["study_flow"]
    emit({"phase": "tools_torch", "concurrent": len(procs), "wall_s": time.perf_counter() - t0,
          "seconds_to_exit": seconds, "keys_match_jax_results": keys_ok,
          "launches_per_step_dx_per_step_per_eval_chunk": per_step,
          "study_field_trajectory": field["trajectory"], "study_field_rays_per_sec":
              field["rays_per_sec"],
          "study_camera_opt": {a: {k: v for k, v in r.items() if "trajectory" not in k}
                               for a, r in arms.items()},
          "study_camera_opt_injected": results["study_camera_opt"]["injected"],
          "study_vanilla_trajectory": results["study_vanilla"]["trajectory"],
          "study_flow": flow, "train_segmenter_heldout": seg,
          "train_segmenter_train_seconds": results["train_segmenter"]["train_seconds"],
          "tune_decoder_eval": {k: results["tune_decoder"][k] for k in
                                ("eval_baseline", "eval_tuned", "eval_tuned_constrained")},
          "validate_inpaint": {k: inp[k] for k in ("masked_psnr_trained",
                                                   "masked_psnr_untrained",
                                                   "masked_psnr_gray_fill", "fill_img_count")},
          "demo_motion_pipeline": results["demo_motion_pipeline"], "regen_data": regen})

    check(all(keys_ok.values()), f"tools' result keys against their JAX twins': {keys_ok}")
    check(regen == ["kitti_dyn", "kitti_syn", "vkitti_syn"] and "DONE" in logs["regen_data"],
          f"regen_data_torch wrote {regen}")
    for name, (train, dx, chunk) in per_step.items():
        camera = name != "study_field" and not name.endswith("pretrain")
        check(train == STUDY_STEP and chunk == STUDY_CHUNK
              and dx == ({"C": 2, "D": 1} if camera else {}),
              f"{name}: launches a step {train}, with dx {dx}, an eval chunk {chunk}")
    check(field_launches["train_steps"] == 100, f"study_field launches {field_launches}")
    evals = [t[2] for t in field["trajectory"]]
    check(len(evals) == 2 and evals[-1] > evals[0], f"study_field eval PSNR {evals}")
    # the frozen arm's recovery counts only through a field that learned the
    # scene: its pretraining's eval PSNR rose and ends within
    # CAMOPT_FIELD_DB of the opt arm's joint field (or above it)
    frozen, opt = arms["frozen"], arms["opt"]
    pre = [t[2] for t in frozen["pretrain_trajectory"]]
    check(pre[-1] > pre[0] and pre[-1] >= opt["final_eval_psnr"] - CAMOPT_FIELD_DB,
          f"study_camera_opt frozen arm: pretraining eval PSNR {pre}, the opt arm's "
          f"{opt['final_eval_psnr']}")
    injected = frozen["injected_reproj_px_err"]
    check(opt["reproj_px_err"] < injected and frozen["reproj_px_err"] <= CAMOPT_RECOVERY * injected,
          f"study_camera_opt reprojection error: opt arm {opt['reproj_px_err']}, frozen arm "
          f"{frozen['reproj_px_err']}, injected {injected}")
    # the camera-only phase moves the tangents alone: the eval cameras
    # carry no deltas, so the frozen field renders them as pretrained
    check(frozen["trajectory"][-1][2] == pre[-1],
          f"study_camera_opt frozen arm: eval PSNR {pre[-1]} after pretraining, "
          f"{frozen['trajectory'][-1][2]} after the camera-only phase")
    check(all(np.isfinite(m["depth_mse"]) and m["num_images"] == 1 for m in flow.values()),
          f"study_flow {flow}")
    check(seg["segmenter_fused_mask_iou"] > 0 and np.isfinite(seg["segmenter_instance_quality"]),
          f"train_segmenter held-out {seg}")
    check(inp["masked_psnr_trained"] > inp["masked_psnr_untrained"],
          f"validate_inpaint {inp}")
    check(abs(results["demo_motion_pipeline"]["mean_iou"] - JAX_CHAIN_IOU) <= CHAIN_IOU_TOL,
          f"demo_motion_pipeline_torch {results['demo_motion_pipeline']}")
    for rec in records:
        if rec["name"] in WRAPPER:
            rec["study_field_launches_per_step"] = per_step["study_field"][0][
                KERNEL_OF[WRAPPER[rec["name"]]]]
        elif rec["name"][:-len("_dx")] in ("fourier_mlp_bwd", "fourier_field_bwd"):
            rec["study_camera_opt_dx_launches_per_step"] = per_step["opt"][1][
                KERNEL_OF[WRAPPER[rec["name"][:-len("_dx")]]]]


# phase reference_runs: the two protocols of tools/reference_runs_torch.sh
# (the JAX package's 30,000-step reference runs) cut to the smoke's scene and
# time. Per protocol: the steps (a multiple of 30, so that the log's cadence,
# steps / 30, divides them), and the launches of a train step and of an eval
# chunk (an eval batch is one chunk). ilf050 runs the flagship field (A and C
# at the proposal widths, B and D); sem30k-flagship2's split field has a
# 2-layer base MLP, (256, 128, 16), which A and C run on their base-width
# wgmma bodies. The counts are exact: a launch of a WMMA body fails the phase.
REFERENCE_RUNS = {
    "ilf050": (750, {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1,
                      "fourier_mlp_bwd_wgmma": 2, "fourier_field_mlp_bwd_wgmma": 1},
               {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1}),
    "sem30k-flagship2": (450, {"fourier_mlp_wgmma": 2, "fourier_mlp_base_wgmma": 1,
                               "fourier_mlp_bwd_wgmma": 2, "fourier_mlp_bwd_base_wgmma": 1},
                         {"fourier_mlp_wgmma": 2, "fourier_mlp_base_wgmma": 1}),
}
REFERENCE_STEPS = 30000
# the protocol's cadences, cut by steps / 30,000 with the run
REFERENCE_CADENCES = ("model.fourier_anneal_steps", "trainer.steps_per_eval_image",
                      "trainer.steps_per_eval_batch", "trainer.steps_per_eval_all_images",
                      "trainer.log_every", "trainer.max_num_iterations")


def protocol_argv(protocol: str, out: str) -> tuple[str, dict]:
    """(method, override pairs) of ``protocol``'s seed-42 run, output under
    ``out``, as tools/reference_runs_torch.sh prints it."""
    words = subprocess.run(["bash", str(HERE / "tools" / "reference_runs_torch.sh"), "--argv",
                            out, f"{protocol}-s42"], check=True, capture_output=True,
                           text=True).stdout.split()
    return words[1], _pairs(words[2:])


def reference_argv(protocol: str, scene: str, out: str) -> tuple[str, list, dict]:
    """(method, argv, cuts) of ``protocol`` as tools/reference_runs_torch.sh
    runs it at seed 42, cut to the smoke: the scene (8 frames at SCENE_HW,
    split 6 / 2, the protocol's 36 / 4 of 40 at 0.9 leaving no eval frame of
    8), its cadences by steps / 30,000 (the Fourier anneal, the evals, the
    log, the run's length), a checkpoint at the end only. Every other pair
    is the protocol's: 16,384 rays a step, the widths, the interlevel
    fraction, ``steps_per_dispatch`` 50. ``cuts`` maps each changed path to
    (protocol's value, cut value)."""
    method, ov = protocol_argv(protocol, out)
    steps = REFERENCE_RUNS[protocol][0]
    cut = {k: str(int(ov[k]) * steps // REFERENCE_STEPS) for k in REFERENCE_CADENCES}
    cut.update({"dataparser.last_frame": "8", "dataparser.train_split_fraction": "0.75",
                "dataparser.image_height": str(SCENE_HW[0]),
                "dataparser.image_width": str(SCENE_HW[1]),
                "trainer.steps_per_save": str(steps)})
    for k, v in ov.items():
        if v.startswith("outputs/kitti_syn"):
            cut[k] = scene + v[len("outputs/kitti_syn"):]
    cuts = {k: (ov[k], v) for k, v in cut.items()}
    ov.update(cut)
    return method, [x for k, v in ov.items() for x in (f"--{k}", v)], cuts


def phase_reference_runs(records, scene: str) -> None:
    """Both protocols of tools/reference_runs_torch.sh through cli.main,
    cut (reference_argv): the launch counts of the whole run (steps x a
    step's, plus the eval batches', eval images' and the split's chunks x a
    chunk's), every logged loss finite, and no stall at the background: the
    split's final PSNR at least 2 dB above that of each eval image against
    its own mean colour (the frozen 3-layer arm of the camera study sat
    there, PERF.md). Records the eval PSNR at each eval, the wall time and
    the median logged rays/s; the ``*_base2`` kernel records (A and C at
    sem30k-flagship2's base widths) take their launches a step from it, and
    one sem30k-flagship2 step is profiled (device busy share)."""
    import numpy as np

    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager
    from nerf_kbs_tpu_torch.engine import cli
    from nerf_kbs_tpu_torch.ops import fused_field as ff

    for protocol, (steps, per_step, per_chunk) in REFERENCE_RUNS.items():
        out = tempfile.mkdtemp(prefix=f"nkt_ref_{protocol}_")
        method, argv, cuts = reference_argv(protocol, scene, out)
        spec = cli.apply_overrides(cli.method_registry[method](), _pairs(argv))
        tr = spec.trainer
        dm = InMemoryDataManager(spec.dataparser.parse("train"), spec.dataparser.parse("val"),
                                 spec.datamanager)
        gts = dm.eval_assets["images"].astype(np.float64) / 255.0
        n_eval = len(gts)
        mean_colour_psnr = [float(-10 * np.log10(np.mean((g - g.mean((0, 1))) ** 2)))
                            for g in gts]
        chunks_per_image = -(-SCENE_HW[0] * SCENE_HW[1] // tr.eval_num_rays_per_chunk)
        chunks = (steps // tr.steps_per_eval_batch
                  + (steps // tr.steps_per_eval_image + n_eval) * chunks_per_image)
        want = {k: steps * per_step.get(k, 0) + chunks * per_chunk.get(k, 0)
                for k in set(per_step) | set(per_chunk)}
        ff.reset_launches()
        t0 = time.perf_counter()
        cli.main([method] + argv)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        check(launches == want, f"{protocol}: launches {launches}, want {want}")
        lines = [json.loads(ln) for ln in
                 (Path(out) / f"{protocol}-s42" / tr.experiment_name / method
                  / "metrics.jsonl").read_text().splitlines()]
        logged = [ln for ln in lines if "total_loss" in ln]
        check(len(logged) == steps // tr.log_every, f"{protocol}: {len(logged)} logged steps")
        check(all(np.isfinite(v) for ln in logged for k, v in ln.items() if k.endswith("_loss")),
              f"{protocol}: a non-finite loss")
        final = [ln for ln in lines if "eval_all_psnr" in ln]
        check(len(final) == 1 and final[0]["eval_all_num_images"] == n_eval
              and all(np.isfinite(v) for v in final[0].values()), f"{protocol}: eval {final}")
        floor = float(np.mean(mean_colour_psnr)) + 2.0
        check(final[0]["eval_all_psnr"] >= floor,
              f"{protocol}: eval_all_psnr {final[0]['eval_all_psnr']:.3f} under {floor:.3f}, "
              "2 dB over the eval images' own mean colour: stalled at the background")
        rays_per_s = sorted(ln["rays_per_sec"] for ln in logged[1:])
        emit({"phase": "reference_runs", "protocol": protocol, "method": method,
              "steps": steps, "cuts": cuts, "wall_s": wall,
              "median_rays_per_s": rays_per_s[len(rays_per_s) // 2],
              "launches": launches, "launches_per_step": per_step,
              "launches_per_eval_chunk": per_chunk, "eval_chunks": chunks,
              "loss_first": logged[0]["total_loss"], "loss_last": logged[-1]["total_loss"],
              "psnr_last": logged[-1]["psnr"],
              "eval_psnr": {ln["step"]: ln["eval_psnr"] for ln in lines if "eval_psnr" in ln},
              "eval_batch_psnr": {ln["step"]: ln["eval_batch_psnr"] for ln in lines
                                  if "eval_batch_psnr" in ln},
              "eval_all": {k: v for k, v in final[0].items() if k.startswith("eval_all_")},
              "mean_colour_psnr": mean_colour_psnr, "stall_floor_psnr": floor})
        if protocol == "sem30k-flagship2":
            for rec in records:
                if rec["name"].endswith("_base2"):
                    counter = f"{WRAPPER[rec['name'][:-len('_base2')]]}_base_wgmma"
                    rec["launches"] = per_step[counter]
                    rec["launches_per"] = "16,384-ray sem30k-flagship2 train step"
                    rec["launches_per_eval_chunk"] = per_chunk.get(counter, 0)
                    rec["reference_run_launches"] = launches[counter]
            # one step of the protocol under the profiler: the device's busy
            # share of a sem30k-flagship2 step
            trainer = cli.build_trainer(spec)
            batch = trainer._to_device(trainer.dm.next_train(steps))
            trainer.train_step(batch)
            phase_profile(lambda: trainer.train_step(batch),
                          spec.datamanager.train_num_rays_per_batch,
                          what="sem30k-flagship2 train step", top=25)
            del trainer


# phase reference_vs_cpu: the logged loss terms of both protocols, held card
# against CPU per step (f32, 3 steps; the largest gap seen on an H100 was
# 2.4e-5, the interlevel term's); ilf050 logs no depth or semantics term
REFERENCE_VS_CPU_TERMS = {
    "ilf050": ("rgb_loss", "distortion_loss", "interlevel_loss"),
    "sem30k-flagship2": ("rgb_loss", "distortion_loss", "interlevel_loss", "depth_loss",
                         "semantics_loss"),
}


def phase_reference_vs_cpu(scene: str) -> None:
    """Both protocols of tools/reference_runs_torch.sh at full width on the
    card against the CPU plain path (_card_vs_cpu): the protocol's model,
    optimizers and data (reference_argv's scene), in f32, 256 rays a step,
    the Fourier window open from step 2 so that every level of the encoding
    takes part; the total and each loss term per step
    (REFERENCE_VS_CPU_TERMS), the semantics and interlevel terms apart."""
    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli

    for protocol, terms in REFERENCE_VS_CPU_TERMS.items():
        out = tempfile.mkdtemp(prefix=f"nkt_ref_cpu_{protocol}_")
        method, argv, _ = reference_argv(protocol, scene, out)
        _card_vs_cpu(cli, method, argv + [
            "--trainer.mixed_precision", "false", "--datamanager.train_num_rays_per_batch", "256",
            "--model.fourier_anneal_steps", "2", "--trainer.max_num_iterations", "3"],
            f"reference_vs_cpu_{protocol}", terms=terms)


# phase repeat_bits: the paths run twice from one seed and their steps (the
# preprocessing trainers of preprocess_trainers too)
REPEAT_BITS = {"ilf050": 100, "sem30k-flagship2": 100, "run3": 20, "run7": 20, "run7b": 20,
               "raft": 3, "segmenter": 3, "inpaint": 3}
PREPROCESS_TRAINERS = ("raft", "segmenter", "inpaint")
# segment sums a step by call site: one a proposal round for the interlevel
# bounds; where sampling is not detached (semantic-nerfw as registered; both
# reference protocols detach it) two a round in the pdf sampler (its running
# maximum, its brackets), all through the short-row kernel; one a hash field
# (the field and the two proposal fields), a radix sort and a by-key sum
REPEAT_SEGMENT_SUMS = {"ilf050": {"interlevel": 2}, "sem30k-flagship2": {"interlevel": 2},
                       "run3": {"interlevel": 2, "sampler": 4, "hash": 3},
                       "run7": {"interlevel": 2},
                       "run7b": {"interlevel": 2, "sampler": 4, "hash": 3}}
# the hash grid's launches a step (ops/hash_grid.py LAUNCHES): a forward and a
# backward a hash field; the backward's dx branch where the positions carry a
# gradient: the field's and the second proposal field's (sampling is not
# detached), and with the camera optimizer the first proposal field's too
REPEAT_HASH_GRID = {"run3": {"hash_grid_fwd": 3, "hash_grid_bwd": 3, "hash_grid_bwd_dx": 2},
                    "run7b": {"hash_grid_fwd": 3, "hash_grid_bwd": 3, "hash_grid_bwd_dx": 3}}


def repeat_trainer(path: str, scene: str, out: str, extra: tuple = (), device=None):
    """A Trainer of one of the smoke's training paths, from its seed:
    'ilf050' and 'sem30k-flagship2' (reference_argv: full width, 16,384
    rays), 'run1', 'run2', 'run3', 'run7' and 'run7b' (the CLI runs' argvs,
    4,096 rays); ``extra`` override pairs go last."""
    import nerf_kbs_tpu_torch.methods  # noqa: F401  (fills cli.method_registry)
    from nerf_kbs_tpu_torch.engine import cli

    if path in REFERENCE_RUNS:
        method, argv, _ = reference_argv(path, scene, out)
    else:
        method, more = {"run1": ("nerfacto-tpu", []),
                        "run2": ("semantic-nerfw", RUN2_MODEL + _run2_data(scene)),
                        "run3": ("semantic-nerfw", _run2_data(scene)),
                        "run7": ("nerfacto-tpu", CAMERA_OPT),
                        "run7b": ("semantic-nerfw", _run2_data(scene) + CAMERA_OPT)}[path]
        argv = _run_argv(scene, out) + more
    spec = cli.apply_overrides(cli.method_registry[method](), _pairs(argv + list(extra)))
    return cli.build_trainer(spec, device=device)


def state_checksums(trainer) -> dict:
    """Per parameter group, of its parameters ('/p') and Adam moments ('/mu',
    '/nu'): two sums over their float32 words read as int32, plain and
    weighted by position mod 1,009, so that a change of any bit shows."""
    import torch

    from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves

    opt = trainer.optimizer
    keys, sums = [], []
    for g in opt.configs:
        for kind, tree in (("p", opt.params[g]), ("mu", opt.state[g]["mu"]),
                           ("nu", opt.state[g]["nu"])):
            words = torch.cat([t.detach().reshape(-1).view(torch.int32).long()
                               for t in tree_leaves(tree)])
            weight = torch.arange(words.numel(), device=words.device) % 1009 + 1
            keys.append(f"{g}/{kind}")
            sums.append(torch.stack([words.sum(), (words * weight).sum()]))
    return dict(zip(keys, torch.stack(sums).tolist()))


def _state_leaves(trainer) -> list:
    from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves

    opt = trainer.optimizer
    return [t for g in opt.configs
            for tree in (opt.params[g], opt.state[g]["mu"], opt.state[g]["nu"])
            for t in tree_leaves(tree)]


def final_state(trainer) -> list:
    """Every parameter and Adam moment, copied to the host."""
    return [t.detach().to("cpu", copy=True) for t in _state_leaves(trainer)]


def restart(trainer, start: list) -> None:
    """Puts back the parameters and Adam moments ``start`` (final_state of
    the trainer as built) and the step and update counts 0: the trainer then
    trains as a new one from the same seed would (its batches and jitter
    are functions of the step)."""
    import torch

    with torch.no_grad():
        for t, s in zip(_state_leaves(trainer), start):
            t.copy_(s)
    for st in trainer.optimizer.state.values():
        st["count"] = 0
    trainer.step = 0


def train_record(trainer, steps: int) -> list:
    """``steps`` steps from the trainer's batches; after each, its logged
    losses (the metrics as floats) and its state's checksums."""
    rec = []
    for _ in range(steps):
        metrics = trainer.train_step(trainer.dm.next_train(trainer.step))
        rec.append({"losses": {k: float(v) for k, v in metrics.items()},
                    "state": state_checksums(trainer)})
    return rec


def first_divergence(a: list, b: list):
    """None when two train_record lists agree in every checksum and every
    loss's bits, else the first step (from 1) that differs with the state
    keys and the losses that differ there."""
    def same(x, y):
        return x == y or (x != x and y != y)  # NaN in both

    for i, (x, y) in enumerate(zip(a, b)):
        state = [k for k in x["state"] if x["state"][k] != y["state"].get(k)]
        losses = [k for k in x["losses"] if not same(x["losses"][k], y["losses"].get(k))]
        if state or losses:
            return {"step": i + 1, "state": state, "losses": losses}
    return None if len(a) == len(b) else {"step": min(len(a), len(b)) + 1, "state": ["length"],
                                          "losses": []}


def module_checksums(module) -> dict:
    """state_checksums' sums over one module's parameters."""
    import torch

    words = torch.cat([p.detach().reshape(-1).view(torch.int32).long()
                       for p in module.parameters()])
    weight = torch.arange(words.numel(), device=words.device) % 1009 + 1
    return {"params/p": torch.stack([words.sum(), (words * weight).sum()]).tolist()}


def trainer_record(name: str, steps: int) -> tuple[list, list]:
    """A preprocessing trainer of preprocess_trainers, built from its seed
    on the card and trained ``steps`` steps: (per step its loss and its
    parameters' checksums, as train_record gives them; its parameters
    copied to the host)."""
    from nerf_kbs_tpu_torch.device import resolve_device

    model, step = preprocess_trainers()[name](resolve_device(None))
    rec = [{"losses": {"loss": float(step())}, "state": module_checksums(model)}
           for _ in range(steps)]
    return rec, [p.detach().to("cpu", copy=True) for p in model.parameters()]


def _segment_sum_spy():
    """Replaces segment_sum in losses and samplers (the short-row sites) and
    segment_sum_by_key in hash_grid (the hash fields' table gradients) by
    wrappers that count the calls by site and keep inputs (cloned): each
    short-row site's first call; of the hash fields the first call of the
    largest span (the field: 'hash') and the first of the smallest (a
    proposal field: 'hash_coarse'). Returns (the inputs by site, the counts,
    restore)."""
    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops import losses, samplers

    seen, counts, saved = {}, {}, []
    for site, mod, attr in (("interlevel", losses, "segment_sum"),
                            ("sampler", samplers, "segment_sum"),
                            ("hash", hg, "segment_sum_by_key")):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        if site != "hash":
            def spy(values, idx, n, _site=site, _fn=fn):
                seen.setdefault(_site, (values.clone(), idx.clone(), n))
                counts[_site] = counts.get(_site, 0) + 1
                return _fn(values, idx, n)
        else:
            def spy(values, keys, perm, out, own=None, _fn=fn):
                counts["hash"] = counts.get("hash", 0) + 1
                span = out.shape[1]
                # the gradient's width and the span's first column
                call = (values.clone(), keys.clone(), perm.clone(), span, own, out.stride(0),
                        out.storage_offset())
                if span > seen.get("hash", (0, 0, 0, -1))[3]:
                    seen["hash"] = call
                if span < seen.get("hash_coarse", (0, 0, 0, span + 1))[3]:
                    seen["hash_coarse"] = call
                return _fn(values, keys, perm, out, own)
        setattr(mod, attr, spy)

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return seen, counts, restore


def _segment_sum_checks(dev) -> None:
    """The segment sums against their plain version in f64: long runs, empty
    runs, one-element rows, a shared index row (the by-key kernel), a run
    across many of its tiles and a row that names no target but 0; within
    Q eps of a row's sum of |v| (any order of Q adds), bit for bit on a
    repeat and, for rows of their own of at most 256 entries, bit for bit
    against the serial sum."""
    import numpy as np
    import torch

    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    rng = np.random.default_rng(18)
    long_idx = np.full((3, 200_000), 4)
    long_idx[:, :3], long_idx[:, -2:] = 1, 9
    across = np.repeat(np.arange(4), [1000, 100_000, 3, 20_000])[None]
    cases = {
        "long_runs": (rng.normal(size=(3, 200_000)), long_idx, 10),
        "empty_runs": (rng.normal(size=(64, 300)),
                       np.sort(rng.integers(0, 100, (64, 300)), axis=-1) * 3, 301),
        "one_element_rows": (rng.normal(size=(1000, 1)), rng.integers(0, 5, (1000, 1)), 5),
        "shared_index_row": (rng.normal(size=(2, 100_000)),
                             np.sort(rng.integers(0, 4096, (1, 100_000)), axis=-1), 4096),
        "run_across_many_tiles": (rng.normal(size=(2, across.shape[1])), across, 4),
        "no_targets_named": (rng.normal(size=(4, 50)), np.zeros((4, 50), np.int64), 1),
    }
    f64 = {}
    for case, (v, i, n) in cases.items():
        vt = torch.as_tensor(v, device=dev)
        it = torch.as_tensor(i, device=dev, dtype=torch.int32)
        got, again = seg.segment_sum(vt, it, n), seg.segment_sum(vt, it, n)
        want = seg.segment_sum_reference(vt.cpu(), it.cpu(), n).to(dev)
        scale = float(vt.abs().sum(-1).max())
        f64[case] = float((got - want).abs().max()) / scale
        own_rows = i.shape[0] == v.shape[0]
        check(f64[case] <= v.shape[1] * 2.0**-52 and torch.equal(got, again)
              and (not own_rows or v.shape[1] > 256 or torch.equal(got, want)),
              f"segment_sum f64 {case}: err {f64[case]} of the row's sum of |v|")
    emit({"phase": "segment_sum_f64", "max_rel_err": f64})


def _by_key_site_records(site: str, call: tuple, what: str, dev) -> list:
    """The by-key sum at a hash level's inputs (the spy's ``call``) in f32
    against its plain version in f64 and bit for bit on a repeat, timed
    against its plain version and scatter_add_ (of the values gathered
    into sorted order beforehand); for the field also the radix sort of
    its keys against torch.sort(stable=True), and its whole table gradient
    (sort and sum) against index_add_'s (a zero-filled gradient of the whole
    table, then the atomic index_add_ of the unsorted keys: what the
    gather's backward was before the fixed order)."""
    import torch

    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    v, k, p, span, own, width, lo = call
    F, M = v.shape
    table = torch.zeros(F, width, device=dev)
    out = table[:, lo:lo + span]
    got = seg.segment_sum_by_key(v, k, p, out, own).clone()
    again = seg.segment_sum_by_key(v, k, p, out, own)
    want = seg.segment_sum_by_key_reference(v.double(), k, p,
                                            torch.zeros(F, span, device=dev, dtype=torch.float64),
                                            own)
    err = float((got.double() - want).abs().max())
    check(torch.equal(got, again), f"segment_sum_by_key {site}: a repeat differs")
    check(err <= 1e-6 * max(float(want.abs().max()), 1.0), f"segment_sum_by_key {site}: err {err}")
    runs = torch.unique_consecutive(k, return_counts=True)[1]
    ms = time_ms(lambda: seg.segment_sum_by_key(v, k, p, out, own), 50)
    plain_ms = time_ms(lambda: seg.segment_sum_by_key_reference(v, k, p, out, own), 50)
    sorted_v = v.index_select(1, p)
    buf = torch.zeros(F, span, device=dev)
    lk = k.long().expand(F, M).contiguous()
    library_ms = time_ms(lambda: buf.scatter_add_(1, lk, sorted_v), 50)
    _, events = device_events(lambda: [seg.segment_sum_by_key(v, k, p, out, own)
                                       for _ in range(20)])
    common = {"route": "cuda", "source": "nerf_kbs_tpu_torch/csrc/segment_sum.cu",
              "site": site, "launches": REPEAT_SEGMENT_SUMS["run3"]["hash"],
              "launches_per": what, "rows": F, "entries_per_row": M, "targets": span,
              "longest_run": int(runs.max()), "runs": int(runs.numel()), "dtype": "float32"}
    recs = [{"name": f"segment_sum_{site}", **common,
             "replaces": "nerf_kbs_tpu/ops/encoding.py:345 the transpose of jnp.take in "
                         "hash_encoding_apply (XLA, not Pallas)",
             "max_abs_err": err, "err_is": "f32 kernel against the plain version in f64",
             "ms": ms, "plain_ms": plain_ms,
             **bound(4 * (F * M + 2 * M + F * span), 0.0, F * M, bf16=False),
             "library_ms": library_ms,
             "library_call": "Tensor.scatter_add_ (atomics) of the values in sorted order",
             "device_ms": sum(us for _, us, _ in events) / 20e3,
             "device_ms_by_kernel": {name: us / 20e3 for name, us, _ in events}}]
    if site != "hash":
        return recs
    # the keys in entry order, as the forward wrote them
    slots = torch.empty_like(k)
    slots[p.long()] = k
    sk, sp = seg.sort_keys(slots, span)
    ts = torch.sort(slots, stable=True)
    check(torch.equal(sk, ts.values) and torch.equal(sp.long(), ts.indices),
          "radix_sort: not torch.sort(stable=True)'s permutation")
    sort_ms = time_ms(lambda: seg.sort_keys(slots, span), 50)
    torch_sort_ms = time_ms(lambda: torch.sort(slots, stable=True), 50)
    plain_sort_ms = time_ms(lambda: [t.to(torch.int32) for t in torch.sort(slots, stable=True)],
                            50)
    _, sort_events = device_events(lambda: [seg.sort_keys(slots, span) for _ in range(20)])
    recs.append({"name": "radix_sort", **common,
                 "replaces": "nerf_kbs_tpu/ops/encoding.py:345 (XLA's scatter of jnp.take's "
                             "transpose needs no sort; no Pallas kernel)",
                 "key_bits": max(1, (span - 1).bit_length()), "max_abs_err": 0.0,
                 "err_is": "keys and permutation equal to torch.sort(stable=True)'s",
                 "ms": sort_ms, "plain_ms": plain_sort_ms,
                 **bound(12 * M, 0.0, M, bf16=False),
                 "library_ms": torch_sort_ms, "library_call": "torch.sort(stable=True)",
                 "device_ms": sum(us for _, us, _ in sort_events) / 20e3,
                 "device_ms_by_kernel": {name: us / 20e3 for name, us, _ in sort_events}})

    def field_bwd():
        sk, sp = seg.sort_keys(slots, span)
        seg.segment_sum_by_key(v, sk, sp, out, own)

    def field_bwd_plain():
        ts = torch.sort(slots, stable=True)
        seg.segment_sum_by_key_reference(v, ts.values, ts.indices, out, own)

    flat = slots.long() + lo
    whole = torch.zeros(F, width, device=dev)
    field_bwd()
    check(torch.equal(out, got), "segment_sum_hash_field_bwd: differs from the sum alone")
    _, bwd_events = device_events(lambda: [field_bwd() for _ in range(20)])
    recs.append({"name": "segment_sum_hash_field_bwd", **common,
                 "replaces": "nerf_kbs_tpu/ops/encoding.py:345 the transpose of jnp.take "
                             "in hash_encoding_apply, whole (XLA, not Pallas)",
                 "kernels": "radix_sort + segment_sum_by_key", "max_abs_err": err,
                 "err_is": "f32 against the plain version in f64 (the sum's)",
                 "ms": time_ms(field_bwd, 50), "plain_ms": time_ms(field_bwd_plain, 50),
                 **bound(4 * (F * M + M + F * span), 0.0, F * M, bf16=False),
                 "library_ms": time_ms(lambda: torch.zeros(F, width, device=dev).index_add_(
                     1, flat, v), 50),
                 "library_call": "torch.zeros(F, L*T).index_add_ (atomics): index_select's "
                                 "backward",
                 "library_ms_index_add_only": time_ms(lambda: whole.index_add_(1, flat, v), 50),
                 "table_columns": width,
                 "device_ms": sum(us for _, us, _ in bwd_events) / 20e3,
                 "device_ms_by_kernel": {name: us / 20e3 for name, us, _ in bwd_events}})
    return recs


def phase_repeat_bits(records, scene: str) -> None:
    """Each path of REPEAT_BITS built once from its seed and trained twice
    from that start in this process (``restart``; tools/repeat_bits_torch.py
    builds each run anew, in this process and another), ``steps`` steps
    each: after every step every parameter's and Adam moment's checksum and
    every logged loss must be equal, and at the end every parameter and
    moment bit for bit (torch.equal); the segment sums' launches a step must
    be REPEAT_SEGMENT_SUMS'. The preprocessing trainers (PREPROCESS_TRAINERS)
    are built twice from their seed, every parameter and loss held the
    same way. Then the segment sums (csrc/segment_sum.cu) against their
    plain version in f64 (_segment_sum_checks), and at each call site's
    inputs of the first ilf050, sem30k-flagship2 and run-3 step (the
    interlevel bounds, the pdf sampler: the short-row kernel; the hash
    field and a proposal field: the by-key kernel, with the radix sort and
    the field's whole table gradient, _by_key_site_records) in f32 against
    the plain version in f64, a repeat bit-identical, timed against the
    plain version and scatter_add_ (the ``segment_sum*`` and
    ``radix_sort`` records). The hash grid's launches a step must be
    REPEAT_HASH_GRID's."""
    import torch

    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    seen, counts, restore = _segment_sum_spy()
    try:
        for path, steps in REPEAT_BITS.items():
            runs = []
            t0 = time.perf_counter()
            if path in PREPROCESS_TRAINERS:
                for _ in range(2):
                    seg.reset_launches()
                    rec, final = trainer_record(path, steps)
                    runs.append((rec, final, dict(seg.LAUNCHES), {}, {}))
            else:
                trainer = repeat_trainer(path, scene, tempfile.mkdtemp(prefix=f"nkt_rep_{path}_"))
                start = final_state(trainer)
                for _ in range(2):
                    restart(trainer, start)
                    seg.reset_launches()
                    hg.reset_launches()
                    counts.clear()
                    rec = train_record(trainer, steps)
                    runs.append((rec, final_state(trainer), dict(seg.LAUNCHES), dict(counts),
                                 dict(hg.LAUNCHES)))
                del trainer
            torch.cuda.empty_cache()
            (ra, fa, la, ca, ha), (rb, fb, lb, cb, hb) = runs
            div = first_divergence(ra, rb)
            equal = len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))
            emit({"phase": "repeat_bits", "path": path, "steps": steps,
                  "seconds": time.perf_counter() - t0, "first_divergence": div,
                  "final_state_bit_identical": equal, "tensors": len(fa),
                  "segment_sum_launches": [la, lb], "segment_sum_calls_by_site": ca,
                  "hash_grid_launches": [ha, hb],
                  "loss_last": ra[-1]["losses"].get("total_loss", ra[-1]["losses"].get("loss"))})
            check(div is None and equal, f"repeat_bits {path}: the two runs part at {div} "
                  f"(final state equal: {equal})")
            if path in REPEAT_SEGMENT_SUMS:
                sites = {k: steps * n for k, n in REPEAT_SEGMENT_SUMS[path].items()}
                hash_calls = sites.get("hash", 0)
                want = {"segment_sum": sites["interlevel"] + sites.get("sampler", 0),
                        "segment_sum_by_key": hash_calls, "radix_sort": hash_calls}
                check(ca == cb == sites and la == lb == want,
                      f"repeat_bits {path}: segment-sum launches {la}, {lb}, by site {ca}, "
                      f"{cb}; want {want}, {sites}")
            if path in REPEAT_HASH_GRID:
                want = {k: steps * n for k, n in REPEAT_HASH_GRID[path].items()}
                check(ha == hb == want, f"repeat_bits {path}: hash grid launches {ha}, {hb}; "
                                        f"want {want}")
    finally:
        restore()

    dev = seen["interlevel"][0].device
    _segment_sum_checks(dev)

    # the short-row sites' inputs: f32 against the plain version in f64,
    # timed against the plain version (scatter_add_ into zeros) and
    # scatter_add_ into a zeroed buffer
    for site, what in (("interlevel", "16,384-ray ilf050 (and sem30k-flagship2) train step"),
                       ("sampler", "4,096-ray run-3 train step (its pdf samplers)")):
        launches_per = {"interlevel": 2, "sampler": 4}[site]
        v, i, n = seen[site]
        got, again = seg.segment_sum(v, i, n), seg.segment_sum(v, i, n)
        want = seg.segment_sum_reference(v.double(), i, n)
        err = float((got.double() - want).abs().max())
        check(torch.equal(got, again), f"segment_sum {site}: a repeat differs")
        check(err <= 1e-6 * max(float(want.abs().max()), 1.0), f"segment_sum {site}: err {err}")
        ms = time_ms(lambda: seg.segment_sum(v, i, n), 50)
        plain_ms = time_ms(lambda: seg.segment_sum_reference(v, i, n), 50)
        buf = torch.zeros(v.shape[0], n, device=dev)
        lidx = i.long().expand(v.shape).contiguous()
        library_ms = time_ms(lambda: buf.scatter_add_(1, lidx, v), 50)
        _, events = device_events(lambda: [seg.segment_sum(v, i, n) for _ in range(20)])
        R, Q = v.shape
        rec = {"name": "segment_sum" if site == "interlevel" else f"segment_sum_{site}",
               "route": "cuda", "source": "nerf_kbs_tpu_torch/csrc/segment_sum.cu",
               "replaces": "nerf_kbs_tpu/ops/losses.py:76 _outer_cw_bwd and "
                           "nerf_kbs_tpu/ops/samplers.py:175 _bracket_bwd (XLA, not Pallas)",
               "site": site, "launches": launches_per, "launches_per": what,
               "max_abs_err": err, "err_is": "f32 kernel against the plain version in f64",
               "ms": ms, "plain_ms": plain_ms,
               **bound(4 * (R * Q + i.shape[0] * Q + R * n), 0.0, R * Q, bf16=False),
               "library_ms": library_ms, "library_call": "Tensor.scatter_add_ (atomics)",
               "device_ms": sum(us for name, us, _ in events if "segment_" in name) / 20e3,
               "device_ms_by_kernel": {name: us / 20e3 for name, us, _ in events},
               "rows": R, "entries_per_row": Q, "targets": n, "index_rows": i.shape[0],
               "dtype": "float32"}
        emit({"phase": "timing", **rec})
        records.append(rec)
    # the hash fields: the field, a proposal field
    what = "4,096-ray run-3 train step (its hash fields, one call each)"
    for site in ("hash", "hash_coarse"):
        for rec in _by_key_site_records(site, seen[site], what, dev):
            emit({"phase": "timing", **rec})
            records.append(rec)


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
    frame_rays_per_s = phase_slice(records)
    phase_bench_torch(records, *phase_train(records), frame_rays_per_s)
    with tempfile.TemporaryDirectory(prefix="nkt_scene_") as tmp:
        scene = phase_scene(tmp)
        phase_cli(records, scene)
        phase_parallel(records, scene)
        phase_native_sampler(scene)
        phase_hash(scene)
        vkitti = phase_vkitti_scene(tmp)
        phase_registry(scene, vkitti)
        phase_launchers_torch(scene, vkitti)
        phase_camera_opt(records, scene)
        phase_stream(scene)
        phase_preprocess(scene, tmp)
        phase_reference_runs(records, scene)
        phase_reference_vs_cpu(scene)
        phase_repeat_bits(records, scene)
    phase_tools_torch(records)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_kbs_tpu", "PIL", "cv2")]
    check(not bad, f"imported {bad}")
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_worker(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
