#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_kbs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:
1. device: the card (nvidia-smi name and power limit), then the kernels are
   built from csrc/ into build/ (one nvcc per source, started together);
2. kernel parity: each kernel against its plain PyTorch version on the card,
   both bases and both compute dtypes, at the main path's shapes and a
   ragged N; times of the kernel and the plain version at the main path's
   operating point (tri basis, bf16);
3. the slice: nerfacto-tpu at full width in bf16 with seeded weights renders
   a 376x1241 camera through Renderer.render_camera in 1<<15-ray chunks; the
   launch counts must show 2 proposal-field and 1 field launches per chunk;
   the frame time is the median of 5 more renders; a profiler pass gives the
   device time by kernel; a small camera rendered in f32 on the card must
   match the CPU plain path; the viewer answers /status, /render and /orbit
   with PNGs;
4. a {"kernels": [...]} line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without CUDA, or run from a directory without the port, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def bound(n_bytes: float, flops: float, bf16: bool) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES
    t_ops = flops / (H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from nerf_kbs_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for n, log in _kernels.build_logs.items()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "libs": [str(p.name) for p in paths.values()],
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
                      "dtype": "bf16" if bf16 else "f32", "max_abs_err": err, "tol": tol,
                      "max_abs_ref": float(want.abs().max())})
                check(err <= tol, f"{name} n={n} {basis} bf16={bf16}: err {err} > {tol}")
                del got, want
        del x, fe
        torch.cuda.empty_cache()

    # times at the main path's operating point (tri, bf16) and shapes; the
    # inputs stay warm in L2 between launches (x of proposal round 0 is 38 MB)
    records = []
    a_mac = 3 * pB.shape[1] + sum(a * b for a, b in zip(pcfg.mlp.dims, pcfg.mlp.dims[1:]))
    b_mac = 3 * fB.shape[1] + sum(a * b for dims in (fcfg.base_mlp.dims, fcfg.rgb_mlp.dims)
                                  for a, b in zip(dims, dims[1:]))
    a_w = sum(t.numel() for t in (*pws, *pbs)) + pB.numel()
    b_w = sum(t.numel() for t in (*bws, *bbs, *rws, *rbs)) + fB.numel()
    for name, n, per_point_bytes, w_floats, mac, src, line in (
        ("fourier_mlp_fwd", n_a0, 12 + 4, a_w, a_mac, "fourier_mlp_fwd.cu", 329),
        ("fourier_field_fwd", n_b, 12 + 64 + 16, b_w, b_mac, "fourier_field_fwd.cu", 677),
    ):
        x = positions(n)
        kern, plain = (a_call("tri", True, x) if name == "fourier_mlp_fwd"
                       else b_call("tri", True, x, feats(n)))
        err = float((kern() - plain()).abs().max())
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
        bms, by = bound(n * per_point_bytes + 4 * w_floats, 2.0 * n * mac, bf16=True)
        rec = {"name": name, "route": "cuda", "source": f"nerf_kbs_tpu_torch/csrc/{src}",
               "replaces": f"nerf_kbs_tpu/ops/fused_field.py:{line}", "launches": 0,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "library_ms": None, "n_points": n, "basis": "tri",
               "dtype": "bf16"}
        emit({"phase": "timing", **rec})
        records.append(rec)
        del x
        torch.cuda.empty_cache()
    return records


def _png(url: str) -> int:
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
        check(resp.headers["Content-Type"] == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n",
              f"{url}: not a PNG")
        return len(body)


def phase_profile(renderer, n_rays: int, top: int = 12) -> None:
    """Where one frame's time goes: device time by kernel name (self time,
    torch.profiler over one render) and the device's busy share of the wall
    time. The profiler's own overhead inflates the wall time somewhat."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_camera(4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side entries only (kernels, copies): an aten:: op's entry
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in events)
    events.sort(key=dev_us, reverse=True)
    emit({"phase": "profile", "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": max(0.0, 1.0 - busy / wall_us), "rays": n_rays,
          "top": [{"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3,
                   "share": dev_us(e) / busy} for e in events[:top]]})


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
    chunk = spec.eval_num_rays_per_chunk
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
    check(launches == {"fourier_mlp": 2 * n_chunks, "fourier_field_mlp": n_chunks},
          f"launches {launches} for {n_chunks} chunks")
    for rec in records:
        rec["launches"] = launches[
            "fourier_mlp" if rec["name"] == "fourier_mlp_fwd" else "fourier_field_mlp"]
    # the frame time: median of repeated renders of the same camera
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        renderer.render_camera(0)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    emit({"phase": "slice", "method": "nerfacto-tpu", "compute_dtype": cfg.compute_dtype,
          "image": [h, w], "chunk_rays": chunk, "chunks": n_chunks, "launches": launches,
          "first_render_s": dt, "render_s": times, "median_render_s": med,
          "rays_per_s": h * w / med, "ms_per_chunk": med * 1e3 / n_chunks,
          "rgb_mean": float(rgb.mean()), "accumulation_mean": float(out["accumulation"].mean())})

    phase_profile(renderer, h * w)

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
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "nerf_kbs_tpu")]
    check(not bad, f"imported {bad}")
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
