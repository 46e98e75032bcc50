"""Where the tile time of the WMMA bodies of the two field kernels goes.

    python3 -m nerf_kbs_tpu_torch.phase_clocks

Builds fourier_field_fwd.cu and fourier_field_bwd.cu with
``-DNKT_PHASE_CLOCKS`` (see csrc/fused_chain.cuh), sends the flagship widths
through the WMMA bodies (``FORCE_WMMA``) at the main paths' shapes (tri basis,
bf16, no position gradient: 1,572,864 points forward, 786,432 backward), and
prints, per kernel, the share of block 0's clock64() ticks that thread 0 spent
in each phase. The marks cost time themselves (a shared-memory update each),
so the launch times printed beside the shares are those of the marked build.
Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

PHASES = ("stage", "load", "encode", "product", "epilogue", "wdh_product", "wdh_epilogue",
          "dw", "barrier", "other")


def _shares(name: str) -> dict:
    from nerf_kbs_tpu_torch.ops import _kernels

    buf = (ctypes.c_longlong * len(PHASES))()
    fn = _kernels.lib(name).nkt_read_phase_clocks
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(buf)
    if code != 0:
        raise RuntimeError(f"nkt_read_phase_clocks: {code}")
    total = sum(buf)
    return {"ticks": total, **{p: buf[i] / total for i, p in enumerate(PHASES) if buf[i]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_clocks: CUDA is not available", file=sys.stderr)
        return 2
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.ops import _kernels
    from nerf_kbs_tpu_torch.ops import fused_field as ff
    from nerf_kbs_tpu_torch.ops.encoding import fourier_encoding_init, sh_encoding
    from nerf_kbs_tpu_torch.ops.mlp import mlp_init

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _kernels.NVCC_FLAGS = _kernels.NVCC_FLAGS + ("-DNKT_PHASE_CLOCKS",)
    ff.FORCE_WMMA = frozenset(ff.KERNELS)
    dev = torch.device("cuda")
    cfg = nerfacto_tpu_method().model_config()
    fcfg = cfg.field
    gen = torch.Generator().manual_seed(1)
    B = fourier_encoding_init(fcfg.fourier, gen, dev)
    base, rgb = mlp_init(fcfg.base_mlp, gen, dev), mlp_init(fcfg.rgb_mlp, gen, dev)

    def inputs(n):
        d = torch.randn(n, 3, generator=gen)
        fe = sh_encoding(d / d.norm(dim=-1, keepdim=True)).T.contiguous().to(dev)
        return torch.rand(3, n, generator=gen).to(dev), fe

    spec = ff.FusedFieldSpec(h_freqs=B.shape[1], feat_dim=16, base_dims=fcfg.base_mlp.dims,
                             rgb_dims=fcfg.rgb_mlp.dims, bf16=True, basis="tri", need_dx=False)
    weights = (base["w"], base["b"], rgb["w"], rgb["b"])

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    n_b = (1 << 15) * cfg.num_nerf_samples_per_ray
    x, fe = inputs(n_b)
    ms = timed(lambda: ff.fourier_field_mlp(spec, x, fe, B, *weights))
    print(json.dumps({"kernel": "fourier_field_fwd", "body": "wmma", "n": n_b, "marked_ms": ms,
                      "shares": _shares("fourier_field_fwd")}), flush=True)
    n_d = 16384 * cfg.num_nerf_samples_per_ray
    x, fe = inputs(n_d)
    g = torch.randn(4, n_d, generator=gen).to(dev)
    ms = timed(lambda: ff._field_backward(spec, x, fe, B, *weights, g))
    print(json.dumps({"kernel": "fourier_field_bwd", "body": "wmma", "n": n_d, "marked_ms": ms,
                      "shares": _shares("fourier_field_bwd")}), flush=True)
    assert ff.LAUNCHES["fourier_field_mlp"] == 2 and ff.LAUNCHES["fourier_field_mlp_bwd"] == 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
