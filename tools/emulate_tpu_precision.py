"""Write a copy of the repository whose port computes the JAX package's f32
products as XLA and Mosaic run them on a TPU at their default precision:
operands rounded to bf16, products summed in f32. The repository itself is
not changed, and the port has no switch for this: the copy is a one-off
build for a measurement.

Rounded in the copy, and nowhere else:
- the projection B^T x of the Fourier encoding in the four fused kernels'
  wrappers (``ops/fused_field.py``: the MLP forward and backward, the field
  forward and backward), on the card and on the CPU; the JAX kernels'
  ``dot_general`` sets no precision (``nerf_kbs_tpu/ops/fused_field.py``
  :131, :175, :531, :562);
- both composites of the fused path (``models/nerfacto.py``: rgb and
  semantics, the JAX package's ``nerf_kbs_tpu/models/nerfacto.py:385,
  418``), forward and backward: the backward rounds the incoming gradient
  and the other operand, as the transposed products of a default-precision
  ``einsum`` do.

Usage:
    python3 tools/emulate_tpu_precision.py <dir>

<dir> gets the port's package, ``tools/`` and the files at the root of
this checkout (the launchers among them); run the launchers from there,
with the scene linked in (``ln -s <repo>/outputs <dir>/outputs``).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DIRS = ("nerf_kbs_tpu_torch", "tools")

ROUND = '''

def _tpu_round(t: torch.Tensor) -> torch.Tensor:
    """An f32 operand of a default-precision TPU product: rounded to bf16."""
    return t.to(torch.bfloat16).to(torch.float32)
'''

EINSUM = '''

def _tpu_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _TpuEinsum(torch.autograd.Function):
    """einsum of two operands at the TPU's default precision: bf16 operands,
    f32 sums, in the forward and in both transposed products."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, _tpu_round(a), _tpu_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ia, ib = ins.split(",")
        g = _tpu_round(g)
        ga = torch.einsum(f"{out},{ib}->{ia}", g, _tpu_round(b)) if ctx.needs_input_grad[1] else None
        gb = torch.einsum(f"{out},{ia}->{ib}", g, _tpu_round(a)) if ctx.needs_input_grad[2] else None
        return None, ga, gb
'''

# (file, anchor, replacement); each anchor must occur exactly as often as
# given, so a change of the port's source stops the copy instead of
# silently measuring the unmodified port
PATCHES = [
    ("nerf_kbs_tpu_torch/ops/fused_field.py",
     "\n\ndef tri_s(u: torch.Tensor) -> torch.Tensor:",
     ROUND + "\n\ndef tri_s(u: torch.Tensor) -> torch.Tensor:", 1),
    ("nerf_kbs_tpu_torch/ops/fused_field.py",
     "def _mlp_forward(spec: FusedMLPSpec, x_t, B, ws, bs) -> torch.Tensor:\n",
     "def _mlp_forward(spec: FusedMLPSpec, x_t, B, ws, bs) -> torch.Tensor:\n"
     "    x_t, B = _tpu_round(x_t), _tpu_round(B)\n", 1),
    ("nerf_kbs_tpu_torch/ops/fused_field.py",
     "def _mlp_backward(spec: FusedMLPSpec, x_t, B, ws, bs, g):\n"
     '    """(dx or None, dws, dbs): the backward kernel for CUDA tensors, the\n'
     '    plain backward for CPU tensors."""\n',
     "def _mlp_backward(spec: FusedMLPSpec, x_t, B, ws, bs, g):\n"
     '    """(dx or None, dws, dbs): the backward kernel for CUDA tensors, the\n'
     '    plain backward for CPU tensors."""\n'
     "    x_t, B = _tpu_round(x_t), _tpu_round(B)\n", 1),
    ("nerf_kbs_tpu_torch/ops/fused_field.py",
     "                   rgb_bs) -> torch.Tensor:\n"
     "    if _on_cpu(x_t, feats, B, *base_ws, *base_bs, *rgb_ws, *rgb_bs):\n",
     "                   rgb_bs) -> torch.Tensor:\n"
     "    x_t, B = _tpu_round(x_t), _tpu_round(B)\n"
     "    if _on_cpu(x_t, feats, B, *base_ws, *base_bs, *rgb_ws, *rgb_bs):\n", 1),
    ("nerf_kbs_tpu_torch/ops/fused_field.py",
     "    backward kernel for CUDA tensors, the plain backward for CPU tensors.\"\"\"\n",
     "    backward kernel for CUDA tensors, the plain backward for CPU tensors.\"\"\"\n"
     "    x_t, B = _tpu_round(x_t), _tpu_round(B)\n", 1),
    ("nerf_kbs_tpu_torch/models/nerfacto.py",
     'torch.einsum("rs,drs->rd", weights, rgb_t)',
     '_TpuEinsum.apply("rs,drs->rd", weights, rgb_t)', 1),
    ("nerf_kbs_tpu_torch/models/nerfacto.py",
     'torch.einsum("rs,crs->rc", w_sem, field_out["semantics_t"])',
     '_TpuEinsum.apply("rs,crs->rc", w_sem, field_out["semantics_t"])', 1),
    ("nerf_kbs_tpu_torch/models/nerfacto.py",
     "\n\n@dataclasses.dataclass",
     EINSUM + "\n\n@dataclasses.dataclass", None),
]


def write_copy(dest: Path) -> None:
    dest = Path(dest)
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    for f in REPO.iterdir():
        if f.is_file():
            shutil.copy2(f, dest / f.name)
    for d in DIRS:
        shutil.copytree(REPO / d, dest / d, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, anchor, new, count in PATCHES:
        path = dest / rel
        text = path.read_text()
        found = text.count(anchor)
        if found == 0 or (count is not None and found != count):
            raise SystemExit(f"{rel}: anchor found {found} times, expected {count}: {anchor!r}")
        # an anchor without a count is patched at its first occurrence only
        text = text.replace(anchor, new, 1 if count is None else count)
        path.write_text(text)
    print(f"wrote {dest} ({len(PATCHES)} patches)")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    write_copy(Path(sys.argv[1]))
