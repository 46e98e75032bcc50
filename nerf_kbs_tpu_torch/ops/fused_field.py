"""Fused Fourier-feature MLPs: the forward wrappers of the two CUDA kernels
and their plain PyTorch versions.

Contract (the JAX package's, feature-major):
- positions ``x_t`` (3, N) f32 and the frequency matrix ``B`` (3, H) f32;
  the projection ``B^T x`` stays f32;
- matrix-product inputs are cast to the compute dtype (bf16 when
  ``spec.bf16``), accumulation is f32 and the bias is added in f32;
- relu outputs are cast back to the compute dtype, as are ``geo`` and the
  per-point ``feats`` before the rgb chain of the field kernel;
- outputs are f32: ``fourier_mlp`` gives (out_dim, N), ``fourier_field_mlp``
  gives (4, N) = [sigma_raw; sigmoid rgb].

A wrapper given CUDA tensors launches its kernel (``csrc/``) or raises; given
CPU tensors it runs the plain version. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_kbs_tpu_torch.ops import _kernels

# kernel launches per wrapper, added to only where a kernel is launched
LAUNCHES = {"fourier_mlp": 0, "fourier_field_mlp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class FusedMLPSpec:
    """layer_dims = (2H, d1, ..., out_dim)."""

    h_freqs: int
    layer_dims: tuple
    bf16: bool = True
    basis: str = "sincos"  # 'sincos' (B pre-scaled by 2*pi) or 'tri' (B in cycles)

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1

    @property
    def out_dim(self) -> int:
        return self.layer_dims[-1]


@dataclasses.dataclass(frozen=True)
class FusedFieldSpec:
    h_freqs: int
    feat_dim: int
    base_dims: tuple  # (2H, ..., 1 + geo)
    rgb_dims: tuple  # (geo + feat_dim, ..., 3)
    bf16: bool = True
    basis: str = "sincos"

    @property
    def geo_dim(self) -> int:
        return self.base_dims[-1] - 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def tri_s(u: torch.Tensor) -> torch.Tensor:
    """sin-like triangle wave, period 1, range [-1, 1], tri_s(0) = 0."""
    f = u + 0.75
    f = f - torch.floor(f)
    return 4.0 * torch.abs(f - 0.5) - 1.0


def tri_c(u: torch.Tensor) -> torch.Tensor:
    """cos-like triangle wave: tri_c(0) = 1."""
    f = u - torch.floor(u)
    return 4.0 * torch.abs(f - 0.5) - 1.0


def _cast(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Round to the compute dtype and compute on in f32: a product of two
    bf16 values is exact in f32, so f32 matmuls of rounded inputs are bf16
    products with f32 accumulation."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _encode(x_t, B, basis, bf16):
    proj = B.T @ x_t  # (H, N) f32
    if basis == "tri":
        s, c = tri_s(proj), tri_c(proj)
    else:
        s, c = torch.sin(proj), torch.cos(proj)
    return _cast(torch.cat([s, c], dim=0), bf16)


def _chain(h, ws, bs, bf16):
    """relu chain; returns the last layer's f32 pre-activation."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = _cast(w, bf16).T @ h + b[:, None]
        if i < len(ws) - 1:
            h = _cast(torch.relu(h), bf16)
    return h


def fourier_mlp_reference(x_t, B, ws, bs, basis: str = "sincos", bf16: bool = False):
    """Plain version of ``fourier_mlp``. x_t (3, N) f32, B (3, H) pre-scaled,
    ws[0] (2H, d1), ws[i] (d_i, d_{i+1}), bs[i] (d_{i+1},). Returns
    (out_dim, N) f32."""
    return _chain(_encode(x_t, B, basis, bf16), ws, bs, bf16)


def fourier_field_reference(x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs,
                            basis: str = "sincos", bf16: bool = False):
    """Plain version of ``fourier_field_mlp``. Returns (4, N) f32:
    [sigma_raw; sigmoid rgb]."""
    base = _chain(_encode(x_t, B, basis, bf16), base_ws, base_bs, bf16)
    rgb_in = _cast(torch.cat([base[1:], feats], dim=0), bf16)
    rgb = torch.sigmoid(_chain(rgb_in, rgb_ws, rgb_bs, bf16))
    return torch.cat([base[0:1], rgb], dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"fused field inputs must all be on the CPU or all on CUDA, got {devs}")


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected float32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )


def _pack(ws, bs, dims, bf16: bool) -> torch.Tensor:
    """One contiguous f32 buffer [W_0, b_0, W_1, ...] with each part starting
    on a 4-float boundary (the layout csrc/fused_chain.cuh reads). Weights are
    rounded to bf16 here when the compute dtype is bf16; biases stay f32."""
    if len(ws) != len(dims) - 1 or len(bs) != len(ws):
        raise ValueError(f"{len(ws)} weights / {len(bs)} biases for dims {dims}")
    parts, off = [], 0
    for i, (w, b) in enumerate(zip(ws, bs)):
        _check(f"W{i}", w, (dims[i], dims[i + 1]))
        _check(f"b{i}", b, (dims[i + 1],))
        for t in (_cast(w, bf16), b):
            parts.append(t.reshape(-1))
            off += t.numel()
            if off % 4:
                parts.append(t.new_zeros(4 - off % 4))
                off += 4 - off % 4
    return torch.cat(parts).contiguous()


def _check_n(n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"{n} points: the kernels index points with 32-bit ints")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def fourier_mlp(spec: FusedMLPSpec, x_t, B, ws, bs) -> torch.Tensor:
    """Fused Fourier-feature MLP forward: x_t (3, N) f32, B (3, H) pre-scaled
    frequency matrix, ws/bs as mlp_init gives them. Returns (out_dim, N) f32."""
    if _on_cpu(x_t, B, *ws, *bs):
        return fourier_mlp_reference(x_t, B, ws, bs, spec.basis, spec.bf16)
    n = x_t.shape[1]
    _check_n(n)
    H = spec.h_freqs
    _check("x_t", x_t, (3, n))
    _check("B", B, (3, H))
    if spec.layer_dims[0] != 2 * H:
        raise ValueError(f"layer_dims[0] {spec.layer_dims[0]} != 2 * h_freqs {2 * H}")
    x = x_t.contiguous()
    Bc = B.contiguous()
    wb = _pack(ws, bs, spec.layer_dims, spec.bf16)
    out = torch.empty(spec.out_dim, n, device=x.device, dtype=torch.float32)
    _kernels.call(
        "fourier_mlp_fwd", x.data_ptr(), n, Bc.data_ptr(), H, wb.data_ptr(), wb.numel(),
        _kernels.int_array(spec.layer_dims), spec.num_layers,
        int(spec.basis == "tri"), int(spec.bf16), out.data_ptr(), _stream(x),
    )
    LAUNCHES["fourier_mlp"] += 1
    return out


def fourier_field_mlp(spec: FusedFieldSpec, x_t, feats, B, base_ws, base_bs,
                      rgb_ws, rgb_bs) -> torch.Tensor:
    """Fully fused nerfacto field forward: x_t (3, N) f32 contracted
    positions, feats (F, N) f32 per-point conditioning (SH rows, appearance
    rows). Returns (4, N) f32 = [sigma_raw; sigmoid rgb]."""
    if _on_cpu(x_t, feats, B, *base_ws, *base_bs, *rgb_ws, *rgb_bs):
        return fourier_field_reference(x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs,
                                       spec.basis, spec.bf16)
    n = x_t.shape[1]
    _check_n(n)
    H, F = spec.h_freqs, spec.feat_dim
    _check("x_t", x_t, (3, n))
    _check("feats", feats, (F, n))
    _check("B", B, (3, H))
    if spec.base_dims[0] != 2 * H or spec.rgb_dims[0] != spec.geo_dim + F or spec.rgb_dims[-1] != 3:
        raise ValueError(f"inconsistent field spec {spec}")
    x = x_t.contiguous()
    fe = feats.contiguous()
    Bc = B.contiguous()
    base_wb = _pack(base_ws, base_bs, spec.base_dims, spec.bf16)
    rgb_wb = _pack(rgb_ws, rgb_bs, spec.rgb_dims, spec.bf16)
    out = torch.empty(4, n, device=x.device, dtype=torch.float32)
    _kernels.call(
        "fourier_field_fwd", x.data_ptr(), fe.data_ptr(), n, F, Bc.data_ptr(), H,
        base_wb.data_ptr(), base_wb.numel(), _kernels.int_array(spec.base_dims),
        len(spec.base_dims) - 1,
        rgb_wb.data_ptr(), rgb_wb.numel(), _kernels.int_array(spec.rgb_dims),
        len(spec.rgb_dims) - 1,
        int(spec.basis == "tri"), int(spec.bf16), out.data_ptr(), _stream(x),
    )
    LAUNCHES["fourier_field_mlp"] += 1
    return out
