"""Fused Fourier-feature MLPs: the wrappers of the four CUDA kernels (two
forwards, two backwards), the autograd Functions that join them, and their
plain PyTorch versions.

Contract (the JAX package's, feature-major):
- positions ``x_t`` (3, N) f32 and the frequency matrix ``B`` (3, H) f32;
  the projection ``B^T x`` stays f32;
- matrix-product inputs are cast to the compute dtype (bf16 when
  ``spec.bf16``), accumulation is f32 and the bias is added in f32;
- relu outputs are cast back to the compute dtype, as are ``geo`` and the
  per-point ``feats`` before the rgb chain of the field kernel;
- outputs are f32: ``fourier_mlp`` gives (out_dim, N), ``fourier_field_mlp``
  gives (4, N) = [sigma_raw; sigmoid rgb].

The backwards save nothing but the inputs and recompute the forward. In bf16
mode the gradient dh of a pre-activation is rounded before both products it
enters (dW = act . dh^T and W . dh); the relu mask comes from the f32
pre-activation; bias gradients sum the f32 dh; a width-1 layer is an f32
multiply-reduce. B gets no gradient, and positions get one only when the
spec says ``need_dx``.

A wrapper given CUDA tensors launches its kernel (``csrc/``) or raises; given
CPU tensors it runs the plain version. ``LAUNCHES`` counts kernel launches
(a backward's passes over the points and its reduction belong to one launch),
``DX_LAUNCHES`` the backward launches among them that ran their dx branch;
they and the cache of weight-image indices on the device are shared by every
thread that launches (a live viewer renders while the trainer steps), so
both change under a lock. A wrapper's call, its packing included, is the
span ``fused_field`` (``utils/profiling.py``).
Every kernel has a wgmma body for the flagship widths (``_wgmma_field``;
``_wgmma_mlp`` for the proposal fields), counted under the ``*_wgmma`` keys,
and the WMMA body for every other shape. The two fused-MLP kernels have a
second wgmma body, for the base chains that the semantics path runs alone,
with one or two hidden layers (``_wgmma_mlp_base``), counted under the
``*_base_wgmma`` keys.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from nerf_kbs_tpu_torch.ops import _kernels
from nerf_kbs_tpu_torch.utils.profiling import spanned

# kernel launches per wrapper, added to only where a kernel is launched
KERNELS = ("fourier_mlp", "fourier_field_mlp", "fourier_mlp_bwd", "fourier_field_mlp_bwd")
LAUNCHES = {**dict.fromkeys(KERNELS, 0), **{f"{k}_wgmma": 0 for k in KERNELS},
            "fourier_mlp_base_wgmma": 0, "fourier_mlp_bwd_base_wgmma": 0}
# the backward launches of LAUNCHES whose spec asked for dx (need_dx)
DX_LAUNCHES = {k: 0 for k in LAUNCHES if "_bwd" in k}
# measurement only: the kernels (names from KERNELS) whose flagship widths
# (and, for the fused MLP, base widths) go through the WMMA body too, so that
# one run can time both bodies of a kernel on the same inputs while the
# others keep their wgmma bodies
FORCE_WMMA: frozenset = frozenset()
_shared = threading.Lock()  # LAUNCHES, DX_LAUNCHES and _image_index_on_device


def reset_launches() -> None:
    with _shared:
        for counts in (LAUNCHES, DX_LAUNCHES):
            for k in counts:
                counts[k] = 0


def _count(key: str, dx: bool = False) -> None:
    with _shared:
        LAUNCHES[key] += 1
        if dx:
            DX_LAUNCHES[key] += 1


@dataclasses.dataclass(frozen=True)
class FusedMLPSpec:
    """layer_dims = (2H, d1, ..., out_dim)."""

    h_freqs: int
    layer_dims: tuple
    bf16: bool = True
    basis: str = "sincos"  # 'sincos' (B pre-scaled by 2*pi) or 'tri' (B in cycles)
    # position gradient: False when the caller's positions are constants
    # (detached sampling, no camera optimizer); the backward then forms no dx
    # and x_t gets no gradient. Must be True whenever positions need one.
    need_dx: bool = True

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
    need_dx: bool = True  # see FusedMLPSpec.need_dx

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


def _encode_grads(x_t, B, basis):
    """f32 basis pair of proj = B^T x and its derivatives (ds/du, dc/du):
    +-4 by the side of the triangle wave's fraction, or (c, -s)."""
    proj = B.T @ x_t
    if basis == "tri":
        fs = proj + 0.75
        fs = fs - torch.floor(fs)
        fc = proj - torch.floor(proj)
        four, mfour = proj.new_tensor(4.0), proj.new_tensor(-4.0)
        return (tri_s(proj), tri_c(proj),
                torch.where(fs > 0.5, four, mfour), torch.where(fc > 0.5, four, mfour))
    s, c = torch.sin(proj), torch.cos(proj)
    return s, c, c, -s


def _chain_fwd(h, ws, bs, bf16):
    """relu chain keeping, per layer, its f32 pre-activation and its input
    (rounded to the compute dtype)."""
    pre, acts = [], []
    for i, (w, b) in enumerate(zip(ws, bs)):
        acts.append(h)
        hp = _cast(w, bf16).T @ h + b[:, None]
        pre.append(hp)
        if i < len(ws) - 1:
            h = _cast(torch.relu(hp), bf16)
    return pre, acts


def _chain_bwd(ws, pre, acts, dh, bf16, dot_first=False, need_din=True):
    """Backprop dh (f32 gradient of the last pre-activation) through a chain.
    dh is rounded to the compute dtype before the dW product and before the
    W . dh product; the relu mask comes from the f32 pre-activation; bias
    gradients sum the f32 dh; a width-1 layer is an f32 multiply-reduce with
    the unrounded weight (unless it is layer 0 and ``dot_first``). Returns
    (gradient of the chain's input or None, dws, dbs)."""
    n = len(ws)
    dws, dbs = [None] * n, [None] * n
    d_in = None
    for i in range(n - 1, -1, -1):
        wide1 = ws[i].shape[1] == 1 and not (i == 0 and dot_first)
        dhc = dh if wide1 else _cast(dh, bf16)
        dws[i] = acts[i] @ dhc.T
        dbs[i] = dh.sum(dim=1)
        if i == 0 and not need_din:
            break
        d_prev = (ws[i] if wide1 else _cast(ws[i], bf16)) @ dhc
        if i > 0:
            dh = d_prev * (pre[i - 1] > 0).to(d_prev.dtype)
        else:
            d_in = d_prev
    return d_in, dws, dbs


def _dx_from_denc(d_enc, dsdu, dcdu, B):
    H = B.shape[1]
    return B @ (d_enc[:H] * dsdu + d_enc[H:] * dcdu)


def fourier_mlp_backward_reference(x_t, B, ws, bs, g, basis: str = "sincos",
                                   bf16: bool = False, need_dx: bool = True):
    """Plain backward of ``fourier_mlp``, written out by hand with the
    kernel's rounding points (autograd through ``_cast`` would not round dh).
    g (out_dim, N) f32. Returns (dx (3, N) or None, dws, dbs)."""
    s, c, dsdu, dcdu = _encode_grads(x_t, B, basis)
    pre, acts = _chain_fwd(_cast(torch.cat([s, c], dim=0), bf16), ws, bs, bf16)
    d_enc, dws, dbs = _chain_bwd(ws, pre, acts, g, bf16, dot_first=True, need_din=need_dx)
    dx = _dx_from_denc(d_enc, dsdu, dcdu, B) if need_dx else None
    return dx, dws, dbs


def fourier_field_backward_reference(x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs, g,
                                     basis: str = "sincos", bf16: bool = False,
                                     need_dx: bool = True):
    """Plain backward of ``fourier_field_mlp``. g (4, N) f32. Returns (dx or
    None, dfeats (F, N), d_base_ws, d_base_bs, d_rgb_ws, d_rgb_bs)."""
    s, c, dsdu, dcdu = _encode_grads(x_t, B, basis)
    pre_b, acts_b = _chain_fwd(_cast(torch.cat([s, c], dim=0), bf16), base_ws, base_bs, bf16)
    base_out = pre_b[-1]
    G = base_out.shape[0] - 1
    rgb_in = _cast(torch.cat([base_out[1:], feats], dim=0), bf16)
    pre_r, acts_r = _chain_fwd(rgb_in, rgb_ws, rgb_bs, bf16)
    rgb = torch.sigmoid(pre_r[-1])
    d_rgb_pre = g[1:] * rgb * (1.0 - rgb)
    d_rgb_in, d_rgb_ws, d_rgb_bs = _chain_bwd(rgb_ws, pre_r, acts_r, d_rgb_pre, bf16)
    d_base_out = torch.cat([g[0:1], d_rgb_in[:G]], dim=0)
    d_enc, d_base_ws, d_base_bs = _chain_bwd(base_ws, pre_b, acts_b, d_base_out, bf16,
                                             need_din=need_dx)
    dx = _dx_from_denc(d_enc, dsdu, dcdu, B) if need_dx else None
    return dx, d_rgb_in[G:], d_base_ws, d_base_bs, d_rgb_ws, d_rgb_bs


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


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def _partial_stride(*chains) -> int:
    """Floats of one block's weight-gradient partial (csrc/chain_bwd.cuh):
    per layer a (pad16(in), pad16(out)) matrix and a pad16(out) bias."""
    return sum(_pad16(a) * _pad16(b) + _pad16(b)
               for dims in chains for a, b in zip(dims[:-1], dims[1:]))


def _packed_offsets(dims):
    """(weight offsets, bias offsets, size) of ``_pack``'s layout, in floats."""
    w_off, b_off, off = [], [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        w_off.append(off)
        off = (off + a * b + 3) // 4 * 4
        b_off.append(off)
        off = (off + b + 3) // 4 * 4
    return w_off, b_off, off


def _unpack(buf: torch.Tensor, dims):
    """Views of the weights and biases inside a buffer laid out as ``_pack``
    lays it out."""
    w_off, b_off, _ = _packed_offsets(dims)
    ws = [buf[o:o + a * b].view(a, b) for o, a, b in zip(w_off, dims[:-1], dims[1:])]
    bs = [buf[o:o + b] for o, b in zip(b_off, dims[1:])]
    return ws, bs


def _wgmma_field(spec: "FusedFieldSpec") -> bool:
    """True for the shapes the wgmma bodies of the two field kernels are
    written for (csrc/wgmma_chain.cuh ``nkt_field_is_flagship``): bf16, H = 128,
    base (256, 128, 128, 16), rgb (15 + F, 64, 64, 3) with F = 16 or 48."""
    return (spec.bf16 and spec.h_freqs == 128
            and tuple(spec.base_dims) == (256, 128, 128, 16) and spec.feat_dim in (16, 48)
            and tuple(spec.rgb_dims) == (15 + spec.feat_dim, 64, 64, 3))


def _wgmma_mlp(spec: "FusedMLPSpec") -> bool:
    """True for the shapes the proposal-width wgmma bodies of the two
    fused-MLP kernels are written for (csrc/wgmma_chain.cuh
    ``nkt_mlp_is_flagship``): bf16, H = 40, dims (80, 16, 1)."""
    return spec.bf16 and spec.h_freqs == 40 and tuple(spec.layer_dims) == (80, 16, 1)


def _wgmma_mlp_base(spec: "FusedMLPSpec") -> bool:
    """True for the shapes the base-width wgmma bodies of the two fused-MLP
    kernels are written for (csrc/wgmma_chain.cuh ``nkt_mlp_base_depth``):
    bf16, H = 128, dims (256, 128, 128, 16), the nerfacto field's base chain,
    or (256, 128, 16), the 2-layer base of ``semantic-nerfw``'s split field."""
    return (spec.bf16 and spec.h_freqs == 128
            and tuple(spec.layer_dims) in ((256, 128, 16), (256, 128, 128, 16)))


# the fused-MLP kernels' bodies: counter suffix -> the C entry's `variant`
_MLP_VARIANTS = {"": 0, "_wgmma": 1, "_base_wgmma": 2}


def _mlp_body(spec: "FusedMLPSpec", kernel: str) -> str:
    """The counter suffix of the body a CUDA call of ``kernel`` (a fused-MLP
    name of KERNELS) runs for ``spec``: '_wgmma', '_base_wgmma', or '' for
    the WMMA and f32 bodies (and for every shape the kernel is forced
    through WMMA for, see FORCE_WMMA)."""
    if kernel in FORCE_WMMA:
        return ""
    if _wgmma_mlp(spec):
        return "_wgmma"
    return "_base_wgmma" if _wgmma_mlp_base(spec) else ""


def _core_offset(r, c, rows: int):
    """Element offset of (r, c) in a bf16 matrix of ``rows`` rows held as 8x8
    core matrices of 128 contiguous bytes, core (c // 8, r // 8) at
    (c // 8) * (rows // 8) + r // 8 (csrc/wgmma_chain.cuh)."""
    return ((c // 8) * (rows // 8) + r // 8) * 64 + (r % 8) * 8 + c % 8


def _shift_rgb_rows(w: torch.Tensor) -> torch.Tensor:
    """The rgb chain's first weight matrix as the wgmma bodies hold it: a
    zero row in front, so that the chain's input can be the base chain's
    whole output [sigma_raw; geo] followed by the feats."""
    return torch.cat([w.new_zeros(1, w.shape[1]), w], dim=0)


def _chain_image_index(dims: tuple, start: int, zero: int, shift_first: int = 0) -> np.ndarray:
    """For each bf16 element of one chain's weight image, its source in a
    flat buffer that holds the chain's packed weights from ``start`` on and a
    zero at ``zero``. The image holds, layer after layer, W^T (pad16(out)
    rows of pad16(in) columns, zeros in the padding) in the core layout; the
    first matrix is shifted ``shift_first`` rows down (``_shift_rgb_rows``)."""
    w_off = _packed_offsets(dims)[0]
    parts = []
    for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        shift = shift_first if l == 0 else 0
        K, N = _pad16(din + shift), _pad16(dout)
        n_, k_ = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
        valid = (n_ < dout) & (k_ >= shift) & (k_ - shift < din)
        src = np.where(valid, start + w_off[l] + (k_ - shift) * dout + n_, zero)
        idx = np.empty(N * K, dtype=np.int64)
        idx[_core_offset(n_, k_, N).reshape(-1)] = src.reshape(-1)
        parts.append(idx)
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _weight_image_index(base_dims: tuple, rgb_dims: tuple) -> np.ndarray:
    """For each bf16 element of the field's weight image, its source in
    cat([base packed, rgb packed, [0]]): the base chain's image, then the rgb
    chain's with its first matrix shifted (``_chain_image_index``)."""
    _, _, base_floats = _packed_offsets(base_dims)
    _, _, rgb_floats = _packed_offsets(rgb_dims)
    zero = base_floats + rgb_floats
    return np.concatenate([_chain_image_index(base_dims, 0, zero),
                           _chain_image_index(rgb_dims, base_floats, zero, shift_first=1)])


@functools.lru_cache(maxsize=None)
def _base_image_index(dims: tuple) -> np.ndarray:
    """For each bf16 element of one chain's image alone (the base-width
    bodies' BaseImage), its source in cat([packed, [0]])."""
    return _chain_image_index(dims, 0, _packed_offsets(dims)[2])


_image_index_on_device: dict = {}


def _index_on(device, build, *dims) -> torch.Tensor:
    """``build(*dims)``, a numpy index, as a tensor on ``device``; made once."""
    key = (build, dims, device)
    with _shared:
        if key not in _image_index_on_device:
            _image_index_on_device[key] = torch.from_numpy(build(*dims)).to(device)
        return _image_index_on_device[key]


def _weight_image(base_wb: torch.Tensor, rgb_wb: torch.Tensor, base_dims, rgb_dims):
    """The bf16 weight image of both packed chains (one gather, one cast)."""
    index = _index_on(base_wb.device, _weight_image_index, tuple(base_dims), tuple(rgb_dims))
    src = torch.cat([base_wb, rgb_wb, base_wb.new_zeros(1)])
    return src[index].to(torch.bfloat16)


def _mlp_k_order(h_freqs: int) -> np.ndarray:
    """The pair order of the 2H encoding features along the first layer's K
    axis (csrc/wgmma_chain.cuh ``nkt_mlp_pair_feature``): entry k is the
    feature of [s; c] that column k holds. Each 16-column k-step holds the s
    of 8 frequencies, then their c."""
    if h_freqs % 8:
        raise ValueError(f"the pair order needs h_freqs % 8 == 0, got {h_freqs}")
    k = np.arange(2 * h_freqs)
    return np.where(k % 16 < 8, 8 * (k // 16) + k % 16, h_freqs + 8 * (k // 16) + k % 16 - 8)


@functools.lru_cache(maxsize=None)
def _mlp_image_index(dims: tuple) -> np.ndarray:
    """For each bf16 element of the proposal chain's image, its source in the
    packed buffer: W_0^T (dims[1] rows of dims[0] columns in pair order) in
    the core layout. Both widths must be multiples of 16: no padding."""
    K, N = dims[0], dims[1]
    if K % 16 or N % 16:
        raise ValueError(f"the image needs widths that are multiples of 16, got {dims}")
    n_, k_ = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
    src = _packed_offsets(dims)[0][0] + _mlp_k_order(K // 2)[k_] * N + n_
    idx = np.empty(N * K, dtype=np.int64)
    idx[_core_offset(n_, k_, N).reshape(-1)] = src.reshape(-1)
    return idx


def _mlp_image(wb: torch.Tensor, dims) -> torch.Tensor:
    """The bf16 image of a packed proposal chain's first layer (one gather,
    one cast)."""
    return wb[_index_on(wb.device, _mlp_image_index, tuple(dims))].to(torch.bfloat16)


def _base_image(wb: torch.Tensor, dims) -> torch.Tensor:
    """The bf16 image of a whole packed chain, for the base-width bodies (one
    gather, one cast)."""
    index = _index_on(wb.device, _base_image_index, tuple(dims))
    return torch.cat([wb, wb.new_zeros(1)])[index].to(torch.bfloat16)


def _field_scratch_bytes(n: int, feat_dim: int) -> int:
    """Bytes the wgmma backward's per-point pass leaves for its
    weight-gradient pass (csrc/fourier_field_bwd.cu ``FieldScratch``): per
    point, as bf16, every layer's input but the encoding (128 + 128 + KR + 64
    + 64, KR = 16 + feat_dim being the rgb chain's padded input) and every
    pre-activation gradient (128 + 128 + 16 + 64 + 64 + 16), for whole
    64-point tiles."""
    tiles = (n + 63) // 64
    return tiles * 64 * (800 + 16 + feat_dim) * 2


def _mlp_base_scratch_bytes(n: int, dims) -> int:
    """Bytes the base-width backward's per-point pass leaves for its
    weight-gradient passes (csrc/fourier_mlp_bwd.cu ``MlpBaseScratch``): per
    point, as bf16, the inputs of the layers after the first (128 a hidden
    layer) and every pre-activation gradient (128 a hidden layer, then 16),
    for whole 64-point tiles: 528 values a point for dims (256, 128, 128, 16),
    272 for (256, 128, 16)."""
    tiles = (n + 63) // 64
    return tiles * 64 * (256 * (len(dims) - 2) + 16) * 2


# the SM count that sizes the backwards' grids and partials, fixed (an H100
# SXM's 132, csrc/chain_bwd.cuh NKT_BWD_GRID_SMS) so that their weight
# gradients' bits depend on the shape alone, not on the card's SM count
BWD_GRID_SMS = 132


# the weight image each wgmma body of the fused-MLP kernels stages
_mlp_images = {"_wgmma": _mlp_image, "_base_wgmma": _base_image}


@spanned("fused_field")
def _mlp_forward(spec: FusedMLPSpec, x_t, B, ws, bs) -> torch.Tensor:
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
    body = _mlp_body(spec, "fourier_mlp")
    # the wgmma bodies round the weights themselves (the image's cast, the
    # staging)
    wb = _pack(ws, bs, spec.layer_dims, spec.bf16 and not body)
    out = torch.empty(spec.out_dim, n, device=x.device, dtype=torch.float32)
    image = _mlp_images[body](wb, spec.layer_dims) if body else None
    _kernels.call(
        "fourier_mlp_fwd", x.data_ptr(), n, Bc.data_ptr(), H, wb.data_ptr(), wb.numel(),
        _kernels.int_array(spec.layer_dims), spec.num_layers,
        int(spec.basis == "tri"), int(spec.bf16), _MLP_VARIANTS[body],
        image.data_ptr() if body else None, 2 * image.numel() if body else 0,
        out.data_ptr(), _stream(x),
    )
    _count("fourier_mlp" + body)
    return out


@spanned("fused_field")
def _mlp_backward(spec: FusedMLPSpec, x_t, B, ws, bs, g):
    """(dx or None, dws, dbs): the backward kernel for CUDA tensors, the
    plain backward for CPU tensors."""
    if _on_cpu(x_t, B, *ws, *bs, g):
        return fourier_mlp_backward_reference(x_t, B, ws, bs, g, spec.basis, spec.bf16,
                                              spec.need_dx)
    n = x_t.shape[1]
    _check_n(n)
    H = spec.h_freqs
    _check("x_t", x_t, (3, n))
    _check("B", B, (3, H))
    _check("g", g, (spec.out_dim, n))
    x, Bc, gc = x_t.contiguous(), B.contiguous(), g.contiguous()
    # unrounded weights: the kernel rounds them where the forward does and
    # reads a width-1 last layer's weight in f32
    wb = _pack(ws, bs, spec.layer_dims, False)
    dwb = torch.empty_like(wb)
    dx = torch.empty(3, n, device=x.device, dtype=torch.float32) if spec.need_dx else None
    rows, stride = 4 * BWD_GRID_SMS, _partial_stride(spec.layer_dims)
    partials = torch.empty(rows * stride, device=x.device, dtype=torch.float32)
    body = _mlp_body(spec, "fourier_mlp_bwd")
    image = _mlp_images[body](wb, spec.layer_dims) if body else None
    scratch = None
    if body == "_base_wgmma":
        scratch = torch.empty(_mlp_base_scratch_bytes(n, spec.layer_dims), device=x.device,
                              dtype=torch.uint8)
    _kernels.call(
        "fourier_mlp_bwd", x.data_ptr(), n, Bc.data_ptr(), H, wb.data_ptr(), wb.numel(),
        _kernels.int_array(spec.layer_dims), spec.num_layers,
        int(spec.basis == "tri"), int(spec.bf16), int(spec.need_dx), gc.data_ptr(),
        dx.data_ptr() if spec.need_dx else None, partials.data_ptr(), rows, stride,
        dwb.data_ptr(), _MLP_VARIANTS[body], image.data_ptr() if body else None,
        2 * image.numel() if body else 0, scratch.data_ptr() if scratch is not None else None,
        scratch.numel() if scratch is not None else 0, _stream(x),
    )
    _count("fourier_mlp_bwd" + body, spec.need_dx)
    dws, dbs = _unpack(dwb, spec.layer_dims)
    return dx, dws, dbs


class FourierMLPFunction(torch.autograd.Function):
    """``fourier_mlp`` with its hand-written backward. Only the inputs are
    saved: the backward recomputes the forward. B gets no gradient; x_t gets
    one only when ``spec.need_dx``."""

    @staticmethod
    def forward(ctx, spec, x_t, B, *wb):
        n = len(wb) // 2
        ws, bs = list(wb[:n]), list(wb[n:])
        ctx.spec = spec
        ctx.save_for_backward(x_t, B, *wb)
        return _mlp_forward(spec, x_t, B, ws, bs)

    @staticmethod
    def backward(ctx, g):
        x_t, B, *wb = ctx.saved_tensors
        n = len(wb) // 2
        dx, dws, dbs = _mlp_backward(ctx.spec, x_t, B, list(wb[:n]), list(wb[n:]), g)
        return (None, dx, None, *dws, *dbs)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fourier_mlp(spec: FusedMLPSpec, x_t, B, ws, bs) -> torch.Tensor:
    """Fused Fourier-feature MLP: x_t (3, N) f32, B (3, H) pre-scaled
    frequency matrix (frozen: no gradient), ws/bs as mlp_init gives them.
    Returns (out_dim, N) f32. Differentiable in ws, bs and, when
    ``spec.need_dx``, x_t."""
    if _wants_grad(x_t, *ws, *bs):
        return FourierMLPFunction.apply(spec, x_t, B, *ws, *bs)
    return _mlp_forward(spec, x_t, B, ws, bs)


def _check_field_spec(spec: FusedFieldSpec) -> None:
    H, F = spec.h_freqs, spec.feat_dim
    if spec.base_dims[0] != 2 * H or spec.rgb_dims[0] != spec.geo_dim + F or spec.rgb_dims[-1] != 3:
        raise ValueError(f"inconsistent field spec {spec}")


@spanned("fused_field")
def _field_forward(spec: FusedFieldSpec, x_t, feats, B, base_ws, base_bs, rgb_ws,
                   rgb_bs) -> torch.Tensor:
    if _on_cpu(x_t, feats, B, *base_ws, *base_bs, *rgb_ws, *rgb_bs):
        return fourier_field_reference(x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs,
                                       spec.basis, spec.bf16)
    n = x_t.shape[1]
    _check_n(n)
    H, F = spec.h_freqs, spec.feat_dim
    _check("x_t", x_t, (3, n))
    _check("feats", feats, (F, n))
    _check("B", B, (3, H))
    _check_field_spec(spec)
    x = x_t.contiguous()
    fe = feats.contiguous()
    Bc = B.contiguous()
    base_wb = _pack(base_ws, base_bs, spec.base_dims, spec.bf16)
    rgb_wb = _pack(rgb_ws, rgb_bs, spec.rgb_dims, spec.bf16)
    out = torch.empty(4, n, device=x.device, dtype=torch.float32)
    wgmma = _wgmma_field(spec) and "fourier_field_mlp" not in FORCE_WMMA
    image = _weight_image(base_wb, rgb_wb, spec.base_dims, spec.rgb_dims) if wgmma else None
    _kernels.call(
        "fourier_field_fwd", x.data_ptr(), fe.data_ptr(), n, F, Bc.data_ptr(), H,
        base_wb.data_ptr(), base_wb.numel(), _kernels.int_array(spec.base_dims),
        len(spec.base_dims) - 1,
        rgb_wb.data_ptr(), rgb_wb.numel(), _kernels.int_array(spec.rgb_dims),
        len(spec.rgb_dims) - 1,
        int(spec.basis == "tri"), int(spec.bf16), int(wgmma),
        image.data_ptr() if wgmma else None, 2 * image.numel() if wgmma else 0,
        out.data_ptr(), _stream(x),
    )
    _count("fourier_field_mlp_wgmma" if wgmma else "fourier_field_mlp")
    return out


@spanned("fused_field")
def _field_backward(spec: FusedFieldSpec, x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs, g):
    """(dx or None, dfeats, d_base_ws, d_base_bs, d_rgb_ws, d_rgb_bs): the
    backward kernel for CUDA tensors, the plain backward for CPU tensors."""
    if _on_cpu(x_t, feats, B, *base_ws, *base_bs, *rgb_ws, *rgb_bs, g):
        return fourier_field_backward_reference(x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs,
                                                g, spec.basis, spec.bf16, spec.need_dx)
    n = x_t.shape[1]
    _check_n(n)
    H, F = spec.h_freqs, spec.feat_dim
    _check("x_t", x_t, (3, n))
    _check("feats", feats, (F, n))
    _check("B", B, (3, H))
    _check("g", g, (4, n))
    _check_field_spec(spec)
    x, fe, Bc, gc = x_t.contiguous(), feats.contiguous(), B.contiguous(), g.contiguous()
    base_wb = _pack(base_ws, base_bs, spec.base_dims, False)
    rgb_wb = _pack(rgb_ws, rgb_bs, spec.rgb_dims, False)
    d_base, d_rgb = torch.empty_like(base_wb), torch.empty_like(rgb_wb)
    dx = torch.empty(3, n, device=x.device, dtype=torch.float32) if spec.need_dx else None
    dfeats = torch.empty(F, n, device=x.device, dtype=torch.float32)
    rows, stride = BWD_GRID_SMS, _partial_stride(spec.base_dims, spec.rgb_dims)
    partials = torch.empty(rows * stride, device=x.device, dtype=torch.float32)
    wgmma = _wgmma_field(spec) and "fourier_field_mlp_bwd" not in FORCE_WMMA
    image = scratch = None
    if wgmma:
        image = _weight_image(base_wb, rgb_wb, spec.base_dims, spec.rgb_dims)
        scratch = torch.empty(_field_scratch_bytes(n, F), device=x.device, dtype=torch.uint8)
    _kernels.call(
        "fourier_field_bwd", x.data_ptr(), fe.data_ptr(), n, F, Bc.data_ptr(), H,
        base_wb.data_ptr(), base_wb.numel(), _kernels.int_array(spec.base_dims),
        len(spec.base_dims) - 1,
        rgb_wb.data_ptr(), rgb_wb.numel(), _kernels.int_array(spec.rgb_dims),
        len(spec.rgb_dims) - 1,
        int(spec.basis == "tri"), int(spec.bf16), int(spec.need_dx), gc.data_ptr(),
        dx.data_ptr() if spec.need_dx else None, dfeats.data_ptr(), partials.data_ptr(), rows,
        stride, d_base.data_ptr(), d_rgb.data_ptr(), int(wgmma),
        image.data_ptr() if wgmma else None, 2 * image.numel() if wgmma else 0,
        scratch.data_ptr() if wgmma else None, scratch.numel() if wgmma else 0, _stream(x),
    )
    _count("fourier_field_mlp_bwd_wgmma" if wgmma else "fourier_field_mlp_bwd", spec.need_dx)
    d_base_ws, d_base_bs = _unpack(d_base, spec.base_dims)
    d_rgb_ws, d_rgb_bs = _unpack(d_rgb, spec.rgb_dims)
    return dx, dfeats, d_base_ws, d_base_bs, d_rgb_ws, d_rgb_bs


class FourierFieldFunction(torch.autograd.Function):
    """``fourier_field_mlp`` with its hand-written backward; saves only its
    inputs. B gets no gradient; x_t gets one only when ``spec.need_dx``."""

    @staticmethod
    def forward(ctx, spec, x_t, feats, B, *wb):
        nb, nr = len(spec.base_dims) - 1, len(spec.rgb_dims) - 1
        ctx.spec = spec
        ctx.save_for_backward(x_t, feats, B, *wb)
        return _field_forward(spec, x_t, feats, B, list(wb[:nb]), list(wb[nb:2 * nb]),
                              list(wb[2 * nb:2 * nb + nr]), list(wb[2 * nb + nr:]))

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        x_t, feats, B, *wb = ctx.saved_tensors
        nb, nr = len(spec.base_dims) - 1, len(spec.rgb_dims) - 1
        dx, dfeats, dbw, dbb, drw, drb = _field_backward(
            spec, x_t, feats, B, list(wb[:nb]), list(wb[nb:2 * nb]),
            list(wb[2 * nb:2 * nb + nr]), list(wb[2 * nb + nr:]), g)
        return (None, dx, dfeats if ctx.needs_input_grad[2] else None, None,
                *dbw, *dbb, *drw, *drb)


def fourier_field_mlp(spec: FusedFieldSpec, x_t, feats, B, base_ws, base_bs,
                      rgb_ws, rgb_bs) -> torch.Tensor:
    """Fully fused nerfacto field: x_t (3, N) f32 contracted positions, feats
    (F, N) f32 per-point conditioning (SH rows, appearance rows). Returns
    (4, N) f32 = [sigma_raw; sigmoid rgb]. Differentiable in the weights,
    feats and, when ``spec.need_dx``, x_t; B gets no gradient."""
    if _wants_grad(x_t, feats, *base_ws, *base_bs, *rgb_ws, *rgb_bs):
        return FourierFieldFunction.apply(spec, x_t, feats, B, *base_ws, *base_bs, *rgb_ws,
                                          *rgb_bs)
    return _field_forward(spec, x_t, feats, B, base_ws, base_bs, rgb_ws, rgb_bs)
