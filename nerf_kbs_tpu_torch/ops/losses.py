"""Training losses: rgb MSE, the interlevel (proposal) loss and the
distortion loss in the samplers' spacing domain, the orientation and
predicted-normal losses, the monocular and euclidean depth losses, the
semantic cross-entropy, and the flow loss on the flow that the rendered
depth induces.

The depth alignment's solve and the masked means sum over the step's global
batch (``parallel.mesh.batch_sum``): in a data-parallel step every rank gets
the term of the whole batch; elsewhere the sums are local."""

from __future__ import annotations

import torch

from nerf_kbs_tpu_torch.ops.segment_sum import segment_sum
from nerf_kbs_tpu_torch.parallel.mesh import batch_sum


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


class _OuterCwBounds(torch.autograd.Function):
    """(cw_before, cw_after), each (R, Sq):
    cw_before = max(0, cw at the rightmost env edge <= t0)   (0 when none)
    cw_after  = min(cw at the first env edge > t1, cw[:, -1]) (the total when none)

    t_env rows are sorted, so both selections are index searches. Only cw
    carries gradient: the cotangents go to the selected env indices, and to
    cw[:, -1] where no env edge lies past t1; t_env, t0 and t1 only select.
    t0 and t1 rows are sorted too, so both index rows are non-decreasing and
    the backward sums each env edge's cotangents in query order
    (``segment_sum``), as the JAX package's one-hot sum does, with no
    atomics."""

    @staticmethod
    def forward(ctx, t_env, cw, t0, t1):
        n_env = t_env.shape[1]
        # number of env edges <= t0; the selected edge is the one before
        i_lo = torch.searchsorted(t_env, t0.contiguous(), right=True)
        # first env edge > t1
        i_hi = torch.searchsorted(t_env, t1.contiguous(), right=True)
        has_lo, has_hi = i_lo > 0, i_hi < n_env
        lo = torch.gather(cw, 1, torch.clamp_min(i_lo - 1, 0))
        lo = torch.where(has_lo, lo, torch.zeros_like(lo))
        hi = torch.gather(cw, 1, torch.clamp_max(i_hi, n_env - 1))
        ctx.save_for_backward(i_lo, i_hi)
        ctx.n_env = n_env
        return torch.clamp_min(lo, 0.0), torch.minimum(hi, cw[:, -1:])

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        i_lo, i_hi = ctx.saved_tensors
        n_env = ctx.n_env
        # the lower and the upper bounds' cotangents as the rows of one sum;
        # no edge past t1: the clamp selected cw[:, -1], index n_env - 1
        idx = torch.cat([torch.clamp_min(i_lo - 1, 0), torch.clamp_max(i_hi, n_env - 1)])
        sums = segment_sum(torch.cat([g_lo * (i_lo > 0).to(g_lo.dtype), g_hi]), idx, n_env)
        R = g_lo.shape[0]
        return None, sums[:R] + sums[R:], None, None


def _outer_cw_bounds(t_env, cw, t0, t1):
    return _OuterCwBounds.apply(t_env, cw, t0, t1)


def _outer_weights(t_query: torch.Tensor, t_env: torch.Tensor, w_env: torch.Tensor):
    """For each query interval [t_query_i, t_query_{i+1}), the total weight
    of the env bins that overlap it (the inclusive outer measure). t_query
    (R, Sq + 1) edges, t_env (R, Se + 1) edges, w_env (R, Se)."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]), torch.cumsum(w_env, dim=-1)], dim=-1)
    before, after = _outer_cw_bounds(t_env, cw, t_query[..., :-1], t_query[..., 1:])
    return after - before


def _edges(samples) -> torch.Tensor:
    return torch.cat([samples.spacing_starts, samples.spacing_ends[..., -1:]], dim=-1)


def interlevel_loss(final_samples, final_weights: torch.Tensor, history) -> torch.Tensor:
    """Proposal loss E[max(0, w - w_outer)^2 / (w + eps)], summed over the
    rounds: each proposal histogram must bound the final weights, which are
    detached, from above."""
    t_final = _edges(final_samples).detach()
    w_final = final_weights.detach()
    loss = 0.0
    for prop_samples, prop_weights in history:
        w_outer = _outer_weights(t_final, _edges(prop_samples).detach(), prop_weights)
        loss = loss + torch.mean(torch.clamp_min(w_final - w_outer, 0.0) ** 2 / (w_final + 1e-7))
    return loss


def distortion_loss(samples, weights: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 distortion regulariser in the spacing domain, in its O(S)
    form with exclusive prefix sums."""
    m = 0.5 * (samples.spacing_starts + samples.spacing_ends)
    interval = samples.spacing_ends - samples.spacing_starts
    loss_uni = torch.sum(weights**2 * interval, dim=-1) / 3.0
    w_cum = torch.cumsum(weights, dim=-1) - weights
    wm_cum = torch.cumsum(weights * m, dim=-1) - weights * m
    loss_bi = 2.0 * torch.sum(weights * (m * w_cum - wm_cum), dim=-1)
    return torch.mean(loss_uni + loss_bi)


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor,
                     view_dirs: torch.Tensor) -> torch.Tensor:
    """Normals (R, S, 3) that face away from the camera, w max(0, n . d)^2,
    summed over samples and averaged over rays; view_dirs (R, 3)."""
    n_dot_v = torch.sum(normals * view_dirs[..., None, :], dim=-1)
    return torch.mean(torch.sum(weights * torch.clamp_min(n_dot_v, 0.0) ** 2, dim=-1))


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor,
                     pred_normals: torch.Tensor) -> torch.Tensor:
    """w (1 - n . n_pred): ties the predicted normals to the density
    gradient's, summed over samples and averaged over rays."""
    sim = torch.sum(normals * pred_normals, dim=-1)
    return torch.mean(torch.sum(weights * (1.0 - sim), dim=-1))


def normalized_depth_scale_and_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """Closed-form least-squares (scale, shift) that align pred to gt over
    the mask, per leading row, with the sums taken over the step's global
    batch; (0, 0) where the system is singular."""
    a00, a01, a11, b0, b1 = batch_sum(torch.stack([
        torch.sum(x, dim=-1)
        for x in (mask * pred * pred, mask * pred, mask, mask * pred * gt, mask * gt)])).unbind()
    det = a00 * a11 - a01 * a01
    valid = det > 1e-9
    safe = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe, zero)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe, zero)
    return scale, shift


def monodepth_loss(termination_depth: torch.Tensor, gt_depth: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scale-and-shift-invariant depth loss: align the rendered depth to the
    target in closed form, then the masked MSE."""
    pred = termination_depth.reshape(1, -1)
    gt = gt_depth.reshape(1, -1)
    m = torch.ones_like(gt) if mask is None else mask.reshape(1, -1).to(gt.dtype)
    scale, shift = normalized_depth_scale_and_shift(pred, gt, m)
    aligned = scale[:, None] * pred + shift[:, None]
    return masked_mean((aligned - gt) ** 2, m)


def masked_mean(values: torch.Tensor, weights: torch.Tensor, per_row: int = 1) -> torch.Tensor:
    """sum(weights * values) / max(sum(weights) * per_row, 1) over the
    global batch; ``weights`` broadcasts against ``values``, and ``per_row``
    counts the values that each weight covers."""
    s = batch_sum(torch.stack([torch.sum(weights * values), torch.sum(weights)]))
    return s[0] / torch.clamp_min(s[1] * per_row, 1.0)


def euclidean_depth_loss(termination_depth: torch.Tensor, gt_depth: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Metric depth MSE, masked when a mask is given."""
    err = (termination_depth - gt_depth) ** 2
    if mask is None:
        return torch.mean(err)
    return masked_mean(err, mask.to(err.dtype))


def colors_to_labels(pixel_colors: torch.Tensor, class_colors: torch.Tensor) -> torch.Tensor:
    """Class of the nearest class colour in L1: pixel_colors (B, 3) and
    class_colors (K, 3) in [0, 1] -> (B,) int32."""
    d = torch.sum(torch.abs(pixel_colors[:, None, :] - class_colors[None, :, :]), dim=-1)
    return torch.argmin(d, dim=-1).to(torch.int32)


def semantic_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, K) logits against (B,) integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -torch.mean(torch.sum(logp * onehot, dim=-1))


def induced_flow(origins: torch.Tensor, directions: torch.Tensor, depth: torch.Tensor,
                 pixel_xy: torch.Tensor, neighbor_w2c: torch.Tensor,
                 neighbor_K: torch.Tensor) -> torch.Tensor:
    """The optical flow that the rendered depth induces: each ray's
    termination point projected into the neighbour camera, minus the source
    pixel. origins, directions (B, 3) world; depth (B, 1) along the ray;
    pixel_xy (B, 2) the source pixel (u, v); neighbor_w2c (B, 3, 4) world ->
    neighbour camera, OpenGL (looking down -z); neighbor_K (B, 4) = (fx, fy,
    cx, cy). Returns (B, 2)."""
    pts = origins + directions * depth
    cam = torch.einsum("bij,bj->bi", neighbor_w2c[..., :3], pts) + neighbor_w2c[..., 3]
    z = torch.clamp_min(-cam[:, 2], 1e-6)
    fx, fy, cx, cy = (neighbor_K[:, i] for i in range(4))
    u = fx * (cam[:, 0] / z) + cx
    v = fy * (-cam[:, 1] / z) + cy
    return torch.stack([u, v], dim=-1) - pixel_xy


def flow_loss(pred_flow: torch.Tensor, gt_flow: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """L1 between induced and observed flow, summed over (u, v) and averaged
    over the valid rows."""
    err = torch.sum(torch.abs(pred_flow - gt_flow), dim=-1)
    if valid is None:
        return torch.mean(err)
    return masked_mean(err, valid.to(err.dtype).reshape(err.shape))
