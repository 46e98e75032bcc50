"""Image-quality metrics: PSNR, masked PSNR and SSIM (an 11x11 Gaussian
window, applied per channel by ``conv2d``). LPIPS needs VGG weights the
repository does not hold and is not computed."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp_min(mse, 1e-12))


def masked_psnr(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSNR over the pixels where mask > 0; the mask has pred's shape or
    lacks its channel axis."""
    m = (mask > 0).to(pred.dtype)
    if m.dim() == pred.dim() - 1:
        m = m[..., None]
    mse = torch.sum(m * (pred - gt) ** 2) / torch.clamp_min(torch.sum(m * torch.ones_like(pred)),
                                                           1.0)
    return 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM with a Gaussian window over the valid region (constants
    K1 = 0.01, K2 = 0.03). pred, gt (H, W, C) in [0, max_val]."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)[None, None]

    def filt(img):
        x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        return torch.nn.functional.conv2d(x, kern)[:, 0].permute(1, 2, 0)

    mu_p, mu_g = filt(pred), filt(gt)
    var_p = filt(pred * pred) - mu_p**2
    var_g = filt(gt * gt) - mu_g**2
    cov = filt(pred * gt) - mu_p * mu_g
    num = (2 * mu_p * mu_g + c1) * (2 * cov + c2)
    den = (mu_p**2 + mu_g**2 + c1) * (var_p + var_g + c2)
    return torch.mean(num / den)
