"""MoNet Gaussian kernel weights over polar pseudo-coordinates.

Counterpart of ``vqa_project_tpu/ops/gaussian.py``, with the same
reference semantics: precisions squared and regularized with 1e-14, the
wrapped theta distance min(|d|, |2*pi - |d||), NaN weights zeroed before
the normalization, normalization across the KERNEL axis, and the
denominator clamped at 1e-20 so an edge whose Gaussians all underflow
weighs 0 instead of NaN. All math is float32.
"""

from __future__ import annotations

import math

import torch


def gaussian_kernel_weights(
    pseudo_coord: torch.Tensor,
    mean_rho: torch.Tensor,
    mean_theta: torch.Tensor,
    precision_rho: torch.Tensor,
    precision_theta: torch.Tensor,
) -> torch.Tensor:
    """(..., 2) pseudo-coordinates and four (n,) parameter vectors ->
    (..., n) float32 weights that sum to 1 over the kernel axis."""
    w, denom = gaussian_kernel_terms(pseudo_coord, mean_rho, mean_theta,
                                     precision_rho, precision_theta)
    return w / denom


def gaussian_kernel_terms(
    pseudo_coord: torch.Tensor,
    mean_rho: torch.Tensor,
    mean_theta: torch.Tensor,
    precision_rho: torch.Tensor,
    precision_theta: torch.Tensor,
):
    """The unnormalized weights (..., n), NaN set to 0, and the clamped
    denominator (..., 1) whose quotient ``gaussian_kernel_weights`` is."""
    pc = pseudo_coord.float()
    rho = pc[..., 0:1]                                   # (..., 1)
    theta = pc[..., 1:2]

    mu_r = mean_rho.float().reshape(-1)                  # (n,)
    mu_t = mean_theta.float().reshape(-1)
    pr = precision_rho.float().reshape(-1)
    pt = precision_theta.float().reshape(-1)

    w_rho = torch.exp(-0.5 * (rho - mu_r) ** 2 / (1e-14 + pr ** 2))

    first = torch.abs(theta - mu_t)
    second = torch.abs(2.0 * math.pi - first)
    w_theta = torch.exp(
        -0.5 * torch.minimum(first, second) ** 2 / (1e-14 + pt ** 2))

    w = w_rho * w_theta
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    denom = torch.sum(w, dim=-1, keepdim=True)
    return w, torch.clamp(denom, min=1e-20)
