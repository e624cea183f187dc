"""Robust loss functions matching Ceres' loss family as used by the reference
(``GetLossFunction``, rig_calibrator.cc:394-411): l2 (none), huber, cauchy,
soft_l1 (Ceres SoftLOneLoss, the reference's "l1"). Port of
``multiview_tpu/solver/losses.py``.

Each rho(s) maps a *squared* residual-block norm s to the robustified cost,
as in Ceres.
"""

from __future__ import annotations

import torch


def rho(loss: str, s, scale):
    """Robust cost of squared norm s; scale = robust threshold a."""
    a2 = scale * scale
    if loss == "l2":
        return s
    if loss == "huber":
        # sqrt argument clamped to a2 so the unselected branch's gradient is
        # finite (the where-NaN autodiff pitfall)
        return torch.where(s <= a2, s,
                           2.0 * scale * torch.sqrt(torch.clamp_min(s, a2)) - a2)
    if loss == "cauchy":
        return a2 * torch.log1p(s / a2)
    if loss in ("soft_l1", "l1"):
        return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)
    raise ValueError(f"Unknown loss: {loss}")


def rho_prime(loss: str, s, scale):
    """d rho / d s. Used for IRLS weights w = sqrt(rho')."""
    a2 = scale * scale
    if loss == "l2":
        return torch.ones_like(s)
    if loss == "huber":
        return torch.where(s <= a2, torch.ones_like(s),
                           scale / torch.sqrt(torch.clamp_min(s, a2)))
    if loss == "cauchy":
        return 1.0 / (1.0 + s / a2)
    if loss in ("soft_l1", "l1"):
        return 1.0 / torch.sqrt(1.0 + s / a2)
    raise ValueError(f"Unknown loss: {loss}")


def robust_weights(loss: str, residual_blocks, scale):
    """Per-block IRLS weights sqrt(rho'(|r|^2)) for residual blocks [...,k]."""
    s = torch.sum(residual_blocks * residual_blocks, dim=-1)
    return torch.sqrt(rho_prime(loss, s, scale))
