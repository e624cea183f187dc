"""Batched-hypothesis RANSAC for a 2D affine map. Port of
``ransac_affine2d`` and its helpers from ``multiview_tpu/sfm/ransac.py``
(the role of cv::estimateAffine2D in the reference front end,
interest_point.cc:133-143, threshold 20 px).

A fixed batch of minimal-sample hypotheses is solved and scored at once,
then the best model is refit on its inliers. Hypotheses are drawn by one
small sampler, ``sample_hypotheses``, from a ``torch.Generator`` seeded per
call; PyTorch cannot reproduce JAX's random bits, so the parity tests
replace that sampler with one that returns JAX's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor        # [...,2,3] affine
    inliers: torch.Tensor      # [...,N] bool
    num_inliers: torch.Tensor  # [...]


def _fit_affine2d(src, dst, w=None):
    """Weighted least-squares affine fit dst ~ A src + t over the row axis:
    src/dst [...,K,2], w [...,K] -> [...,2,3]."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype, device=src.device)
    A = torch.cat([src, ones], dim=-1)                           # [...,K,3]
    Aw = A if w is None else A * w[..., None]
    H = A.transpose(-1, -2) @ Aw
    H = H + 1e-12 * torch.eye(3, dtype=src.dtype, device=src.device)
    b = Aw.transpose(-1, -2) @ dst                               # [...,3,2]
    sol = torch.linalg.solve_ex(H, b).result                     # [...,3,2]
    return sol.transpose(-1, -2)


def _apply_affine2d(model, pts):
    return pts @ model[..., :, :2].transpose(-1, -2) + model[..., None, :, 2]


def sample_hypotheses(valid: torch.Tensor, num_hypotheses: int, seed: int) -> torch.Tensor:
    """[num_hypotheses, 3] row indices drawn with replacement among the
    ``valid`` rows of one point set, uniformly, from a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(int(seed))
    # no valid row: draw uniformly (the hypotheses then score 0 anyway)
    probs = torch.where(torch.any(valid), valid.to(torch.float32),
                        torch.ones_like(valid, dtype=torch.float32))
    draws = torch.multinomial(probs, num_hypotheses * 3, replacement=True, generator=gen)
    return draws.view(num_hypotheses, 3)


def ransac_affine2d(src, dst, valid=None, threshold: float = 20.0,
                    num_hypotheses: int = 512, refit_rounds: int = 2,
                    seed: int = 0, samples: Optional[torch.Tensor] = None
                    ) -> RansacResult:
    """Batched-hypothesis RANSAC for a 2D affine map.

    src, dst [...,N,2] (leading dims: independent point sets, e.g. image
    pairs); valid [...,N] marks rows to use. Hypotheses come from
    ``samples`` [...,H,3] when given, else from ``sample_hypotheses`` with
    ``seed`` (one point set only)."""
    n = src.shape[-2]
    lead = src.shape[:-2]
    if n < 3:
        return RansacResult(
            torch.eye(2, 3, dtype=src.dtype, device=src.device).expand(lead + (2, 3)),
            torch.zeros(lead + (n,), dtype=torch.bool, device=src.device),
            torch.zeros(lead, dtype=torch.int64, device=src.device))
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=src.device)
    if samples is None:
        if lead:
            raise ValueError("batched ransac_affine2d needs explicit samples")
        samples = sample_hypotheses(valid, num_hypotheses, seed)
    samples = samples.to(device=src.device, dtype=torch.int64)
    H = samples.shape[-2]

    # [...,H,3,2] minimal sets -> [...,H,2,3] models
    flat = samples.reshape(lead + (H * 3,))
    take = lambda x: torch.gather(x, -2, flat[..., None].expand(flat.shape + (2,)))  # noqa: E731
    s_src = take(src).reshape(lead + (H, 3, 2))
    s_dst = take(dst).reshape(lead + (H, 3, 2))
    models = _fit_affine2d(s_src, s_dst)                          # [...,H,2,3]

    # score every hypothesis over every row: [...,H,N]
    pred = _apply_affine2d(models, src[..., None, :, :])
    err = torch.linalg.norm(pred - dst[..., None, :, :], dim=-1)
    inl = (err <= threshold) & valid[..., None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)                           # first max, as jnp.argmax
    model = torch.gather(models, -3, best[..., None, None, None].expand(lead + (1, 2, 3)))
    model = model.squeeze(-3)

    for _ in range(refit_rounds):
        err = torch.linalg.norm(_apply_affine2d(model, src) - dst, dim=-1)
        inl = (err <= threshold) & valid
        model = _fit_affine2d(src, dst, w=inl.to(src.dtype))
    err = torch.linalg.norm(_apply_affine2d(model, src) - dst, dim=-1)
    inliers = (err <= threshold) & valid
    return RansacResult(model, inliers, inliers.sum(-1))
