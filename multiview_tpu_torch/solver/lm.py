"""Dense Levenberg-Marquardt with parameter masks and bounds. Port of
``multiview_tpu/solver/lm.py``: the solver of the small and medium problems
(RPC inverse fitting, rpc_distortion.cc:559-721; the single-sensor BA
configurations). The full Jacobian comes from ``torch.func.jacrev`` of a
residual function written on tensors. The loop syncs with the host once per
iteration for its stop test.

For large sparse BA problems use ``solver.schur`` instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class LMResult(NamedTuple):
    x: torch.Tensor          # final parameters
    cost: torch.Tensor       # final robust cost (0.5 * sum rho)
    initial_cost: torch.Tensor
    iterations: int
    lam: torch.Tensor        # final damping
    converged: bool


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iterations: int = 20,
    lam0: float = 1e-4,
    parameter_tolerance: float = 1e-8,
    function_tolerance: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
) -> LMResult:
    """Minimize 0.5 * |residual_fn(x)|^2 over x.

    residual_fn: x [n] -> residuals [m] (robust weighting, if any, is baked
      into the residuals).
    mask: boolean [n]; False entries are frozen (Ceres
      SetParameterBlockConstant semantics, rig_calibrator.cc:1702-1752).
    lower/upper: optional [n] box bounds; steps are projected.

    Nielsen's damping update (gain-ratio driven), Jacobi-scaled
    (lambda * diag(J^T J)) like Ceres' default LM. A damped matrix that is
    not positive definite gives a NaN step, which the accept test rejects
    (lambda then grows).
    """
    x = x0.detach()
    n = x.shape[0]
    dtype, device = x.dtype, x.device
    free = (torch.ones(n, dtype=dtype, device=device) if mask is None
            else torch.as_tensor(mask, device=device).to(dtype))

    def project(v):
        if lower is not None:
            v = torch.maximum(v, lower)
        if upper is not None:
            v = torch.minimum(v, upper)
        return v

    def res_and_jac(v):
        def f(z):
            r = residual_fn(z)
            return r, r
        J, r = torch.func.jacrev(f, has_aux=True)(v)
        return r.detach(), J.detach()

    with torch.no_grad():
        r0 = residual_fn(x)
        cost = 0.5 * torch.sum(r0 * r0)
    c0 = cost
    lam = torch.as_tensor(lam0, dtype=dtype, device=device)
    nu = torch.as_tensor(2.0, dtype=dtype, device=device)
    iterations = 0
    done = False
    nan = torch.full((), float("nan"), dtype=dtype, device=device)

    while iterations < max_iterations and not done:
        r, J = res_and_jac(x)
        with torch.no_grad():
            J = J * free[None, :]                    # zero columns of frozen params
            g = J.T @ r
            H = J.T @ J
            diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
            # frozen entries get a unit diagonal so the solve stays well-posed
            Hd = H + torch.diag(lam * diag + (1.0 - free))
            L, info = torch.linalg.cholesky_ex(Hd)
            dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
            dx = torch.where(info == 0, dx, nan) * free

            x_new = project(x + dx)
            step = x_new - x
            r_new = residual_fn(x_new)
            new_cost = 0.5 * torch.sum(r_new * r_new)

            # gain ratio: actual reduction / model reduction
            pred = -(step @ g) - 0.5 * step @ (H @ step) \
                - 0.5 * lam * torch.sum(diag * step * step)
            rho = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
            good = (new_cost < cost) & torch.isfinite(new_cost)

            lam_dec = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            lam_new = torch.where(good, torch.clamp_min(lam_dec, 1e-14), lam * nu)
            nu = torch.where(good, torch.full_like(nu, 2.0), nu * 2.0)

            step_norm = torch.linalg.norm(step)
            x_norm = torch.linalg.norm(x)
            small_step = good & (step_norm <= parameter_tolerance
                                 * (x_norm + parameter_tolerance))
            small_decrease = good & (torch.abs(cost - new_cost)
                                     <= function_tolerance * torch.clamp_min(cost, 1e-30))
            blown_up = lam > 1e10
            stop = small_step | small_decrease | blown_up

            x = torch.where(good, x_new, x)
            cost = torch.where(good, new_cost, cost)
            lam = lam_new
            iterations += 1
            done = bool(stop)         # the one host sync of an iteration
    return LMResult(x, cost, c0, iterations, lam, done)
