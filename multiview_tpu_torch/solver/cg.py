"""Preconditioned conjugate gradients on the BA's reduced camera system
(``solver/schur.py``): ``pcg(schur_mv, M, rhs, ...)`` -> (x, CG count).

CG runs from 0 and stops where |r|^2 <= cg_tolerance^2 |rhs|^2 (the
reference's test) or after ``iterations`` steps. The test is evaluated every
step as a mask and read on the host every ``check_every`` steps, so x and
the count are those of a test at every step and a solve runs at most
``check_every - 1`` matvecs past convergence. ``force=m``
(``debug_force_cg``) runs exactly m steps, with no test and no mask.

The preconditioner ``M`` is Jacobi (a scalar a camera column) or
SCHUR_JACOBI (the inverted 7x7 pose blocks on the pose columns, the scalar
one on the rest), both from ``solver/assembly.py``.

On CUDA tensors the vector work of a step runs the hand-written kernel
``csrc/cg_step.cu``: one start launch, then one launch a step after the
caller's matvec (``pcg_cuda``); its dots are taken in a fixed order
(``csrc/cg_step.cuh``), so two processes with the same inputs get the same
bits. On CPU tensors it runs the plain loop (``pcg_plain``) that the solver
held before the kernel existed; nothing on the card gives way to it.
``LAUNCHES`` counts the kernel's launches. This per-step path serves several
shards and the linear solvers whose matvec is not ``csrc/schur_mv.cu``'s; one
shard of ``cg_blocks`` runs its whole CG in one launch
(``solver/cg_solve.py``), with the same step arithmetic."""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from multiview_tpu_torch.utils import cuda_build

SOURCE = "cg_step.cu"
# kernel launches of csrc/cg_step.cu (the start and every step)
LAUNCHES = 0
_START, _STEP, _FORCED = 0, 1, 2


class Preconditioner(NamedTuple):
    """``precond`` [C] 1 / (cam_diag * cam_free + dc); ``pose_inv``
    [R,7,7] the SCHUR_JACOBI pose blocks' inverses (None: Jacobi)."""

    precond: torch.Tensor
    pose_inv: Optional[torch.Tensor] = None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """M^-1 v (plain)."""
        if self.pose_inv is None:
            return self.precond * v
        num_ref = self.pose_inv.shape[0]
        vp = torch.einsum("rij,rj->ri", self.pose_inv, v[:num_ref * 7].reshape(num_ref, 7))
        return torch.cat([vp.reshape(-1), v[num_ref * 7:] * self.precond[num_ref * 7:]])


def _dot(a, b):
    """Dot of replicated (camera-space) vectors."""
    return torch.sum(a * b)


def update_plain(M: Preconditioner, x, rr, p, rz, Ap):
    """One CG step after its matvec ``Ap = S p``: (x, r, p, rz) new."""
    denom = _dot(p, Ap)
    pos = denom > 0
    alpha = torch.where(pos, rz / torch.where(pos, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    rr_n = rr - alpha * Ap
    zz = M.apply(rr_n)
    rz_n = _dot(rr_n, zz)
    beta = rz_n / torch.where(rz > 0, rz, torch.ones_like(rz))
    return x + alpha * p, rr_n, zz + beta * p, rz_n


def pcg_plain(schur_mv: Callable, M: Preconditioner, rhs: torch.Tensor, iterations: int,
              tolerance: float, check_every: int, force: Optional[int] = None):
    """(x, CG count) of the plain loop. ``rr`` is a replicated vector (its
    partial sums went through ``mesh.sum``), so every shard and rank reads
    the same test and leaves at the same step."""
    device = rhs.device
    x = torch.zeros_like(rhs)
    rr = rhs
    p = M.apply(rr)
    rz = _dot(rr, p)

    def step(x, rr, p, rz):
        return update_plain(M, x, rr, p, rz, schur_mv(p))

    if force is not None:
        for _ in range(force):
            x, rr, p, rz = step(x, rr, p, rz)
        return x, torch.full((), force, dtype=torch.int64, device=device)
    stop2 = tolerance ** 2 * _dot(rhs, rhs)
    active = torch.ones((), dtype=torch.bool, device=device)
    cg_k = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(iterations):
        active = active & (_dot(rr, rr) > stop2)
        if k % check_every == 0 and not bool(active):     # host sync
            break
        new = step(x, rr, p, rz)
        x, rr, p, rz = (torch.where(active, a, b) for a, b in zip(new, (x, rr, p, rz)))
        cg_k = cg_k + active.to(torch.int64)
    return x, cg_k


# ----------------------------------------------------------------------------
# The kernel (csrc/cg_step.cu)
# ----------------------------------------------------------------------------


def _lib():
    lib = cuda_build.load_library(SOURCE)
    if lib.mv_cg.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mv_cg.argtypes = [i32, i32, i64, i64, p, p, p, p, p, p, p, ctypes.c_double, p, p]
        lib.mv_cg.restype = ctypes.c_int
        lib.mv_cg_empty.argtypes = [p]
        lib.mv_cg_empty.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "cg_step kernel")


class CudaCG:
    """One CG solve's vectors and state on the card, and the launches of
    csrc/cg_step.cu on them: ``start()``, then ``step(Ap)`` after each matvec
    of ``p``. x, r and p are updated in place. Launch with the tensors'
    card current (``torch.cuda.device``)."""

    def __init__(self, M: Preconditioner, rhs: torch.Tensor, tolerance: float):
        dev, dt, n = rhs.device, rhs.dtype, rhs.shape[0]
        if dev.type != "cuda":
            raise ValueError(f"cg_step kernel: rhs lies on {dev}, not on a CUDA device")
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"cg_step kernel: float32 or float64, got {dt}")
        _check("rhs", rhs, (n,), dt, dev)
        _check("precond", M.precond, (n,), dt, dev)
        nposes = 0
        if M.pose_inv is not None:
            nposes = M.pose_inv.shape[0]
            _check("pose_inv", M.pose_inv, (nposes, 7, 7), dt, dev)
            if 7 * nposes > n:
                raise ValueError(f"cg_step kernel: {nposes} pose blocks for {n} entries")
        self.rhs, self.M, self.n, self.nposes = rhs, M, n, nposes
        self.x, self.r, self.p, self.z = (torch.empty_like(rhs) for _ in range(4))
        self.state = torch.empty(4, dtype=torch.float64, device=dev)   # rz, stop2, active, count
        self.tol2 = float(tolerance) ** 2
        self._fixed = (self.x.data_ptr(), self.r.data_ptr(), self.p.data_ptr(),
                       self.z.data_ptr())

    def _launch(self, mode: int, v: torch.Tensor) -> None:
        global LAUNCHES
        M = self.M
        err = _lib().mv_cg(v.element_size(), mode, self.n, self.nposes, *self._fixed,
                           v.data_ptr(), M.precond.data_ptr(),
                           None if M.pose_inv is None else M.pose_inv.data_ptr(), self.tol2,
                           self.state.data_ptr(),
                           cuda_build.stream(self.rhs.device))
        if err != 0:
            raise RuntimeError(f"cg_step kernel (mode {mode}) failed with cudaError {err}")
        LAUNCHES += 1

    def start(self) -> None:
        """x = 0, r = rhs, p = M^-1 rhs, the stop test of the first step."""
        self._launch(_START, self.rhs)

    def step(self, Ap: torch.Tensor, forced: bool = False) -> None:
        """The step after the matvec Ap = S p (masked by the stop test
        unless ``forced``)."""
        _check("Ap", Ap, (self.n,), self.rhs.dtype, self.rhs.device)
        self._launch(_FORCED if forced else _STEP, Ap)

    def active(self) -> bool:
        """The stop test of the next step (a host sync)."""
        return bool(self.state[2])

    def count(self) -> torch.Tensor:
        return self.state[3].to(torch.int64)


def empty_launch(device) -> None:
    """One launch of an empty kernel on ``device``'s current stream (the
    least time of a launch, the CG step's bound)."""
    err = _lib().mv_cg_empty(cuda_build.stream(device))
    if err != 0:
        raise RuntimeError(f"cg_step empty kernel failed with cudaError {err}")


def pcg_cuda(schur_mv: Callable, M: Preconditioner, rhs: torch.Tensor, iterations: int,
             tolerance: float, check_every: int, force: Optional[int] = None):
    """(x, CG count) with csrc/cg_step.cu: the plain loop's steps, tests and
    host reads, one launch a step."""
    cg = CudaCG(M, rhs, tolerance)
    with torch.cuda.device(rhs.device):
        cg.start()
        if force is not None:
            for _ in range(force):
                cg.step(schur_mv(cg.p), forced=True)
            return cg.x, torch.full((), force, dtype=torch.int64, device=rhs.device)
        for k in range(iterations):
            if k % check_every == 0 and not cg.active():     # host sync
                break
            cg.step(schur_mv(cg.p))
        return cg.x, cg.count()


def pcg(schur_mv: Callable, M: Preconditioner, rhs: torch.Tensor, iterations: int,
        tolerance: float, check_every: int, force: Optional[int] = None):
    """(x, CG count): the plain loop for a CPU ``rhs``, the kernel for a CUDA
    one (which raises on anything it does not take)."""
    if rhs.device.type == "cpu":
        return pcg_plain(schur_mv, M, rhs, iterations, tolerance, check_every, force)
    return pcg_cuda(schur_mv, M, rhs, iterations, tolerance, check_every, force)
