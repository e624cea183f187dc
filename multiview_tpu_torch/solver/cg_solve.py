"""The whole CG of one LM iteration of ``linear_solver`` "cg_blocks" on one
shard (``solver/schur.py``): the reduced system's right-hand side
-(g_c - cam_free * J_c^T J_p Hpp^-1 g_p), preconditioned CG from 0 on S x =
rhs, the back-substitution's product u = J_c (cam_free * x), J_p^T u, and,
where asked, the LM iteration's trial point (``lm_step.trial``'s function).

``solve(system, g_c, g_p, M, iterations, tolerance, check_every, force)`` ->
``Solution``. On CUDA tensors it runs one cooperative launch of the
hand-written kernel ``cg_solve_kernel`` of ``csrc/schur_mv.cu``
(``solve_cuda``): the matvec's passes of ``schur_kernel`` and the step of
``csrc/cg_step.cuh`` in a loop on the device, the stop test taken at every
step (the reference's ``cg_cond``), so its matvecs equal its CG count and
the host reads nothing until the LM loop's own sync; given ``trial`` it
writes the trial point in its tail (``csrc/lm_trial.cuh``, the arithmetic of
``csrc/lm_step.cu``'s trial kernel: the same bits). ``SolveBuffers``, kept
over an LM solve, hold its vectors and its count (allocated once), and the
LM loop's stop flag ``halt``, where set, makes the launch return at once.
On CPU tensors it runs
the plain version (``solve_plain``): ``schur_rhs``, ``cg.pcg`` with the stop
test read every ``check_every`` steps (the steps past it masked: the same x
and count), ``row_products`` and, given ``trial``, ``lm_step.trial_plain``.
``LAUNCHES`` counts the kernel's launches.

With several shards (whose matvec sums over the shards between its passes)
and in the other linear solvers the solver keeps the per-step path: a
matvec, then a launch of ``csrc/cg_step.cu`` (``cg.pcg``), and the trial
point's own launch."""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional

import torch

from multiview_tpu_torch.solver import cg, lm_step, schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build

# launches of cg_solve_kernel (csrc/schur_mv.cu), one a CG solve
LAUNCHES = 0
# with RECORD_LAUNCH set, the shape of the last launch (LAST_LAUNCH): grid,
# threads a block, rows a tile, the ring's slots, the rows a point pass finds
# in shared memory at its start, the pose window, whether x * cam_free stays
# whole in shared memory, the copies of the pose columns, the bytes of rows
# a CG step reads from device memory, and the grid barriers a CG step crosses
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
_INFO = ("grid", "threads", "tile_rows", "slots", "resident_rows", "window_poses",
         "x_in_shared", "pose_copies", "row_bytes_a_step", "barriers_a_step")


class Solution(NamedTuple):
    x: torch.Tensor              # [C] the step of the reduced camera system
    count: torch.Tensor          # 0-d int64: the CG steps taken
    u: List[torch.Tensor]        # per shard, flat in residual order: J_c (cam_free * x)
    jtp_u: torch.Tensor          # [P,3] J_p^T u
    trial: Optional[lm_step.Trial] = None   # the trial point, where asked


class TrialInputs(NamedTuple):
    """What the trial point reads besides the solve's outputs: the LM state
    (its dp and step_c buffers on the card), the current cameras [C] and
    points [P, 3] (on the card half-0 arrays of ``halves``), the bounds."""

    st: lm_step.LMState
    cam: torch.Tensor
    points: torch.Tensor
    lower: Optional[torch.Tensor]
    upper: Optional[torch.Tensor]
    halves: Optional[lm_step.Halves]


def solve_plain(system: smv.SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor,
                M: cg.Preconditioner, iterations: int, tolerance: float, check_every: int,
                force: Optional[int] = None, schur_mv: Optional[Callable] = None,
                trial: Optional[TrialInputs] = None) -> Solution:
    """The plain composition; ``schur_mv`` (default: the plain S x) is the
    matvec ``cg.pcg`` calls; ``trial``: then ``lm_step.trial_plain``."""
    rhs = smv.schur_rhs_plain(system, g_c, g_p)
    mv = schur_mv or functools.partial(smv.schur_matvec_plain, system)
    x, count = cg.pcg(mv, M, rhs, iterations, tolerance, check_every, force)
    u, jtp_u = smv.row_products_plain(system, x)
    t = None
    if trial is not None:
        t = lm_step.trial_plain(trial.st, trial.cam, trial.points, x, system.cam_free,
                                trial.lower, trial.upper, system.hpp_inv, g_p, jtp_u)
    return Solution(x, count, u, jtp_u, t)


_check = functools.partial(cuda_build.check_tensor, "cg_solve kernel")


class SolveBuffers:
    """The one-launch solve's vectors, scratch and count on the card, kept
    over an LM solve: allocated at the first call, anew where the sizes,
    dtype or device change. The outputs of one call are overwritten by the
    next."""

    def __init__(self):
        self._key = None

    def get(self, C: int, P: int, u_len: int, u_zero: bool, dt, dev) -> dict:
        key = (C, P, u_len, u_zero, dt, dev)
        if key != self._key:
            kw = dict(dtype=dt, device=dev)
            self.t = {"x": torch.empty(C, **kw), "r": torch.empty(2 * C, **kw),
                      "p": torch.empty(2 * C, **kw), "ap": torch.empty(2 * C, **kw),
                      # the rows of a family without a camera block stay 0
                      "u": (torch.zeros if u_zero else torch.empty)(u_len, **kw),
                      "jtp_u": torch.empty((P, 3), **kw), "w": torch.empty((P, 3), **kw),
                      "state": torch.empty(4, dtype=torch.float64, device=dev),
                      "count": torch.zeros((), dtype=torch.int64, device=dev)}
            self._key = key
        return self.t


def solve_cuda(system: smv.SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor,
               M: cg.Preconditioner, iterations: int, tolerance: float,
               force: Optional[int] = None, buffers: Optional[SolveBuffers] = None,
               halt: Optional[torch.Tensor] = None,
               trial: Optional[TrialInputs] = None) -> Solution:
    """One launch of cg_solve_kernel: the stop test at every step on the
    device (``force=m``: exactly m steps, no test). ``buffers``: see
    ``SolveBuffers`` (None: the call's own); ``halt``: the LM loop's stop
    flag (an int32 0-d tensor on the shard's device); ``trial``: the trial
    point written in the solve's tail (its cameras and points half-0 arrays
    of ``trial.halves``, the system's halves, read in half sel and written in
    half 1 - sel; dp and step_c into the state's buffers). A system with the
    LM loop's halves is read in the half its selector picks."""
    global LAUNCHES, LAST_LAUNCH
    if system.mesh.size != 1:
        raise ValueError(f"cg_solve kernel: the observations lie in {system.mesh.size} "
                         f"shards; it solves one shard (use the per-step path)")
    plan = smv._plans(system, None)[0]
    dev, dt = plan.device, system.cam_free.dtype
    C, P = system.total, system.num_points
    _check("g_c", g_c, (C,), dt, dev)
    _check("g_p", g_p, (P, 3), dt, dev)
    _check("precond", M.precond, (C,), dt, dev)
    nposes = 0
    if M.pose_inv is not None:
        nposes = M.pose_inv.shape[0]
        _check("pose_inv", M.pose_inv, (nposes, 7, 7), dt, dev)
        if 7 * nposes > C:
            raise ValueError(f"cg_solve kernel: {nposes} pose blocks for {C} entries")
    if force is not None and force < 0:
        raise ValueError(f"cg_solve kernel: force = {force}")
    if halt is not None:
        _check("the stop flag", halt, (), torch.int32, dev)
    ptr = cuda_build.ptr
    trial_ptrs, t = None, None
    if trial is not None:
        st, h = trial.st, trial.halves
        lm_step._on_card(st, h, True)
        if h is not system.halves:
            raise ValueError("cg_solve kernel: the trial point's halves are not the system's")
        for name, a, shape in (("cam", trial.cam, (C,)), ("points", trial.points, (P, 3)),
                               ("lower", trial.lower, (C,)), ("upper", trial.upper, (C,))):
            if a is not None:
                _check(name, a, shape, dt, dev)
        _check("the state's dp", st.dp, (P, 3), dt, dev)
        _check("the state's step_c", st.step_c, (C,), dt, dev)
        h.check("cam", trial.cam)
        h.check("points", trial.points)
        trial_ptrs = (ctypes.c_longlong * 6)(
            trial.cam.data_ptr(), trial.points.data_ptr(), ptr(trial.lower) or 0,
            ptr(trial.upper) or 0, st.dp.data_ptr(), st.step_c.data_ptr())
        t = lm_step.Trial(h.pair(trial.cam), h.pair(trial.points), st.dp, st.step_c)
    b = (buffers or SolveBuffers()).get(C, P, plan.u_len, plan.u_zero, dt, dev)
    x, r, p, ap, u, jtp_u, w = (b[k] for k in ("x", "r", "p", "ap", "u", "jtp_u", "w"))
    info = (ctypes.c_longlong * len(_INFO))() if RECORD_LAUNCH else None
    sel, half = smv.halves_of(system, dev)
    with torch.cuda.device(dev):
        err = smv._lib().mv_cg_solve(
            dt.itemsize, plan.table, plan.families, plan.cam_free.data_ptr(),
            system.dc.data_ptr(), plan.hpp_inv.data_ptr(), g_c.data_ptr(), g_p.data_ptr(),
            M.precond.data_ptr(), ptr(M.pose_inv), nposes, P, C, system.num_ref, iterations,
            -1 if force is None else force, float(tolerance) ** 2, x.data_ptr(),
            r.data_ptr(), p.data_ptr(), ap.data_ptr(), u.data_ptr(), jtp_u.data_ptr(),
            w.data_ptr(), b["state"].data_ptr(), b["count"].data_ptr(), ptr(halt), sel, half,
            trial_ptrs, info, cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f"cg_solve kernel failed with cudaError {err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = dict(zip(_INFO, list(info)))
    return Solution(x, b["count"], [u], jtp_u, t)


def solve(system: smv.SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor,
          M: cg.Preconditioner, iterations: int, tolerance: float, check_every: int,
          force: Optional[int] = None, schur_mv: Optional[Callable] = None,
          buffers: Optional[SolveBuffers] = None, halt: Optional[torch.Tensor] = None,
          trial: Optional[TrialInputs] = None) -> Solution:
    """The plain version for CPU tensors (``check_every`` and ``schur_mv``
    are its), the kernel for CUDA ones (``buffers`` and ``halt`` are its;
    it raises on anything it does not take); ``trial``: the trial point too."""
    if g_c.device.type == "cpu":
        return solve_plain(system, g_c, g_p, M, iterations, tolerance, check_every, force,
                           schur_mv, trial)
    return solve_cuda(system, g_c, g_p, M, iterations, tolerance, force, buffers, halt, trial)
