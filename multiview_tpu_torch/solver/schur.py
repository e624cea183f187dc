"""Schur-complement Levenberg-Marquardt for bundle adjustment. Port of
``multiview_tpu/solver/schur.py::make_schur_solver`` (the counterpart of
Ceres' ITERATIVE_SCHUR + SCHUR_JACOBI, the reference's solver choice,
rig_calibrator.cc:1909-1919, and of DENSE_SCHUR).

Structure points are eliminated exactly and the reduced camera system is
solved, in the default ``cg_blocks`` mode, by preconditioned CG on the
explicit per-row block Jacobians:

- each LM iteration evaluates, per observation row, the robustified
  residual and its Jacobian with respect to the parameter blocks the row
  touches (pixel rows: beg/end pose, rig, offset, focal, centre,
  distortion; depth rows: beg/end pose, rig, offset, depth_to_image, depth
  scale; point) in ``solver/row_blocks.py``: on the card the hand-written
  kernel ``csrc/row_blocks.cu`` (one launch a family), on the CPU
  reverse-mode autograd of the row-summed residuals;
- camera columns are gathered per row by the bracketing pose indices and
  reduced back with ``index_add_`` per pose (per-sensor constant columns
  are plain sums); point sides are ``index_add_`` per point. The CG's Schur
  matvec, its right-hand side and the back-substitution's product
  (``solver/schur_matvec.py``) run the hand-written kernel
  ``csrc/schur_mv.cu`` on the card and those gathers and sums on the CPU;
  on one shard the whole CG of an LM iteration with both products is one
  launch of that kernel's ``cg_solve_kernel`` (``solver/cg_solve.py``), the
  stop test taken on the device at every step;
- the gradient, Hpp [P,3,3], the Jacobi diagonal and the 7x7 SCHUR_JACOBI
  pose blocks are assembled once per LM iteration, Hpp+lam*D inverted in
  closed form and the pose blocks by LU (``solver/assembly.py``: on the card
  the hand-written kernel ``csrc/lm_assembly.cu``, one launch an LM
  iteration on one shard);
- elsewhere (several shards, the other linear solvers) the preconditioned
  CG (``solver/cg.py``) runs its vector work in the hand-written kernel
  ``csrc/cg_step.cu`` on the card, one launch a step after the matvec, and
  as the plain loop on the CPU.

The other linear solvers of the reference (``cg``, ``cg_dense_j``,
``dense_schur``) share that loop; ``make_schur_solver`` says how each
differs. CG stops at the reference's test: on the device at every step in
the one-launch solve, else read on the host every ``CG_CHECK_EVERY``
iterations. After the CG, each LM iteration's trial point, model reduction,
accept and lam update run in ``solver/lm_step.py`` (on the card the
hand-written kernel ``csrc/lm_step.cu``: the accept, and the trial point
where the one-launch CG solve does not write it in its tail), whose state
stays on the device; the host reads it every ``LM_CHECK_EVERY``
iterations where an iteration has no sync of its own, else every iteration.
Every residual family of the problem is supported: pixel reprojection,
depth against the triangulated point, depth against the mesh (camera side
only: it touches no point) and xyz priors (point side only).

Observations sharded over a ``parallel.sharding.ShardMesh`` (pixel
families in row shards, the rest whole) solve with the same loop: row-space
work (block Jacobians, ``J x``, the CG's ``u``) stays on each shard, camera-
and point-space vectors are replicated on the lead device, and the sums of
row partials (``J^T u`` per pose and per point, Hpp, the Jacobi diagonal,
the SCHUR_JACOBI blocks after the summed Hpp, the row-space dots of the
costs and of the model reduction) go through ``ShardMesh.sum``. Dots of
replicated vectors are taken once; the whole families count on the lead
shard of rank 0 only; so every LM and CG decision is the same on every
shard and rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.parallel.sharding import ShardMesh, ShardedPixelObs
from multiview_tpu_torch.solver import assembly, cg, cg_solve, lm_step, schur_matvec as smv
from multiview_tpu_torch.solver.row_blocks import (  # noqa: F401  (re-exported)
    depth_row_blocks, depth_row_launch, pixel_row_blocks, pixel_row_launch, prior_row_blocks,
    prior_row_launch)
from multiview_tpu_torch.utils.device import indexed_device


class CamLayout(NamedTuple):
    world_to_ref: int
    ref_to_cam: int
    offsets: int
    focal: int
    ctr: int
    dist: Tuple[int, ...]
    d2i: int
    dscale: int
    total: int


def cam_layout(template: prob.RigState) -> CamLayout:
    off = 0

    def sec(n):
        nonlocal off
        start = off
        off += int(n)
        return start

    w = sec(template.world_to_ref.numel())
    r = sec(template.ref_to_cam.numel())
    o = sec(template.timestamp_offsets.numel())
    f = sec(template.focal.numel())
    c = sec(template.optical_center.numel())
    d = tuple(sec(x.numel()) for x in template.dist)
    d2i = sec(template.depth_to_image.numel())
    ds = sec(template.depth_scale.numel())
    return CamLayout(w, r, o, f, c, d, d2i, ds, off)


# ----------------------------------------------------------------------------
# The solver
# ----------------------------------------------------------------------------


LINEAR_SOLVERS = ("cg", "cg_blocks", "cg_dense_j", "dense_schur")

# CG's stop test is read on the host once every this many iterations (one
# sync each) where the host drives the CG step by step (several shards, the
# other linear solvers, the CPU); the iterations in between that follow
# convergence are masked to no-ops, so x and the CG count are those of a test
# at every iteration, and a solve runs at most CG_CHECK_EVERY - 1 matvecs
# past convergence. The one-launch CG solve on the card tests every step
CG_CHECK_EVERY = 2
# The LM loop's state (done, the counts, the singular flag) is read on the
# host once every this many iterations, and after the last, on one shard of
# cg_blocks, where an LM iteration has no host sync of its own; an iteration
# past done is a no-op (every launch returns at once on the device's stop
# flag), so the result is that of a read at every iteration. The other paths
# read at every iteration: their CG reads its stop test on the host, and
# dense_schur's dense solve (plain PyTorch) cannot test the device's flag.
LM_CHECK_EVERY = 2


class SchurLMResult(NamedTuple):
    cam: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int
    lam: torch.Tensor
    cg_iters_total: torch.Tensor
    matvecs: int                 # Schur matvecs the CG loops ran (masked ones too)


@dataclasses.dataclass
class _Family:
    """Index structure of one residual family (loop constants of a solve)."""

    kind: str                            # "pix" | "depth_tri" | "depth_mesh" | "prior"
    obs: object
    point_idx: Optional[torch.Tensor]    # [N]; None: the family touches no point
    beg_idx: Optional[torch.Tensor] = None
    end_idx: Optional[torch.Tensor] = None
    const_cols: Optional[torch.Tensor] = None  # [B-14] per-sensor columns
    weight: float = 0.0
    th: float = 0.0


def make_schur_solver(template: prob.RigState, observations: prob.Observations,
                      models: Sequence[str], opts: prob.BAOptions,
                      cam_mask: np.ndarray,
                      max_iterations: int = 20,
                      cg_iterations: int = 50,
                      cg_tolerance: float = 1e-8,
                      lam0: float = 1e-4,
                      lower: Optional[torch.Tensor] = None,
                      upper: Optional[torch.Tensor] = None,
                      linear_solver: str = "auto",
                      preconditioner: str = "auto",
                      debug_unroll_lm: int = 0,
                      debug_force_cg: Optional[int] = None):
    """Build a Schur-LM solve function
    ``(cam_vec0, points0, observations=None, cam_mask_rt=None) -> SchurLMResult``.

    ``cam_mask``: free mask over the camera vector (points always free).
    Observations passed at solve time must keep the template's family
    structure (sensors, priors); their index arrays, masks and measurements
    are free to differ. ``preconditioner``: "jacobi", "schur_jacobi" or
    "auto" (jacobi for cg_tolerance >= 0.01, as the reference picks).

    ``linear_solver``, how each LM step solves the reduced camera system:

    - "cg_blocks": PCG whose matvecs are products with the per-row block
      Jacobians (on the card the kernel ``csrc/schur_mv.cu``, on the CPU
      gathers by pose index and ``index_add_``);
    - "cg": PCG, matrix-free: the residual function is linearized at the
      current state once per LM iteration (``torch.func.vjp``) and every
      product with J or J^T (the gradient, the matvecs, the back-substitution,
      the model reduction) is a ``torch.func.jvp`` or a call of that vjp;
      Hpp and the preconditioner still come from the row blocks;
    - "cg_dense_j": PCG whose camera-side products use each family's camera
      Jacobian densified to [N,k,C] once per LM iteration;
    - "dense_schur": S = B - E Hpp^-1 E^T assembled with the damping and the
      freeze, then Cholesky (Ceres' DENSE_SCHUR); where S is not positive
      definite the step is NaN and the LM rejects it. Its CG count is 0;
    - "auto": "cg_blocks". The reference's "auto" takes "cg" where its
      one-hot pose selectors (2 * rows * poses floats) would pass 2^29; the
      port has no selectors (its gathers and ``index_add_`` take no extra
      memory), so "cg_blocks" serves every size.

    "cg_dense_j" and "dense_schur" take the gradient, the back-substitution
    and the model reduction from the row blocks, where the reference takes
    them from its linearization: the same products, summed in another order.
    Only "cg_blocks" solves sharded observations.

    ``debug_force_cg=m``: every CG solve runs exactly m steps, with no stop
    test and no mask. ``debug_unroll_lm=k``: exactly k LM iterations, the
    stop test ignored. With both, one steady iteration can be timed."""
    if linear_solver == "auto":
        linear_solver = "cg_blocks"
    if linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver {linear_solver!r}: one of {LINEAR_SOLVERS} or 'auto'")
    layout = cam_layout(template)
    num_points = template.points.shape[0]
    num_ref = template.world_to_ref.shape[0]
    dtype, device = template.dtype, template.device
    cam_free_default = torch.as_tensor(np.asarray(cam_mask, np.float64), dtype=dtype,
                                       device=device)
    if preconditioner == "auto":
        preconditioner = "jacobi" if cg_tolerance >= 0.01 else "schur_jacobi"
    # SCHUR_JACOBI's 7x7 pose blocks (DENSE_SCHUR solves exactly: no CG)
    block_precond = preconditioner == "schur_jacobi" and linear_solver != "dense_schur"

    def const_cols(s: int, dev) -> torch.Tensor:
        d = int(template.dist[s].numel())
        cols = np.concatenate([
            layout.ref_to_cam + s * 7 + np.arange(7),
            [layout.offsets + s], [layout.focal + s],
            layout.ctr + s * 2 + np.arange(2),
            layout.dist[s] + np.arange(d)]).astype(np.int64)
        return torch.as_tensor(cols, device=dev)

    def depth_const_cols(s: int) -> torch.Tensor:
        nd = int(template.depth_to_image.shape[1])
        cols = np.concatenate([
            layout.ref_to_cam + s * 7 + np.arange(7),
            [layout.offsets + s],
            layout.d2i + s * nd + np.arange(nd),
            [layout.dscale + s]]).astype(np.int64)
        return torch.as_tensor(cols, device=device)

    def pixel_family(o: prob.PixelObs, dev) -> _Family:
        return _Family("pix", o, o.point_idx, o.beg_idx, o.end_idx, const_cols(o.sensor, dev))

    def shard_families(obs: prob.Observations) -> Tuple[ShardMesh, List[List[_Family]]]:
        """The mesh of the observations (one shard on the template's device
        when no family is sharded) and the families of each local shard.
        Sharded pixel families put one family on every shard; the whole
        families (unsharded pixels, depth rows, priors) go to the lead shard
        of rank 0 only, so the sums over shards and ranks count them once."""
        meshes = {id(o.mesh): o.mesh for o in obs.pixels if isinstance(o, ShardedPixelObs)}
        if len(meshes) > 1:
            raise ValueError("the sharded pixel families lie on different meshes")
        mesh = next(iter(meshes.values())) if meshes else ShardMesh((device,))
        if mesh.lead != device:
            raise ValueError(f"the observations are sharded from {mesh.lead}, the state "
                             f"is on {device}: replicate the state onto the mesh")
        shards: List[List[_Family]] = [[] for _ in mesh.devices]
        whole = mesh.rank == 0
        for o in obs.pixels:
            if isinstance(o, ShardedPixelObs):
                for fams, so, dev in zip(shards, o.shards, mesh.devices):
                    fams.append(pixel_family(so, dev))
            elif whole:
                shards[0].append(pixel_family(o, device))
        if whole:
            shards[0] += [_Family("depth_mesh" if mesh_v else "depth_tri", o,
                                  None if mesh_v else o.point_idx, o.beg_idx, o.end_idx,
                                  depth_const_cols(o.sensor))
                          for o, mesh_v in prob.depth_families(obs, opts)]
            shards[0] += [_Family("prior", p, p.point_idx, weight=w, th=th)
                          for p, w, th in prob.static_priors(obs, opts)]
        return mesh, shards

    def unpack(cam_vec, points):
        st = prob.unpack_state(cam_vec, template, include_points=False)
        return dataclasses.replace(st, points=points)

    def lm_solve(cam0, points0, obs=None, cam_mask_rt=None) -> SchurLMResult:
        if obs is None:
            obs = observations
        cam_free = (torch.as_tensor(np.asarray(cam_mask_rt, np.float64), dtype=dtype,
                                    device=device)
                    if cam_mask_rt is not None else cam_free_default)
        mesh, shards = shard_families(obs)
        if linear_solver != "cg_blocks" and mesh.size > 1:
            raise ValueError(f"linear_solver {linear_solver!r} solves unsharded observations "
                             f"only; these lie in {mesh.size} shards (use 'cg_blocks')")
        with torch.no_grad():
            return _solve(cam0, points0, obs, mesh, shards, cam_free)

    def _solve(cam0, points0, obs: prob.Observations, mesh: ShardMesh,
               shards: List[List[_Family]], cam_free) -> SchurLMResult:
        """The LM loop. Row-space quantities (Jacobian blocks, residuals,
        ``u``) are lists with one entry per local shard, on its device;
        camera- and point-space vectors are replicated on the lead device,
        and every sum of row-space partials goes through ``mesh.sum``. Dots
        of replicated vectors are taken once, never summed over shards."""
        devs = mesh.devices
        matvecs = 0

        def on(x, s):
            """A replicated tensor on shard ``s``'s device (itself when there)."""
            return None if x is None else x.to(devs[s])

        def cat(parts, s):
            return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=devs[s])

        def blocks_at(cam_vec, points):
            """Per shard: per-family (j_cam | None, j_pt | None) and the flat residual."""
            out = []
            for s, fams in enumerate(shards):
                st = unpack(on(cam_vec, s), on(points, s))
                jc, jp, res = [], [], []
                for f in fams:
                    if f.kind == "pix":
                        a, b, r = pixel_row_blocks(st, f.obs, models[f.obs.sensor], opts)
                    elif f.kind != "prior":
                        a, b, r = depth_row_blocks(st, f.obs, opts, f.kind == "depth_mesh")
                    else:
                        a = None
                        b, r = prior_row_blocks(st, f.obs, f.weight, f.th)
                    jc.append(a)
                    jp.append(b)
                    res.append(r.reshape(-1))
                out.append((jc, jp, cat(res, s)))
            return [o[:2] for o in out], [o[2] for o in out]

        def row_cols(f: _Family):
            """Each row's camera columns [N,B]: beg pose, end pose, constants."""
            seven = torch.arange(7, device=f.beg_idx.device)
            return torch.cat([f.beg_idx[:, None] * 7 + seven, f.end_idx[:, None] * 7 + seven,
                              f.const_cols.expand(f.beg_idx.shape[0], -1)], dim=-1)

        def densify(J):
            """Per shard and family the camera Jacobian [N,k,C] (None where
            the family has no camera block)."""
            out = []
            for fams, (jc, _) in zip(shards, J):
                dense = []
                for f, a in zip(fams, jc):
                    if a is None:
                        dense.append(None)
                        continue
                    n, k, _b = a.shape
                    d = torch.zeros((n, k, layout.total), dtype=dtype, device=a.device)
                    dense.append(d.scatter_add_(2, row_cols(f)[:, None, :].expand(n, k, -1), a))
                out.append(dense)
            return out

        def Jmv(J, xc, xp, dense=None):
            """J @ (xc, xp) per shard; None skips that side. With ``dense``
            (``densify(J)``) the camera side multiplies the dense blocks."""
            return [smv.shard_jmv(fams, jc, jp, on(xc, s), on(xp, s), num_ref, dtype, devs[s],
                                  None if dense is None else dense[s])
                    for s, (fams, (jc, jp)) in enumerate(zip(shards, J))]

        def JTmv_c(J, u, dense=None):
            partials = []
            for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u)):
                if dense is None:
                    partials.append(smv.shard_jtmv_c(fams, jc, jp, us, num_ref, layout.total,
                                                     dtype, devs[s]))
                    continue
                gc = torch.zeros(layout.total, dtype=dtype, device=devs[s])
                for d, ub in zip(dense[s], smv.split_rows(us, jc, jp)):
                    if d is not None:
                        # as [C, N*k] @ [N*k]: a transposed view, no copy of d
                        gc = gc + d.reshape(-1, layout.total).t() @ ub.reshape(-1)
                partials.append(gc)
            return mesh.sum(partials)

        def JTmv_p(J, u):
            return mesh.sum([smv.shard_jtmv_p(fams, jc, jp, us, num_points, dtype, devs[s])
                             for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u))])

        def rsub(a, b):
            return [x - y for x, y in zip(a, b)]

        def residual_fn(cam_vec, pts):
            return prob.all_residuals(unpack(cam_vec, pts), obs, models, opts)

        def dense_schur_solve(J, hpp_inv, cam_free, dc, rhs):
            """DENSE_SCHUR: S = B - E Hpp^-1 E^T from the dense camera blocks,
            frozen rows and columns replaced by the unit diagonal, damped by
            ``dc``, then Cholesky. A factorization that fails (S not positive
            definite) gives a NaN step, as the reference's ``cho_factor``."""
            C = layout.total
            (fams,), ((jc, jp),) = shards, J
            B = torch.zeros((C, C), dtype=dtype, device=device)
            E = torch.zeros((num_points, C, 3), dtype=dtype, device=device)
            for f, a, b, d in zip(fams, jc, jp, densify(J)[0]):
                if a is None:
                    continue
                dm = d.reshape(-1, C)
                B = B + dm.t() @ dm
                if b is not None:
                    E.index_put_((f.point_idx[:, None], row_cols(f)),
                                 torch.einsum("nkb,nkj->nbj", a, b), accumulate=True)
            T = torch.einsum("pci,pij->pcj", E, hpp_inv)
            S = B - torch.einsum("pcj,pdj->cd", T, E)
            S = S * cam_free[:, None] * cam_free[None, :] + torch.diag(dc)
            L, info = torch.linalg.cholesky_ex(S)
            x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
            return x * cam_free

        def family_rows(f: _Family) -> Tuple[int, int]:
            """(rows, components a row) of a family."""
            if f.kind == "prior":
                return f.obs.point_idx.shape[0], 3
            return len(f.obs), 2 if f.kind == "pix" else 3

        def block_shapes(f: _Family):
            """(camera block, point block) shapes of a family's rows (None
            where it has no such block), as the row-block kernel writes them."""
            n, k = family_rows(f)
            if f.kind == "prior":
                return None, (n, 3, 3)
            b = 25 + int(template.dist[f.obs.sensor].numel()) if f.kind == "pix" else \
                23 + (12 if opts.affine_depth_to_image else 7)
            return (n, k, b), (None if f.kind == "depth_mesh" else (n, k, 3))

        def row_launches(halves: lm_step.Halves):
            """On the card: (launch, cam, points, J, r) with the current and
            the trial point, blocks and residuals in ``halves`` (cam, points,
            J and r: their half-0 arrays, allocated once); ``launch(halt,
            flip)`` evaluates every family's row blocks at the cameras and
            points of the half the state's sel picks (``flip`` 1: the other
            half, the trial point) into that half's J and r (a ``RowLaunch``
            a family, which writes its span of the flat residual; a shard on
            another device than the lead's reads both halves' copies of the
            cameras and points that ``launch`` refreshes, and its launches
            are not halted)."""
            C = layout.total
            halves.reserve(lead, (C,))
            halves.reserve(lead, (num_points, 3))
            sizes = []
            for s, fams in enumerate(shards):
                dev = indexed_device(devs[s])
                if dev != lead:
                    halves.reserve(dev, (C,))
                    halves.reserve(dev, (num_points, 3))
                sizes.append([family_rows(f) for f in fams])
                halves.reserve(dev, (sum(n * k for n, k in sizes[-1]),))
                for f in fams:
                    for shape in block_shapes(f):
                        if shape is not None:
                            halves.reserve(dev, shape)
            arrays = iter(halves.allocate())
            cam_vec, pts = next(arrays), next(arrays)
            copies, launches, J, r = [], [], [], []
            for s, fams in enumerate(shards):
                dev = indexed_device(devs[s])
                c, p = cam_vec, pts
                if dev != lead:
                    c, p = next(arrays), next(arrays)
                    copies += [(halves.pair(c), halves.pair(cam_vec)),
                               (halves.pair(p), halves.pair(pts))]
                state = unpack(c, p)
                flat = next(arrays)
                jc, jp, ls, off = [], [], [], 0
                for f, (n, k) in zip(fams, sizes[s]):
                    res = flat[off:off + n * k].view(n, k)
                    off += n * k
                    a, b = (None if shape is None else next(arrays) for shape in block_shapes(f))
                    if f.kind == "pix":
                        ls.append(pixel_row_launch(state, f.obs, models[f.obs.sensor], opts,
                                                   (a, b, res), halves))
                    elif f.kind != "prior":
                        ls.append(depth_row_launch(state, f.obs, opts, f.kind == "depth_mesh",
                                                   (a, b, res), halves))
                    else:
                        ls.append(prior_row_launch(state, f.obs, f.weight, f.th, (b, res),
                                                   halves))
                    jc.append(a)
                    jp.append(b)
                launches.append((dev == lead, ls))
                J.append((jc, jp))
                r.append(flat)

            def launch(halt, flip):
                for dst, src in copies:
                    dst.copy_(src)
                for here, ls in launches:
                    for fn in ls:
                        fn(halt if here else None, flip)
            return launch, cam_vec, pts, J, r

        on_card = indexed_device(device).type == "cuda"
        lead = indexed_device(device)
        st = lm_step.LMState(dtype, device, layout.total, num_points)
        halves = J_t = r_t = None
        if on_card:
            # the current point, its blocks and residual and the trial's in the
            # two halves of one allocation a device: the state's sel, which
            # every kernel of the loop reads, picks the current half, and an
            # accepted step flips it; the kernels' tables hold half 0
            halves = lm_step.Halves(st)
            rows_at, cam, points, J, r = row_launches(halves)
            cam.copy_(cam0)
            points.copy_(points0)
            rows_at(None, 0)
        else:
            cam, points = cam0, points0
            J, r = blocks_at(cam, points)
        lm_step.init(st, mesh, r, lam0)

        def current(sel: int):
            """(cam, points, J) as plain PyTorch reads them: on the card the
            views of half ``sel`` (which the host learns at its read of the
            state), on the CPU the accept's own."""
            if not on_card:
                return cam, points, J
            return (halves.pair(cam)[sel], halves.pair(points)[sel],
                    [tuple([None if a is None else halves.pair(a)[sel] for a in side]
                           for side in sj) for sj in J])

        # the assembly kernel's table and buffers, the one-launch CG's
        # buffers, kept over the solve
        asm_plan = assembly.AssemblyPlan()
        solve_buffers = cg_solve.SolveBuffers()
        system = bound_system = None
        bounded = lower is not None or upper is not None
        no_cg = torch.zeros((), dtype=torch.int64, device=device)
        one_launch = linear_solver == "cg_blocks" and mesh.size == 1
        # the host reads the LM state every LM_CHECK_EVERY iterations where an
        # iteration has no sync of its own and every launch tests the stop
        # flag (one shard of cg_blocks), else every iteration; on the card the
        # other linear solvers read the blocks in plain PyTorch, in the half
        # that read found current (every iteration, debug_unroll_lm too)
        check_every = LM_CHECK_EVERY if one_launch else 1
        host_sel = on_card and linear_solver != "cg_blocks"
        iterations = cg_total = sel = 0
        n_iter = debug_unroll_lm or max_iterations

        for it in range(n_iter):
            # after done the iterations up to the next read are no-ops: the
            # kernels return at once where the state's halt flag is set; the
            # CPU reads it here (for free)
            if not lm_step.halted(st):
                # what plain PyTorch reads of the current point and blocks
                cam_pl, pts_pl, J_pl = current(sel) if host_sel else (cam, points, J)
                # the products with J and J^T of this iteration: the row
                # blocks, or in "cg" mode the residual function linearized here
                if linear_solver == "cg":
                    r_lin, vjp_fn = torch.func.vjp(residual_fn, cam_pl, pts_pl)
                    lin_at = (cam_pl, pts_pl)

                    def Jx(xc, xp):
                        t = (torch.zeros_like(cam_pl) if xc is None else xc,
                             torch.zeros_like(pts_pl) if xp is None else xp)
                        return [torch.func.jvp(residual_fn, lin_at, t)[1]]

                    def JTc(u):
                        return vjp_fn(u[0])[0]

                    def JTp(u):
                        return vjp_fn(u[0])[1]

                    gc_raw, g_p = vjp_fn(r_lin)
                    g_c = gc_raw * cam_free
                else:
                    Jx, JTc, JTp = (functools.partial(fn, J_pl) for fn in (Jmv, JTmv_c, JTmv_p))

                # the gradient (but in "cg"), Hpp, the Jacobi diagonal,
                # Hpp^-1, dc and the preconditioner: csrc/lm_assembly.cu on
                # the card, plain on the CPU
                asm = assembly.assemble(mesh, shards, J, None if linear_solver == "cg" else r,
                                        cam_free, st.lam, num_ref, num_points, block_precond,
                                        st.singular, asm_plan, st.halt, halves)
                if linear_solver != "cg":
                    g_c, g_p = asm.g_c, asm.g_p
                cam_diag, pt_diag, hpp_inv, dc = asm.cam_diag, asm.pt_diag, asm.hpp_inv, asm.dc

                def solve3(rhs):
                    return smv.solve3(hpp_inv, rhs)

                M = cg.Preconditioner(asm.precond, asm.pose_inv)
                solved = None
                if linear_solver == "dense_schur":
                    dc_step = dense_schur_solve(J_pl, hpp_inv, cam_free, dc, -(
                        g_c - JTc(Jx(None, solve3(g_p))) * cam_free))
                    cg_k = no_cg
                else:
                    if linear_solver == "cg_blocks":
                        # S x, its right-hand side and the back-substitution's
                        # product: csrc/schur_mv.cu on the card, plain on the
                        # CPU (on the card J, dc and Hpp^-1 keep their tensors
                        # over the solve, and so the system its tables)
                        if not (system and system.J is J and system.dc is dc
                                and system.hpp_inv is hpp_inv):
                            system = smv.SchurSystem(mesh, shards, J, cam_free, dc, hpp_inv,
                                                     num_ref, halves)

                        def schur_mv(x):
                            nonlocal matvecs
                            matvecs += 1
                            return smv.schur_matvec(system, x)

                        if mesh.size == 1:
                            # the right-hand side, the CG, the
                            # back-substitution's product and the trial
                            # point: one launch of csrc/schur_mv.cu's
                            # cg_solve_kernel on the card, the plain loop
                            # and lm_step.trial_plain on the CPU
                            solved = cg_solve.solve(system, g_c, g_p, M, cg_iterations,
                                                    cg_tolerance, CG_CHECK_EVERY, debug_force_cg,
                                                    schur_mv, solve_buffers, st.halt,
                                                    cg_solve.TrialInputs(st, cam, points, lower,
                                                                         upper, halves))
                            dc_step, cg_k = solved.x, solved.count
                        else:
                            rhs = smv.schur_rhs(system, g_c, g_p)
                    else:
                        # the camera side on dense blocks in "cg_dense_j", by
                        # the linearization in "cg"; the point side is the row blocks'
                        if linear_solver == "cg_dense_j":
                            dense = densify(J_pl)
                            cg_Jx = functools.partial(Jmv, J_pl, dense=dense)
                            cg_JTc = functools.partial(JTmv_c, J_pl, dense=dense)
                        else:
                            cg_Jx, cg_JTc = Jx, JTc

                        def schur_mv(x):
                            nonlocal matvecs
                            matvecs += 1
                            u = cg_Jx(x * cam_free, None)
                            w = solve3(JTp(u))
                            z = cg_Jx(None, w)
                            return cg_JTc(rsub(u, z)) * cam_free + dc * x

                        # rhs = -(g_c - E Hpp^-1 g_p)
                        rhs = -(g_c - cg_JTc(cg_Jx(None, solve3(g_p))) * cam_free)
                    if solved is None:
                        # the CG's steps: csrc/cg_step.cu on the card, the plain loop on the CPU
                        dc_step, cg_k = cg.pcg(schur_mv, M, rhs, cg_iterations, cg_tolerance,
                                               CG_CHECK_EVERY, debug_force_cg)

                # the back-substitution's product u = J_c (cam_free dc_step), J_p^T u
                if solved is not None:
                    u, jtp_u = solved.u, solved.jtp_u
                elif linear_solver == "cg_blocks":
                    u, jtp_u = smv.row_products(system, dc_step)
                else:
                    u = Jx(dc_step * cam_free, None)
                    jtp_u = JTp(u)

                # the trial point (the one-launch solve's, else
                # csrc/lm_step.cu's trial on the card), its row blocks, then
                # the exact model reduction, the accept and lam:
                # csrc/lm_step.cu on the card, plain on the CPU
                t = solved.trial if solved is not None else lm_step.trial(
                    st, cam, points, dc_step, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                    halves)
                if on_card:
                    rows_at(st.halt, 1)
                else:
                    J_t, r_t = blocks_at(t.cam, t.points)
                # Jd's camera half: u where the step is unbounded (step_c is
                # then cam_free dc_step), else J_c step_c; "cg" takes Jd from
                # its linearization
                jd = None
                if linear_solver == "cg":
                    jd = Jx(t.step_c, t.dp) if bounded else \
                        [a + b for a, b in zip(u, Jx(None, t.dp))]
                elif bounded and linear_solver == "cg_blocks":
                    if not (bound_system and bound_system.J is J and bound_system.dc is dc
                            and bound_system.hpp_inv is hpp_inv):
                        # the products with every camera column (cam_free = 1),
                        # into tensors of the solve's own on the card
                        bound_system = smv.SchurSystem(mesh, shards, J, torch.ones_like(cam_free),
                                                       dc, hpp_inv, num_ref, halves)
                        bound_out = None if not on_card else [
                            (torch.empty((num_points, 3), dtype=dtype, device=d),
                             torch.zeros_like(rs)) for d, rs in zip(devs, r)]
                    u = smv.row_products(bound_system, t.step_c, bound_out, st.halt)[0]
                elif bounded:
                    u = Jx(t.step_c, None)
                cam, points, J, r = lm_step.accept(st, mesh, shards, num_ref, J, r, J_t, r_t, t,
                                                   cam, points, g_c, g_p, cam_diag, pt_diag,
                                                   None if jd is not None else u, jd, cg_k,
                                                   not debug_unroll_lm, halves)
            if it + 1 == n_iter or host_sel or (not debug_unroll_lm and
                                                (it + 1) % check_every == 0):
                # the host's read of the state: stop, the counts, the
                # singular flag and the current half
                stop, iterations, cg_total, sel = lm_step.read(st)
                if stop:
                    break

        if one_launch and on_card:
            matvecs += cg_total          # the one-launch CG solves: a matvec a step
        # the result from the half the last read found current (on the card
        # copies: the halves' allocation is the solve's)
        cam, points, _ = current(sel)
        if on_card:
            cam, points = cam.clone(), points.clone()
        return SchurLMResult(cam, points, st.cost.clone(),
                             st.values[lm_step.C0].to(dtype, copy=True),
                             iterations, st.lam.clone(),
                             torch.full((), cg_total, dtype=torch.int64, device=device),
                             matvecs)

    return lm_solve
