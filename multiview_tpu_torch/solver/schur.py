"""Schur-complement Levenberg-Marquardt for bundle adjustment, ``cg_blocks``
mode. Port of ``multiview_tpu/solver/schur.py::make_schur_solver`` (the
counterpart of Ceres' ITERATIVE_SCHUR + SCHUR_JACOBI, the reference's
solver choice, rig_calibrator.cc:1909-1919).

Structure points are eliminated exactly and the reduced camera system is
solved by preconditioned CG on the explicit per-row block Jacobians:

- each LM iteration evaluates, per observation row, the robustified
  residual and its Jacobian with respect to the parameter blocks the row
  touches (pixel rows: beg/end pose, rig, offset, focal, centre,
  distortion; depth rows: beg/end pose, rig, offset, depth_to_image, depth
  scale; point), by reverse-mode autograd of the row-summed residuals with per-row leaf
  copies of the parameters;
- camera columns are gathered per row by the bracketing pose indices and
  reduced back with ``index_add_`` per pose (per-sensor constant columns
  are plain sums); point sides are ``index_add_`` per point;
- Hpp [P,3,3], the Jacobi diagonal and the 7x7 SCHUR_JACOBI pose blocks are
  assembled once per LM iteration, Hpp+lam*D inverted in closed form.

The CG loop runs its fixed ``cg_iterations`` budget with convergence applied
as a mask (no host round trip inside CG); the LM loop syncs with the host
once per iteration for its stop test. Every residual family of the problem
is supported: pixel reprojection, depth against the triangulated point,
depth against the mesh (camera side only: it touches no point) and xyz
priors (point side only).

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.parallel.sharding import ShardMesh, ShardedPixelObs


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
# Per-row residuals + block Jacobians
# ----------------------------------------------------------------------------


def _row_jacobians(res: torch.Tensor, inputs: Sequence[torch.Tensor]):
    """Per-row Jacobians of res [N,k] w.r.t. per-row leaf inputs [N,...]:
    row n of the gradient of sum_n res[n,c] is d res[n,c] / d input[n].
    Returns one [N,k,...] tensor per input."""
    k = res.shape[1]
    cols = []
    for c in range(k):
        g = torch.autograd.grad(res[:, c].sum(), inputs, retain_graph=c < k - 1,
                                allow_unused=True)
        cols.append([torch.zeros_like(x) if gi is None else gi
                     for gi, x in zip(g, inputs)])
    return [torch.stack([cols[c][i] for c in range(k)], dim=1) for i in range(len(inputs))]


def _rows_of(x: torch.Tensor, n: int):
    """A per-row leaf copy [n, ...] of a shared parameter block."""
    return x.detach().expand((n,) + tuple(x.shape)).clone().requires_grad_(True)


def pixel_row_blocks(state: prob.RigState, obs: prob.PixelObs, model: str,
                     opts: prob.BAOptions):
    """(J_cam [N,2,B], J_pt [N,2,3], res [N,2]) of every row, B = 25 + d
    (beg7, end7, rig7, offset1, focal1, ctr2, dist d)."""
    s = obs.sensor
    n = len(obs)
    with torch.enable_grad():
        beg = state.world_to_ref[obs.beg_idx].detach().requires_grad_(True)
        end = state.world_to_ref[obs.end_idx].detach().requires_grad_(True)
        rig = _rows_of(state.ref_to_cam[s], n)
        off = _rows_of(state.timestamp_offsets[s], n)
        foc = _rows_of(state.focal[s], n)
        ctr = _rows_of(state.optical_center[s], n)
        dist = _rows_of(state.dist[s], n)
        pt = state.points[obs.point_idx].detach().requires_grad_(True)
        w2c = pose_mod.world_to_cam_from_bracket(beg, end, rig, obs.dt_cam,
                                                 obs.dt_bracket, off)
        pred = prob.project_rows(w2c, pt, foc, ctr, dist, obs.dist_half_size, model)
        res = pred - obs.pix
        w = prob.robust_weight(torch.sum(res * res, dim=-1), opts.robust_threshold)
        res = res * (w * obs.mask.to(res.dtype))[:, None]
        jb, je, jr, jo, jf, jc, jd, jp = _row_jacobians(
            res, (beg, end, rig, off, foc, ctr, dist, pt))
    j_cam = torch.cat([jb, je, jr, jo[..., None], jf[..., None], jc, jd], dim=-1)
    return j_cam.detach(), jp.detach(), res.detach()


def depth_row_blocks(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
                     mesh_variant: bool):
    """(J_cam [N,3,B], J_pt [N,3,3] | None, res [N,3]) of every depth row,
    B = 7+7+7+1 + (7|12) + 1 (beg7, end7, rig7, offset1, depth_to_image,
    scale1). The mesh variant (target = the row's mesh point) touches no
    structure point: its J_pt is None."""
    s = obs.sensor
    n = len(obs)
    weight = opts.depth_mesh_weight if mesh_variant else opts.depth_tri_weight
    if mesh_variant:
        if obs.mesh_xyz is None:
            raise ValueError("the depth-mesh family needs DepthObs.mesh_xyz")
        row_mask, target = prob.mesh_target(obs)
    else:
        row_mask = obs.mask
    with torch.enable_grad():
        beg = state.world_to_ref[obs.beg_idx].detach().requires_grad_(True)
        end = state.world_to_ref[obs.end_idx].detach().requires_grad_(True)
        rig = _rows_of(state.ref_to_cam[s], n)
        off = _rows_of(state.timestamp_offsets[s], n)
        d2i = _rows_of(state.depth_to_image[s], n)
        dsc = _rows_of(state.depth_scale[s], n)
        inputs = [beg, end, rig, off, d2i, dsc]
        if not mesh_variant:
            target = state.points[obs.point_idx].detach().requires_grad_(True)
            inputs.append(target)
        w2c = pose_mod.world_to_cam_from_bracket(beg, end, rig, obs.dt_cam,
                                                 obs.dt_bracket, off)
        M_world = prob.depth_world_points(w2c, d2i, dsc, obs.depth_xyz,
                                          opts.affine_depth_to_image)
        res = weight * (target - M_world)
        w = prob.robust_weight(torch.sum(res * res, dim=-1), opts.robust_threshold)
        res = res * (w * row_mask.to(res.dtype))[:, None]
        jac = _row_jacobians(res, inputs)
    jb, je, jr, jo, jd, js = jac[:6]
    j_cam = torch.cat([jb, je, jr, jo[..., None], jd, js[..., None]], dim=-1)
    j_pt = None if mesh_variant else jac[6].detach()
    return j_cam.detach(), j_pt, res.detach()


def prior_row_blocks(state: prob.RigState, prior: prob.XyzPriorObs,
                     weight: float, th: float):
    """(J_pt [M,3,3], res [M,3]) of an xyz-prior family (XYZError),
    numerically identical to ``prob.xyz_prior_residuals``."""
    with torch.enable_grad():
        pt = state.points[prior.point_idx].detach().requires_grad_(True)
        res = weight * (pt - prior.ref_xyz)
        m = prior.mask.to(res.dtype)
        if th <= 0:
            res = res * m[:, None]
        else:
            res = res * (prob.robust_weight(torch.sum(res * res, dim=-1), th) * m)[:, None]
        (jp,) = _row_jacobians(res, (pt,))
    return jp.detach(), res.detach()


def inv3x3_spd(A):
    """Batched closed-form inverse of damped SPD 3x3 blocks [P,3,3] by the
    diagonally normalized adjugate (A = D An D, An unit-diagonal); blocks
    with det <= 0 (rounding noise on numerically singular blocks) get a zero
    inverse."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1), 1e-32))
    S = d[..., :, None] * d[..., None, :]
    M = A / S
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    dd, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = e * i - f * h
    c10 = f * g - dd * i
    c20 = dd * h - e * g
    det = a * c00 + b * c10 + c * c20
    ok = det > 0.0
    inv_det = torch.where(ok, torch.ones_like(det), torch.zeros_like(det)) / \
        torch.where(ok, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([c00, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([c10, a * i - c * g, c * dd - a * f], dim=-1),
        torch.stack([c20, b * g - a * h, a * e - b * dd], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None] / S


# ----------------------------------------------------------------------------
# The solver
# ----------------------------------------------------------------------------


class SchurLMResult(NamedTuple):
    cam: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int
    lam: torch.Tensor
    cg_iters_total: torch.Tensor


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
                      preconditioner: str = "auto"):
    """Build a Schur-LM solve function
    ``(cam_vec0, points0, observations=None, cam_mask_rt=None) -> SchurLMResult``.

    ``cam_mask``: free mask over the camera vector (points always free).
    Observations passed at solve time must keep the template's family
    structure (sensors, priors); their index arrays, masks and measurements
    are free to differ. ``preconditioner``: "jacobi", "schur_jacobi" or
    "auto" (jacobi for cg_tolerance >= 0.01, as the reference picks)."""
    layout = cam_layout(template)
    num_points = template.points.shape[0]
    num_ref = template.world_to_ref.shape[0]
    dtype, device = template.dtype, template.device
    cam_free_default = torch.as_tensor(np.asarray(cam_mask, np.float64), dtype=dtype,
                                       device=device)
    if preconditioner == "auto":
        preconditioner = "jacobi" if cg_tolerance >= 0.01 else "schur_jacobi"
    use_block_precond = preconditioner == "schur_jacobi"

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

    def project(cam_vec):
        if lower is not None:
            cam_vec = torch.maximum(cam_vec, lower)
        if upper is not None:
            cam_vec = torch.minimum(cam_vec, upper)
        return cam_vec

    def lm_solve(cam0, points0, obs=None, cam_mask_rt=None) -> SchurLMResult:
        if obs is None:
            obs = observations
        cam_free = (torch.as_tensor(np.asarray(cam_mask_rt, np.float64), dtype=dtype,
                                    device=device)
                    if cam_mask_rt is not None else cam_free_default)
        mesh, shards = shard_families(obs)
        with torch.no_grad():
            return _solve(cam0, points0, mesh, shards, cam_free)

    def _solve(cam0, points0, mesh: ShardMesh, shards: List[List[_Family]],
               cam_free) -> SchurLMResult:
        """The LM loop. Row-space quantities (Jacobian blocks, residuals,
        ``u``) are lists with one entry per local shard, on its device;
        camera- and point-space vectors are replicated on the lead device,
        and every sum of row-space partials goes through ``mesh.sum``. Dots
        of replicated vectors are taken once, never summed over shards."""
        free_pose = cam_free[:num_ref * 7].reshape(num_ref, 7)
        devs = mesh.devices

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

        def split(u, jc, jp):
            """Flat residual-space vector -> per-family [n,k] blocks."""
            out, off = [], 0
            for a, b in zip(jc, jp):
                n, k = (b if a is None else a).shape[:2]
                out.append(u[off:off + n * k].reshape(n, k))
                off += n * k
            return out

        def gather_cols(f: _Family, xc):
            """Each row's camera sub-vector [N,B] (pose columns by index)."""
            wref = xc[:num_ref * 7].reshape(num_ref, 7)
            n = f.beg_idx.shape[0]
            return torch.cat([wref[f.beg_idx], wref[f.end_idx],
                              xc[f.const_cols].expand(n, -1)], dim=-1)

        def reduce_cols(contribs, dev):
            """[(family, [N,B])] -> [C] on ``dev``: index_add_ per pose for the
            pose columns, plain sums for the per-sensor constant columns."""
            gc = torch.zeros(layout.total, dtype=dtype, device=dev)
            gpose = torch.zeros((num_ref, 7), dtype=dtype, device=dev)
            for f, c in contribs:
                gpose.index_add_(0, f.beg_idx, c[:, :7])
                gpose.index_add_(0, f.end_idx, c[:, 7:14])
                gc.index_add_(0, f.const_cols, c[:, 14:].sum(0))
            gc[:num_ref * 7] += gpose.reshape(-1)
            return gc

        def Jmv(J, xc, xp):
            """J @ (xc, xp) per shard; None skips that side."""
            out = []
            for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
                xcs, xps = on(xc, s), on(xp, s)
                parts = []
                for f, a, b in zip(fams, jc, jp):
                    u = None
                    if a is not None and xcs is not None:
                        u = torch.einsum("nkb,nb->nk", a, gather_cols(f, xcs))
                    if b is not None and xps is not None:
                        up = torch.einsum("nkj,nj->nk", b, xps[f.point_idx])
                        u = up if u is None else u + up
                    if u is None:
                        u = torch.zeros((b if a is None else a).shape[:2], dtype=dtype,
                                        device=devs[s])
                    parts.append(u.reshape(-1))
                out.append(cat(parts, s))
            return out

        def JTmv_c(J, u):
            partials = []
            for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u)):
                contribs = [(f, torch.einsum("nkb,nk->nb", a, ub))
                            for f, a, ub in zip(fams, jc, split(us, jc, jp)) if a is not None]
                partials.append(reduce_cols(contribs, devs[s]))
            return mesh.sum(partials)

        def JTmv_p(J, u):
            partials = []
            for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u)):
                gp = torch.zeros((num_points, 3), dtype=dtype, device=devs[s])
                for f, b, ub in zip(fams, jp, split(us, jc, jp)):
                    if b is not None:
                        gp.index_add_(0, f.point_idx, torch.einsum("nkj,nk->nj", b, ub))
                partials.append(gp)
            return mesh.sum(partials)

        def dot(a, b):
            """Dot of replicated (camera- or point-space) vectors."""
            return torch.sum(a * b)

        def rdot(a, b):
            """Dot of row-space vectors: per-shard partials summed over the mesh."""
            return mesh.sum([torch.sum(x * y) for x, y in zip(a, b)])

        def rsub(a, b):
            return [x - y for x, y in zip(a, b)]

        J, r = blocks_at(cam0, points0)
        cam, points = cam0, points0
        cost = 0.5 * rdot(r, r)
        c0 = cost
        lam = torch.as_tensor(lam0, dtype=dtype, device=device)
        nu = torch.as_tensor(2.0, dtype=dtype, device=device)
        cg_total = torch.zeros((), dtype=torch.int64, device=device)
        iterations = 0

        for _ in range(max_iterations):
            g_c = JTmv_c(J, r) * cam_free
            g_p = JTmv_p(J, r)

            hpp_parts, diag_parts = [], []
            for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
                hpp = torch.zeros((num_points, 3, 3), dtype=dtype, device=devs[s])
                for f, b in zip(fams, jp):
                    if b is not None:
                        hpp.index_add_(0, f.point_idx, torch.einsum("nki,nkj->nij", b, b))
                hpp_parts.append(hpp)
                diag_parts.append(reduce_cols([(f, torch.sum(a * a, dim=1))
                                               for f, a in zip(fams, jc) if a is not None],
                                              devs[s]))
            hpp = mesh.sum(hpp_parts)
            cam_diag = torch.clamp(mesh.sum(diag_parts), 1e-12, 1e32)
            pt_diag = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), 1e-12, 1e32)
            hpp_inv = inv3x3_spd(hpp + torch.diag_embed(lam * pt_diag))

            def solve3(rhs):
                return torch.einsum("pij,pj->pi", hpp_inv, rhs)

            dc = lam * cam_diag * cam_free + (1.0 - cam_free)
            precond = 1.0 / (cam_diag * cam_free + dc)

            if use_block_precond:
                # SCHUR_JACOBI: exact-per-row 7x7 pose blocks of
                # S = B - E Hpp^-1 E^T; non-pose parameters stay scalar. A
                # second round over the shards: each row's E Hpp^-1 E^T reads
                # the summed Hpp
                block_parts = []
                for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
                    fp, hi = on(free_pose, s), on(hpp_inv, s)
                    blocks = torch.zeros((num_ref, 7, 7), dtype=dtype, device=devs[s])
                    for f, a, b in zip(fams, jc, jp):
                        if a is None:
                            continue
                        for sl, idx in ((slice(0, 7), f.beg_idx), (slice(7, 14), f.end_idx)):
                            jb = a[:, :, sl] * fp[idx][:, None, :]              # [N,k,7]
                            bb = torch.einsum("nki,nkj->nij", jb, jb)
                            if b is not None:
                                E = torch.einsum("nki,nkm->nim", jb, b)         # [N,7,3]
                                bb = bb - torch.einsum("nim,nmq,njq->nij", E,
                                                       hi[f.point_idx], E)
                            blocks.index_add_(0, idx, bb)
                    block_parts.append(blocks)
                blocks = mesh.sum(block_parts) + torch.diag_embed(
                    dc[:num_ref * 7].reshape(num_ref, 7))
                pose_prec_inv = torch.linalg.inv(blocks)
                rest_precond = precond[num_ref * 7:]

                def precond_apply(v):
                    vp = torch.einsum("rij,rj->ri", pose_prec_inv,
                                      v[:num_ref * 7].reshape(num_ref, 7))
                    return torch.cat([vp.reshape(-1), v[num_ref * 7:] * rest_precond])
            else:
                def precond_apply(v):
                    return precond * v

            def schur_mv(x):
                u = Jmv(J, x * cam_free, None)
                w = solve3(JTmv_p(J, u))
                z = Jmv(J, None, w)
                return JTmv_c(J, rsub(u, z)) * cam_free + dc * x

            # rhs = -(g_c - E Hpp^-1 g_p)
            gc0 = JTmv_c(J, Jmv(J, None, solve3(g_p)))
            rhs = -(g_c - gc0 * cam_free)

            # PCG, fixed budget, convergence as a mask
            x = torch.zeros_like(rhs)
            rr = rhs
            zz = precond_apply(rr)
            p = zz
            rz = dot(rr, zz)
            stop2 = cg_tolerance ** 2 * dot(rhs, rhs)
            active = torch.ones((), dtype=torch.bool, device=device)
            cg_k = torch.zeros((), dtype=torch.int64, device=device)
            for _k in range(cg_iterations):
                active = active & (dot(rr, rr) > stop2)
                Ap = schur_mv(p)
                denom = dot(p, Ap)
                pos = denom > 0
                alpha = torch.where(pos, rz / torch.where(pos, denom, torch.ones_like(denom)),
                                    torch.zeros_like(denom))
                x_n = x + alpha * p
                rr_n = rr - alpha * Ap
                zz = precond_apply(rr_n)
                rz_n = dot(rr_n, zz)
                beta = rz_n / torch.where(rz > 0, rz, torch.ones_like(rz))
                p_n = zz + beta * p
                x = torch.where(active, x_n, x)
                rr = torch.where(active, rr_n, rr)
                p = torch.where(active, p_n, p)
                rz = torch.where(active, rz_n, rz)
                cg_k = cg_k + active.to(torch.int64)
            dc_step = x

            # back-substitute points: dp = Hpp^-1 (-g_p - Jp^T Jc dc)
            u = Jmv(J, dc_step * cam_free, None)
            dp = solve3(-g_p - JTmv_p(J, u))

            cam_new = project(cam + dc_step * cam_free)
            pts_new = points + dp
            J_t, r_t = blocks_at(cam_new, pts_new)
            new_cost = 0.5 * rdot(r_t, r_t)

            # exact model reduction: -g.d - 0.5|Jd|^2 - 0.5 lam d'Dd
            step_c = cam_new - cam
            if lower is None and upper is None:
                Jd = [a + b for a, b in zip(u, Jmv(J, None, dp))]
            else:
                Jd = Jmv(J, step_c, dp)
            pred = -(dot(step_c, g_c) + dot(dp, g_p)) - 0.5 * rdot(Jd, Jd) \
                - 0.5 * lam * (dot(cam_diag * step_c, step_c) + dot(pt_diag * dp, dp))
            good = (new_cost < cost) & torch.isfinite(new_cost)
            rho = (cost - new_cost) / torch.clamp_min(torch.abs(pred), 1e-30)
            lam_dec = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            lam_new = torch.where(good, torch.clamp_min(lam_dec, 1e-14), lam * nu)
            nu = torch.where(good, torch.full_like(nu, 2.0), nu * 2.0)
            rel_decrease = torch.abs(cost - new_cost) / torch.clamp_min(cost, 1e-30)
            done = (good & (rel_decrease < 1e-10)) | (lam > 1e12)

            cam = torch.where(good, cam_new, cam)
            points = torch.where(good, pts_new, points)
            cost = torch.where(good, new_cost, cost)
            J = [([None if a is None else torch.where(on(good, s), a, a0)
                   for a, a0 in zip(jc_t, jc)],
                  [None if b is None else torch.where(on(good, s), b, b0)
                   for b, b0 in zip(jp_t, jp)])
                 for s, ((jc_t, jp_t), (jc, jp)) in enumerate(zip(J_t, J))]
            r = [torch.where(on(good, s), a, a0) for s, (a, a0) in enumerate(zip(r_t, r))]
            lam = lam_new
            cg_total = cg_total + cg_k
            iterations += 1
            if bool(done):      # the one host sync of an LM iteration
                break

        return SchurLMResult(cam, points, cost, c0, iterations, lam, cg_total)

    return lm_solve
