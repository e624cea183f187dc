"""Per-row robustified residuals and block Jacobians of the BA's residual
families, the rows the Schur solver (``solver/schur.py``) assembles and
multiplies with:

- ``pixel_row_blocks(state, obs, model, opts)`` -> (J_cam [N,2,25+d],
  J_pt [N,2,3], res [N,2]); camera columns beg7, end7, rig7, offset, focal,
  ctr2, dist d (BracketedCamError);
- ``depth_row_blocks(state, obs, opts, mesh_variant)`` -> (J_cam [N,3,B],
  J_pt [N,3,3] or None for the mesh variant, res [N,3]); B = 30 or 35:
  beg7, end7, rig7, offset, depth_to_image 7 (pose) or 12 (affine), scale
  (BracketedDepthError / BracketedDepthMeshError);
- ``prior_row_blocks(state, prior, weight, th)`` -> (J_pt [M,3,3],
  res [M,3]) (XYZError), numerically ``prob.xyz_prior_residuals``.

Each is the counterpart of ``_pixel_row_blocks`` / ``_depth_row_blocks`` /
``_prior_row_blocks`` of ``multiview_tpu/solver/schur.py`` (a vmap of a
jacrev per family). The route is chosen by the tensors' device alone: CPU
tensors take the plain version (``*_plain``: reverse-mode autograd of the
row-summed residuals, one pass per residual component, with per-row leaf
copies of every shared block), CUDA tensors the hand-written kernel
``csrc/row_blocks.cu`` (one launch a family; ``*_cuda``), which raises on
anything it does not take; ``*_row_launch`` binds a family's launch once
(``RowLaunch``: the LM loop's current and trial points, whose tensors stay
over a solve, evaluated into fixed outputs, a launch returning at once
where the loop's stop flag is set). The kernel evaluates each row's residual chain
once, differentiates its tail (projection, distortion, Cauchy weight) once
and seeds only the head's blocks (poses, rig, offset), and stores its
outputs from shared memory in contiguous spans (see the source). It takes
every distortion model (rpc up to degree 8) and computes in float64 for
float32 tensors too, rounding its outputs: in float32 the residuals of
far-from-origin rigs err by a few 1e-4 of their largest value, the plain
version's float32 results as much.
``LAUNCHES`` counts the kernel's launches."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import distortion as dist_mod, pose as pose_mod
from multiview_tpu_torch.utils import cuda_build
from multiview_tpu_torch.utils.device import indexed_device as _device

SOURCE = "row_blocks.cu"
# kernel launches of csrc/row_blocks.cu, one a family
LAUNCHES = 0
# the kernel's model code for each distortion model and coefficient count (rpc: any
# count of a degree from 1 to RPC_MAX_DEGREE, both halves)
_MODEL_CODES = {("none", 0): 0, ("fov", 1): 1, ("tsai", 4): 2, ("tsai", 5): 3}
_RPC = 4
RPC_MAX_DEGREE = 8
_PIXEL, _DEPTH, _PRIOR = 0, 1, 2


def model_code(model: str, d: int) -> int:
    """The kernel's code of a pixel family's distortion model with ``d``
    coefficients; raises ValueError for one the kernel does not take."""
    if model == "rpc" and d % 2 == 0 and d > 5:
        deg = dist_mod.rpc_degree_from_num_params(d // 2)
        if dist_mod.rpc_num_params_from_degree(deg) == d // 2 and 1 <= deg <= RPC_MAX_DEGREE:
            return _RPC
    if (model, d) not in _MODEL_CODES:
        raise ValueError(f"row_blocks kernel (pixel): model {model!r} with {d} coefficients "
                         f"has no kernel (it takes none / fov 1 / tsai 4 or 5 / rpc of degree "
                         f"1 to {RPC_MAX_DEGREE})")
    return _MODEL_CODES[(model, d)]


# ----------------------------------------------------------------------------
# The plain version (autograd)
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


def pixel_row_blocks_plain(state: prob.RigState, obs: prob.PixelObs, model: str,
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


def depth_row_blocks_plain(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
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


def prior_row_blocks_plain(state: prob.RigState, prior: prob.XyzPriorObs,
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


# ----------------------------------------------------------------------------
# The kernel (csrc/row_blocks.cu)
# ----------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """``RowBlocksArgs`` of csrc/row_blocks.cu, field for field."""

    _fields_ = ([(name, ctypes.c_int) for name in
                 ("family", "elem", "model", "affine", "mesh", "robust", "ndist")]
                + [("n", ctypes.c_longlong), ("weight", ctypes.c_double),
                   ("threshold", ctypes.c_double)]
                + [(name, ctypes.c_void_p) for name in
                   ("poses", "beg", "end", "points", "pidx", "dt_cam", "dt_bracket", "mask",
                    "rig", "offset", "pix", "focal", "ctr", "dist", "dist_half", "depth_xyz",
                    "d2i", "dscale", "mesh_xyz", "mesh_mask", "ref_xyz", "res", "j_cam",
                    "j_pt", "halt")])


def _lib():
    lib = cuda_build.load_library(SOURCE)
    if lib.mv_row_blocks.argtypes is None:
        p = ctypes.c_void_p
        lib.mv_row_blocks.argtypes = [ctypes.POINTER(_Args), p]
        lib.mv_row_blocks.restype = ctypes.c_int
    return lib


class _Checker:
    """Checks each tensor the kernel reads against the family's device,
    dtype and shape, and returns its address; ``_launch`` refuses a device
    that is not a card, after every other check."""

    def __init__(self, family: str, like: torch.Tensor):
        self.family = family
        self.dev = _device(like.device)
        self.dtype = like.dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"row_blocks kernel ({family}): float32 or float64, "
                            f"got {self.dtype}")

    def on_card(self) -> None:
        if self.dev.type != "cuda":
            raise ValueError(f"row_blocks kernel ({self.family}): the tensors lie on "
                             f"{self.dev}, not on a CUDA device")

    def __call__(self, name: str, t: Optional[torch.Tensor], shape, dtype=None) -> int:
        dtype = self.dtype if dtype is None else dtype
        where = f"row_blocks kernel ({self.family}): {name}"
        if t is None:
            raise ValueError(f"{where} is missing")
        if t.dtype != dtype:
            raise TypeError(f"{where} is {t.dtype}, expected {dtype}")
        if _device(t.device) != self.dev:
            raise ValueError(f"{where} lies on {t.device}, expected {self.dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{where} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{where} is not contiguous")
        return t.data_ptr()


def _bracket(chk: _Checker, a: _Args, state: prob.RigState, obs, n: int):
    """The fields every pixel and depth row reads: poses, bracket, rig, offset."""
    s = obs.sensor
    a.n = n
    a.poses = chk("world_to_ref", state.world_to_ref, (state.world_to_ref.shape[0], 7))
    a.beg = chk("beg_idx", obs.beg_idx, (n,), torch.int64)
    a.end = chk("end_idx", obs.end_idx, (n,), torch.int64)
    a.dt_cam = chk("dt_cam", obs.dt_cam, (n,))
    a.dt_bracket = chk("dt_bracket", obs.dt_bracket, (n,))
    a.mask = chk("mask", obs.mask, (n,), torch.bool)
    a.rig = chk("ref_to_cam[sensor]", state.ref_to_cam[s], (7,))
    a.offset = chk("timestamp_offsets", state.timestamp_offsets,
                   (state.timestamp_offsets.shape[0],)) + s * state.dtype.itemsize


def _outputs(chk: _Checker, res, shapes):
    """The launch's outputs (shapes: the blocks', None where the family has
    no such block, then the residual's): new tensors, but the residual where
    the caller gives ``res`` (checked: a span of its flat residual)."""
    *blocks, res_shape = shapes
    if res is None:
        res = torch.empty(res_shape, dtype=chk.dtype, device=chk.dev)
    else:
        chk("the output res", res, res_shape)
    return tuple(None if sh is None else torch.empty(sh, dtype=chk.dtype, device=chk.dev)
                 for sh in blocks) + (res,)


def _launch(chk: _Checker, a: _Args) -> None:
    global LAUNCHES
    chk.on_card()
    if a.n == 0:
        return
    a.elem = chk.dtype.itemsize
    with torch.cuda.device(chk.dev):
        err = _lib().mv_row_blocks(ctypes.byref(a),
                                   torch.cuda.current_stream(chk.dev).cuda_stream)
    if err != 0:
        what = "no kernel for these arguments" if err < 0 else f"cudaError {err}"
        raise RuntimeError(f"row_blocks kernel ({chk.family}) failed: {what}")
    LAUNCHES += 1


def _pixel_args(state: prob.RigState, obs: prob.PixelObs, model: str, opts: prob.BAOptions,
                res=None):
    """(checker, args, outputs) of a pixel family (``res``: see ``_outputs``)."""
    n = len(obs)
    s = obs.sensor
    chk = _Checker("pixel", state.world_to_ref)
    d = int(state.dist[s].numel())
    a = _Args(family=_PIXEL, model=model_code(model, d), ndist=d)
    _bracket(chk, a, state, obs, n)
    a.threshold = float(opts.robust_threshold)
    a.points = chk("points", state.points, (state.points.shape[0], 3))
    a.pidx = chk("point_idx", obs.point_idx, (n,), torch.int64)
    a.pix = chk("pix", obs.pix, (n, 2))
    a.focal = chk("focal", state.focal, (state.focal.shape[0],)) + s * state.dtype.itemsize
    a.ctr = chk("optical_center[sensor]", state.optical_center[s], (2,))
    a.dist = chk("dist[sensor]", state.dist[s], (d,)) if d else None
    a.dist_half = chk("dist_half_size", obs.dist_half_size, (2,))
    out = _outputs(chk, res, ((n, 2, 25 + d), (n, 2, 3), (n, 2)))
    a.j_cam, a.j_pt, a.res = (t.data_ptr() for t in out)
    return chk, a, out


def pixel_row_blocks_cuda(state: prob.RigState, obs: prob.PixelObs, model: str,
                          opts: prob.BAOptions):
    """``pixel_row_blocks`` on the card: one launch of csrc/row_blocks.cu."""
    return pixel_row_launch(state, obs, model, opts)()


def _depth_args(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
                mesh_variant: bool, res=None):
    n = len(obs)
    s = obs.sensor
    chk = _Checker("depth", state.world_to_ref)
    nd = 12 if opts.affine_depth_to_image else 7
    a = _Args(family=_DEPTH, affine=int(nd == 12), mesh=int(mesh_variant))
    _bracket(chk, a, state, obs, n)
    a.threshold = float(opts.robust_threshold)
    a.weight = float(opts.depth_mesh_weight if mesh_variant else opts.depth_tri_weight)
    a.depth_xyz = chk("depth_xyz", obs.depth_xyz, (n, 3))
    a.d2i = chk("depth_to_image[sensor]", state.depth_to_image[s], (nd,))
    a.dscale = chk("depth_scale", state.depth_scale,
                   (state.depth_scale.shape[0],)) + s * state.dtype.itemsize
    if mesh_variant:
        if obs.mesh_xyz is None:
            raise ValueError("the depth-mesh family needs DepthObs.mesh_xyz")
        a.mesh_xyz = chk("mesh_xyz", obs.mesh_xyz, (n, 3))
        if obs.mesh_mask is not None:
            a.mesh_mask = chk("mesh_mask", obs.mesh_mask, (n,), torch.bool)
    else:
        a.points = chk("points", state.points, (state.points.shape[0], 3))
        a.pidx = chk("point_idx", obs.point_idx, (n,), torch.int64)
    j_cam, j_pt, res = _outputs(chk, res, ((n, 3, 23 + nd), None if mesh_variant else (n, 3, 3),
                                           (n, 3)))
    a.j_cam, a.res = j_cam.data_ptr(), res.data_ptr()
    a.j_pt = None if j_pt is None else j_pt.data_ptr()
    return chk, a, (j_cam, j_pt, res)


def depth_row_blocks_cuda(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
                          mesh_variant: bool):
    """``depth_row_blocks`` on the card: one launch of csrc/row_blocks.cu."""
    return depth_row_launch(state, obs, opts, mesh_variant)()


def _prior_args(state: prob.RigState, prior: prob.XyzPriorObs, weight: float, th: float,
                res=None):
    m = prior.point_idx.shape[0]
    chk = _Checker("prior", state.points)
    a = _Args(family=_PRIOR, robust=int(th > 0), n=m, weight=float(weight),
              threshold=float(th) if th > 0 else 0.0)
    a.points = chk("points", state.points, (state.points.shape[0], 3))
    a.pidx = chk("point_idx", prior.point_idx, (m,), torch.int64)
    a.ref_xyz = chk("ref_xyz", prior.ref_xyz, (m, 3))
    a.mask = chk("mask", prior.mask, (m,), torch.bool)
    j_pt, res = _outputs(chk, res, ((m, 3, 3), (m, 3)))
    a.j_pt, a.res = j_pt.data_ptr(), res.data_ptr()
    return chk, a, (j_pt, res)


def prior_row_blocks_cuda(state: prob.RigState, prior: prob.XyzPriorObs, weight: float,
                          th: float):
    """``prior_row_blocks`` on the card: one launch of csrc/row_blocks.cu."""
    return prior_row_launch(state, prior, weight, th)()


class RowLaunch:
    """One family's launch of csrc/row_blocks.cu with its arguments checked
    and bound once (``*_row_launch``): the LM loop on the card evaluates its
    current and its trial point into the same tensors every iteration, so a
    call is the launch alone. ``out``: the outputs, as the family's entry
    point returns them."""

    def __init__(self, chk: _Checker, args: _Args, out):
        self.chk, self.args, self.out = chk, args, out

    def __call__(self, halt: Optional[torch.Tensor] = None):
        """Launches (``halt``: the LM loop's stop flag, an int32 0-d tensor on
        the family's device; where set the launch returns at once) and
        returns ``out``."""
        if halt is not None:
            self.chk("the stop flag", halt, (), torch.int32)
        self.args.halt = None if halt is None else halt.data_ptr()
        _launch(self.chk, self.args)
        return self.out


def pixel_row_launch(state: prob.RigState, obs: prob.PixelObs, model: str,
                     opts: prob.BAOptions, res=None) -> RowLaunch:
    """A pixel family's ``RowLaunch`` at ``state`` (its tensors read at each
    launch), writing its blocks into new tensors and its residual into
    ``res`` (None: a new tensor); ``RowLaunch.out`` holds them."""
    return RowLaunch(*_pixel_args(state, obs, model, opts, res))


def depth_row_launch(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
                     mesh_variant: bool, res=None) -> RowLaunch:
    """As ``pixel_row_launch``; ``out``: (J_cam, J_pt | None, res)."""
    return RowLaunch(*_depth_args(state, obs, opts, mesh_variant, res))


def prior_row_launch(state: prob.RigState, prior: prob.XyzPriorObs, weight: float, th: float,
                     res=None) -> RowLaunch:
    """As ``pixel_row_launch``; ``out``: (J_pt, res)."""
    return RowLaunch(*_prior_args(state, prior, weight, th, res))


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def pixel_row_blocks(state: prob.RigState, obs: prob.PixelObs, model: str,
                     opts: prob.BAOptions):
    """(J_cam [N,2,25+d], J_pt [N,2,3], res [N,2]): the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if state.world_to_ref.device.type == "cpu":
        return pixel_row_blocks_plain(state, obs, model, opts)
    return pixel_row_blocks_cuda(state, obs, model, opts)


def depth_row_blocks(state: prob.RigState, obs: prob.DepthObs, opts: prob.BAOptions,
                     mesh_variant: bool):
    """(J_cam [N,3,30|35], J_pt [N,3,3] | None, res [N,3]), dispatched as
    ``pixel_row_blocks``."""
    if state.world_to_ref.device.type == "cpu":
        return depth_row_blocks_plain(state, obs, opts, mesh_variant)
    return depth_row_blocks_cuda(state, obs, opts, mesh_variant)


def prior_row_blocks(state: prob.RigState, prior: prob.XyzPriorObs, weight: float,
                     th: float):
    """(J_pt [M,3,3], res [M,3]), dispatched as ``pixel_row_blocks``."""
    if state.points.device.type == "cpu":
        return prior_row_blocks_plain(state, prior, weight, th)
    return prior_row_blocks_cuda(state, prior, weight, th)
