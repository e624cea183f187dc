"""The step and the accept of one Levenberg-Marquardt iteration of the BA's
Schur-LM (``solver/schur.py``), after its CG solve; the counterpart of
``multiview_tpu/solver/schur.py:1241-1295``:

- ``trial``: the point step dp = Hpp^-1 (-g_p - J_p^T u), one 3x3 block a
  point; the trial point cam_t = clamp(cam + x * cam_free, lower, upper),
  pts_t = points + dp, and step_c = cam_t - cam;
- ``accept`` (after the row blocks at the trial point): new_cost =
  |r_t|^2 / 2; the exact model reduction pred = -g.d - |Jd|^2 / 2 - lam
  d'Dd / 2 with Jd = u + J_p dp a row (J_p the current blocks; u the CG's
  J_c (cam_free * x), or J_c step_c where the cameras are bounded; the rows
  of Jd as given where ``linear_solver`` "cg" linearizes); good, rho, lam,
  nu, rel_decrease and done; on good the trial's cameras, points, blocks
  and residual become the current ones; the iteration count and the CG
  total;
- ``init``: a solve's start, cost = c0 = |r|^2 / 2, lam0, nu = 2.

Their state (``LMState``) lives on the lead device: float64 slots (the
cost, lam, nu, c0, the counters, the last iteration's new_cost, pred, rho,
good, done and rel_decrease) and two int32 flags, ``halt`` and ``singular``
(which the assembly kernel sets). Where the caller asks for it (``gate``),
accept sets ``halt`` when done (or a block was singular), and every later
launch of the solve returns at once; ``read`` takes the state to the host
in one sync. The cost and every sum that decides good or done is taken in
float64.

On CUDA tensors ``trial`` and ``accept`` launch the hand-written kernel
``csrc/lm_step.cu`` (one launch each on one shard; with several shards a
rows launch a shard, ``ShardMesh.sum`` of their two sums, a scalars launch
on the lead and a copy launch a shard). Its buffers are the ``LMState``'s,
allocated once a solve: the trial's, and the tables, checked at the first
accept of a solve whose blocks keep their tensors (the LM loop on the card
keeps its current and trial blocks in place). An accepted step copies the
trial's blocks over the current ones in the kernel, in place: the other
choice, a device-side index into double buffers, would need no copy but
make the row blocks, assembly and Schur kernels read their blocks through
it, and was not built; an accepted step's copy costs what
``chip_smoke.py`` phase 3g measures against a rejected one. On CPU tensors they run the plain versions (``*_plain``:
the solver's former code, its sums in float64), which honour ``halt`` as
the kernel does where the host reads it for free (CPU tensors; run on the
card, for comparison with the kernel, they read it not, and never sync);
nothing on the card gives way to them. ``LAUNCHES`` counts
the kernel's launches."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.solver import assembly, schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build
from multiview_tpu_torch.utils.device import indexed_device as _device

SOURCE = "lm_step.cu"
# kernel launches of csrc/lm_step.cu, one each
LAUNCHES = 0
# with RECORD_LAUNCH set, the grid and threads of the last accept launch
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
# the state's float64 slots (FLAGS: two int32, halt and singular)
COST, LAM, NU, C0, ITER, CG_TOTAL, NEW_COST, PRED, RHO, GOOD, DONE, REL, FLAGS = range(13)
_SLOTS = 14
_ROWS, _SCALARS, _COPY, _INIT = 1, 2, 4, 8   # the accept kernel's passes
_MAX_FAMILIES = 32
_MAX_COPIES = 80
_PARTIAL_BLOCKS = 8192          # the accept grid's partial sums (the kernel checks its grid)
_F64 = torch.float64


class Trial(NamedTuple):
    cam: torch.Tensor        # [C] cam_t
    points: torch.Tensor     # [P,3] pts_t
    dp: torch.Tensor         # [P,3]
    step_c: torch.Tensor     # [C] cam_t - cam


class LMState:
    """One solve's LM state on ``device``: ``values`` [14] float64 (slots
    above), ``halt`` and ``singular`` (0-d int32 views into it), ``lam`` and
    ``cost`` (0-d views in the solve's dtype, which the assembly and the
    result read). On the card, the trial's buffers for ``num_cam`` camera
    entries and ``num_points`` points and the accept's scratch."""

    def __init__(self, dtype: torch.dtype, device, num_cam: int = 0, num_points: int = 0):
        self.values = torch.zeros(_SLOTS, dtype=_F64, device=device)
        flags = self.values.view(torch.int32)
        self.halt, self.singular = flags[2 * FLAGS], flags[2 * FLAGS + 1]
        self.typed = torch.zeros(2, dtype=dtype, device=device)
        self.lam, self.cost = self.typed[0], self.typed[1]
        self.on_card = self.values.device.type != "cpu"
        self.trial = None
        if self.on_card:
            kw = dict(dtype=dtype, device=device)
            self.trial = Trial(torch.empty(num_cam, **kw), torch.empty((num_points, 3), **kw),
                               torch.empty((num_points, 3), **kw), torch.empty(num_cam, **kw))
            self.partial = torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=device)
        self._plan = None


def halted(st: LMState) -> bool:
    """Whether ``halt`` is set, where the host reads it for free (CPU
    tensors); on the card False: the kernels test it themselves."""
    return not st.on_card and bool(st.halt)


def read(st: LMState):
    """(stop, iterations, CG total) in one host sync; raises
    ``torch.linalg.LinAlgError`` where the assembly kernel found a singular
    7x7 block (as ``torch.linalg.inv`` does on the CPU)."""
    v = st.values.cpu()
    flags = v.view(torch.int32)
    stop = assembly.stop_test(flags[2 * FLAGS] != 0, flags[2 * FLAGS + 1])
    return stop, int(v[ITER]), int(v[CG_TOTAL])


# ----------------------------------------------------------------------------
# The plain versions
# ----------------------------------------------------------------------------


def _dot(a, b):
    """Dot of replicated (camera- or point-space) vectors, in float64."""
    return torch.sum(a.to(_F64) * b.to(_F64))


def _rdot(mesh: ShardMesh, a, b):
    """Dot of row-space vectors: per-shard partials in float64, ``mesh.sum``."""
    return mesh.sum([torch.sum(x.to(_F64) * y.to(_F64)) for x, y in zip(a, b)])


def _set_typed(st: LMState, lam, cost) -> None:
    """lam and cost in the solve's dtype, as new tensors: what a caller was
    handed before (the assembly's lam) keeps its value."""
    st.typed = torch.stack([lam, cost]).to(st.typed.dtype)
    st.lam, st.cost = st.typed[0], st.typed[1]


def init_plain(st: LMState, mesh: ShardMesh, r: Sequence[torch.Tensor], lam0: float) -> None:
    v = st.values
    cost = 0.5 * _rdot(mesh, r, r)
    v.zero_()
    v[COST] = cost
    v[C0] = cost
    v[LAM] = lam0
    v[NU] = 2.0
    _set_typed(st, v[LAM], cost)


def trial_plain(st: LMState, cam, points, x, cam_free, lower, upper, hpp_inv, g_p,
                jtp_u) -> Optional[Trial]:
    """The trial point (None where ``halt`` is set)."""
    if halted(st):
        return None
    dp = smv.solve3(hpp_inv, -g_p - jtp_u)
    cam_new = cam + x * cam_free
    if lower is not None:
        cam_new = torch.maximum(cam_new, lower)
    if upper is not None:
        cam_new = torch.minimum(cam_new, upper)
    return Trial(cam_new, points + dp, dp, cam_new - cam)


def accept_plain(st: LMState, mesh: ShardMesh, shards, num_ref: int, J, r, J_t, r_t,
                 t: Trial, cam, points, g_c, g_p, cam_diag, pt_diag,
                 u: Optional[Sequence[torch.Tensor]], jd: Optional[Sequence[torch.Tensor]],
                 cg_count: Optional[torch.Tensor], gate: bool):
    """(cam, points, J, r) after the accept, selected by ``torch.where``; the
    state updated in place (nothing where ``halt`` is set). ``u`` per shard:
    the camera half of Jd (J_p dp is added here), or ``jd`` per shard: Jd
    itself."""
    if halted(st):
        return cam, points, J, r
    v, devs = st.values, mesh.devices
    cost, lam, nu = v[COST].clone(), v[LAM].clone(), v[NU].clone()
    new_cost = 0.5 * _rdot(mesh, r_t, r_t)
    if jd is None:
        jd = [ub.to(_F64) + smv.shard_jmv(fams, jc, [None if b is None else b.to(_F64)
                                                     for b in jp],
                                          None, t.dp.to(devs[s]).to(_F64), num_ref, _F64,
                                          devs[s])
              for s, (fams, (jc, jp), ub) in enumerate(zip(shards, J, u))]
    step_c, dp = t.step_c.to(_F64), t.dp.to(_F64)
    pred = -(_dot(step_c, g_c) + _dot(dp, g_p)) - 0.5 * _rdot(mesh, jd, jd) \
        - 0.5 * lam * (_dot(cam_diag.to(_F64) * step_c, step_c)
                       + _dot(pt_diag.to(_F64) * dp, dp))
    good = (new_cost < cost) & torch.isfinite(new_cost)
    rho = (cost - new_cost) / torch.clamp_min(torch.abs(pred), 1e-30)
    lam_dec = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    lam_new = torch.where(good, torch.clamp_min(lam_dec, 1e-14), lam * nu)
    nu_new = torch.where(good, torch.full_like(nu, 2.0), nu * 2.0)
    rel_decrease = torch.abs(cost - new_cost) / torch.clamp_min(cost, 1e-30)
    done = (good & (rel_decrease < 1e-10)) | (lam > 1e12)
    kept = torch.where(good, new_cost, cost)

    v[COST] = kept
    v[LAM] = lam_new
    v[NU] = nu_new
    v[ITER] += 1
    if cg_count is not None:
        v[CG_TOTAL] += cg_count.to(_F64)
    v[NEW_COST], v[PRED], v[RHO], v[REL] = new_cost, pred, rho, rel_decrease
    v[GOOD], v[DONE] = good.to(_F64), done.to(_F64)
    _set_typed(st, lam_new, kept)
    if gate:
        st.halt.copy_(done | (st.singular != 0))

    def on(x, s):
        return x.to(devs[s])

    cam = torch.where(good, t.cam, cam)
    points = torch.where(good, t.points, points)
    J = [([None if a is None else torch.where(on(good, s), a, a0) for a, a0 in zip(jc_t, jc)],
          [None if b is None else torch.where(on(good, s), b, b0) for b, b0 in zip(jp_t, jp)])
         for s, ((jc_t, jp_t), (jc, jp)) in enumerate(zip(J_t, J))]
    r = [torch.where(on(good, s), a, a0) for s, (a, a0) in enumerate(zip(r_t, r))]
    return cam, points, J, r


# ----------------------------------------------------------------------------
# The kernel (csrc/lm_step.cu)
# ----------------------------------------------------------------------------


def _lib():
    lib = cuda_build.load_library(SOURCE)
    if lib.mv_lm_trial.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mv_lm_trial.argtypes = [i32, i64, i64] + [p] * 14 + [p]
        lib.mv_lm_trial.restype = ctypes.c_int
        lib.mv_lm_accept.argtypes = ([i32, i32, i32, p, i32, p, i32, i64, i64] + [p] * 13
                                     + [i64, p, p, p, p, ctypes.c_double, p, p])
        lib.mv_lm_accept.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "lm_step kernel")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on(x: torch.Tensor, dev) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def trial_cuda(st: LMState, cam, points, x, cam_free, lower, upper, hpp_inv, g_p,
               jtp_u) -> Trial:
    """One launch of the trial kernel into ``st.trial`` (returned)."""
    global LAUNCHES
    if not st.on_card:
        raise ValueError(f"lm_step kernel: the LM state lies on {st.values.device}, not on a "
                         f"CUDA device")
    t = st.trial
    dev, dt = st.values.device, t.cam.dtype
    C, P = t.cam.shape[0], t.points.shape[0]
    for name, a, shape in (("cam", cam, (C,)), ("x", x, (C,)), ("cam_free", cam_free, (C,)),
                           ("lower", lower, (C,)), ("upper", upper, (C,)),
                           ("points", points, (P, 3)), ("hpp_inv", hpp_inv, (P, 3, 3)),
                           ("g_p", g_p, (P, 3)), ("jtp_u", jtp_u, (P, 3))):
        if a is not None:
            _check(name, a, shape, dt, dev)
    with torch.cuda.device(dev):
        err = _lib().mv_lm_trial(dt.itemsize, C, P, cam.data_ptr(), points.data_ptr(),
                                 x.data_ptr(), cam_free.data_ptr(), _ptr(lower), _ptr(upper),
                                 hpp_inv.data_ptr(), g_p.data_ptr(), jtp_u.data_ptr(),
                                 t.cam.data_ptr(), t.points.data_ptr(), t.dp.data_ptr(),
                                 t.step_c.data_ptr(), st.halt.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"lm_step kernel (trial) failed with cudaError {err}")
    LAUNCHES += 1
    return t


def _family_table(fams, jc, jp, rows: torch.Tensor, dtype, dev, s: int):
    """A shard's families in the accept kernel's table (5 int64 each: J_p,
    point_idx, n, the first element in the flat rows, k); their tensors
    checked."""
    fields, off = [], 0
    if len(fams) > _MAX_FAMILIES:
        raise ValueError(f"lm_step kernel: shard {s} has {len(fams)} families, more than the "
                         f"kernel's {_MAX_FAMILIES}")
    for i, (f, a, b) in enumerate(zip(fams, jc, jp)):
        n, k = (b if a is None else a).shape[:2]
        if b is not None:
            _check(f"shard {s}'s family {i}'s point block", b, (n, k, 3), dtype, dev)
            _check(f"shard {s}'s family {i}'s point_idx", f.point_idx, (n,), torch.int64, dev)
        fields += [_ptr(b) or 0, 0 if b is None else f.point_idx.data_ptr(), n, off, k]
        off += n * k
    _check(f"shard {s}'s residuals", rows, (off,), dtype, dev)
    return (ctypes.c_longlong * max(len(fields), 1))(*fields), len(fams)


def _copy_table(pairs):
    """(destination, source) tensor pairs in the kernel's copy table."""
    fields = []
    for dst, src in pairs:
        if dst is None:
            continue
        if dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device or \
                not (dst.is_contiguous() and src.is_contiguous()):
            raise ValueError(f"lm_step kernel: a copy of {tuple(src.shape)} {src.dtype} into "
                             f"{tuple(dst.shape)} {dst.dtype}")
        fields += [dst.data_ptr(), src.data_ptr(), dst.numel() * dst.element_size()]
    if len(fields) > 3 * _MAX_COPIES:
        raise ValueError(f"lm_step kernel: {len(fields) // 3} copies, more than the kernel's "
                         f"{_MAX_COPIES}")
    return (ctypes.c_longlong * max(len(fields), 1))(*fields), len(fields) // 3


def _plan_key(mesh, J, r, J_t, r_t, t, cam, points):
    """What an accept plan was built for: the mesh and every tensor's
    address and size (the current and trial blocks and residuals, the trial
    point, the cameras and points)."""
    xs = [x for blocks in (J, J_t) for jc, jp in blocks for x in (*jc, *jp)]
    xs += [*r, *r_t, t.cam, t.points, cam, points]
    return mesh, tuple((0, 0) if x is None else (x.data_ptr(), x.numel()) for x in xs)


class _AcceptPlan:
    """The accept's tables over a solve whose current and trial blocks,
    residuals, cameras and points keep their tensors."""

    def __init__(self, st: LMState, mesh: ShardMesh, shards, J, r, J_t, r_t, t: Trial, cam,
                 points):
        dt = st.typed.dtype
        self.devs = [_device(d) for d in mesh.devices]
        lead = st.values.device
        for s, d in enumerate(self.devs):
            if d.type != "cuda":
                raise ValueError(f"lm_step kernel: shard {s} lies on {d}, not on a CUDA device")
        self.families = [_family_table(fams, jc, jp, rs, dt, d, s)
                         for s, (fams, (jc, jp), rs, d) in enumerate(zip(shards, J, r, self.devs))]
        self.shard_copies = []
        for s, ((jc, jp), (jc_t, jp_t), rs, rs_t) in enumerate(zip(J, J_t, r, r_t)):
            pairs = list(zip(jc, jc_t)) + list(zip(jp, jp_t)) + [(rs, rs_t)]
            self.shard_copies.append(pairs)
        _check("cam", cam, t.cam.shape, dt, lead)
        _check("points", points, t.points.shape, dt, lead)
        self.lead_copies = [(cam, t.cam), (points, t.points)]
        if mesh.size == 1:
            self.copies = [_copy_table(self.lead_copies + self.shard_copies[0])]
        else:
            self.copies = [_copy_table(self.lead_copies)] + \
                [_copy_table(c) for c in self.shard_copies]
            self.rows = [torch.empty(2, dtype=_F64, device=d) for d in self.devs]
            self.partials = [st.partial if d == lead else
                             torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=d)
                             for d in self.devs]
            # a copy of the state on each other device: its copy launch reads good there
            self.states = [None if d == lead else torch.zeros(_SLOTS, dtype=_F64, device=d)
                           for d in self.devs]
        self.key = _plan_key(mesh, J, r, J_t, r_t, t, cam, points)


def _accept_launch(st: LMState, dev, passes: int, gate: bool, families, copies, rows,
                   u=None, jd=None, t: Optional[Trial] = None, g_c=None, g_p=None,
                   cam_diag=None, pt_diag=None, cg_count=None, rows_in=None, rows_out=None,
                   partial=None, state=None, lam0: float = 0.0) -> None:
    """One launch of the accept kernel on ``dev``; ``state``: the state's
    copy on a device other than the lead's (None: the lead's own, with its
    typed values and flags)."""
    global LAUNCHES, LAST_LAUNCH
    info = (ctypes.c_longlong * 2)() if RECORD_LAUNCH else None
    (table, nfam), (ctab, ncopy) = families, copies
    lead = state is None
    state = st.values if lead else state
    C = 0 if t is None else t.cam.shape[0]
    P = 0 if t is None else t.points.shape[0]
    with torch.cuda.device(dev):
        err = _lib().mv_lm_accept(
            st.typed.element_size(), passes, int(gate), table, nfam, ctab, ncopy, C, P,
            _ptr(rows), _ptr(u), _ptr(jd), None if t is None else _on(t.dp, dev).data_ptr(),
            None if t is None else t.step_c.data_ptr(), _ptr(g_c), _ptr(g_p), _ptr(cam_diag),
            _ptr(pt_diag), _ptr(cg_count), _ptr(rows_in), _ptr(rows_out),
            (st.partial if partial is None else partial).data_ptr(), _PARTIAL_BLOCKS,
            state.data_ptr(), st.typed.data_ptr() if lead else None,
            st.halt.data_ptr() if lead else None, st.singular.data_ptr() if lead else None,
            float(lam0), info, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lm_step kernel (accept, passes {passes}) failed with cudaError "
                           f"{err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = {"grid": info[0], "threads": info[1], "passes": passes}


_NO_FAMILIES = ((ctypes.c_longlong * 1)(), 0)
_NO_COPIES = ((ctypes.c_longlong * 1)(), 0)


def init_cuda(st: LMState, mesh: ShardMesh, r: Sequence[torch.Tensor], lam0: float) -> None:
    """The state at a solve's start: one launch on one shard (a rows launch a
    shard, then the start on the lead, with several)."""
    if not st.on_card:
        raise ValueError(f"lm_step kernel: the LM state lies on {st.values.device}, not on a "
                         f"CUDA device")
    dt, lead = st.typed.dtype, st.values.device
    devs = [_device(d) for d in mesh.devices]
    tables = []
    for s, (rs, d) in enumerate(zip(r, devs)):
        if d.type != "cuda":
            raise ValueError(f"lm_step kernel: shard {s} lies on {d}, not on a CUDA device")
        _check(f"shard {s}'s residuals", rs, (rs.shape[0],), dt, d)
        n = rs.shape[0]
        tables.append(((ctypes.c_longlong * 5)(0, 0, n, 0, 1), 1))
    if mesh.size == 1:
        _accept_launch(st, lead, _INIT, False, tables[0], _NO_COPIES, r[0], lam0=lam0)
        return
    parts = []
    for s, (rs, d) in enumerate(zip(r, devs)):
        out = torch.empty(2, dtype=_F64, device=d)
        other = d != lead
        _accept_launch(st, d, _ROWS, False, tables[s], _NO_COPIES, rs, rows_out=out,
                       partial=torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=d) if other
                       else st.partial,
                       state=torch.zeros(_SLOTS, dtype=_F64, device=d) if other else None)
        parts.append(out)
    _accept_launch(st, lead, _INIT, False, _NO_FAMILIES, _NO_COPIES, None,
                   rows_in=mesh.sum(parts), lam0=lam0)


def accept_cuda(st: LMState, mesh: ShardMesh, shards, num_ref: int, J, r, J_t, r_t,
                t: Trial, cam, points, g_c, g_p, cam_diag, pt_diag,
                u: Optional[Sequence[torch.Tensor]], jd: Optional[Sequence[torch.Tensor]],
                cg_count: Optional[torch.Tensor], gate: bool):
    """The accept kernel: one cooperative launch on one shard (the rows'
    sums, the scalars, the copy); with several shards a rows launch a shard,
    ``mesh.sum``, the scalars and the cameras' and points' copy on the lead,
    then a copy launch a shard. The current tensors are updated in place and
    returned."""
    key = _plan_key(mesh, J, r, J_t, r_t, t, cam, points)
    if st._plan is None or st._plan.key != key:
        st._plan = _AcceptPlan(st, mesh, shards, J, r, J_t, r_t, t, cam, points)
    plan, dt, lead = st._plan, st.typed.dtype, st.values.device
    C, P = t.cam.shape[0], t.points.shape[0]
    for name, a, shape in (("g_c", g_c, (C,)), ("cam_diag", cam_diag, (C,)),
                           ("g_p", g_p, (P, 3)), ("pt_diag", pt_diag, (P, 3))):
        _check(name, a, shape, dt, lead)
    if cg_count is not None:
        _check("the CG count", cg_count, (), torch.int64, lead)
    rows_of = jd if jd is not None else u
    for s, (rs, d) in enumerate(zip(r, plan.devs)):
        if rows_of is not None:
            _check(f"shard {s}'s {'Jd' if jd is not None else 'u'}", rows_of[s], rs.shape, dt, d)
    one = (lambda x, s: None if x is None else x[s])
    if mesh.size == 1:
        _accept_launch(st, lead, _ROWS | _SCALARS | _COPY, gate, plan.families[0], plan.copies[0],
                       r_t[0], one(u, 0), one(jd, 0), t, g_c, g_p, cam_diag, pt_diag, cg_count)
        return cam, points, J, r
    for s, d in enumerate(plan.devs):
        _accept_launch(st, d, _ROWS, False, plan.families[s], _NO_COPIES, r_t[s], one(u, s),
                       one(jd, s), t, rows_out=plan.rows[s], partial=plan.partials[s],
                       state=plan.states[s])
    _accept_launch(st, lead, _SCALARS | _COPY, gate, _NO_FAMILIES, plan.copies[0], None,
                   t=t, g_c=g_c, g_p=g_p, cam_diag=cam_diag, pt_diag=pt_diag, cg_count=cg_count,
                   rows_in=mesh.sum(plan.rows))
    for s, d in enumerate(plan.devs):
        if plan.states[s] is not None:
            plan.states[s].copy_(st.values)
        _accept_launch(st, d, _COPY, False, _NO_FAMILIES, plan.copies[1 + s], None,
                       partial=plan.partials[s], state=plan.states[s])
    return cam, points, J, r


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def init(st: LMState, mesh: ShardMesh, r: Sequence[torch.Tensor], lam0: float) -> None:
    """The state at a solve's start from its residuals ``r`` (per shard)."""
    (init_cuda if st.on_card else init_plain)(st, mesh, r, lam0)


def trial(st: LMState, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u):
    """The trial point (``Trial``); the plain version for CPU tensors, the
    kernel for CUDA ones (which raises on anything it does not take)."""
    fn = trial_cuda if st.on_card else trial_plain
    return fn(st, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u)


def accept(st: LMState, mesh: ShardMesh, shards, num_ref: int, J, r, J_t, r_t, t: Trial,
           cam, points, g_c, g_p, cam_diag, pt_diag, u=None, jd=None, cg_count=None,
           gate: bool = True):
    """(cam, points, J, r) after one iteration's accept, dispatched as
    ``trial``. ``J`` / ``r`` per shard the current blocks and flat residuals,
    ``J_t`` / ``r_t`` the trial's; ``u`` per shard the camera half of Jd
    (flat rows; Jd = u + J_p dp) or ``jd`` per shard Jd itself; ``cg_count``
    the iteration's CG steps (0-d int64; None: 0); ``gate``: set ``halt``
    where done."""
    fn = accept_cuda if st.on_card else accept_plain
    return fn(st, mesh, shards, num_ref, J, r, J_t, r_t, t, cam, points, g_c, g_p, cam_diag,
              pt_diag, u, jd, cg_count, gate)
