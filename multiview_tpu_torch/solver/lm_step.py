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
good, done and rel_decrease) and four int32: ``halt`` and ``singular``
(which the assembly kernel sets), the selector ``sel`` and the accept
kernel's ticket counter. Where the caller asks for it (``gate``), accept
sets ``halt`` when done (or a block was singular), and every later launch of
the solve returns at once; ``read`` takes the state to the host in one sync.
The cost and every sum that decides good or done is taken in float64.

Current and trial in two halves. On the card the LM loop keeps its current
and its trial cameras, points, row blocks and residual in the two halves of
one allocation a device (``Halves``): ``sel`` says which half is current,
an accepted step flips it and nothing is copied. Every kernel of the loop
reads ``sel`` on the device (the trial, the row blocks at the trial point,
the assembly, the Schur matvec, the CG solve, the accept), so the host need
not know it until its read; the kernels' tables hold the half-0 addresses
and each launch the halves' distance. The plain versions keep ``sel`` with
the same meaning (0 at the start, flipped on each accepted step) while they
select the current tensors themselves (``torch.where``).

On CUDA tensors ``trial`` and ``accept`` launch the hand-written kernel
``csrc/lm_step.cu``: the trial one launch (on one shard of ``cg_blocks`` the
LM loop takes the trial point from the CG solve's tail instead,
``solver/cg_solve.py``, with the same arithmetic, ``csrc/lm_trial.cuh``); the accept one ordinary launch on
one shard (a row a thread, each block's partial sums, then the last block to
take a ticket sums them in block order and updates the state); with several
shards a rows launch a shard, ``ShardMesh.sum`` of their two sums and a
scalars launch on the lead. Its scratch (the trial's step buffers, the
partials) is the ``LMState``'s, allocated once a solve; the accept's tables
are checked at the first accept of a solve. On CPU tensors they run the
plain versions (``*_plain``: the solver's former code, its sums in float64),
which honour ``halt`` as the kernel does where the host reads it for free
(CPU tensors; run on the card, for comparison with the kernel, they read it
not, and never sync); nothing on the card gives way to them. ``LAUNCHES``
counts the kernel's launches."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.solver import assembly, schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build
from multiview_tpu_torch.utils.cuda_build import ptr as _ptr, stream as _stream
from multiview_tpu_torch.utils.device import indexed_device as _device

SOURCE = "lm_step.cu"
# kernel launches of csrc/lm_step.cu, one each; TRIAL_LAUNCHES: of them, the
# trial's (none on one shard of cg_blocks, whose CG solve writes the trial)
LAUNCHES = 0
TRIAL_LAUNCHES = 0
# with RECORD_LAUNCH set, the grid and threads of the last accept launch
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
# the state's float64 slots (FLAGS: two int32, halt and singular; SEL: two
# int32, sel and the accept's ticket counter)
COST, LAM, NU, C0, ITER, CG_TOTAL, NEW_COST, PRED, RHO, GOOD, DONE, REL, FLAGS, SEL = range(14)
_SLOTS = 14
_ROWS, _SCALARS, _INIT = 1, 2, 4   # the accept kernel's passes
_MAX_FAMILIES = 32
_PARTIAL_BLOCKS = 8192          # the accept grid's partial sums (a row a thread up to here)
_ALIGN = 256                    # bytes: where each region of a half starts
_F64 = torch.float64


class Trial(NamedTuple):
    cam: torch.Tensor        # [C] cam_t (the card: [2, C], both halves; cam_t in half 1 - sel)
    points: torch.Tensor     # [P,3] pts_t (the card: [2, P, 3])
    dp: torch.Tensor         # [P,3]
    step_c: torch.Tensor     # [C] cam_t - cam


class LMState:
    """One solve's LM state on ``device``: ``values`` [14] float64 (slots
    above), ``halt``, ``singular`` and ``sel`` (0-d int32 views into it),
    ``lam`` and ``cost`` (0-d views in the solve's dtype, which the assembly
    and the result read). On the card, the trial's step buffers for
    ``num_cam`` camera entries and ``num_points`` points and the accept's
    scratch."""

    def __init__(self, dtype: torch.dtype, device, num_cam: int = 0, num_points: int = 0):
        self.values = torch.zeros(_SLOTS, dtype=_F64, device=device)
        flags = self.values.view(torch.int32)
        self.halt, self.singular = flags[2 * FLAGS], flags[2 * FLAGS + 1]
        self.sel = flags[2 * SEL]
        self.typed = torch.zeros(2, dtype=dtype, device=device)
        self.lam, self.cost = self.typed[0], self.typed[1]
        self.on_card = self.values.device.type != "cpu"
        self.dp = self.step_c = None
        if self.on_card:
            kw = dict(dtype=dtype, device=device)
            self.dp, self.step_c = torch.empty((num_points, 3), **kw), torch.empty(num_cam, **kw)
            self.partial = torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=device)
        self._plan = None
        self._mirrors: Dict[torch.device, torch.Tensor] = {}

    def mirror(self, dev) -> torch.Tensor:
        """The state's values on ``dev`` (itself on its own device; elsewhere
        a copy that the accept refreshes after each scalar update): a
        shard's launches read ``sel`` there and keep their ticket there."""
        dev = _device(dev)
        if dev == _device(self.values.device):
            return self.values
        if dev not in self._mirrors:
            self._mirrors[dev] = torch.zeros(_SLOTS, dtype=_F64, device=dev)
        return self._mirrors[dev]

    def refresh_mirrors(self) -> None:
        for m in self._mirrors.values():
            m.copy_(self.values)


class Halves:
    """The LM loop's current and trial arrays on the card, in the two halves
    of one allocation a device ([2, m] in the solve's dtype): an array's
    half-1 copy lies ``stride(dev)`` bytes after its half-0 copy, and the
    state's ``sel`` (``sel(dev)``: on a device other than the lead's, the
    state's mirror there) says which half is current. ``reserve`` every
    array, then ``allocate`` returns their half-0 views, which the kernels'
    tables hold; ``pair(t)`` is a half-0 view with its half-1 copy, [2,
    *t.shape]."""

    def __init__(self, st: LMState):
        self.st = st
        self.dtype = st.typed.dtype
        self._shapes: List = []
        self._used: Dict[torch.device, int] = {}
        self._arenas: Dict[torch.device, torch.Tensor] = {}
        # what the LM loop asks for at every iteration, made once: the
        # checked arrays, their pairs, each device's (sel address, stride)
        self._checked, self._pairs, self._of = set(), {}, {}

    def reserve(self, dev, shape) -> None:
        dev = _device(dev)
        n = math.prod(shape)
        off = self._used.get(dev, 0)
        step = _ALIGN // self.dtype.itemsize
        self._used[dev] = off + -(-n // step) * step
        self._shapes.append((dev, tuple(shape), off))

    def allocate(self) -> List[torch.Tensor]:
        """The half-0 views, in the order reserved (both halves
        uninitialised: the LM loop writes each array before it reads it)."""
        for dev, m in self._used.items():
            self._arenas[dev] = torch.empty((2, max(m, 1)), dtype=self.dtype, device=dev)
        return [self._arenas[dev][0, off:off + math.prod(shape)].view(shape)
                for dev, shape, off in self._shapes]

    def stride(self, dev) -> int:
        """Bytes from half 0 to half 1 on ``dev``."""
        return self._arenas[_device(dev)].stride(0) * self.dtype.itemsize

    def sel(self, dev) -> torch.Tensor:
        return self.st.mirror(dev).view(torch.int32)[2 * SEL]

    def pair(self, t: torch.Tensor) -> torch.Tensor:
        key = (t.data_ptr(), tuple(t.shape), t.dtype)
        if key not in self._pairs:
            self.check("a pair's array", t)
            self._pairs[key] = t.as_strided(
                (2,) + tuple(t.shape), (self.stride(t.device) // t.element_size(),)
                + tuple(t.stride()))
        return self._pairs[key]

    def check(self, name: str, t: Optional[torch.Tensor]) -> None:
        """Raises where ``t`` is not a contiguous half-0 view of this
        allocation (a kernel would read its other half out of bounds)."""
        if t is None:
            return
        key = (t.data_ptr(), t.numel(), t.dtype, t.device, t.is_contiguous())
        if key in self._checked:
            return
        arena = self._arenas.get(_device(t.device))
        ok = arena is not None and t.dtype == arena.dtype and t.is_contiguous()
        if ok:
            base, item = arena.data_ptr(), arena.element_size()
            ok = base <= t.data_ptr() and t.data_ptr() + t.numel() * item <= \
                base + arena.stride(0) * item
        if not ok:
            raise ValueError(f"halves: {name} is not a half-0 array of the LM loop's halves")
        self._checked.add(key)

    def of(self, dev):
        """(the address of ``sel`` on ``dev``, the stride in bytes), as the
        kernels take them."""
        if dev not in self._of:
            self._of[dev] = (self.sel(dev).data_ptr(), self.stride(dev))
        return self._of[dev]


def halves_for(st: LMState, now: Sequence[Optional[torch.Tensor]],
               trial: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """(``Halves``, half-0 arrays) holding copies of the tensors ``now`` in
    the half the state's ``sel`` picks and of ``trial`` (None: ``now``) in
    the other, each on its own device (None stays None): the kernels' checks
    and timings on arrays that no LM loop made. Reads ``sel`` (a sync)."""
    h = Halves(st)
    for t in now:
        if t is not None:
            h.reserve(t.device, t.shape)
    arrays = iter(h.allocate())
    sel = int(st.sel)
    out = []
    for i, t in enumerate(now):
        if t is None:
            out.append(None)
            continue
        a = next(arrays)
        pair = h.pair(a)
        pair[sel].copy_(t)
        pair[1 - sel].copy_(t if trial is None else trial[i])
        out.append(a)
    return h, out


def halted(st: LMState) -> bool:
    """Whether ``halt`` is set, where the host reads it for free (CPU
    tensors); on the card False: the kernels test it themselves."""
    return not st.on_card and bool(st.halt)


def read(st: LMState):
    """(stop, iterations, CG total, sel) in one host sync; raises
    ``torch.linalg.LinAlgError`` where the assembly kernel found a singular
    7x7 block (as ``torch.linalg.inv`` does on the CPU)."""
    v = st.values.cpu()
    flags = v.view(torch.int32)
    stop = assembly.stop_test(flags[2 * FLAGS] != 0, flags[2 * FLAGS + 1])
    return stop, int(v[ITER]), int(v[CG_TOTAL]), int(flags[2 * SEL])


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
    state updated in place, ``sel`` flipped on a good step (nothing where
    ``halt`` is set). ``u`` per shard: the camera half of Jd (J_p dp is
    added here), or ``jd`` per shard: Jd itself."""
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
    st.sel.bitwise_xor_(good.to(torch.int32))
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
        lib.mv_lm_trial.argtypes = [i32, i64, i64] + [p] * 12 + [i64, p, p]
        lib.mv_lm_trial.restype = ctypes.c_int
        lib.mv_lm_accept.argtypes = ([i32, i32, i32, p, i32, i64, i64] + [p] * 13
                                     + [i64, p, p, i64, p, p, p, ctypes.c_double, p, p])
        lib.mv_lm_accept.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "lm_step kernel")


def _on_card(st: LMState, halves: Optional[Halves] = None, needed: bool = False) -> None:
    if not st.on_card:
        raise ValueError(f"lm_step kernel: the LM state lies on {st.values.device}, not on a "
                         f"CUDA device")
    if needed and halves is None:
        raise ValueError("lm_step kernel: the trial and the accept read the LM loop's halves "
                         "(lm_step.Halves); none given")


def trial_cuda(st: LMState, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
               halves: Optional[Halves] = None) -> Trial:
    """One launch of the trial kernel: ``cam`` [C] and ``points`` [P, 3] are
    half-0 arrays of ``halves`` (on the lead device), read in half sel, the
    trial point written into half 1 - sel; dp and step_c into the state's
    buffers. Returns them with the pairs of both halves."""
    global LAUNCHES, TRIAL_LAUNCHES
    _on_card(st, halves, True)
    dev, dt = st.values.device, st.typed.dtype
    C, P = st.step_c.shape[0], st.dp.shape[0]
    for name, a, shape in (("cam", cam, (C,)), ("x", x, (C,)), ("cam_free", cam_free, (C,)),
                           ("lower", lower, (C,)), ("upper", upper, (C,)),
                           ("points", points, (P, 3)), ("hpp_inv", hpp_inv, (P, 3, 3)),
                           ("g_p", g_p, (P, 3)), ("jtp_u", jtp_u, (P, 3))):
        if a is not None:
            _check(name, a, shape, dt, dev)
    halves.check("cam", cam)
    halves.check("points", points)
    sel, stride = halves.of(dev)
    with torch.cuda.device(dev):
        err = _lib().mv_lm_trial(dt.itemsize, C, P, cam.data_ptr(), points.data_ptr(),
                                 x.data_ptr(), cam_free.data_ptr(), _ptr(lower), _ptr(upper),
                                 hpp_inv.data_ptr(), g_p.data_ptr(), jtp_u.data_ptr(),
                                 st.dp.data_ptr(), st.step_c.data_ptr(), sel, stride,
                                 st.halt.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"lm_step kernel (trial) failed with cudaError {err}")
    LAUNCHES += 1
    TRIAL_LAUNCHES += 1
    return Trial(halves.pair(cam), halves.pair(points), st.dp, st.step_c)


def _family_table(fams, jc, jp, rows: torch.Tensor, dtype, dev, s: int,
                  halves: Optional[Halves]):
    """A shard's families in the accept kernel's table (5 int64 each: J_p,
    point_idx, n, the first element in the flat rows, k); their tensors
    checked (half-0 arrays of ``halves`` where given)."""
    fields, off = [], 0
    if len(fams) > _MAX_FAMILIES:
        raise ValueError(f"lm_step kernel: shard {s} has {len(fams)} families, more than the "
                         f"kernel's {_MAX_FAMILIES}")
    for i, (f, a, b) in enumerate(zip(fams, jc, jp)):
        n, k = (b if a is None else a).shape[:2]
        if b is not None:
            _check(f"shard {s}'s family {i}'s point block", b, (n, k, 3), dtype, dev)
            _check(f"shard {s}'s family {i}'s point_idx", f.point_idx, (n,), torch.int64, dev)
            if halves is not None:
                halves.check(f"shard {s}'s family {i}'s point block", b)
        fields += [_ptr(b) or 0, 0 if b is None else f.point_idx.data_ptr(), n, off, k]
        off += n * k
    _check(f"shard {s}'s residuals", rows, (off,), dtype, dev)
    if halves is not None:
        halves.check(f"shard {s}'s residuals", rows)
    return (ctypes.c_longlong * max(len(fields), 1))(*fields), len(fams)


class _AcceptPlan:
    """The accept's tables over a solve whose current blocks and residuals
    keep their half-0 arrays."""

    def __init__(self, st: LMState, mesh: ShardMesh, shards, J, r, halves: Halves):
        dt = st.typed.dtype
        self.devs = [_device(d) for d in mesh.devices]
        lead = st.values.device
        for s, d in enumerate(self.devs):
            if d.type != "cuda":
                raise ValueError(f"lm_step kernel: shard {s} lies on {d}, not on a CUDA device")
        self.families = [_family_table(fams, jc, jp, rs, dt, d, s, halves)
                         for s, (fams, (jc, jp), rs, d) in enumerate(zip(shards, J, r, self.devs))]
        if mesh.size > 1:
            self.rows = [torch.empty(2, dtype=_F64, device=d) for d in self.devs]
            self.partials = [st.partial if d == lead else
                             torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=d)
                             for d in self.devs]
        self.key = _plan_key(mesh, J, r)


def _plan_key(mesh, J, r):
    """What an accept plan was built for: the mesh and every block's and
    residual's address and size (no reference to the halves, which refer to
    the state that holds the plan: a cycle would keep a solve's halves
    allocated until the garbage collector ran)."""
    xs = [x for jc, jp in J for x in (*jc, *jp)] + list(r)
    return mesh, tuple((0, 0) if x is None else (x.data_ptr(), x.numel()) for x in xs)


def _accept_launch(st: LMState, dev, passes: int, gate: bool, families, rows, u=None, jd=None,
                   t: Optional[Trial] = None, g_c=None, g_p=None, cam_diag=None, pt_diag=None,
                   cg_count=None, rows_in=None, rows_out=None, partial=None, lead: bool = True,
                   halves: Optional[Halves] = None, lam0: float = 0.0) -> None:
    """One launch of the accept kernel on ``dev``: ``lead`` with the state
    itself (its typed values and flags), else with the state's mirror on
    ``dev`` (its ``sel`` and ticket); ``halves`` None: half 0 alone."""
    global LAUNCHES, LAST_LAUNCH
    info = (ctypes.c_longlong * 2)() if RECORD_LAUNCH else None
    table, nfam = families
    state = st.mirror(dev)
    sel, stride = halves.of(dev) if halves is not None else (None, 0)
    C = 0 if t is None else t.step_c.shape[0]
    P = 0 if t is None else t.dp.shape[0]
    with torch.cuda.device(dev):
        err = _lib().mv_lm_accept(
            st.typed.element_size(), passes, int(gate), table, nfam, C, P, _ptr(rows), _ptr(u),
            _ptr(jd), None if t is None else t.dp.to(dev).data_ptr(),
            None if t is None else t.step_c.data_ptr(), _ptr(g_c), _ptr(g_p), _ptr(cam_diag),
            _ptr(pt_diag), _ptr(cg_count), _ptr(rows_in), _ptr(rows_out),
            (st.partial if partial is None else partial).data_ptr(), _PARTIAL_BLOCKS,
            state.data_ptr(), sel, stride, st.typed.data_ptr() if lead else None,
            st.halt.data_ptr() if lead else None, st.singular.data_ptr() if lead else None,
            float(lam0), info, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lm_step kernel (accept, passes {passes}) failed with cudaError "
                           f"{err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = {"grid": info[0], "threads": info[1], "passes": passes}


_NO_FAMILIES = ((ctypes.c_longlong * 1)(), 0)


def init_cuda(st: LMState, mesh: ShardMesh, r: Sequence[torch.Tensor], lam0: float) -> None:
    """The state at a solve's start from ``r`` (per shard: the residual of
    half 0, the current one): one launch on one shard (a rows launch a
    shard, then the start on the lead, with several)."""
    _on_card(st)
    dt, lead = st.typed.dtype, st.values.device
    devs = [_device(d) for d in mesh.devices]
    tables = []
    for s, (rs, d) in enumerate(zip(r, devs)):
        if d.type != "cuda":
            raise ValueError(f"lm_step kernel: shard {s} lies on {d}, not on a CUDA device")
        _check(f"shard {s}'s residuals", rs, (rs.shape[0],), dt, d)
        tables.append(((ctypes.c_longlong * 5)(0, 0, rs.shape[0], 0, 1), 1))
    if mesh.size == 1:
        _accept_launch(st, lead, _INIT, False, tables[0], r[0], lam0=lam0)
        return
    parts = []
    for s, (rs, d) in enumerate(zip(r, devs)):
        out = torch.empty(2, dtype=_F64, device=d)
        _accept_launch(st, d, _ROWS, False, tables[s], rs, rows_out=out, lead=d == lead,
                       partial=None if d == lead else
                       torch.empty(_PARTIAL_BLOCKS * 6, dtype=_F64, device=d))
        parts.append(out)
    _accept_launch(st, lead, _INIT, False, _NO_FAMILIES, None, rows_in=mesh.sum(parts),
                   lam0=lam0)
    st.refresh_mirrors()


def accept_cuda(st: LMState, mesh: ShardMesh, shards, J, r, t: Trial, g_c, g_p, cam_diag,
                pt_diag, u: Optional[Sequence[torch.Tensor]],
                jd: Optional[Sequence[torch.Tensor]], cg_count: Optional[torch.Tensor],
                gate: bool, halves: Optional[Halves] = None) -> None:
    """The accept kernel: one launch on one shard (the rows' sums with
    J_p of half sel and r_t of half 1 - sel, the scalars, ``sel`` flipped on a
    good step); with several shards a rows launch a shard, ``mesh.sum``, the
    scalars on the lead, then the state's mirrors refreshed. ``J`` and ``r``
    per shard: the half-0 arrays of ``halves``."""
    _on_card(st, halves, True)
    key = _plan_key(mesh, J, r)
    if st._plan is None or st._plan.key != key:
        st._plan = _AcceptPlan(st, mesh, shards, J, r, halves)
    plan, dt, lead = st._plan, st.typed.dtype, st.values.device
    C, P = t.step_c.shape[0], t.dp.shape[0]
    for name, a, shape in (("g_c", g_c, (C,)), ("cam_diag", cam_diag, (C,)),
                           ("g_p", g_p, (P, 3)), ("pt_diag", pt_diag, (P, 3)),
                           ("step_c", t.step_c, (C,)), ("dp", t.dp, (P, 3))):
        _check(name, a, shape, dt, lead)
    if cg_count is not None:
        _check("the CG count", cg_count, (), torch.int64, lead)
    rows_of = jd if jd is not None else u
    for s, (rs, d) in enumerate(zip(r, plan.devs)):
        if rows_of is not None:
            _check(f"shard {s}'s {'Jd' if jd is not None else 'u'}", rows_of[s], rs.shape, dt, d)
    one = (lambda x, s: None if x is None else x[s])
    if mesh.size == 1:
        _accept_launch(st, lead, _ROWS | _SCALARS, gate, plan.families[0], r[0], one(u, 0),
                       one(jd, 0), t, g_c, g_p, cam_diag, pt_diag, cg_count, halves=halves)
        return
    for s, d in enumerate(plan.devs):
        _accept_launch(st, d, _ROWS, False, plan.families[s], r[s], one(u, s), one(jd, s), t,
                       rows_out=plan.rows[s], partial=plan.partials[s], lead=d == lead,
                       halves=halves)
    _accept_launch(st, lead, _SCALARS, gate, _NO_FAMILIES, None, t=t, g_c=g_c, g_p=g_p,
                   cam_diag=cam_diag, pt_diag=pt_diag, cg_count=cg_count,
                   rows_in=mesh.sum(plan.rows), halves=halves)
    st.refresh_mirrors()


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def init(st: LMState, mesh: ShardMesh, r: Sequence[torch.Tensor], lam0: float) -> None:
    """The state at a solve's start from its residuals ``r`` (per shard; on
    the card those of half 0)."""
    (init_cuda if st.on_card else init_plain)(st, mesh, r, lam0)


def trial(st: LMState, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
          halves: Optional[Halves] = None):
    """The trial point (``Trial``); the plain version for CPU tensors, the
    kernel for CUDA ones (``halves``: see ``trial_cuda``; it raises on
    anything it does not take)."""
    if st.on_card:
        return trial_cuda(st, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                          halves)
    return trial_plain(st, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u)


def accept(st: LMState, mesh: ShardMesh, shards, num_ref: int, J, r, J_t, r_t, t: Trial,
           cam, points, g_c, g_p, cam_diag, pt_diag, u=None, jd=None, cg_count=None,
           gate: bool = True, halves: Optional[Halves] = None):
    """(cam, points, J, r) after one iteration's accept, dispatched as
    ``trial``. ``J`` / ``r`` per shard the current blocks and flat residuals,
    ``J_t`` / ``r_t`` the trial's; ``u`` per shard the camera half of Jd
    (flat rows; Jd = u + J_p dp) or ``jd`` per shard Jd itself; ``cg_count``
    the iteration's CG steps (0-d int64; None: 0); ``gate``: set ``halt``
    where done. On the card ``J`` and ``r`` are the half-0 arrays of
    ``halves``, which hold the trial's too (``J_t`` and ``r_t`` are not
    read), and what it returns is what it was given: ``sel`` picks the
    current half."""
    if st.on_card:
        accept_cuda(st, mesh, shards, J, r, t, g_c, g_p, cam_diag, pt_diag, u, jd, cg_count,
                    gate, halves)
        return cam, points, J, r
    return accept_plain(st, mesh, shards, num_ref, J, r, J_t, r_t, t, cam, points, g_c, g_p,
                        cam_diag, pt_diag, u, jd, cg_count, gate)
