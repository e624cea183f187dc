"""The Schur complement matvec of the BA's CG (``solver/schur.py``,
``linear_solver`` "cg_blocks") and the two products of an LM iteration that
share its passes:

    S x = cam_free * J_c^T (u - J_p Hpp^-1 J_p^T u) + dc * x,    u = J_c (cam_free * x)

- ``schur_matvec(system, x)``: S x, once per CG step;
- ``schur_rhs(system, g_c, g_p)``: the reduced system's right-hand side
  -(g_c - cam_free * J_c^T J_p Hpp^-1 g_p);
- ``row_products(system, x)``: u per shard and J_p^T u, the
  back-substitution's product.

On CUDA tensors each runs the hand-written kernel of ``csrc/schur_mv.cu``,
one cooperative launch at a time (see the source): on one shard S x is one
launch (point pass, grid barrier, camera pass), the right-hand side one
launch and the back-substitution's product one launch; with more shards S x
is a point-pass launch and a camera-pass launch a shard, the shards' sums
added between them. On CPU tensors each runs its plain version, the
composition of gathers, batched block products and ``index_add_`` that the
solver ran before the kernel existed; nothing on the card gives way to it.
The kernel adds with atomics, so on the card the order of the sums, and the
last bits of S x, vary from run to run (as ``index_add_`` does there).

The per-shard products (``shard_jmv``, ``shard_jtmv_c``, ``shard_jtmv_p``)
are also the solver's products with the row blocks outside the CG. A
family is any object with ``beg_idx`` / ``end_idx`` [N] int64 and
``const_cols`` [B-14] int64 (where it has a camera block) and ``point_idx``
[N] int64 (where it touches points), as ``schur._Family``."""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.utils import cuda_build
from multiview_tpu_torch.utils.cuda_build import ptr as _ptr
from multiview_tpu_torch.utils.device import indexed_device as _device

SOURCE = "schur_mv.cu"
# kernel launches of csrc/schur_mv.cu, one each
LAUNCHES = 0
# with RECORD_LAUNCH set, the shape of the last launch (LAST_LAUNCH): grid,
# threads a block, rows a tile, the ring's slots, the rows its camera pass
# found in shared memory, the poses a block sums in shared memory (all of them
# unless they overflow it: the others take global atomics), whether
# x * cam_free stayed whole in shared memory, and the copies of those pose
# columns (one a warp where they are few)
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
_FIELDS = 10            # int64 fields of one family in the kernel's table
_MAX_FAMILIES = 32      # families with a camera block a shard the kernel takes
_POINT, _CAMERA = 1, 2  # the kernel's passes


# ----------------------------------------------------------------------------
# The products with the row blocks of one shard (plain PyTorch)
# ----------------------------------------------------------------------------


def gather_cols(f, xc: torch.Tensor, num_ref: int) -> torch.Tensor:
    """Each row's camera sub-vector [N,B] (pose columns by index)."""
    wref = xc[:num_ref * 7].reshape(num_ref, 7)
    n = f.beg_idx.shape[0]
    return torch.cat([wref[f.beg_idx], wref[f.end_idx],
                      xc[f.const_cols].expand(n, -1)], dim=-1)


def reduce_cols(contribs, num_ref: int, total: int, dtype, dev) -> torch.Tensor:
    """[(family, [N,B])] -> [C] on ``dev``: index_add_ per pose for the pose
    columns, plain sums for the per-sensor constant columns."""
    gc = torch.zeros(total, dtype=dtype, device=dev)
    gpose = torch.zeros((num_ref, 7), dtype=dtype, device=dev)
    for f, c in contribs:
        gpose.index_add_(0, f.beg_idx, c[:, :7])
        gpose.index_add_(0, f.end_idx, c[:, 7:14])
        gc.index_add_(0, f.const_cols, c[:, 14:].sum(0))
    gc[:num_ref * 7] += gpose.reshape(-1)
    return gc


def split_rows(u: torch.Tensor, jc, jp) -> List[torch.Tensor]:
    """Flat residual-space vector -> per-family [n,k] blocks."""
    out, off = [], 0
    for a, b in zip(jc, jp):
        n, k = (b if a is None else a).shape[:2]
        out.append(u[off:off + n * k].reshape(n, k))
        off += n * k
    return out


def shard_jmv(fams, jc, jp, xc, xp, num_ref: int, dtype, dev, dense=None) -> torch.Tensor:
    """J @ (xc, xp) over one shard's families, flat in residual order; None
    skips that side. With ``dense`` (the families' camera blocks densified
    to [N,k,C], None where a family has none) the camera side multiplies
    those."""
    parts = []
    for i, (f, a, b) in enumerate(zip(fams, jc, jp)):
        u = None
        if a is not None and xc is not None:
            u = ((dense[i] @ xc) if dense is not None
                 else torch.einsum("nkb,nb->nk", a, gather_cols(f, xc, num_ref)))
        if b is not None and xp is not None:
            up = torch.einsum("nkj,nj->nk", b, xp[f.point_idx])
            u = up if u is None else u + up
        if u is None:
            u = torch.zeros((b if a is None else a).shape[:2], dtype=dtype, device=dev)
        parts.append(u.reshape(-1))
    return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=dev)


def shard_jtmv_c(fams, jc, jp, u, num_ref: int, total: int, dtype, dev) -> torch.Tensor:
    """J_c^T u of one shard, [C]."""
    contribs = [(f, torch.einsum("nkb,nk->nb", a, ub))
                for f, a, ub in zip(fams, jc, split_rows(u, jc, jp)) if a is not None]
    return reduce_cols(contribs, num_ref, total, dtype, dev)


def shard_jtmv_p(fams, jc, jp, u, num_points: int, dtype, dev) -> torch.Tensor:
    """J_p^T u of one shard, [P,3]."""
    gp = torch.zeros((num_points, 3), dtype=dtype, device=dev)
    for f, b, ub in zip(fams, jp, split_rows(u, jc, jp)):
        if b is not None:
            gp.index_add_(0, f.point_idx, torch.einsum("nkj,nk->nj", b, ub))
    return gp


def solve3(hpp_inv: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Hpp^-1 rhs, one 3x3 block per point."""
    return torch.einsum("pij,pj->pi", hpp_inv, rhs)


# ----------------------------------------------------------------------------
# The system of one LM iteration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SchurSystem:
    """What S x reads besides x; constant over one LM iteration.

    ``shards``: per local shard of ``mesh`` its families; ``J``: per shard
    (camera blocks [N,k,B] or None, point blocks [N,k,3] or None) in family
    order, on the shard's device. ``cam_free`` and ``dc`` [C] and ``hpp_inv``
    [P,3,3] lie on the lead device. The kernels' tables are made at the first
    product on the card. The plain products read J as given."""

    mesh: ShardMesh
    shards: Sequence[Sequence[object]]
    J: Sequence[Tuple[Sequence[Optional[torch.Tensor]], Sequence[Optional[torch.Tensor]]]]
    cam_free: torch.Tensor
    dc: torch.Tensor
    hpp_inv: torch.Tensor
    num_ref: int
    # the LM loop's ``lm_step.Halves`` (None: J as given): J holds its half-0
    # arrays, and the kernels read the half its selector picks
    halves: Optional[object] = dataclasses.field(default=None, repr=False)
    _plans: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def total(self) -> int:
        return self.cam_free.shape[0]

    @property
    def num_points(self) -> int:
        return self.hpp_inv.shape[0]


def _jmv(s: SchurSystem, xc, xp) -> List[torch.Tensor]:
    dt = s.cam_free.dtype
    return [shard_jmv(fams, jc, jp, None if xc is None else xc.to(dev),
                      None if xp is None else xp.to(dev), s.num_ref, dt, dev)
            for fams, (jc, jp), dev in zip(s.shards, s.J, s.mesh.devices)]


def _jtmv_c(s: SchurSystem, u) -> torch.Tensor:
    dt = s.cam_free.dtype
    return s.mesh.sum([shard_jtmv_c(fams, jc, jp, us, s.num_ref, s.total, dt, dev)
                       for fams, (jc, jp), us, dev in zip(s.shards, s.J, u, s.mesh.devices)])


def _jtmv_p(s: SchurSystem, u) -> torch.Tensor:
    dt = s.cam_free.dtype
    return s.mesh.sum([shard_jtmv_p(fams, jc, jp, us, s.num_points, dt, dev)
                       for fams, (jc, jp), us, dev in zip(s.shards, s.J, u, s.mesh.devices)])


def schur_matvec_plain(system: SchurSystem, x: torch.Tensor) -> torch.Tensor:
    """S x by gathers, batched block products and ``index_add_``."""
    u = _jmv(system, x * system.cam_free, None)
    w = solve3(system.hpp_inv, _jtmv_p(system, u))
    z = _jmv(system, None, w)
    return (_jtmv_c(system, [a - b for a, b in zip(u, z)]) * system.cam_free
            + system.dc * x)


def schur_rhs_plain(system: SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor) -> torch.Tensor:
    gc0 = _jtmv_c(system, _jmv(system, None, solve3(system.hpp_inv, g_p)))
    return -(g_c - gc0 * system.cam_free)


def row_products_plain(system: SchurSystem, x: torch.Tensor):
    u = _jmv(system, x * system.cam_free, None)
    return u, _jtmv_p(system, u)


# ----------------------------------------------------------------------------
# The kernels (csrc/schur_mv.cu)
# ----------------------------------------------------------------------------


class _ShardPlan(NamedTuple):
    device: torch.device
    table: ctypes.Array            # _FIELDS int64 per family with a camera block
    families: int
    u_len: int                     # rows x k of every family of the shard
    u_zero: bool                   # a family without camera block: its u is 0
    cam_free: torch.Tensor         # on the shard's device
    hpp_inv: torch.Tensor


def _lib():
    lib = cuda_build.load_library(SOURCE)
    if lib.mv_schur.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mv_schur.argtypes = ([i32, p, i32, i32, p, p, p, p, i64, i64, i64] + [p] * 6
                                 + [i64, p, p])
        lib.mv_schur.restype = ctypes.c_int
        # cg_solve_kernel's entry (solver/cg_solve.py)
        f64 = ctypes.c_double
        lib.mv_cg_solve.argtypes = ([i32, p, i32] + [p] * 7 + [i64] * 4 + [i32, i32, f64]
                                    + [p] * 11 + [i64, p, p, p])
        lib.mv_cg_solve.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "schur_mv kernel")


def _shard_plan(system: SchurSystem, s: int) -> _ShardPlan:
    dev = _device(system.mesh.devices[s])
    dtype = system.cam_free.dtype
    if dev.type != "cuda":
        raise ValueError(f"schur_mv kernel: shard {s} lies on {dev}, not on a CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"schur_mv kernel: float32 or float64, got {dtype}")
    fields, u_len, u_zero = [], 0, False
    fams, (jc, jp) = system.shards[s], system.J[s]
    i64 = torch.int64
    for i, (f, a, b) in enumerate(zip(fams, jc, jp)):
        n, k = (b if a is None else a).shape[:2]
        if a is None:
            u_zero = True
        else:
            if a.dim() != 3 or k not in (2, 3) or a.shape[2] < 14:
                raise ValueError(f"schur_mv kernel: family {i}'s camera block has shape "
                                 f"{tuple(a.shape)}, expected [N, 2 or 3, B >= 14]")
            B = a.shape[2]
            _check(f"family {i}'s camera block", a, (n, k, B), dtype, dev)
            _check(f"family {i}'s beg_idx", f.beg_idx, (n,), i64, dev)
            _check(f"family {i}'s end_idx", f.end_idx, (n,), i64, dev)
            _check(f"family {i}'s const_cols", f.const_cols, (B - 14,), i64, dev)
            if b is not None:
                _check(f"family {i}'s point block", b, (n, k, 3), dtype, dev)
                _check(f"family {i}'s point_idx", f.point_idx, (n,), i64, dev)
            if system.halves is not None:
                for x in (a, b):
                    system.halves.check(f"schur_mv kernel: family {i}'s block", x)
            fields += [a.data_ptr(), 0 if b is None else b.data_ptr(), f.beg_idx.data_ptr(),
                       f.end_idx.data_ptr(), f.const_cols.data_ptr(),
                       0 if b is None else f.point_idx.data_ptr(), n, u_len, k, B]
        u_len += n * k
    if len(fields) > _MAX_FAMILIES * _FIELDS:
        raise ValueError(f"schur_mv kernel: shard {s} has {len(fields) // _FIELDS} families "
                         f"with a camera block, more than the kernel's {_MAX_FAMILIES}")
    table = (ctypes.c_longlong * max(len(fields), 1))(*fields)
    hpp_inv = system.hpp_inv.to(dev)
    _check("hpp_inv", hpp_inv, (system.num_points, 3, 3), dtype, dev)
    cam_free = system.cam_free.to(dev)
    _check("cam_free", cam_free, (system.total,), dtype, dev)
    return _ShardPlan(dev, table, len(fields) // _FIELDS, u_len, u_zero, cam_free, hpp_inv)


def _plans(system: SchurSystem, x: Optional[torch.Tensor]) -> List[_ShardPlan]:
    if system._plans is None:
        _check("dc", system.dc, (system.total,), system.cam_free.dtype,
               _device(system.mesh.lead))
        system._plans = [_shard_plan(system, s) for s in range(len(system.shards))]
    if x is not None:
        _check("x", x, (system.total,), system.cam_free.dtype, system._plans[0].device)
    return system._plans


def halves_of(system: SchurSystem, dev):
    """(the address of the LM loop's selector on ``dev``, the halves'
    stride in bytes), or (None, 0) for a system without halves."""
    return (None, 0) if system.halves is None else system.halves.of(dev)


def _launch(system: SchurSystem, plan: _ShardPlan, passes: int, x, dc, g_p, out, u,
            halt: Optional[torch.Tensor] = None) -> None:
    """One cooperative launch of csrc/schur_mv.cu on the plan's shard
    (``halt``: the LM loop's stop flag there; where set it returns at once)."""
    global LAUNCHES, LAST_LAUNCH
    dt = plan.cam_free.dtype
    info = (ctypes.c_longlong * 8)() if RECORD_LAUNCH else None
    w = torch.empty((system.num_points, 3), dtype=dt, device=plan.device) if passes & _CAMERA \
        else None
    sel, half = halves_of(system, plan.device)
    with torch.cuda.device(plan.device):
        err = _lib().mv_schur(
            dt.itemsize, plan.table, plan.families, passes, _ptr(x), plan.cam_free.data_ptr(),
            _ptr(dc), plan.hpp_inv.data_ptr(), system.num_points, system.total,
            system.num_ref, _ptr(g_p), _ptr(w), _ptr(out), _ptr(u), _ptr(halt), sel, half, info,
            cuda_build.stream(plan.device))
    if err != 0:
        raise RuntimeError(f"schur_mv kernel (passes {passes}) failed with cudaError {err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = dict(zip(("grid", "threads", "tile_rows", "slots", "resident_rows",
                                "window_poses", "x_in_shared", "pose_copies"), list(info)),
                           passes=passes)


def point_pass_cuda(system: SchurSystem, plan: _ShardPlan, x: torch.Tensor, want_u: bool,
                    out=None, halt: Optional[torch.Tensor] = None):
    """(J_p^T u [P,3], u flat [rows x k] or None) of one shard on the card,
    u = J_c (cam_free * x): one launch of the point pass. ``out``: the two
    outputs' tensors to write (u's rows of a family without a camera block
    are not written: zero them once)."""
    dt = plan.cam_free.dtype
    if out is None:
        g_p = torch.empty((system.num_points, 3), dtype=dt, device=plan.device)
        u = None
        if want_u:
            u = (torch.zeros if plan.u_zero else torch.empty)(plan.u_len, dtype=dt,
                                                              device=plan.device)
    else:
        g_p, u = out
        _check("J_p^T u", g_p, (system.num_points, 3), dt, plan.device)
        _check("u", u, (plan.u_len,), dt, plan.device)
    _launch(system, plan, _POINT, x, None, g_p, None, u, halt)
    return g_p, u


def camera_pass_cuda(system: SchurSystem, plan: _ShardPlan, x: Optional[torch.Tensor],
                     g_p: torch.Tensor, dc: Optional[torch.Tensor]) -> torch.Tensor:
    """dc * x + cam_free * J_c^T (u - J_p Hpp^-1 g_p) [C] of one shard on the
    card (x None: u = 0; dc None: no dc * x): one launch of the camera pass."""
    dt = plan.cam_free.dtype
    g_p = g_p.to(plan.device).contiguous()
    _check("g_p", g_p, (system.num_points, 3), dt, plan.device)
    out = torch.empty(system.total, dtype=dt, device=plan.device)
    _launch(system, plan, _CAMERA, x, None if dc is None else dc.to(plan.device), g_p, out,
            None)
    return out


def schur_matvec_cuda(system: SchurSystem, x: torch.Tensor) -> torch.Tensor:
    plans = _plans(system, x)
    if system.mesh.size == 1:
        # one shard over every process: one launch (point pass, grid barrier,
        # camera pass)
        plan = plans[0]
        g_p = torch.empty((system.num_points, 3), dtype=x.dtype, device=plan.device)
        u = torch.empty(plan.u_len, dtype=x.dtype, device=plan.device)
        out = torch.empty_like(x)
        _launch(system, plan, _POINT | _CAMERA, x, system.dc, g_p, out, u)
        return out
    # a shard's g_p is summed over every shard (and process) between the
    # passes; dc * x is added on the first shard of all
    xs = [x.to(p.device) for p in plans]
    g_p = system.mesh.sum([point_pass_cuda(system, p, xi, False)[0]
                           for p, xi in zip(plans, xs)])
    first = [system.mesh.global_index(i) == 0 for i in range(len(plans))]
    return system.mesh.sum([camera_pass_cuda(system, p, xi, g_p, system.dc if f else None)
                            for p, xi, f in zip(plans, xs, first)])


def schur_rhs_cuda(system: SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor) -> torch.Tensor:
    plans = _plans(system, None)
    # the camera pass with u = 0 gives -cam_free * J_c^T J_p Hpp^-1 g_p
    return -(g_c + system.mesh.sum([camera_pass_cuda(system, p, None, g_p, None)
                                    for p in plans]))


def row_products_cuda(system: SchurSystem, x: torch.Tensor, out=None,
                      halt: Optional[torch.Tensor] = None):
    """``out`` (per shard the (J_p^T u, u) tensors to write) and ``halt``
    (the lead shard's stop flag) as ``point_pass_cuda`` takes them."""
    plans = _plans(system, x)
    parts = [point_pass_cuda(system, p, x.to(p.device), True, None if out is None else out[i],
                             halt if i == 0 else None)
             for i, p in enumerate(plans)]
    return [u for _, u in parts], system.mesh.sum([g for g, _ in parts])


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def schur_matvec(system: SchurSystem, x: torch.Tensor) -> torch.Tensor:
    """S x: the plain version for a CPU tensor, the kernel for a CUDA tensor
    (which raises on anything it does not take)."""
    if x.device.type == "cpu":
        return schur_matvec_plain(system, x)
    return schur_matvec_cuda(system, x)


def schur_rhs(system: SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor) -> torch.Tensor:
    """-(g_c - cam_free * J_c^T J_p Hpp^-1 g_p), dispatched as ``schur_matvec``."""
    if g_c.device.type == "cpu":
        return schur_rhs_plain(system, g_c, g_p)
    return schur_rhs_cuda(system, g_c, g_p)


def row_products(system: SchurSystem, x: torch.Tensor, out=None,
                 halt: Optional[torch.Tensor] = None):
    """(u per shard, flat in residual order, and J_p^T u summed over the
    shards), u = J_c (cam_free * x); dispatched as ``schur_matvec``
    (``out`` and ``halt`` are the kernel's: ``row_products_cuda``)."""
    if x.device.type == "cpu":
        return row_products_plain(system, x)
    return row_products_cuda(system, x, out, halt)
