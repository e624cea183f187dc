"""The Schur complement matvec of the BA's CG (``solver/schur.py``,
``linear_solver`` "cg_blocks") and the two products of an LM iteration that
share its passes:

    S x = cam_free * J_c^T (u - J_p Hpp^-1 J_p^T u) + dc * x,    u = J_c (cam_free * x)

- ``schur_matvec(system, x)``: S x, once per CG step;
- ``schur_rhs(system, g_c, g_p)``: the reduced system's right-hand side
  -(g_c - cam_free * J_c^T J_p Hpp^-1 g_p);
- ``row_products(system, x)``: u per shard and J_p^T u, the
  back-substitution's product.

On CUDA tensors each runs the hand-written kernels of ``csrc/schur_mv.cu``
(per shard a point pass and a camera pass, then one epilogue; see the
source). On CPU tensors each runs its plain version, the composition of
gathers, batched block products and ``index_add_`` that the solver ran
before the kernel existed; nothing on the card gives way to it. The kernel
adds with atomics, so on the card the order of the sums, and the last bits
of S x, vary from run to run (as ``index_add_`` does there).

The per-shard products (``shard_jmv``, ``shard_jtmv_c``, ``shard_jtmv_p``)
are also the solver's products with the row blocks outside the CG. A
family is any object with ``beg_idx`` / ``end_idx`` [N] int64 and
``const_cols`` [B-14] int64 (where it has a camera block) and ``point_idx``
[N] int64 (where it touches points), as ``schur._Family``."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.utils import cuda_build

SOURCE = "schur_mv.cu"
# kernel launches of csrc/schur_mv.cu: each pass and each epilogue adds one
LAUNCHES = 0
_FIELDS = 10            # int64 fields of one family in the kernel's table


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
    product on the card."""

    mesh: ShardMesh
    shards: Sequence[Sequence[object]]
    J: Sequence[Tuple[Sequence[Optional[torch.Tensor]], Sequence[Optional[torch.Tensor]]]]
    cam_free: torch.Tensor
    dc: torch.Tensor
    hpp_inv: torch.Tensor
    num_ref: int
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
    if lib.mv_schur_epilogue.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mv_schur_point_pass.argtypes = [i32, p, i32, p, p, i64, p, p, p, p]
        lib.mv_schur_camera_pass.argtypes = [i32, p, i32, p, p, p, p, i64, p, p, p]
        lib.mv_schur_epilogue.argtypes = [i32, i64, p, p, p, p, p, p]
        for fn in (lib.mv_schur_point_pass, lib.mv_schur_camera_pass, lib.mv_schur_epilogue):
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, dev):
    if t.dtype != dtype:
        raise TypeError(f"schur_mv kernel: {name} is {t.dtype}, expected {dtype}")
    if t.device != dev:
        raise ValueError(f"schur_mv kernel: {name} lies on {t.device}, expected {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"schur_mv kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"schur_mv kernel: {name} is not contiguous")


def _device(d) -> torch.device:
    """``d`` with its index (a bare "cuda" names the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


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
            if a.dim() != 3 or not 1 <= k <= 3 or a.shape[2] < 14:
                raise ValueError(f"schur_mv kernel: family {i}'s camera block has shape "
                                 f"{tuple(a.shape)}, expected [N, 1-3, B >= 14]")
            B = a.shape[2]
            _check(f"family {i}'s camera block", a, (n, k, B), dtype, dev)
            _check(f"family {i}'s beg_idx", f.beg_idx, (n,), i64, dev)
            _check(f"family {i}'s end_idx", f.end_idx, (n,), i64, dev)
            _check(f"family {i}'s const_cols", f.const_cols, (B - 14,), i64, dev)
            if b is not None:
                _check(f"family {i}'s point block", b, (n, k, 3), dtype, dev)
                _check(f"family {i}'s point_idx", f.point_idx, (n,), i64, dev)
            fields += [a.data_ptr(), 0 if b is None else b.data_ptr(), f.beg_idx.data_ptr(),
                       f.end_idx.data_ptr(), f.const_cols.data_ptr(),
                       0 if b is None else f.point_idx.data_ptr(), n, u_len, k, B]
        u_len += n * k
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def point_pass_cuda(plan: _ShardPlan, x: torch.Tensor, num_points: int, want_u: bool):
    """(J_p^T u [P,3], u flat [rows x k] or None) of one shard on the card,
    u = J_c (cam_free * x)."""
    global LAUNCHES
    dt = plan.cam_free.dtype
    g_p = torch.empty((num_points, 3), dtype=dt, device=plan.device)
    u = None
    if want_u:
        u = (torch.zeros if plan.u_zero else torch.empty)(plan.u_len, dtype=dt,
                                                          device=plan.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(plan.device):
        err = _lib().mv_schur_point_pass(
            dt.itemsize, plan.table, plan.families, x.data_ptr(), plan.cam_free.data_ptr(),
            num_points, g_p.data_ptr(), _ptr(u), ctypes.byref(launched),
            torch.cuda.current_stream(plan.device).cuda_stream)
    LAUNCHES += launched.value
    if err != 0:
        raise RuntimeError(f"schur_mv point pass failed with cudaError {err}")
    return g_p, u


def camera_pass_cuda(plan: _ShardPlan, x: Optional[torch.Tensor], g_p: torch.Tensor,
                     total: int) -> torch.Tensor:
    """J_c^T (u - J_p Hpp^-1 g_p) [C] of one shard on the card; x None: u = 0."""
    global LAUNCHES
    dt = plan.cam_free.dtype
    g_c = torch.empty(total, dtype=dt, device=plan.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(plan.device):
        err = _lib().mv_schur_camera_pass(
            dt.itemsize, plan.table, plan.families, _ptr(x), plan.cam_free.data_ptr(),
            plan.hpp_inv.data_ptr(), g_p.data_ptr(), total, g_c.data_ptr(),
            ctypes.byref(launched), torch.cuda.current_stream(plan.device).cuda_stream)
    LAUNCHES += launched.value
    if err != 0:
        raise RuntimeError(f"schur_mv camera pass failed with cudaError {err}")
    return g_c


def epilogue_cuda(g_c: torch.Tensor, cam_free: torch.Tensor, dc: Optional[torch.Tensor],
                  x: Optional[torch.Tensor]) -> torch.Tensor:
    """cam_free * g_c + dc * x on the card; x None: cam_free * g_c."""
    global LAUNCHES
    out = torch.empty_like(g_c)
    with torch.cuda.device(g_c.device):
        err = _lib().mv_schur_epilogue(
            g_c.dtype.itemsize, g_c.shape[0], g_c.data_ptr(), cam_free.data_ptr(), _ptr(dc),
            _ptr(x), out.data_ptr(), torch.cuda.current_stream(g_c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"schur_mv epilogue failed with cudaError {err}")
    LAUNCHES += 1
    return out


def schur_matvec_cuda(system: SchurSystem, x: torch.Tensor) -> torch.Tensor:
    plans = _plans(system, x)
    xs = [x.to(p.device) for p in plans]
    g_p = system.mesh.sum([point_pass_cuda(p, xi, system.num_points, False)[0]
                           for p, xi in zip(plans, xs)])
    g_c = system.mesh.sum([camera_pass_cuda(p, xi, g_p.to(p.device), system.total)
                           for p, xi in zip(plans, xs)])
    return epilogue_cuda(g_c, system.cam_free, system.dc, x)


def schur_rhs_cuda(system: SchurSystem, g_c: torch.Tensor, g_p: torch.Tensor) -> torch.Tensor:
    plans = _plans(system, None)
    gc0 = system.mesh.sum([camera_pass_cuda(p, None, g_p.to(p.device), system.total)
                           for p in plans])
    # the camera pass with u = 0 gives -J_c^T J_p Hpp^-1 g_p
    return -(g_c + epilogue_cuda(gc0, system.cam_free, None, None))


def row_products_cuda(system: SchurSystem, x: torch.Tensor):
    plans = _plans(system, x)
    parts = [point_pass_cuda(p, x.to(p.device), system.num_points, True) for p in plans]
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


def row_products(system: SchurSystem, x: torch.Tensor):
    """(u per shard, flat in residual order, and J_p^T u summed over the
    shards), u = J_c (cam_free * x); dispatched as ``schur_matvec``."""
    if x.device.type == "cpu":
        return row_products_plain(system, x)
    return row_products_cuda(system, x)
