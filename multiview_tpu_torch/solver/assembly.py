"""The per-iteration assembly of the BA's Schur-LM (``solver/schur.py``):
from one LM iteration's row blocks, residuals and damping ``lam``,

- the gradient g_c = cam_free * J_c^T r and g_p = J_p^T r (unless the
  caller takes it from elsewhere: ``linear_solver`` "cg" takes it from its
  linearization);
- Hpp = J_p^T J_p per point and the Jacobi diagonal of the camera columns;
- pt_diag, Hpp^-1 = ``inv3x3_spd(Hpp + lam diag(pt_diag))``, dc and the
  scalar preconditioner;
- SCHUR_JACOBI only: per pose the 7x7 block of S = B - E Hpp^-1 E^T, exact
  per row and side, summed per pose, plus diag(dc), inverted.

``assemble(...)`` -> ``Assembly``. On CUDA tensors it runs the hand-written
kernel ``csrc/lm_assembly.cu`` (``assemble_cuda``: one cooperative launch on
one shard; with several shards a rows-pass launch a shard, a points-pass
launch, a blocks-pass launch a shard and a poses-pass launch, the shards'
sums added between them); it computes in float64 and rounds its outputs. An
``AssemblyPlan`` kept over a solve holds the kernel's table, checked once,
and its outputs and scratch, allocated once; each LM iteration refreshes
only the pointers of its J and r. On
CPU tensors it runs the plain composition the solver held before the kernel
existed (``assemble_plain``); nothing on the card gives way to it.

Sharding: each shard computes its partials, ``mesh.sum`` adds them before
Hpp is inverted, then the 7x7 pass runs per shard on the summed Hpp^-1 and
``mesh.sum`` adds its blocks. A singular 7x7 block: ``torch.linalg.inv``
raises on the CPU; the kernel sets a device flag instead, which
``stop_test`` reads in the LM loop's host read of its state
(``lm_step.read``) and raises on. Where the loop's stop flag ``halt`` is
set, the one-shard launch returns at once. ``LAUNCHES`` counts the kernel's launches. A family is any object
as ``schur_matvec`` takes it (``beg_idx`` / ``end_idx`` / ``const_cols`` where
it has a camera block, ``point_idx`` where it touches points)."""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple, Optional, Sequence

import torch

from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.solver import schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build
from multiview_tpu_torch.utils.device import indexed_device as _device

SOURCE = "lm_assembly.cu"
# kernel launches of csrc/lm_assembly.cu, one each
LAUNCHES = 0
# with RECORD_LAUNCH set, the shape of the last launch (LAST_LAUNCH): grid,
# threads a block, dynamic shared memory, the poses of the warps' window
# copies in shared memory, rows a tile, the ring's slots, chunks of 32 rows,
# the rows the blocks pass found in shared memory, the bytes of rows read
# from device memory
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
# with RECORD_MARKS set, LAST_MARKS: the last launch's %globaltimer stamps,
# [_MAX_GRID, 5] int64, a row a block (its start and the end of each pass it
# ran; rows past the grid and passes not run stay 0)
RECORD_MARKS = False
LAST_MARKS: Optional[torch.Tensor] = None
_MAX_GRID = 1024
_FIELDS = 10            # int64 fields of one family in the kernel's table
_MAX_FAMILIES = 32      # families a shard the kernel takes
_ROWS, _POINTS, _BLOCKS, _POSES = 1, 2, 4, 8  # the kernel's passes


class Assembly(NamedTuple):
    g_c: Optional[torch.Tensor]       # [C] cam_free * J_c^T r (None: not asked)
    g_p: Optional[torch.Tensor]       # [P,3] J_p^T r (None: not asked)
    hpp: torch.Tensor                 # [P,3,3] J_p^T J_p
    cam_diag: torch.Tensor            # [C] the Jacobi diagonal, clamped to [1e-12, 1e32]
    pt_diag: torch.Tensor             # [P,3] diag Hpp, clamped
    hpp_inv: torch.Tensor             # [P,3,3] (Hpp + lam diag(pt_diag))^-1
    dc: torch.Tensor                  # [C] lam * cam_diag * cam_free + (1 - cam_free)
    precond: torch.Tensor             # [C] 1 / (cam_diag * cam_free + dc)
    pose_inv: Optional[torch.Tensor]  # [R,7,7] SCHUR_JACOBI's inverted blocks (None: not asked)


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
# The plain version
# ----------------------------------------------------------------------------


def assemble_plain(mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
                   cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
                   block_precond: bool, singular: Optional[torch.Tensor] = None) -> Assembly:
    """``index_add_`` of the row products per shard, ``mesh.sum``, the
    closed-form 3x3 inverses and ``torch.linalg.inv`` of the 7x7 blocks
    (which raises on a singular one; ``singular`` is not read)."""
    total, dtype, devs = cam_free.shape[0], cam_free.dtype, mesh.devices
    g_c = g_p = None
    if r is not None:
        gc_raw = mesh.sum([smv.shard_jtmv_c(fams, jc, jp, rs, num_ref, total, dtype, devs[s])
                           for s, (fams, (jc, jp), rs) in enumerate(zip(shards, J, r))])
        g_p = mesh.sum([smv.shard_jtmv_p(fams, jc, jp, rs, num_points, dtype, devs[s])
                        for s, (fams, (jc, jp), rs) in enumerate(zip(shards, J, r))])
        g_c = gc_raw * cam_free

    hpp_parts, diag_parts = [], []
    for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
        hpp = torch.zeros((num_points, 3, 3), dtype=dtype, device=devs[s])
        for f, b in zip(fams, jp):
            if b is not None:
                hpp.index_add_(0, f.point_idx, torch.einsum("nki,nkj->nij", b, b))
        hpp_parts.append(hpp)
        diag_parts.append(smv.reduce_cols([(f, torch.sum(a * a, dim=1))
                                           for f, a in zip(fams, jc) if a is not None],
                                          num_ref, total, dtype, devs[s]))
    hpp = mesh.sum(hpp_parts)
    cam_diag = torch.clamp(mesh.sum(diag_parts), 1e-12, 1e32)
    pt_diag = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), 1e-12, 1e32)
    hpp_inv = inv3x3_spd(hpp + torch.diag_embed(lam * pt_diag))
    dc = lam * cam_diag * cam_free + (1.0 - cam_free)
    precond = 1.0 / (cam_diag * cam_free + dc)

    pose_inv = None
    if block_precond:
        # SCHUR_JACOBI: exact-per-row 7x7 pose blocks of S = B - E Hpp^-1 E^T;
        # non-pose parameters stay scalar. A second round over the shards:
        # each row's E Hpp^-1 E^T reads the summed Hpp
        free_pose = cam_free[:num_ref * 7].reshape(num_ref, 7)
        block_parts = []
        for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
            fp, hi = free_pose.to(devs[s]), hpp_inv.to(devs[s])
            blocks = torch.zeros((num_ref, 7, 7), dtype=dtype, device=devs[s])
            for f, a, b in zip(fams, jc, jp):
                if a is None:
                    continue
                for sl, idx in ((slice(0, 7), f.beg_idx), (slice(7, 14), f.end_idx)):
                    jb = a[:, :, sl] * fp[idx][:, None, :]              # [N,k,7]
                    bb = torch.einsum("nki,nkj->nij", jb, jb)
                    if b is not None:
                        E = torch.einsum("nki,nkm->nim", jb, b)         # [N,7,3]
                        bb = bb - torch.einsum("nim,nmq,njq->nij", E, hi[f.point_idx], E)
                    blocks.index_add_(0, idx, bb)
            block_parts.append(blocks)
        blocks = mesh.sum(block_parts) + torch.diag_embed(dc[:num_ref * 7].reshape(num_ref, 7))
        pose_inv = torch.linalg.inv(blocks)
    return Assembly(g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc, precond, pose_inv)


# ----------------------------------------------------------------------------
# The kernel (csrc/lm_assembly.cu)
# ----------------------------------------------------------------------------


def _lib():
    lib = cuda_build.load_library(SOURCE)
    if lib.mv_lm_assembly.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mv_lm_assembly.argtypes = [i32, p, i32, i32, i32, p, p, i64, i64, i64] + [p] * 17
        lib.mv_lm_assembly.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "lm_assembly kernel")


class _ShardTable:
    """One shard's families in the kernel's table (``_FIELDS`` int64 each),
    their tensors checked once; ``refresh`` points it at one LM iteration's
    J and r (the index tensors stay those of the solve)."""

    def __init__(self, fams, jc, jp, r: Optional[torch.Tensor], dtype, dev, s: int):
        i64 = torch.int64
        fields, self.shapes, off = [], [], 0
        for i, (f, a, b) in enumerate(zip(fams, jc, jp)):
            if a is None and b is None:
                raise ValueError(f"lm_assembly kernel: shard {s}'s family {i} has no block")
            n, k = (b if a is None else a).shape[:2]
            if k not in (2, 3):
                raise ValueError(f"lm_assembly kernel: shard {s}'s family {i} has {k} components "
                                 f"a row, expected 2 or 3")
            B = 0
            if a is not None:
                if a.dim() != 3 or a.shape[2] < 14:
                    raise ValueError(f"lm_assembly kernel: family {i}'s camera block has shape "
                                     f"{tuple(a.shape)}, expected [N, k, B >= 14]")
                B = a.shape[2]
                _check(f"family {i}'s camera block", a, (n, k, B), dtype, dev)
                _check(f"family {i}'s beg_idx", f.beg_idx, (n,), i64, dev)
                _check(f"family {i}'s end_idx", f.end_idx, (n,), i64, dev)
                _check(f"family {i}'s const_cols", f.const_cols, (B - 14,), i64, dev)
            if b is not None:
                _check(f"family {i}'s point block", b, (n, k, 3), dtype, dev)
                _check(f"family {i}'s point_idx", f.point_idx, (n,), i64, dev)
            fields += [0, 0, 0 if a is None else f.beg_idx.data_ptr(),
                       0 if a is None else f.end_idx.data_ptr(),
                       0 if a is None else f.const_cols.data_ptr(),
                       0 if b is None else f.point_idx.data_ptr(), 0, n, k, B]
            self.shapes.append((None if a is None else tuple(a.shape),
                                None if b is None else tuple(b.shape), off))
            off += n * k
        if len(fams) > _MAX_FAMILIES:
            raise ValueError(f"lm_assembly kernel: shard {s} has {len(fams)} families, more "
                             f"than the kernel's {_MAX_FAMILIES}")
        if r is not None:
            _check(f"shard {s}'s residuals", r, (off,), dtype, dev)
        self.rows = off
        self.table = (ctypes.c_longlong * max(len(fields), 1))(*fields)
        self.families = len(fams)
        self.refresh(jc, jp, r)

    def refresh(self, jc, jp, r: Optional[torch.Tensor]) -> None:
        """The J and r pointers of this iteration's tensors (each of the
        solve's shape, contiguous: ``torch.where`` of two such makes one)."""
        if r is not None and (r.numel() != self.rows or not r.is_contiguous()):
            raise ValueError(f"lm_assembly kernel: {r.numel()} residuals for the table's "
                             f"{self.rows}, or not contiguous")
        t = self.table
        for i, ((sa, sb, off), a, b) in enumerate(zip(self.shapes, jc, jp)):
            for shape, x in ((sa, a), (sb, b)):
                if (x is None) != (shape is None) or (x is not None and (
                        tuple(x.shape) != shape or not x.is_contiguous())):
                    raise ValueError(f"lm_assembly kernel: family {i}'s block is not of the "
                                     f"solve's shape {shape}, or not contiguous")
            t[i * _FIELDS] = 0 if a is None else a.data_ptr()
            t[i * _FIELDS + 1] = 0 if b is None else b.data_ptr()
            t[i * _FIELDS + 6] = 0 if r is None else r.data_ptr() + off * r.element_size()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_OUTPUTS = ("g_c", "g_p", "hpp", "cam_diag", "pt_diag", "hpp_inv", "dc", "precond", "pose_inv")
_INFO = ("grid", "threads", "shared_bytes", "window_poses", "tile_rows", "slots", "chunks",
         "resident_rows", "row_bytes_read")


def _launch(passes: int, zero_first: bool, table: _ShardTable, dev, cam_free, lam,
            num_points: int, num_ref: int, acc=None, blocks=None, hinv=None,
            out: Optional[dict] = None, singular=None, halt=None) -> None:
    """One cooperative launch of csrc/lm_assembly.cu on ``dev`` (``halt``: the
    LM loop's stop flag on ``dev``, where set the launch returns at once)."""
    global LAUNCHES, LAST_LAUNCH, LAST_MARKS
    out = out or {}
    info = (ctypes.c_longlong * len(_INFO))() if RECORD_LAUNCH else None
    marks = torch.zeros((_MAX_GRID, 5), dtype=torch.int64, device=dev) if RECORD_MARKS else None
    with torch.cuda.device(dev):
        err = _lib().mv_lm_assembly(
            cam_free.element_size(), table.table, table.families, passes, int(zero_first),
            cam_free.data_ptr(), lam.data_ptr(), num_points, cam_free.shape[0], num_ref,
            _ptr(acc), _ptr(blocks), _ptr(hinv), *(_ptr(out.get(k)) for k in _OUTPUTS),
            _ptr(singular), _ptr(halt), _ptr(marks), info,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lm_assembly kernel (passes {passes}) failed with cudaError {err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = dict(zip(_INFO, list(info)), passes=passes)
    if marks is not None:
        LAST_MARKS = marks


_EMPTY = types.SimpleNamespace(table=(ctypes.c_longlong * 1)(), families=0)


def _require_card(lead, devs) -> None:
    """Raises where the lead shard or a shard does not lie on a CUDA device."""
    if lead.type != "cuda":
        raise ValueError(f"lm_assembly kernel: the lead shard lies on {lead}, not on a CUDA "
                         f"device")
    for s, d in enumerate(devs):
        if d.type != "cuda":
            raise ValueError(f"lm_assembly kernel: shard {s} lies on {d}, not on a CUDA device")


def new_flag(device) -> torch.Tensor:
    """The device flag the kernel sets on a singular 7x7 block (0 at first)."""
    return torch.zeros((), dtype=torch.int32, device=device)


class AssemblyPlan:
    """What the kernel's launches of one solve share: each shard's table,
    its tensors checked once (each launch refreshes only the J and r
    pointers), the outputs and the float64 scratch, allocated once (the
    single-shard launch leaves its scratch at 0 for the next). The outputs
    of one call are overwritten by the next: read them before it. Built at
    the first call on the card; a call with other families, mesh, dtype or
    sizes builds it anew."""

    def __init__(self):
        self._key = self._cam_free = self._singular = self._halt = None

    def _build(self, key, mesh: ShardMesh, shards, J, r, cam_free, num_ref: int,
               num_points: int, block_precond: bool) -> None:
        lead = _device(mesh.lead)
        dtype, C, P, R = cam_free.dtype, cam_free.shape[0], num_points, num_ref
        self.devs = [_device(d) for d in mesh.devices]
        _require_card(lead, self.devs)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"lm_assembly kernel: float32 or float64, got {dtype}")
        self.tables = [_ShardTable(fams, jc, jp, None if r is None else r[s], dtype,
                                   self.devs[s], s)
                       for s, (fams, (jc, jp)) in enumerate(zip(shards, J))]
        f64 = torch.float64
        self.out = {"hpp": torch.empty((P, 3, 3), dtype=dtype, device=lead),
                    "cam_diag": torch.empty(C, dtype=dtype, device=lead),
                    "pt_diag": torch.empty((P, 3), dtype=dtype, device=lead),
                    "hpp_inv": torch.empty((P, 3, 3), dtype=dtype, device=lead),
                    "dc": torch.empty(C, dtype=dtype, device=lead),
                    "precond": torch.empty(C, dtype=dtype, device=lead)}
        if r is not None:
            self.out["g_c"] = torch.empty(C, dtype=dtype, device=lead)
            self.out["g_p"] = torch.empty((P, 3), dtype=dtype, device=lead)
        if block_precond:
            self.out["pose_inv"] = torch.empty((R, 7, 7), dtype=dtype, device=lead)
        self.hinv = torch.empty(P * 9, dtype=f64, device=lead) if block_precond else None
        acc_len = 2 * C + 9 * P
        if mesh.size == 1:
            # the launch finds its sums at 0 and leaves them so
            self.acc = [torch.zeros(acc_len, dtype=f64, device=lead)]
            self.blocks = [torch.zeros(R * 28, dtype=f64, device=lead)] if block_precond \
                else [None]
        else:
            self.acc = [torch.empty(acc_len, dtype=f64, device=d) for d in self.devs]
            self.blocks = [torch.empty(R * 28, dtype=f64, device=d) if block_precond else None
                           for d in self.devs]
        self._mesh, self._shards, self._key = mesh, shards, key

    def __call__(self, mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
                 cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
                 block_precond: bool, singular: Optional[torch.Tensor] = None,
                 halt: Optional[torch.Tensor] = None) -> Assembly:
        key = (cam_free.dtype, r is None, block_precond, cam_free.shape[0], num_points, num_ref)
        if not (self._key == key and self._mesh is mesh and self._shards is shards):
            self._build(key, mesh, shards, J, r, cam_free, num_ref, num_points, block_precond)
        else:
            for s, (table, (jc, jp)) in enumerate(zip(self.tables, J)):
                table.refresh(jc, jp, None if r is None else r[s])
        lead, P, R = _device(mesh.lead), num_points, num_ref
        # cam_free and the flag stay over a solve: checked when they change;
        # lam is new each LM iteration: its dtype, device and shape
        if cam_free is not self._cam_free:
            _check("cam_free", cam_free, (cam_free.shape[0],), cam_free.dtype, lead)
            self._cam_free = cam_free
        if not (lam.dtype == cam_free.dtype and lam.device == lead and lam.dim() == 0):
            _check("lam", lam, (), cam_free.dtype, lead)
        if block_precond:
            if singular is None:
                singular = new_flag(lead)
            if singular is not self._singular:
                _check("the singular flag", singular, (), torch.int32, lead)
                self._singular = singular
        if halt is not None and halt is not self._halt:
            _check("the stop flag", halt, (), torch.int32, lead)
            self._halt = halt
        out, hinv = self.out, self.hinv
        if mesh.size == 1:
            # one shard over every process: one launch of every pass
            passes = _ROWS | _POINTS | ((_BLOCKS | _POSES) if block_precond else 0)
            _launch(passes, False, self.tables[0], lead, cam_free, lam, P, R, self.acc[0],
                    self.blocks[0], hinv, out, singular, halt)
        else:
            for table, acc, d in zip(self.tables, self.acc, self.devs):
                _launch(_ROWS, True, table, d, cam_free.to(d), lam.to(d), P, R, acc)
            acc = mesh.sum(self.acc)
            _launch(_POINTS, True, _EMPTY, lead, cam_free, lam, P, R, acc, None, hinv, out)
            if block_precond:
                for table, part, d in zip(self.tables, self.blocks, self.devs):
                    _launch(_BLOCKS, True, table, d, cam_free.to(d), lam.to(d), P, R, None, part,
                            hinv.to(d))
                _launch(_POSES, True, _EMPTY, lead, cam_free, lam, P, R, acc,
                        mesh.sum(self.blocks), None, out, singular)
        return Assembly(*(out.get(k) for k in _OUTPUTS))


def assemble_cuda(mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
                  cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
                  block_precond: bool, singular: Optional[torch.Tensor] = None,
                  plan: Optional[AssemblyPlan] = None,
                  halt: Optional[torch.Tensor] = None) -> Assembly:
    """The assembly on the card: one cooperative launch on one shard, else a
    launch a pass and shard with ``mesh.sum`` between them. ``singular`` (an
    int32 0-d tensor on the lead device, from ``new_flag``) is set to 1 where
    a 7x7 block is singular; without it the kernel sets a flag of its own
    that nothing reads. ``plan`` (an ``AssemblyPlan`` kept over a solve)
    reuses its table and buffers; without it the call builds its own.
    ``halt`` (an int32 0-d tensor on the lead device: the LM loop's stop
    flag, ``lm_step.LMState.halt``): where it is set, the one-shard launch
    returns at once and the outputs keep their last values."""
    return (plan or AssemblyPlan())(mesh, shards, J, r, cam_free, lam, num_ref, num_points,
                                    block_precond, singular, halt)


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def assemble(mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
             cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
             block_precond: bool, singular: Optional[torch.Tensor] = None,
             plan: Optional[AssemblyPlan] = None, halt: Optional[torch.Tensor] = None) -> Assembly:
    """One LM iteration's assembly: ``shards`` per local shard of ``mesh`` its
    families, ``J`` per shard (camera blocks [N,k,B] or None, point blocks
    [N,k,3] or None) in family order, ``r`` per shard the flat residuals
    (None: no gradient), ``cam_free`` [C] and the 0-d ``lam`` on the lead
    device; ``block_precond``: also SCHUR_JACOBI's 7x7 inverses. The plain
    version for CPU tensors, the kernel for CUDA ones (``plan``, ``halt``:
    see ``assemble_cuda``; the plain version takes neither)."""
    if cam_free.device.type == "cpu":
        return assemble_plain(mesh, shards, J, r, cam_free, lam, num_ref, num_points,
                              block_precond, singular)
    return assemble_cuda(mesh, shards, J, r, cam_free, lam, num_ref, num_points, block_precond,
                         singular, plan, halt)


def stop_test(done: torch.Tensor, singular: torch.Tensor):
    """``bool(done)`` and the singular-block flag in one host sync; raises
    ``torch.linalg.LinAlgError`` where the kernel found a singular 7x7 block
    (as ``torch.linalg.inv`` does on the CPU)."""
    state = int(done.to(torch.int64) + 2 * singular.to(done.device))
    if state & 2:
        raise torch.linalg.LinAlgError(
            "lm_assembly kernel: a SCHUR_JACOBI 7x7 pose block is singular (a zero pivot); "
            "its inverse could not be completed")
    return bool(state & 1)
