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
sums added between them); it computes in float64 and rounds its outputs. On
CPU tensors it runs the plain composition the solver held before the kernel
existed (``assemble_plain``); nothing on the card gives way to it.

Sharding: each shard computes its partials, ``mesh.sum`` adds them before
Hpp is inverted, then the 7x7 pass runs per shard on the summed Hpp^-1 and
``mesh.sum`` adds its blocks. A singular 7x7 block: ``torch.linalg.inv``
raises on the CPU; the kernel sets a device flag instead, which
``stop_test`` reads in the LM loop's one host sync of an iteration and
raises on. ``LAUNCHES`` counts the kernel's launches. A family is any object
as ``schur_matvec`` takes it (``beg_idx`` / ``end_idx`` / ``const_cols`` where
it has a camera block, ``point_idx`` where it touches points)."""

from __future__ import annotations

import ctypes
import functools
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
# threads a block, dynamic shared memory, whether the camera sums and the pose
# blocks' sums took a copy a warp in shared memory, chunks of 32 rows
RECORD_LAUNCH = False
LAST_LAUNCH: dict = {}
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
        lib.mv_lm_assembly.argtypes = [i32, p, i32, i32, p, p, i64, i64, i64] + [p] * 15
        lib.mv_lm_assembly.restype = ctypes.c_int
    return lib


_check = functools.partial(cuda_build.check_tensor, "lm_assembly kernel")


def _table(fams, jc, jp, r: Optional[torch.Tensor], dtype, dev, s: int):
    """The kernel's table of one shard's families (and the count)."""
    i64 = torch.int64
    fields, off = [], 0
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
        fields += [0 if a is None else a.data_ptr(), 0 if b is None else b.data_ptr(),
                   0 if a is None else f.beg_idx.data_ptr(),
                   0 if a is None else f.end_idx.data_ptr(),
                   0 if a is None else f.const_cols.data_ptr(),
                   0 if b is None else f.point_idx.data_ptr(),
                   0 if r is None else r.data_ptr() + off * r.element_size(), n, k, B]
        off += n * k
    if len(fams) > _MAX_FAMILIES:
        raise ValueError(f"lm_assembly kernel: shard {s} has {len(fams)} families, more than "
                         f"the kernel's {_MAX_FAMILIES}")
    if r is not None:
        _check(f"shard {s}'s residuals", r, (off,), dtype, dev)
    return (ctypes.c_longlong * max(len(fields), 1))(*fields), len(fams)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(passes: int, table, families: int, dev, cam_free, lam, num_points: int,
            num_ref: int, acc=None, blocks=None, hinv=None, out: Optional[dict] = None,
            singular=None) -> None:
    """One cooperative launch of csrc/lm_assembly.cu on ``dev``."""
    global LAUNCHES, LAST_LAUNCH
    out = out or {}
    info = (ctypes.c_longlong * 6)() if RECORD_LAUNCH else None
    names = ("g_c", "g_p", "hpp", "cam_diag", "pt_diag", "hpp_inv", "dc", "precond", "pose_inv")
    with torch.cuda.device(dev):
        err = _lib().mv_lm_assembly(
            cam_free.element_size(), table, families, passes, cam_free.data_ptr(),
            lam.data_ptr(), num_points, cam_free.shape[0], num_ref, _ptr(acc), _ptr(blocks),
            _ptr(hinv), *(_ptr(out.get(k)) for k in names), _ptr(singular), info,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lm_assembly kernel (passes {passes}) failed with cudaError {err}")
    LAUNCHES += 1
    if info is not None:
        LAST_LAUNCH = dict(zip(("grid", "threads", "shared_bytes", "camera_copies",
                                "block_copies", "chunks"), list(info)), passes=passes)


def new_flag(device) -> torch.Tensor:
    """The device flag the kernel sets on a singular 7x7 block (0 at first)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def assemble_cuda(mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
                  cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
                  block_precond: bool, singular: Optional[torch.Tensor] = None) -> Assembly:
    """The assembly on the card: one cooperative launch on one shard, else a
    launch a pass and shard with ``mesh.sum`` between them. ``singular`` (an
    int32 0-d tensor on the lead device, from ``new_flag``) is set to 1 where
    a 7x7 block is singular; without it the kernel sets a flag of its own
    that nothing reads."""
    lead = _device(mesh.lead)
    dtype, C, P, R = cam_free.dtype, cam_free.shape[0], num_points, num_ref
    if lead.type != "cuda":
        raise ValueError(f"lm_assembly kernel: the lead shard lies on {lead}, not on a CUDA "
                         f"device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lm_assembly kernel: float32 or float64, got {dtype}")
    _check("cam_free", cam_free, (C,), dtype, lead)
    _check("lam", lam, (), dtype, lead)
    if block_precond:
        if singular is None:
            singular = new_flag(lead)
        _check("the singular flag", singular, (), torch.int32, lead)
    devs = [_device(d) for d in mesh.devices]
    for s, d in enumerate(devs):
        if d.type != "cuda":
            raise ValueError(f"lm_assembly kernel: shard {s} lies on {d}, not on a CUDA device")
    tables = [_table(fams, jc, jp, None if r is None else r[s], dtype, devs[s], s)
              for s, (fams, (jc, jp)) in enumerate(zip(shards, J))]
    f64 = torch.float64
    out = {"hpp": torch.empty((P, 3, 3), dtype=dtype, device=lead),
           "cam_diag": torch.empty(C, dtype=dtype, device=lead),
           "pt_diag": torch.empty((P, 3), dtype=dtype, device=lead),
           "hpp_inv": torch.empty((P, 3, 3), dtype=dtype, device=lead),
           "dc": torch.empty(C, dtype=dtype, device=lead),
           "precond": torch.empty(C, dtype=dtype, device=lead)}
    if r is not None:
        out["g_c"] = torch.empty(C, dtype=dtype, device=lead)
        out["g_p"] = torch.empty((P, 3), dtype=dtype, device=lead)
    if block_precond:
        out["pose_inv"] = torch.empty((R, 7, 7), dtype=dtype, device=lead)
    hinv = torch.empty(P * 9, dtype=f64, device=lead) if block_precond else None
    acc_len = 2 * C + 9 * P
    if mesh.size == 1:
        # one shard over every process: one launch of every pass
        acc = torch.empty(acc_len, dtype=f64, device=lead)
        blocks = torch.empty(R * 28, dtype=f64, device=lead) if block_precond else None
        passes = _ROWS | _POINTS | ((_BLOCKS | _POSES) if block_precond else 0)
        _launch(passes, *tables[0], lead, cam_free, lam, P, R, acc, blocks, hinv, out, singular)
    else:
        accs = []
        for (table, n), d in zip(tables, devs):
            accs.append(torch.empty(acc_len, dtype=f64, device=d))
            _launch(_ROWS, table, n, d, cam_free.to(d), lam.to(d), P, R, accs[-1])
        acc = mesh.sum(accs)
        empty = (ctypes.c_longlong * 1)()
        _launch(_POINTS, empty, 0, lead, cam_free, lam, P, R, acc, None, hinv, out)
        if block_precond:
            parts = []
            for (table, n), d in zip(tables, devs):
                parts.append(torch.empty(R * 28, dtype=f64, device=d))
                _launch(_BLOCKS, table, n, d, cam_free.to(d), lam.to(d), P, R, None, parts[-1],
                        hinv.to(d))
            _launch(_POSES, empty, 0, lead, cam_free, lam, P, R, acc, mesh.sum(parts), None,
                    out, singular)
    return Assembly(out.get("g_c"), out.get("g_p"), out["hpp"], out["cam_diag"],
                    out["pt_diag"], out["hpp_inv"], out["dc"], out["precond"],
                    out.get("pose_inv"))


# ----------------------------------------------------------------------------
# Entry points: the kernel on the card, the plain version on the CPU
# ----------------------------------------------------------------------------


def assemble(mesh: ShardMesh, shards, J, r: Optional[Sequence[torch.Tensor]],
             cam_free: torch.Tensor, lam: torch.Tensor, num_ref: int, num_points: int,
             block_precond: bool, singular: Optional[torch.Tensor] = None) -> Assembly:
    """One LM iteration's assembly: ``shards`` per local shard of ``mesh`` its
    families, ``J`` per shard (camera blocks [N,k,B] or None, point blocks
    [N,k,3] or None) in family order, ``r`` per shard the flat residuals
    (None: no gradient), ``cam_free`` [C] and the 0-d ``lam`` on the lead
    device; ``block_precond``: also SCHUR_JACOBI's 7x7 inverses. The plain
    version for CPU tensors, the kernel for CUDA ones."""
    fn = assemble_plain if cam_free.device.type == "cpu" else assemble_cuda
    return fn(mesh, shards, J, r, cam_free, lam, num_ref, num_points, block_precond, singular)


def stop_test(done: torch.Tensor, singular: torch.Tensor) -> bool:
    """``bool(done)`` and the singular-block flag in one host sync; raises
    ``torch.linalg.LinAlgError`` where the kernel found a singular 7x7 block
    (as ``torch.linalg.inv`` does on the CPU)."""
    state = int(done.to(torch.int32) + 2 * singular.to(done.device))
    if state & 2:
        raise torch.linalg.LinAlgError(
            "lm_assembly kernel: a SCHUR_JACOBI 7x7 pose block is singular (a zero pivot); "
            "its inverse could not be completed")
    return bool(state & 1)
