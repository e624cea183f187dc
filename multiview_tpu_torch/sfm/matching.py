"""Descriptor matching: exact 2-NN by squared L2 distance + Lowe ratio test.

Port of ``multiview_tpu/sfm/matching.py``. The reference replaces FLANN's
knn-2 search with a dense distance computation |a-b|^2 = |a|^2+|b|^2-2a.b;
on the TPU a Pallas kernel (``matched_pairs_pallas``) fuses the distance
tiles with the top-2 reduction so the [N,M] distance matrix never reaches
memory. Here that kernel has two hand-written CUDA counterparts for Hopper:

- ``csrc/knn2_wgmma.cu`` (``knn2_cuda_wgmma``): the products on the tensor
  cores as split TF32 (3xTF32, FP32 accuracy), tiles loaded asynchronously;
  descriptor widths 64 and 128, and every narrower width zero-padded to the
  next of them (zeros change no product and no norm).
- ``csrc/knn2.cu`` (``knn2_cuda_fma``): FP32 FMA on the CUDA cores; every
  width, the FP32 oracle on the card, and the kernel for D > 128, which no
  path of the port reaches.

Dispatch (``knn2``) is a rule on where the tensor lies and on its shape,
never on a timing or on a failure: a tensor on the CPU goes to the plain
PyTorch version (``knn2_plain``, same formula); a CUDA tensor goes to
``knn2_cuda``, which launches the tensor-core kernel when D <= 128 (padded
to 64 or 128) and the FMA kernel for any wider D, or raises. ``knn2_split_plain`` is the
plain version of the tensor-core kernel's arithmetic. Every function takes
one pair ([N,D] x [M,D]) or a batch of pairs ([P,N,D] x [P,M,D]).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from multiview_tpu_torch.utils import cuda_build


class MatchResult(NamedTuple):
    """Per-query best/second-best match (indices into the train set)."""

    best_idx: torch.Tensor     # [..., N] int32
    best_dist: torch.Tensor    # [..., N] squared L2
    second_dist: torch.Tensor  # [..., N]


# launches of each CUDA kernel, counted by its wrapper where it launches
WGMMA_LAUNCHES = 0
FMA_LAUNCHES = 0

WGMMA_DIMS = (64, 128)   # descriptor widths csrc/knn2_wgmma.cu is built for
_TILE_ROWS = 64          # rows of a tile of csrc/knn2_wgmma.cu
_MIN_TILES_PER_SPLIT = 4


def _top2(d2: torch.Tensor) -> MatchResult:
    neg, idx = torch.topk(-d2, 2, dim=-1)
    return MatchResult(idx[..., 0].to(torch.int32), -neg[..., 0], -neg[..., 1])


def _sq_dists(query: torch.Tensor, train: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    qn = torch.sum(query * query, dim=-1, keepdim=True)             # [...,N,1]
    tn = torch.sum(train * train, dim=-1).unsqueeze(-2)             # [...,1,M]
    return torch.clamp_min(qn + tn - 2.0 * dot, 0.0)


def knn2_plain(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN by squared L2 in plain tensor ops (the formula of the
    reference's ``knn2``: norms once, clamp at 0, top-2 of the negated
    distances). query [...,N,D], train [...,M,D], M >= 2."""
    return _top2(_sq_dists(query, train, torch.matmul(query, train.transpose(-1, -2))))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) on the bit
    pattern: nearest, ties away from zero, the low 13 mantissa bits zero;
    what ``cvt.rna.tf32.f32`` gives for finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ~= hi + lo with both in TF32: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def knn2_split_plain(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """The arithmetic of the tensor-core kernel in plain tensor ops: float32
    inputs split into TF32 hi and lo parts, q.t taken as
    (q_lo.t_hi + q_hi.t_lo) + q_hi.t_hi with float32 sums (the lo.lo term is
    dropped), norms from the unsplit rows, then the formula and tie rule of
    ``knn2_plain``."""
    if query.dtype != torch.float32 or train.dtype != torch.float32:
        raise TypeError(f"knn2_split_plain takes float32, got {query.dtype} and {train.dtype}")
    q_hi, q_lo = tf32_split(query)
    t_hi, t_lo = tf32_split(train)
    t_hi_t = t_hi.transpose(-1, -2)
    dot = (torch.matmul(q_lo, t_hi_t) + torch.matmul(q_hi, t_lo.transpose(-1, -2))
           + torch.matmul(q_hi, t_hi_t))
    return _top2(_sq_dists(query, train, dot))


def kernel_for(dim: int) -> str:
    """The CUDA kernel ``knn2_cuda`` launches for descriptors of width
    ``dim``: the tensor-core kernel up to 128 (widths other than 64 and 128
    zero-padded to the next of them, ``wgmma_width``), the FMA kernel above."""
    return "knn2_wgmma" if dim <= WGMMA_DIMS[-1] else "knn2_fma"


def wgmma_width(dim: int) -> int:
    """The width the tensor-core kernel runs descriptors of width ``dim`` at."""
    return next(w for w in WGMMA_DIMS if dim <= w)


def split_factor(blocks: int, tiles: int, sms: int) -> int:
    """How many blocks share the train sweep of one query tile in the
    tensor-core kernel, which runs one block per SM: the smallest count that
    fills at least 90% of the waves ``blocks * count`` blocks take on ``sms``
    SMs, each block keeping at least ``_MIN_TILES_PER_SPLIT`` of the ``tiles``
    train tiles; where no count reaches 90%, the one that fills most."""
    best, best_fill = 1, 0.0
    for s in range(1, max(1, tiles // _MIN_TILES_PER_SPLIT) + 1):
        fill = blocks * s / (sms * -(-blocks * s // sms))
        if fill > best_fill:
            best, best_fill = s, fill
        if fill >= 0.9:
            break
    return best


def _check_pairs(name: str, query: torch.Tensor, train: torch.Tensor):
    """Raises on what the kernels do not take; returns the batched views
    and (P, N, M, D)."""
    if query.dtype != torch.float32 or train.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {query.dtype} and {train.dtype}")
    if not (query.is_contiguous() and train.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    q = query if query.dim() == 3 else query.unsqueeze(0)
    t = train if train.dim() == 3 else train.unsqueeze(0)
    if (query.dim() != train.dim() or q.dim() != 3 or q.shape[0] != t.shape[0]
            or q.shape[2] != t.shape[2]):
        raise ValueError(f"{name} takes [N,D] x [M,D] or [P,N,D] x [P,M,D], got "
                         f"{tuple(query.shape)} x {tuple(train.shape)}")
    if query.device.type != "cuda" or train.device != query.device:
        raise ValueError(f"{name} needs query and train on the same CUDA device, "
                         f"got {query.device} and {train.device}")
    P, N, D = q.shape
    M = t.shape[1]
    if P < 1 or N < 1 or M < 2 or D < 1 or P > 65535:
        raise ValueError(f"{name}: unsupported sizes P={P} N={N} M={M} D={D}")
    return q, t, (P, N, M, D)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _outputs(P: int, N: int, dev):
    return (torch.empty((P, N), dtype=torch.int32, device=dev),
            torch.empty((P, N), dtype=torch.float32, device=dev),
            torch.empty((P, N), dtype=torch.float32, device=dev))


def _result(batched: bool, best_idx, best, second) -> MatchResult:
    if not batched:
        return MatchResult(best_idx[0], best[0], second[0])
    return MatchResult(best_idx, best, second)


def _fma_lib():
    fn = cuda_build.load_library("knn2.cu").mv_knn2_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def _wgmma_lib():
    lib = cuda_build.load_library("knn2_wgmma.cu")
    fn = lib.mv_knn2_wgmma_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
        lib.mv_knn2_wgmma_image_bytes.argtypes = [ctypes.c_int]
        lib.mv_knn2_wgmma_image_bytes.restype = ctypes.c_int
    return fn, lib.mv_knn2_wgmma_image_bytes


def knn2_cuda_fma(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """The FP32 FMA kernel (csrc/knn2.cu), any descriptor width.

    query [N,D] or [P,N,D], train [M,D] or [P,M,D]: float32, contiguous, on
    one CUDA device. Launches on the current stream and does not wait."""
    global FMA_LAUNCHES
    q, t, (P, N, M, D) = _check_pairs("knn2_cuda_fma", query, train)
    fn = _fma_lib()
    dev = q.device
    best_idx, best, second = _outputs(P, N, dev)
    qn = torch.empty((P, N), dtype=torch.float32, device=dev)
    tn = torch.empty((P, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = cuda_build.stream(dev)
        err = fn(q.data_ptr(), t.data_ptr(), qn.data_ptr(), tn.data_ptr(),
                 P, N, M, D, best_idx.data_ptr(), best.data_ptr(),
                 second.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn2 FMA kernel launch failed with cudaError {err}")
    FMA_LAUNCHES += 1
    return _result(query.dim() == 3, best_idx, best, second)


def knn2_cuda_wgmma(query: torch.Tensor, train: torch.Tensor,
                    clocks: Optional[list] = None) -> MatchResult:
    """The split-TF32 tensor-core kernel (csrc/knn2_wgmma.cu), descriptor
    width 64 or 128; same inputs and outputs as ``knn2_cuda_fma``. The
    scratch (tile images of the split inputs with their norms, partial
    top-2s of the sweep's splits) is allocated here. A list passed as
    ``clocks`` receives one int64 tensor [blocks, 2 warpgroups, 4] of clock
    counts (waiting for a tile, wgmma chains, top-2 fold, whole sweep)."""
    global WGMMA_LAUNCHES
    q, t, (P, N, M, D) = _check_pairs("knn2_cuda_wgmma", query, train)
    if D not in WGMMA_DIMS:
        raise ValueError(f"knn2_cuda_wgmma takes D in {WGMMA_DIMS}, got {D}")
    q_tiles = -(-N // _TILE_ROWS)
    t_tiles = -(-M // _TILE_ROWS)
    if q_tiles > 65535:
        raise ValueError(f"knn2_cuda_wgmma: unsupported size N={N}")
    fn, image_bytes = _wgmma_lib()
    dev = q.device
    splits = split_factor(P * q_tiles, t_tiles, _sm_count(dev.index))
    best_idx, best, second = _outputs(P, N, dev)
    # one scratch allocation: query images, train images, three partial arrays
    q_bytes = P * q_tiles * image_bytes(D)
    t_bytes = P * t_tiles * image_bytes(D)
    part_bytes = P * splits * N * 4
    scratch = torch.empty(q_bytes + t_bytes + 3 * part_bytes, dtype=torch.uint8, device=dev)
    q_img = scratch.data_ptr()
    t_img = q_img + q_bytes
    part = t_img + t_bytes
    clock_ptr = None
    if clocks is not None:
        clocks.append(torch.zeros((P * q_tiles * splits, 2, 4), dtype=torch.int64, device=dev))
        clock_ptr = clocks[-1].data_ptr()
    with torch.cuda.device(dev):
        stream = cuda_build.stream(dev)
        err = fn(q.data_ptr(), t.data_ptr(), q_img, t_img, P, N, M, D, splits,
                 part, part + part_bytes, part + 2 * part_bytes,
                 best_idx.data_ptr(), best.data_ptr(), second.data_ptr(), clock_ptr, stream)
    if err != 0:
        raise RuntimeError(f"knn2 tensor-core kernel launch failed with cudaError {err}")
    WGMMA_LAUNCHES += 1
    return _result(query.dim() == 3, best_idx, best, second)


def knn2_cuda(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN on the card. The kernel follows from the shape alone:
    float32 contiguous CUDA tensors with D <= 128 go to the tensor-core
    kernel, zero-padded to D = 64 or 128 where they are narrower, any wider
    D to the FMA kernel (``kernel_for``). Anything else raises, as does a
    build or a launch that fails: nothing here gives way to another path."""
    _check_pairs("knn2_cuda", query, train)
    d = query.shape[-1]
    if kernel_for(d) == "knn2_fma":
        return knn2_cuda_fma(query, train)
    width = wgmma_width(d)
    if width != d:
        query = torch.nn.functional.pad(query, (0, width - d))
        train = torch.nn.functional.pad(train, (0, width - d))
    return knn2_cuda_wgmma(query, train)


def knn2(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN: the plain version for CPU tensors, a CUDA kernel for
    CUDA tensors (``knn2_cuda``, which raises on anything it does not take)."""
    if query.device.type == "cpu" and train.device.type == "cpu":
        return knn2_plain(query, train)
    return knn2_cuda(query, train)


def ratio_test_mask(m: MatchResult, ratio: float = 0.8) -> torch.Tensor:
    """Lowe ratio test on distances: kept when d1 < ratio * d2 (OpenCV
    semantics, non-squared distances)."""
    return torch.sqrt(m.best_dist) < ratio * torch.sqrt(m.second_dist)


def match_descriptors(query: torch.Tensor, train: torch.Tensor,
                      ratio: float = 0.8, cross_check: bool = False):
    """Matched index pairs after the ratio test.

    Returns (pairs [...,N,2] int32 with -1 rows where rejected, mask [...,N]).
    With cross_check=True the match must also be mutual."""
    m = knn2(query, train)
    keep = ratio_test_mask(m, ratio)
    n = query.shape[-2]
    ar = torch.arange(n, dtype=torch.int32, device=query.device)
    ar = ar.expand(m.best_idx.shape)
    if cross_check:
        m_rev = knn2(train, query)
        back = torch.gather(m_rev.best_idx, -1, m.best_idx.long())
        keep = keep & (back == ar)
    pairs = torch.stack([ar, m.best_idx], dim=-1)
    pairs = torch.where(keep[..., None], pairs, torch.full_like(pairs, -1))
    return pairs, keep
