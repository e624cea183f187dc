"""Descriptor matching: exact 2-NN by squared L2 distance + Lowe ratio test.

Port of ``multiview_tpu/sfm/matching.py``. The reference replaces FLANN's
knn-2 search with a dense distance computation |a-b|^2 = |a|^2+|b|^2-2a.b;
on the TPU a Pallas kernel (``matched_pairs_pallas``) fuses the distance
tiles with the top-2 reduction so the [N,M] distance matrix never reaches
memory. Here that kernel is ``csrc/knn2.cu``, hand-written CUDA for Hopper.

Dispatch (``knn2``): a tensor on the CPU goes to the plain PyTorch version
(``knn2_plain``, same formula); a CUDA tensor always goes to the kernel, at
every size, or the wrapper raises. Every function takes one pair ([N,D] x
[M,D]) or a batch of pairs ([P,N,D] x [P,M,D]).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from multiview_tpu_torch.utils import cuda_build


class MatchResult(NamedTuple):
    """Per-query best/second-best match (indices into the train set)."""

    best_idx: torch.Tensor     # [..., N] int32
    best_dist: torch.Tensor    # [..., N] squared L2
    second_dist: torch.Tensor  # [..., N]


# launches of the CUDA kernel, counted by knn2_cuda where it launches
KERNEL_LAUNCHES = 0


def knn2_plain(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN by squared L2 in plain tensor ops (the formula of the
    reference's ``knn2``: norms once, clamp at 0, top-2 of the negated
    distances). query [...,N,D], train [...,M,D], M >= 2."""
    qn = torch.sum(query * query, dim=-1, keepdim=True)             # [...,N,1]
    tn = torch.sum(train * train, dim=-1).unsqueeze(-2)             # [...,1,M]
    d2 = qn + tn - 2.0 * torch.matmul(query, train.transpose(-1, -2))
    d2 = torch.clamp_min(d2, 0.0)
    neg, idx = torch.topk(-d2, 2, dim=-1)
    return MatchResult(idx[..., 0].to(torch.int32), -neg[..., 0], -neg[..., 1])


def _knn2_lib():
    lib = cuda_build.load_library("knn2.cu")
    fn = lib.mv_knn2_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def knn2_cuda(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """The fused distance + top-2 CUDA kernel (csrc/knn2.cu).

    query [N,D] or [P,N,D], train [M,D] or [P,M,D]: float32, contiguous, on
    one CUDA device. Launches on the current stream and does not wait."""
    global KERNEL_LAUNCHES
    if query.device.type != "cuda" or train.device != query.device:
        raise ValueError("knn2_cuda needs query and train on the same CUDA device, "
                         f"got {query.device} and {train.device}")
    if query.dtype != torch.float32 or train.dtype != torch.float32:
        raise TypeError(f"knn2_cuda takes float32, got {query.dtype} and {train.dtype}")
    if not (query.is_contiguous() and train.is_contiguous()):
        raise ValueError("knn2_cuda takes contiguous tensors")
    batched = query.dim() == 3
    q = query if batched else query.unsqueeze(0)
    t = train if batched else train.unsqueeze(0)
    if (q.dim() != 3 or t.dim() != 3 or q.shape[0] != t.shape[0]
            or q.shape[2] != t.shape[2]):
        raise ValueError("knn2_cuda takes [N,D] x [M,D] or [P,N,D] x [P,M,D], got "
                         f"{tuple(query.shape)} x {tuple(train.shape)}")
    P, N, D = q.shape
    M = t.shape[1]
    if P < 1 or N < 1 or M < 2 or D < 1 or P > 65535:
        raise ValueError(f"knn2_cuda: unsupported sizes P={P} N={N} M={M} D={D}")
    fn = _knn2_lib()
    dev = q.device
    best_idx = torch.empty((P, N), dtype=torch.int32, device=dev)
    best = torch.empty((P, N), dtype=torch.float32, device=dev)
    second = torch.empty((P, N), dtype=torch.float32, device=dev)
    qn = torch.empty((P, N), dtype=torch.float32, device=dev)
    tn = torch.empty((P, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), t.data_ptr(), qn.data_ptr(), tn.data_ptr(),
                 P, N, M, D, best_idx.data_ptr(), best.data_ptr(),
                 second.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn2 CUDA kernel launch failed with cudaError {err}")
    KERNEL_LAUNCHES += 1
    if not batched:
        return MatchResult(best_idx[0], best[0], second[0])
    return MatchResult(best_idx, best, second)


def knn2(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which raises on anything it does not take)."""
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
