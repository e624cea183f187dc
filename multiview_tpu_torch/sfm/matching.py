"""Descriptor matching: exact 2-NN by squared L2 distance + Lowe ratio test.

Port of ``multiview_tpu/sfm/matching.py``. The reference replaces FLANN's
knn-2 search with a dense distance computation |a-b|^2 = |a|^2+|b|^2-2a.b;
on the TPU a Pallas kernel (``matched_pairs_pallas``) fuses the distance
tiles with the top-2 reduction so the [N,M] distance matrix never reaches
memory. Here that kernel has two hand-written CUDA counterparts for Hopper:

- ``csrc/knn2_wgmma.cu`` (``knn2_cuda_wgmma``): the products on the tensor
  cores as split TF32 (3xTF32, FP32 accuracy), slabs of 32 dimensions
  loaded asynchronously; every descriptor width (a width that is not a
  multiple of 32 is zero-filled by the kernel's loads: zeros change no
  product and no norm); two launches a call.
- ``csrc/knn2.cu`` (``knn2_cuda_fma``): FP32 FMA on the CUDA cores, every
  width; the FP32 oracle on the card, which no path launches.

Dispatch (``knn2``) is a rule on where the tensor lies, never on a timing
or on a failure: a tensor on the CPU goes to the plain PyTorch version
(``knn2_plain``, same formula); a CUDA tensor goes to ``knn2_cuda``, which
launches the tensor-core kernel or raises. ``knn2_split_plain`` is the
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

_QUERY_ROWS = 128        # rows of a query tile of csrc/knn2_wgmma.cu
_TRAIN_ROWS = 96         # rows of a train tile (the tensor-core product's N)
_SLAB_DIMS = 32          # dimensions of a slab: the width the kernel's loads fill to
_SPLIT_COST_TILES = 1    # a block's fixed cost, in train tiles' time (split_factor)
# what the tensor-core kernel's clock counters count, a consumer warpgroup each
CLOCK_PARTS = ("waiting for slabs", "waiting for chains", "chain sums", "top-2 fold",
               "start", "issuing chains", "releasing slabs", "whole kernel")


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
    ``dim``: the tensor-core kernel, whatever the width."""
    return "knn2_wgmma"


def wgmma_width(dim: int) -> int:
    """The width the tensor-core kernel's loads fill descriptors of width
    ``dim`` to with zeros: the next multiple of its 32-dimension slab."""
    return -(-dim // _SLAB_DIMS) * _SLAB_DIMS


@functools.lru_cache(maxsize=4096)
def split_factor(blocks: int, tiles: int, sms: int) -> int:
    """How many blocks share the train sweep of one query tile in the
    tensor-core kernel, which runs one block per SM (the last of them to
    finish folds their partial top-2s): the count that ends soonest, taking a
    block's time as its share of the ``tiles`` train tiles plus
    ``_SPLIT_COST_TILES`` (its query tile's set-up and fold) and the sweep's
    time as the waves ``blocks * count`` blocks take on ``sms`` SMs times a
    block's; the smallest of equals."""
    best, best_cost = 1, None
    for s in range(1, min(tiles, 4 * sms) + 1):
        cost = -(-blocks * s // sms) * (_SPLIT_COST_TILES + -(-tiles // s))
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _check_pairs(name: str, query: torch.Tensor, train: torch.Tensor):
    """Raises on what the kernels do not take; returns (P, N, M, D) (P = 1
    for [N,D] x [M,D]). Reads attributes only: a call's host time is part of
    what it costs."""
    if query.dtype != torch.float32 or train.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {query.dtype} and {train.dtype}")
    if not (query.is_contiguous() and train.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    qs, ts = query.shape, train.shape
    if len(qs) != len(ts) or len(qs) not in (2, 3) or qs[-1] != ts[-1] or qs[:-2] != ts[:-2]:
        raise ValueError(f"{name} takes [N,D] x [M,D] or [P,N,D] x [P,M,D], got "
                         f"{tuple(qs)} x {tuple(ts)}")
    if not query.is_cuda or train.device != query.device:
        raise ValueError(f"{name} needs query and train on the same CUDA device, "
                         f"got {query.device} and {train.device}")
    P = qs[0] if len(qs) == 3 else 1
    N, D = qs[-2], qs[-1]
    M = ts[-2]
    if P < 1 or N < 1 or M < 2 or D < 1 or P > 65535:
        raise ValueError(f"{name}: unsupported sizes P={P} N={N} M={M} D={D}")
    return P, N, M, D


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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.mv_knn2_wgmma_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.mv_knn2_wgmma_scratch_bytes.restype = ctypes.c_longlong
    return fn, lib.mv_knn2_wgmma_scratch_bytes


def knn2_cuda_fma(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """The FP32 FMA kernel (csrc/knn2.cu), any descriptor width.

    query [N,D] or [P,N,D], train [M,D] or [P,M,D]: float32, contiguous, on
    one CUDA device. Launches on the current stream and does not wait."""
    global FMA_LAUNCHES
    P, N, M, D = _check_pairs("knn2_cuda_fma", query, train)
    fn = _fma_lib()
    dev = query.device
    best_idx, best, second = _outputs(P, N, dev)
    qn = torch.empty((P, N), dtype=torch.float32, device=dev)
    tn = torch.empty((P, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = cuda_build.stream(dev)
        err = fn(query.data_ptr(), train.data_ptr(), qn.data_ptr(), tn.data_ptr(),
                 P, N, M, D, best_idx.data_ptr(), best.data_ptr(),
                 second.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn2 FMA kernel launch failed with cudaError {err}")
    FMA_LAUNCHES += 1
    return _result(query.dim() == 3, best_idx, best, second)


@functools.lru_cache(maxsize=4096)
def _wgmma_plan(P: int, N: int, M: int, D: int, device_index: int):
    """(splits, scratch bytes, query tiles) of a call at these sizes; raises
    on sizes the tensor-core kernel does not take."""
    q_tiles = -(-N // _QUERY_ROWS)
    splits = split_factor(P * q_tiles, -(-M // _TRAIN_ROWS), _sm_count(device_index))
    nbytes = _wgmma_lib()[1](P, N, M, D, splits)
    if nbytes < 0:
        raise ValueError(f"knn2_cuda_wgmma: unsupported sizes P={P} N={N} M={M} D={D}")
    return splits, nbytes, q_tiles


# per (device, stream): the scratch of the tensor-core kernel, kept between
# calls (a call on the same stream runs after the one before it)
_SCRATCH: dict = {}


def _scratch(device, stream: int, nbytes: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf


_RAW_STREAM = []  # torch's getter of a device's current stream as an int, once found


def _current_stream(index: int) -> int:
    if not _RAW_STREAM:
        _RAW_STREAM.append(getattr(torch._C, "_cuda_getCurrentRawStream", None)
                           or (lambda i: torch.cuda.current_stream(i).cuda_stream))
    return _RAW_STREAM[0](index)


def knn2_cuda_wgmma(query: torch.Tensor, train: torch.Tensor,
                    clocks: Optional[list] = None) -> MatchResult:
    """The split-TF32 tensor-core kernel (csrc/knn2_wgmma.cu), any
    descriptor width; same inputs and outputs as ``knn2_cuda_fma``. Two
    launches: the pre-pass that splits both sets into slabs with their
    norms, and the sweep, whose last block of each query tile folds the
    splits' partial top-2s. The outputs are one allocation; the scratch is
    kept per device and stream. A list passed as ``clocks`` receives one
    int64 tensor [blocks, 2 warpgroups, len(CLOCK_PARTS)] of clock counts."""
    global WGMMA_LAUNCHES
    P, N, M, D = _check_pairs("knn2_cuda_wgmma", query, train)
    dev = query.device
    index = dev.index
    splits, nbytes, q_tiles = _wgmma_plan(P, N, M, D, index)
    fn = _wgmma_lib()[0]
    stream = _current_stream(index)
    scratch = _scratch(dev, stream, nbytes)
    # best index (as int32 bits), best and second distance, in one allocation;
    # the views are made after the launch, while the card works
    out = query.new_empty((3,) + tuple(query.shape[:-1]))
    base, plane = out.data_ptr(), 4 * P * N
    clock_ptr = None
    if clocks is not None:
        clocks.append(torch.zeros((P * q_tiles * splits, 2, len(CLOCK_PARTS)),
                                  dtype=torch.int64, device=dev))
        clock_ptr = clocks[-1].data_ptr()
    args = (query.data_ptr(), train.data_ptr(), scratch.data_ptr(), P, N, M, D, splits,
            base, base + plane, base + 2 * plane, clock_ptr, stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"knn2 tensor-core kernel launch failed with cudaError {err}")
    WGMMA_LAUNCHES += 1
    idx_bits, best, second = out.unbind(0)
    return MatchResult(idx_bits.view(torch.int32), best, second)


def knn2_cuda(query: torch.Tensor, train: torch.Tensor) -> MatchResult:
    """Exact 2-NN on the card: float32 contiguous CUDA tensors of any
    descriptor width go to the tensor-core kernel (``kernel_for``). Anything
    else raises, as does a build or a launch that fails: nothing here gives
    way to another path."""
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
