"""Shape-bucketing helpers: variable-length batches padded to power-of-2
buckets (the reference's compile-hygiene helpers, kept so padded shapes
match it)."""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


def pad_rows_pow2(arr: np.ndarray, fill=0) -> np.ndarray:
    """Zero-(or fill-)pad axis 0 to the next power of two."""
    arr = np.asarray(arr)
    nb = next_pow2(arr.shape[0])
    if nb == arr.shape[0]:
        return arr
    out = np.full((nb,) + arr.shape[1:], fill, arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def group_ranks(ids: np.ndarray):
    """Rank of each element within its group, plus the stable order that
    sorts by group: returns (order, sorted_ids, rank) with
    ``rank[k]`` = position of ``order[k]`` among its group's members.

    The vectorized core of building padded per-group tables
    (``table[sorted_ids, rank] = values[order]``)."""
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    if len(sids) == 0:
        return order, sids, np.zeros(0, np.int64)
    first = np.r_[0, np.flatnonzero(np.diff(sids)) + 1]
    starts = np.repeat(first, np.diff(np.r_[first, len(sids)]))
    rank = np.arange(len(sids)) - starts
    return order, sids, rank
