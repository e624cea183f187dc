"""Port parity: descriptor matching (multiview_tpu_torch.sfm.matching)
against the JAX package's knn2 and its Pallas kernel (interpret mode on the
CPU).

Tolerances: best_idx identical and ratio-test masks identical (random unit
descriptors have no near-ties at these sizes); distances atol 1e-4, the
bar of tests/test_sfm_frontend.py for the Pallas kernel (float32 sums of
128 products in different orders). The CUDA kernel itself is held against
the plain version in tests/test_torch_cuda.py, on the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.sfm import matching as jm
from multiview_tpu_torch.sfm import matching as tm


def _descs(rng, n, d=128):
    a = rng.normal(size=(n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.best_idx.numpy(), np.asarray(ref.best_idx))
    np.testing.assert_allclose(ours.best_dist.numpy(), np.asarray(ref.best_dist), atol=1e-4)
    np.testing.assert_allclose(ours.second_dist.numpy(), np.asarray(ref.second_dist),
                               atol=1e-4)
    np.testing.assert_array_equal(tm.ratio_test_mask(ours).numpy(),
                                  np.asarray(jm.ratio_test_mask(ref)))


@pytest.mark.parametrize("n,m", [(512, 512), (300, 517)])
def test_plain_knn2_matches_jax_knn2_and_pallas(n, m):
    rng = np.random.default_rng(n + m)
    q, t = _descs(rng, n), _descs(rng, m)
    ours = tm.knn2(torch.as_tensor(q), torch.as_tensor(t))
    _assert_same(ours, jm.knn2(jnp.asarray(q), jnp.asarray(t)))
    pallas = jm.knn2_pallas_padded(jnp.asarray(q), jnp.asarray(t), interpret=True)
    _assert_same(ours, pallas)


def test_batched_pairs_match_per_pair():
    rng = np.random.default_rng(7)
    q = np.stack([_descs(rng, 200) for _ in range(3)])
    t = np.stack([_descs(rng, 230) for _ in range(3)])
    batched = tm.knn2(torch.as_tensor(q), torch.as_tensor(t))
    for p in range(3):
        ref = jm.knn2(jnp.asarray(q[p]), jnp.asarray(t[p]))
        _assert_same(tm.MatchResult(*(x[p] for x in batched)), ref)


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_descriptors_matches_jax(cross_check):
    rng = np.random.default_rng(3)
    t = _descs(rng, 120)
    q = np.concatenate([t[::-1][:80] + 0.01 * rng.normal(size=(80, 128)).astype(np.float32),
                        _descs(rng, 40)])
    pairs, keep = tm.match_descriptors(torch.as_tensor(q), torch.as_tensor(t),
                                       cross_check=cross_check)
    jp, jk = jm.match_descriptors(jnp.asarray(q), jnp.asarray(t), cross_check=cross_check)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(jp))
    assert keep.sum() >= 60


def test_exact_duplicate_gives_equal_second_distance():
    rng = np.random.default_rng(4)
    q = _descs(rng, 10)
    t = np.concatenate([_descs(rng, 30), q[2:3], q[2:3]])
    res = tm.knn2(torch.as_tensor(q), torch.as_tensor(t))
    assert int(res.best_idx[2]) in (30, 31)
    assert float(res.second_dist[2]) == float(res.best_dist[2])
    assert not bool(tm.ratio_test_mask(res)[2])


def test_cpu_tensors_use_plain_version_and_kernel_wrapper_checks_inputs():
    rng = np.random.default_rng(5)
    q = torch.as_tensor(_descs(rng, 16))
    t = torch.as_tensor(_descs(rng, 20))
    before = tm.KERNEL_LAUNCHES
    tm.knn2(q, t)
    assert tm.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError):
        tm.knn2_cuda(q, t)                      # CPU tensors never reach the kernel
    meta = torch.empty((16, 128), device="meta")
    with pytest.raises(ValueError):
        tm.knn2(meta, meta)                     # a non-CPU tensor goes to the kernel wrapper
    assert tm.KERNEL_LAUNCHES == before
