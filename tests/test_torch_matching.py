"""Port parity: descriptor matching (multiview_tpu_torch.sfm.matching)
against the JAX package's knn2 and its Pallas kernel (interpret mode on the
CPU).

Tolerances: best_idx identical and ratio-test masks identical (random unit
descriptors have no near-ties at these sizes); distances atol 1e-4, the
bar of tests/test_sfm_frontend.py for the Pallas kernel (float32 sums of
128 products in different orders). ``knn2_split_plain``, the plain version of
the tensor-core kernel's arithmetic (split TF32), is held tighter: distances
atol 1e-6 against ``knn2_plain`` and the JAX functions (the dropped lo.lo
term is below 2^-22 of the products, and the three float32 products sum in
other orders). The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, on the card."""

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
    before = (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES)
    tm.knn2(q, t)
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == before
    for wrapper in (tm.knn2_cuda, tm.knn2_cuda_wgmma, tm.knn2_cuda_fma):
        with pytest.raises(ValueError):
            wrapper(q, t)                       # CPU tensors never reach a kernel
    meta = torch.empty((16, 128), device="meta")
    with pytest.raises(ValueError):
        tm.knn2(meta, meta)                     # a non-CPU tensor goes to the kernel wrapper
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == before


@pytest.mark.parametrize("dim,kernel", [(128, "knn2_wgmma"), (64, "knn2_wgmma"),
                                        (96, "knn2_wgmma"), (32, "knn2_wgmma"),
                                        (256, "knn2_fma")])
def test_dispatch_rule_follows_the_descriptor_width(dim, kernel):
    """Up to 128 the tensor-core kernel, at the next of its widths (96 runs
    at 128 and 32 at 64, zero-padded); wider descriptors the FMA kernel."""
    assert tm.kernel_for(dim) == kernel
    if kernel == "knn2_wgmma":
        assert tm.wgmma_width(dim) == (64 if dim <= 64 else 128)


@pytest.mark.parametrize("dim", [32, 96])
def test_zero_padding_to_the_tensor_core_width_keeps_the_matches(dim):
    """What ``knn2_cuda`` hands the tensor-core kernel for a narrow width,
    the descriptors zero-padded to 64 or 128, gives the unpadded matches:
    the same best indices, distances within float32 summation order, in the
    kernel's split-TF32 arithmetic as in the plain formula."""
    rng = np.random.default_rng(dim)
    q = torch.as_tensor(_descs(rng, 200, dim))
    t = torch.as_tensor(_descs(rng, 300, dim))
    width = tm.wgmma_width(dim)
    pad = (0, width - dim)
    for fn in (tm.knn2_plain, tm.knn2_split_plain):
        ref = fn(q, t)
        got = fn(torch.nn.functional.pad(q, pad), torch.nn.functional.pad(t, pad))
        assert torch.equal(got.best_idx, ref.best_idx)
        torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [96, 128])
def test_kernel_wrappers_raise_on_what_they_do_not_take(dim):
    """float64 and non-contiguous requests raise before any device is
    touched (a meta tensor stands for a tensor that is not on the CPU)."""
    q = torch.empty((16, dim), device="meta")
    t = torch.empty((20, dim), device="meta")
    with pytest.raises(TypeError, match="float32"):
        tm.knn2(q.double(), t.double())
    wide = torch.empty((16, 2 * dim), device="meta")[:, ::2]
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tm.knn2(wide, t)
    with pytest.raises(ValueError, match=r"\[N,D\] x \[M,D\]"):
        tm.knn2_cuda_fma(q, torch.empty((20, dim + 1), device="meta"))


@pytest.mark.parametrize("blocks,tiles,sms,want", [
    (512, 64, 132, 1),     # the main path's chunk: 8 pairs x 64 query tiles, 3.9 waves
    (157, 157, 132, 4),    # one 10000 x 10000 pair: 628 blocks, 4.8 waves
    (16, 17, 132, 4),      # 1000 x 1037: at least 4 train tiles a block
    (1, 2, 132, 1),
])
def test_split_factor_fills_the_card(blocks, tiles, sms, want):
    assert tm.split_factor(blocks, tiles, sms) == want
    for b in (1, 7, 157, 1000):
        for tl in (1, 3, 64, 157):
            assert 1 <= tm.split_factor(b, tl, sms) <= max(1, tl)


def test_tf32_split_keeps_float32_within_two_to_the_minus_21():
    rng = np.random.default_rng(11)
    x = torch.as_tensor(np.concatenate([
        rng.normal(size=4096), rng.normal(size=4096) * 1e-3, -rng.random(4096),
        [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10]]).astype(np.float32))
    hi, lo = tm.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0   # 13 zero low bits
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())
    # ties go away from zero, as cvt.rna does
    assert float(tm.tf32_round(torch.tensor(1.0 + 2.0 ** -11))) == 1.0 + 2.0 ** -10
    assert float(tm.tf32_round(torch.tensor(-1.0 - 2.0 ** -11))) == -1.0 - 2.0 ** -10


def _assert_split_same(ours, ref, mask_ref):
    np.testing.assert_array_equal(ours.best_idx.numpy(), np.asarray(ref.best_idx))
    np.testing.assert_allclose(ours.best_dist.numpy(), np.asarray(ref.best_dist), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ours.second_dist.numpy(), np.asarray(ref.second_dist),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tm.ratio_test_mask(ours).numpy(), np.asarray(mask_ref))


@pytest.mark.parametrize("n,m,d", [(512, 512, 128), (300, 517, 128), (512, 512, 64),
                                   (300, 517, 64)])
def test_split_plain_matches_plain_jax_knn2_and_pallas(n, m, d):
    rng = np.random.default_rng(n + m + d)
    q, t = _descs(rng, n, d), _descs(rng, m, d)
    ours = tm.knn2_split_plain(torch.as_tensor(q), torch.as_tensor(t))
    plain = tm.knn2_plain(torch.as_tensor(q), torch.as_tensor(t))
    _assert_split_same(ours, plain, tm.ratio_test_mask(plain))
    ref = jm.knn2(jnp.asarray(q), jnp.asarray(t))
    _assert_split_same(ours, ref, jm.ratio_test_mask(ref))
    pallas = jm.knn2_pallas_padded(jnp.asarray(q), jnp.asarray(t), interpret=True)
    _assert_split_same(ours, pallas, jm.ratio_test_mask(pallas))


def test_split_plain_batched_pairs_match_per_pair():
    rng = np.random.default_rng(8)
    q = np.stack([_descs(rng, 130, 64) for _ in range(3)])
    t = np.stack([_descs(rng, 150, 64) for _ in range(3)])
    batched = tm.knn2_split_plain(torch.as_tensor(q), torch.as_tensor(t))
    for p in range(3):
        single = tm.knn2_split_plain(torch.as_tensor(q[p]), torch.as_tensor(t[p]))
        _assert_split_same(tm.MatchResult(*(x[p] for x in batched)), single,
                           tm.ratio_test_mask(single))
    with pytest.raises(TypeError):
        tm.knn2_split_plain(torch.as_tensor(q).double(), torch.as_tensor(t).double())


@pytest.mark.parametrize("d", [64, 128])
def test_split_plain_exact_duplicates_and_near_ties(d):
    """An exact duplicate pair of train rows gives second == best and fails
    the ratio test; a planted near-tie (two train rows 1e-4 from the query)
    is found, fails the ratio test, and its distances agree with the plain
    version within 1e-6 although the index may be either row."""
    rng = np.random.default_rng(40 + d)
    q = np.abs(_descs(rng, 24, d))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.abs(_descs(rng, 90, d))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t[10] = q[3]
    t[70] = q[3]
    for row in (21, 88):
        near = q[20] + 1e-4 * rng.normal(size=d).astype(np.float32)
        t[row] = near / np.linalg.norm(near)
    ours = tm.knn2_split_plain(torch.as_tensor(q), torch.as_tensor(t))
    plain = tm.knn2_plain(torch.as_tensor(q), torch.as_tensor(t))
    assert int(ours.best_idx[3]) in (10, 70)
    assert float(ours.second_dist[3]) == float(ours.best_dist[3])
    assert float(ours.best_dist[3]) <= 1e-6
    assert int(ours.best_idx[20]) in (21, 88)
    keep = tm.ratio_test_mask(ours)
    assert not bool(keep[3]) and not bool(keep[20])
    decided = torch.ones(24, dtype=torch.bool)
    decided[[3, 20]] = False
    assert torch.equal(ours.best_idx[decided], plain.best_idx[decided])
    np.testing.assert_allclose(ours.best_dist.numpy(), plain.best_dist.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.second_dist.numpy(), plain.second_dist.numpy(), atol=1e-6,
                               rtol=0)
    assert torch.equal(keep, tm.ratio_test_mask(plain))
