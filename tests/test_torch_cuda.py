"""The CUDA kernels of multiview_tpu_torch against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device. This file
imports no jax (the GPU machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: identical best indices on random unit descriptors (no near-ties
at these sizes); distances rtol 1e-5 / atol 1e-6 (float32 sums of the
products in different orders: the FMA kernel's chain, the tensor-core
kernel's split-TF32 chains, cuBLAS)."""

import pytest
import torch

from multiview_tpu_torch.sfm import matching as tm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,m", [(1, 300, 517), (4, 1024, 1000)])
def test_cuda_kernel_matches_plain_version(cuda_device, p, n, m):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((p, n, 128), generator=g, device=cuda_device)
    t = torch.randn((p, m, 128), generator=g, device=cuda_device)
    q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
    t = (t / t.norm(dim=-1, keepdim=True)).contiguous()
    before = tm.WGMMA_LAUNCHES
    got = tm.knn2(q, t)
    torch.cuda.synchronize()
    assert tm.WGMMA_LAUNCHES == before + 1      # D = 128 goes to the tensor-core kernel
    ref = tm.knn2_plain(q, t)
    assert torch.equal(got.best_idx, ref.best_idx)
    torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        tm.knn2_cuda(q.double(), t.double())


def _unit(gen, shape, device):
    x = torch.randn(shape, generator=gen, device=device).abs()
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


def _assert_close(got, ref):
    assert torch.equal(got.best_idx, ref.best_idx)
    torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)
    assert torch.equal(tm.ratio_test_mask(got), tm.ratio_test_mask(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,m,d", [(1, 64, 64, 128), (1, 300, 517, 128), (3, 1000, 1037, 128),
                                     (2, 200, 1037, 64), (1, 5000, 5000, 64)])
def test_tensor_core_kernel_matches_plain_split_plain_and_fma_kernel(cuda_device, p, n, m, d):
    g = torch.Generator(device=cuda_device).manual_seed(p + n + m + d)
    q, t = _unit(g, (p, n, d), cuda_device), _unit(g, (p, m, d), cuda_device)
    before = (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES)
    got = tm.knn2_cuda(q, t)
    torch.cuda.synchronize()
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == (before[0] + 1, before[1])
    _assert_close(got, tm.knn2_plain(q, t))
    _assert_close(got, tm.knn2_split_plain(q, t))
    _assert_close(got, tm.knn2_cuda_fma(q, t))
    single = tm.knn2_cuda(q[0], t[0])           # [N,D] x [M,D]
    assert torch.equal(single.best_idx, got.best_idx[0])
    assert torch.equal(single.best_dist, got.best_dist[0])


@pytest.mark.cuda
def test_other_widths_go_to_the_fma_kernel(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, t = _unit(g, (2, 333, 96), cuda_device), _unit(g, (2, 517, 96), cuda_device)
    before = (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES)
    got = tm.knn2(q, t)
    torch.cuda.synchronize()
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == (before[0], before[1] + 1)
    _assert_close(got, tm.knn2_plain(q, t))
    with pytest.raises(ValueError):
        tm.knn2_cuda_wgmma(q, t)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_kernel_ties_keep_the_lowest_index(cuda_device, d):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, t = _unit(g, (200, d), cuda_device), _unit(g, (1037, d), cuda_device)
    t[900] = q[3]
    t[10] = q[3]                                # duplicates in different tiles and splits
    t[1036] = q[199]
    got = tm.knn2_cuda_wgmma(q, t)
    torch.cuda.synchronize()
    assert int(got.best_idx[3]) == 10
    assert float(got.second_dist[3]) == float(got.best_dist[3]) <= 1e-6
    assert int(got.best_idx[199]) == 1036
    assert not bool(tm.ratio_test_mask(got)[3])
