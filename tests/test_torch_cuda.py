"""The CUDA kernels of multiview_tpu_torch against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device. This file
imports no jax (the GPU machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: identical best indices on random unit descriptors (no near-ties
at these sizes); distances rtol 1e-5 / atol 1e-6 (float32 sums of 128
products in different orders: the kernel's FMA chain vs cuBLAS)."""

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
    before = tm.KERNEL_LAUNCHES
    got = tm.knn2(q, t)
    torch.cuda.synchronize()
    assert tm.KERNEL_LAUNCHES == before + 1
    ref = tm.knn2_plain(q, t)
    assert torch.equal(got.best_idx, ref.best_idx)
    torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        tm.knn2_cuda(q.double(), t.double())
