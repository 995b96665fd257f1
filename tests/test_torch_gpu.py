"""The CUDA kernels against their plain versions on a card (marker
``gpu``; each test skips without a CUDA device).  No JAX here, so the
file also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import aeq as taeq
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv.kernel import (
    event_conv_cuda_batched, event_conv_cuda_interlaced_batched)
from repro_torch.kernels.event_conv.ref import (
    event_conv_ref_batched, event_conv_ref_interlaced_batched)
from repro_torch.kernels.threshold_pool.kernel import \
    threshold_pool_cuda_batched
from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_cuda_kernels_equal_plain_versions(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    fm = torch.rand((8, 28, 28), generator=g) < 0.6
    q = taeq.build_aeq_batched(fm.to(cuda), 256)
    qp = taeq.segment_pad(q, 8)
    vm = (torch.randn((8, 30, 30, 8), generator=g) * 50).to(dtype).to(cuda)
    kern = (torch.randn((3, 3, 8), generator=g) * 40).to(dtype).to(cuda)
    got = event_conv_cuda_batched(vm, q.coords, q.valid, kern)
    assert torch.equal(got, event_conv_ref_batched(vm, q.coords, q.valid, kern))
    got = event_conv_cuda_interlaced_batched(vm, qp.coords, qp.valid, kern,
                                             event_par=8)
    assert torch.equal(got, event_conv_ref_interlaced_batched(
        vm, qp.coords, qp.valid, kern, event_par=8))
    fired = (torch.rand((8, 28, 28, 8), generator=g) < 0.1).to(cuda)
    a, b = vm.clone(), vm.clone()
    sa, pa = threshold_pool_cuda_batched(a, kern[0, 0], fired, v_t=1.0,
                                         pool=3, halo=(1, 1))
    sb, pb = threshold_pool_tile_ref(b, kern[0, 0], fired, v_t=1.0, pool=3,
                                     halo=(1, 1))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(sa, sb) and torch.equal(pa, pb)


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches_only(cuda):
    runtime.reset_launches()
    vm = torch.zeros((2, 10, 10, 4), device=cuda)
    q = taeq.build_aeq_batched(torch.ones((2, 8, 8), dtype=torch.bool,
                                          device=cuda), 64)
    kern = torch.ones((3, 3, 4), device=cuda)
    event_conv_ref_batched(vm, q.coords, q.valid, kern)
    event_conv_cuda_batched(vm, q.coords, q.valid, kern, out=vm)
    assert runtime.LAUNCHES == {"event_conv_seq": 1,
                                "event_conv_interlaced": 0,
                                "threshold_pool": 0}
