"""Kernel D as a traceable op, the FLOP count and ``compressed_mean`` on
the card.

* ``repro_torch::ssd_scan``: fake CUDA tensors take its shape function and
  never reach the launch (the launch count stays), real ones launch the
  kernel (the count rises by one) with the same shapes;
* ``FlopCounterMode`` around a bf16 Mamba-2 prefill on the card (the
  reduced config, the full one's width would take longer) equals the dry
  run's FLOPs for that step on a 1 x 1 mesh;
* ``compressed_mean`` over an NCCL group of one equals
  ``_dequantize(_quantize(g))``.

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda_launch.py``.  This file imports no JAX.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b=2, S=128, H=4, P=64, N=64, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(b, S, H, P, generator=gen, device=device).to(dtype)
    dt = torch.rand(b, S, H, generator=gen, device=device) * 0.1
    A = -torch.rand(H, generator=gen, device=device)
    B = torch.randn(b, S, N, generator=gen, device=device).to(dtype)
    C = torch.randn(b, S, N, generator=gen, device=device).to(dtype)
    D = torch.rand(H, generator=gen, device=device)
    return x, dt, A, B, C, D


def test_ssd_op_fake_and_real_shapes(cuda):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _inputs(cuda)
    build.reset_launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fargs = [mode.from_tensor(t) for t in args]
        fy, fs = kd.ssd_scan_kernel(*fargs, chunk=64)
    assert kd.SSD_SCAN.launches == 0
    y, s = kd.ssd_scan_kernel(*args, chunk=64)
    torch.cuda.synchronize()
    assert kd.SSD_SCAN.launches == 1
    assert (fy.shape, fy.dtype, fy.device) == (y.shape, y.dtype, y.device)
    assert (fs.shape, fs.dtype, fs.device) == (s.shape, s.dtype, s.device)
    y0, s0 = kd.ssd_scan_plain(*args, chunk=64)
    assert float((y.float() - y0.float()).abs().max()) <= kd.plain_tol(
        y0, y.dtype)


def test_an_out_of_contract_call_raises_on_the_card(cuda):
    x, dt, A, B, C, D = _inputs(cuda, P=128)  # wider than the kernel's tile
    with pytest.raises(ValueError):
        kd.ssd_scan_kernel(x, dt, A, B, C, D, chunk=64)


def test_flop_counter_equals_the_1x1_dry_run(cuda):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                              dtype="bfloat16", ssm_heads=4,
                              ssm_head_dim=16, ssd_chunk=64)
    params = M.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=cuda)
    build.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert kd.SSD_SCAN.launches == cfg.n_layers
    cost, _ = dryrun.fitted_cost(
        cfg, ShapeConfig("prefill_32k", 256, 2, "prefill"),
        fake_mesh((1, 1), ("data", "model")), full_depth=True)
    assert fc.get_total_flops() == cost["flops"]


def test_compressed_mean_over_nccl_world_1(cuda):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.grad_compress import (
        _dequantize,
        _quantize,
        compressed_mean,
    )

    mesh = make_host_mesh()
    try:
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        g = torch.randn(1000, 7, device=cuda)
        q, scale = _quantize(g)
        assert torch.equal(compressed_mean(g), _dequantize(q, scale, g.shape))
        gb = g.to(torch.bfloat16)
        out = compressed_mean(gb)
        assert out.dtype == torch.bfloat16 and out.shape == gb.shape
    finally:
        dist.destroy_process_group()
