"""The port's CUDA kernel on the card: build, kernel vs its plain PyTorch
version per pyramid (equal skip maps, outputs within tolerance), and
run_network on CUDA vs the port's reference_network.

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run
on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX, so it also runs on a
machine where only PyTorch is installed.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fusion import FusedLevel, FusionSpec  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.core.executor import init_pyramid_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_conv import fused_conv as fc  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.net.partition import auto_partition  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.net.runner import (  # noqa: E402
    bf16_logit_tol,
    init_network_params,
    prepare_network_params,
    reference_network,
    run_network,
)

pytestmark = pytest.mark.cuda

Q3_CHAIN = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=1, pad=1, n_in=2, n_out=6),
        FusedLevel("pool", K=2, S=2, pad=0, n_in=6, n_out=6),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=6, n_out=8),
        FusedLevel("conv", K=3, S=1, pad=0, n_in=8, n_out=4),
    ),
    input_size=20,
)
STEM = FusionSpec(
    levels=(
        FusedLevel("conv", K=7, S=2, pad=3, n_in=3, n_out=16),
        FusedLevel("pool", K=3, S=2, pad=1, n_in=16, n_out=16),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=16, n_out=16),
    ),
    input_size=32,
)
STRIDED = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=2, pad=1, n_in=8, n_out=16),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=16, n_out=16),
    ),
    input_size=16,
)

# (spec, out_region, c_tiles)
CASES = {
    "q3_alpha4": (Q3_CHAIN, 1, 1),
    "stem_padded_pool": (STEM, 4, 1),
    "strided_c4": (STRIDED, 8, 4),
    "strided_alpha2_c2": (STRIDED, 4, 2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(ref, dtype):
    # f32: sums of <= K*K*Cin terms in another order than cuDNN's;
    # bf16: one rounding flip per level of an 8-bit significand
    scale = max(1.0, float(ref.abs().max()))
    return (1e-4 if dtype == torch.float32 else 2e-2) * scale


def test_library_builds(cuda):
    reports = build.build()
    print(reports["fused_pyramid"])
    assert build.library_path("fused_pyramid").is_file()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name, sparse, dtype):
    spec, region, c_tiles = CASES[name]
    prog = compile_program(spec, region, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    p = init_pyramid_params(spec, seed=3, device=cuda)
    gen = torch.Generator().manual_seed(4)
    B, n = 3, spec.input_size
    x = torch.randn((B, n, n, spec.levels[0].n_in), generator=gen)
    biases = p.biases
    if sparse:
        # a blob in one corner of image 0, all-zero images after it, and
        # negative biases: the skip maps hold live and dead tiles
        blob = max(2, n // 3)
        x[:, blob:, :, :] = 0
        x[:, :, blob:, :] = 0
        x[1:] = 0
        biases = [b - 0.3 for b in biases]
    xp = torch.nn.functional.pad(
        x.to(cuda, tdt), (0, 0, prog.pad_lo, prog.pad_hi, prog.pad_lo,
                          prog.pad_hi)
    ).contiguous()
    ws = [w.to(tdt) for w in p.weights]
    bs = [b.to(tdt) for b in biases]
    before = (fc.PYRAMID.launches, fc.PYRAMID_KTILED.launches)
    y, skip = fc.fused_pyramid_kernel(xp, ws, bs, program=prog,
                                      c_tiles=c_tiles)
    torch.cuda.synchronize()
    kernel = fc.PYRAMID_KTILED if c_tiles > 1 else fc.PYRAMID
    assert kernel.launches == before[c_tiles > 1] + 1
    y_ref, skip_ref = fc.fused_pyramid_plain(xp, ws, bs, program=prog)
    assert torch.equal(skip, skip_ref)
    if sparse and spec.q_convs > 1:
        assert 0 < int(skip[..., 1:].sum()) < skip[..., 1:].numel()
    err = float((y.float() - y_ref.float()).abs().max())
    assert err <= _tol(y_ref.float(), tdt), err


def test_streamed_flat_weights_match_resident(cuda):
    spec, region, _ = CASES["strided_c4"]
    prog = compile_program(spec, region)
    p = init_pyramid_params(spec, seed=5, device=cuda)
    x = torch.randn((2, 16, 16, 8), device=cuda)
    xp = torch.nn.functional.pad(
        x, (0, 0, prog.pad_lo, prog.pad_hi, prog.pad_lo, prog.pad_hi)
    ).contiguous()
    flat = torch.cat([w.reshape(-1) for w in p.weights])
    y1, s1 = fc.fused_pyramid_kernel(xp, p.weights, p.biases, program=prog)
    y2, s2 = fc.fused_pyramid_kernel(
        xp, None, p.biases, program=prog, stream_weights=True,
        weights_flat=flat,
    )
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["lenet", "resnet18"])
def test_run_network_on_cuda(cuda, model, dtype):
    graph = MODELS[model](input_size=32, num_classes=10)
    params = init_network_params(graph, seed=0, device=cuda)
    x = torch.randn((2, 32, 32, graph.in_channels), device=cuda)
    plan = auto_partition(graph, batch=2, compute_dtype=dtype)
    logits, skips = run_network(
        x, prepare_network_params(plan, params), plan=plan
    )
    ref = reference_network(x, graph, params)
    err = float((logits.float() - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max())) if dtype == "float32" \
        else bf16_logit_tol(ref)
    assert err <= tol
    assert len(skips) == plan.n_launches()


def test_traced_run_times_launches_with_cuda_events(cuda):
    graph = MODELS["lenet"](input_size=32, num_classes=10)
    params = init_network_params(graph, seed=0, device=cuda)
    x = torch.randn((2, 32, 32, 1), device=cuda)
    plan = auto_partition(graph, batch=2, prefer_region="smallest")
    with tracing() as col:
        logits, _ = run_network(x, params, plan=plan)
    assert logits.is_cuda
    assert [s.name for s in col.spans] == [p.name for p in plan.pyramids]
    assert all(s.duration_ms > 0 for s in col.spans)
    assert col.events[-1].name == "run_network"
