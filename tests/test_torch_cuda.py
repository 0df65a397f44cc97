"""The port's CUDA kernels on the card: build, the pyramid kernel vs its
plain PyTorch version per pyramid (equal skip maps, outputs within
tolerance), run_network on CUDA vs the port's reference_network, and the
SOP + END kernel vs its plain version.

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
from repro_torch.kernels.online_sop import online_sop as tos  # noqa: E402
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

# the edges of the conv tiles: an RGB 7x7/2 level (the scalar gather, K*K*Cin
# = 147 not a multiple of the K step) at an input of 64
RGB_K7_S2 = FusionSpec(
    levels=(
        FusedLevel("conv", K=7, S=2, pad=3, n_in=3, n_out=64),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=64, n_out=64),
    ),
    input_size=64,
)
# Cout of 6 and 96, neither a multiple of the channel tile
COUT_6_96 = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=1, pad=1, n_in=8, n_out=6),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=6, n_out=96),
    ),
    input_size=16,
)
# 7 x 7 levels, below every pixel tile
LEVEL_7X7 = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=1, pad=1, n_in=32, n_out=64),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=64, n_out=64),
    ),
    input_size=7,
)
# Q = 4 with two pools, run at alpha = 4
Q4_POOLS = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=1, pad=1, n_in=3, n_out=16),
        FusedLevel("pool", K=2, S=2, pad=0, n_in=16, n_out=16),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=16, n_out=32),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=32, n_out=32),
        FusedLevel("pool", K=2, S=2, pad=0, n_in=32, n_out=32),
        FusedLevel("conv", K=3, S=1, pad=1, n_in=32, n_out=64),
    ),
    input_size=32,
)

# (spec, out_region, c_tiles)
CASES = {
    "q3_alpha4": (Q3_CHAIN, 1, 1),
    "stem_padded_pool": (STEM, 4, 1),
    "strided_c4": (STRIDED, 8, 4),
    "strided_alpha2_c2": (STRIDED, 4, 2),
    "rgb_k7_s2_in64": (RGB_K7_S2, 16, 1),
    "cout_6_96": (COUT_6_96, 8, 1),
    "level_7x7": (LEVEL_7X7, 7, 1),
    "q4_pools_alpha4": (Q4_POOLS, 2, 1),
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
    for name in build.SOURCES:
        print(reports[name])
        assert build.library_path(name).is_file()


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["q4_pools_alpha4", "strided_c4"])
def test_launches_are_deterministic(cuda, name, dtype):
    """Two launches of one pyramid agree bit for bit: no atomics on sums,
    and split partial sums are added in split order."""
    spec, region, c_tiles = CASES[name]
    prog = compile_program(spec, region, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    p = init_pyramid_params(spec, seed=6, device=cuda)
    gen = torch.Generator().manual_seed(7)
    B, n = 2, spec.input_size
    x = torch.randn((B, n, n, spec.levels[0].n_in), generator=gen)
    xp = torch.nn.functional.pad(
        x.to(cuda, tdt), (0, 0, prog.pad_lo, prog.pad_hi, prog.pad_lo,
                          prog.pad_hi)
    ).contiguous()
    ws = [w.to(tdt) for w in p.weights]
    bs = [b.to(tdt) for b in p.biases]
    kernel = fc.PYRAMID_KTILED if c_tiles > 1 else fc.PYRAMID
    grid = kernel.resident_blocks(fc._DTYPE_CODES[dtype], cuda)
    desc, _, _ = fc._descriptor(prog, True, True, c_tiles, B, grid)
    splits = [desc[fc._HEADER + fc._PER_LEVEL * l + fc._PER_LEVEL - 2]
              for l in range(prog.q_convs)]
    assert max(splits) > 1  # a K-split level is part of the check
    y1, s1 = fc.fused_pyramid_kernel(xp, ws, bs, program=prog,
                                     c_tiles=c_tiles)
    y2, s2 = fc.fused_pyramid_kernel(xp, ws, bs, program=prog,
                                     c_tiles=c_tiles)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


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


# (P, m, n_digits): the VGG-16 CONV1 and CONV2 window widths; one to three
# chunks of 16 cycles; ragged P; odd m (x staged 4 bytes at a time); an m
# whose limbs stay resident (363, 6 k-tiles) and one they stream through
# (20000, 313 k-tiles)
SOP_CASES = [(1001, 27, 16), (4096, 576, 16), (999, 64, 24), (513, 65, 33),
             (777, 363, 40), (64, 20000, 12)]


def _sop_operands(P, m, n_filters, cuda):
    gen = torch.Generator().manual_seed(P + m + (n_filters or 0))
    x = (torch.rand((P, m), generator=gen) * 1.8 - 0.9).to(cuda)
    shape = (m,) if n_filters is None else (n_filters, m)
    y = ((torch.rand(shape, generator=gen) * 1.8 - 0.9) / m).to(cuda)
    return x, y


def _check_sop_filter(x, y, n_digits, got):
    """One filter's kernel results against the plain version."""
    plain = tos.online_sop_end_plain(x, y, n_digits)
    # both sum up to m float32 products, in different orders
    err = float((got[0] - plain[0]).abs().max())
    assert err <= 1e-5 * max(1.0, float(plain[0].abs().max())), err
    rows, margins, tie = tos.latch_disagreements(x, y, n_digits, got, plain)
    assert bool((margins <= tie).all()), (rows, margins, tie)
    assert not bool((got[2] & (got[0] >= 0)).any())


@pytest.mark.parametrize("P,m,n_digits", SOP_CASES)
def test_sop_end_kernel_matches_plain(cuda, P, m, n_digits):
    x, y = _sop_operands(P, m, None, cuda)
    before = tos.SOP_END.launches
    got = tos.online_sop_end_kernel(x, y, n_digits)
    torch.cuda.synchronize()
    assert tos.SOP_END.launches == before + 1
    _check_sop_filter(x, y, n_digits, got)
    assert 0 < int(got[2].sum()) < P


# (P, m, F, n_digits): 3, 64 and 65 filters (one and two filter blocks, a
# block of one filter) at the CONV1 and CONV2 widths with ragged P; 700
# and 20000 elements, whose limbs stream through in k-tiles
SOP_BATCHED = [(1001, 27, 64, 16), (999, 27, 3, 24), (517, 27, 65, 16),
               (4099, 576, 64, 16), (513, 576, 3, 33), (777, 576, 65, 16),
               (333, 700, 5, 20), (40, 20000, 3, 12)]


@pytest.mark.parametrize("P,m,n_filters,n_digits", SOP_BATCHED)
def test_sop_end_batched_matches_plain(cuda, P, m, n_filters, n_digits):
    """One launch for all filters; each column against the plain version."""
    x, Y = _sop_operands(P, m, n_filters, cuda)
    before = tos.SOP_END.launches
    got = tos.online_sop_end_kernel(x, Y, n_digits)
    torch.cuda.synchronize()
    assert tos.SOP_END.launches == before + 1
    assert got[0].shape == got[1].shape == got[2].shape == (P, n_filters)
    for f in range(n_filters):
        _check_sop_filter(x, Y[f], n_digits,
                          tuple(t[:, f] for t in got))
    assert 0 < int(got[2].sum()) < got[2].numel()


@pytest.mark.parametrize("P,m,n_filters,n_digits",
                         [(1001, 27, 65, 16), (777, 576, 64, 33),
                          (40, 20000, 3, 12)])
def test_sop_end_batched_equals_single_calls(cuda, P, m, n_filters,
                                             n_digits):
    """Each filter's arithmetic is independent of F and of the block that
    holds it: a batched call equals F single calls bit for bit."""
    x, Y = _sop_operands(P, m, n_filters, cuda)
    got = tos.online_sop_end_kernel(x, Y, n_digits)
    for f in range(n_filters):
        one = tos.online_sop_end_kernel(x, Y[f].contiguous(), n_digits)
        for a, b in zip(got, one):
            assert torch.equal(a[:, f], b), f


def test_sop_end_kernel_contract(cuda):
    x, Y = _sop_operands(64, 27, 4, cuda)
    before = tos.SOP_END.launches
    with pytest.raises(TypeError):
        tos.online_sop_end_kernel(x, Y.double(), 16)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, Y[:, :26].contiguous(), 16)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, Y[None], 16)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, Y.cpu(), 16)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, Y.t(), 16)
    assert tos.SOP_END.launches == before
    sop, cyc, det = tos.online_sop_end_kernel(x[:0], Y, 16)  # P = 0
    assert sop.shape == (0, 4) and tos.SOP_END.launches == before
