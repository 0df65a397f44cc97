"""The port's CUDA kernels on the card: build, the pyramid kernel vs its
plain PyTorch version per pyramid (equal skip maps, outputs within
tolerance), run_network on CUDA vs the port's reference_network (plain,
traced and guarded, with one injected launch failure taking the eager
rung), and the SOP + END kernel vs its plain version.

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run
on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX, so it also runs on a
machine where only PyTorch is installed.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import h100  # noqa: E402
from repro_torch.core.fusion import FusedLevel, FusionSpec  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.core.executor import init_pyramid_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_conv import fused_conv as fc  # noqa: E402
from repro_torch.kernels.online_sop import online_sop as tos  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.core.program import REFERENCE_BUDGET  # noqa: E402
from repro_torch.net.partition import auto_partition  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    FaultInjected,
    GuardConfig,
    guarding,
    inject,
)
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
# VGG-16's deep levels, one conv a launch as the card plans them at batch
# 32 (run here at batch 3, where they also split K): 256 -> 256 at 28 x 28
# (72 K steps), and 512 -> 512 at 14 x 14 with its pool (196 pixels in two
# 128-row tiles, through the pre-pool tile)
CONV256_28 = FusionSpec(
    levels=(FusedLevel("conv", K=3, S=1, pad=1, n_in=256, n_out=256),),
    input_size=28,
)
CONV512_POOL_14 = FusionSpec(
    levels=(
        FusedLevel("conv", K=3, S=1, pad=1, n_in=512, n_out=512),
        FusedLevel("pool", K=2, S=2, pad=0, n_in=512, n_out=512),
    ),
    input_size=14,
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
    "conv256_28": (CONV256_28, 28, 1),
    "conv512_pool_14": (CONV512_POOL_14, 7, 1),
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
@pytest.mark.parametrize("kernel", fc.KERNELS, ids=lambda k: k.symbol)
def test_resident_blocks_fill_the_planned_grid(cuda, kernel, dtype):
    """Both entry points hold the grid the planner's K-splits assume
    (card_layout on h100.PYRAMID_GRID blocks) at both dtypes."""
    assert kernel.resident_blocks(fc._DTYPE_CODES[dtype], cuda) == \
        h100.PYRAMID_GRID


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


def test_resnet50_full_size_batch_32_on_cuda(cuda):
    """ResNet-50 v1.5 at 224², batch 32, on the card's plan (ten fused
    1x1-into-3x3 pairs, linear 1x1 launches, sixteen joins):
    ``run_network``'s logits against ``reference_network`` to the f32
    contract, and its skip maps equal to those of the plain path on the
    CPU."""
    graph = MODELS["resnet50"]()
    params = init_network_params(graph, seed=0, device="cpu")
    x = torch.randn((32, 224, 224, 3),
                    generator=torch.Generator().manual_seed(1))
    plan = auto_partition(graph, batch=32)
    assert plan.fused_convs() == 20 and plan.n_launches() == 43
    on_card = {k: (w.to(cuda), b.to(cuda)) for k, (w, b) in params.items()}
    logits, skips = run_network(
        x.to(cuda), prepare_network_params(plan, on_card), plan=plan
    )
    ref = reference_network(x.to(cuda), graph, on_card)
    err = float((logits - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max()))
    _, plain_skips = run_network(
        x, prepare_network_params(plan, params), plan=plan
    )
    assert list(skips) == list(plain_skips) == [p.name for p in plan.pyramids]
    for name, skip in skips.items():
        assert torch.equal(skip.cpu(), plain_skips[name]), name


def test_traced_run_times_launches_with_cuda_events(cuda):
    graph = MODELS["lenet"](input_size=32, num_classes=10)
    params = init_network_params(graph, seed=0, device=cuda)
    x = torch.randn((2, 32, 32, 1), device=cuda)
    plan = auto_partition(graph, batch=2, prefer_region="smallest")
    with tracing(launches=True) as col:
        logits, _ = run_network(x, params, plan=plan)
    assert logits.is_cuda
    assert [s.name for s in col.spans] == [p.name for p in plan.pyramids]
    assert all(s.duration_ms > 0 for s in col.spans)
    assert {s.device for s in col.spans} == {torch.cuda.get_device_name(cuda)}
    assert col.events[-1].name == "run_network"


def _guarded_resnet(cuda):
    graph = MODELS["resnet18"](input_size=64, num_classes=10)
    master = init_network_params(graph, seed=0, device=cuda)
    plan = auto_partition(graph, batch=1)
    x = torch.randn((1, 64, 64, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    return graph, master, plan, prepare_network_params(plan, master), x


def _plan_counts(plan):
    want = {k.symbol: 0 for k in build.KERNELS}
    for p in plan.pyramids:
        want[(fc.PYRAMID_KTILED if p.launch.c_tiles > 1
              else fc.PYRAMID).symbol] += 1
    return want


def test_clean_guarded_forward_launches_every_kernel(cuda):
    """Under guarding() with no fault: no fallback, every launch clean and
    through its kernel, logits within tolerance of reference_network."""
    graph, master, plan, params, x = _guarded_resnet(cuda)
    build.reset_launch_counts()
    with guarding(GuardConfig(), source_params=master) as guard:
        logits, skips = run_network(x, params, plan=plan)
    counts = {k.symbol: k.launches for k in build.KERNELS}
    rep = guard.last_report
    assert rep.events == [] and rep.clean_launches == rep.launches
    assert rep.launches == plan.n_launches() == len(skips)
    assert counts == _plan_counts(plan)
    ref = reference_network(x, graph, master)
    assert float((logits - ref).abs().max()) <= _tol(ref, torch.float32)


def test_guarded_launch_failure_takes_the_eager_rung(cuda):
    """One injected launch failure: one recorded eager event, that launch
    through the plain version on the card, every other launch through its
    kernel."""
    graph, master, plan, params, x = _guarded_resnet(cuda)
    first = plan.pyramids[0]
    build.reset_launch_counts()
    with guarding(GuardConfig(), source_params=master) as guard:
        with inject(seed=0) as inj:
            inj.raise_at("run", launch=first.name)
            logits, _ = run_network(x, params, plan=plan)
    rep = guard.last_report
    assert [(e.launch, e.rung) for e in rep.events] == [(first.name, "eager")]
    assert rep.clean_launches == rep.launches - 1
    want = _plan_counts(plan)
    want[(fc.PYRAMID_KTILED if first.launch.c_tiles > 1
          else fc.PYRAMID).symbol] -= 1
    assert {k.symbol: k.launches for k in build.KERNELS} == want
    ref = reference_network(x, graph, master)
    assert float((logits - ref).abs().max()) <= _tol(ref, torch.float32)


# (P, m, n_digits): the VGG-16 CONV1 and CONV2 window widths; one to three
# chunks of 16 cycles; ragged P; odd m (x staged 4 bytes at a time); an m
# whose limbs stay resident (363, 6 k-tiles) and one they stream through
# (20000, 313 k-tiles)
SOP_CASES = [(1001, 27, 16), (4096, 576, 16), (999, 64, 24), (513, 65, 33),
             (777, 363, 40), (64, 20000, 12)]


def test_guarded_real_launch_error_raises(cuda, monkeypatch):
    """A launch the card refuses (a cooperative grid one block larger than
    fits) is not an injected fault: it raises out of the guarded run
    instead of taking the eager rung, and nothing runs the plain version."""
    graph, master, plan, params, x = _guarded_resnet(cuda)
    first = plan.pyramids[0]
    kernel = fc.PYRAMID_KTILED if first.launch.c_tiles > 1 else fc.PYRAMID
    fits = kernel.resident_blocks
    monkeypatch.setattr(kernel, "resident_blocks",
                        lambda code, dev: fits(code, dev) + 1)
    monkeypatch.setattr(fc, "fused_pyramid_plain", _never)
    build.reset_launch_counts()
    with guarding(GuardConfig(), source_params=master) as guard:
        with pytest.raises(RuntimeError, match="launch failed") as err:
            run_network(x, params, plan=plan)
    assert not isinstance(err.value, FaultInjected)
    assert guard.last_report is None
    assert kernel.launches == 0


def _never(*args, **kwargs):
    raise AssertionError("the plain version ran on the card")


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


# ---------------------------------------------------------------------------
# the compiled forward (a captured CUDA graph per key) and serving on the card
# ---------------------------------------------------------------------------


def _vgg_b1(cuda):
    """VGG-16 at 32 x 32, batch 1, planned under the reference's TPU budget
    (kernel B's only route): 5 launches, one of them channel-tiled, so a
    replay runs kernels A and B."""
    graph = MODELS["vgg16"](input_size=32, num_classes=10)
    master = init_network_params(graph, seed=0, device=cuda)
    plan = auto_partition(graph, batch=1, budget=REFERENCE_BUDGET)
    assert any(p.launch.c_tiles > 1 for p in plan.pyramids)
    assert any(p.launch.c_tiles == 1 for p in plan.pyramids)
    x = torch.randn((1, 32, 32, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    return graph, master, plan, prepare_network_params(plan, master), x


def _counts():
    return {k.symbol: k.launches for k in build.KERNELS}


def _eager(x, params, plan):
    from repro_torch.core.executor import full_fp32
    from repro_torch.net.runner import _forward

    with full_fp32():
        return _forward(x, params, plan=plan, end_skip=True,
                        cdt=plan.compute_dtype)


def test_replays_are_bitwise_and_counted(cuda):
    """One key captured, then replayed 20 times: every replay's logits and
    skip maps equal the eager forward's bit for bit (the same kernels,
    the same cuDNN and cuBLAS calls), each replay counts the plan's
    launches of A and B, and the capture itself counts none."""
    from repro_torch.net import runner

    graph, master, plan, params, x = _vgg_b1(cuda)
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    build.reset_launch_counts()
    first, first_skips = run_network(x, params, plan=plan)  # eager + capture
    torch.cuda.synchronize()
    assert runner.jit_trace_count() == 1
    assert _counts() == _plan_counts(plan)
    want, want_skips = _eager(x, params, plan)
    torch.cuda.synchronize()
    assert torch.equal(first, want)
    build.reset_launch_counts()
    for i in range(20):
        xi = x if i % 2 == 0 else x.clone()  # the input is copied in
        y, skips = run_network(xi, params, plan=plan)
        assert torch.equal(y, want), i
        assert all(torch.equal(skips[k], want_skips[k]) for k in want_skips)
    torch.cuda.synchronize()
    assert runner.jit_trace_count() == 1
    assert _counts() == {k: 20 * v for k, v in _plan_counts(plan).items()}
    # results handed out are clones: a later replay leaves them alone
    other = torch.randn_like(x)
    kept = y.clone()
    run_network(other, params, plan=plan)
    assert torch.equal(y, kept)
    ref = reference_network(x, graph, master)
    assert float((y - ref).abs().max()) <= _tol(ref, torch.float32)


def test_capture_error_raises(cuda, monkeypatch):
    """A forward that cannot be captured (here: a synchronisation inside
    it) raises from run_network; nothing is cached or counted, and the next
    capture works."""
    from repro_torch.net import runner

    graph, master, plan, params, x = _vgg_b1(cuda)
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    head = runner._head_op

    def syncing_head(*args, **kwargs):
        torch.cuda.synchronize()
        return head(*args, **kwargs)

    monkeypatch.setattr(runner, "_head_op", syncing_head)
    with pytest.raises(RuntimeError):
        run_network(x, params, plan=plan)
    assert runner.jit_trace_count() == 0
    assert runner.compiled_cache_info()["currsize"] == 0
    monkeypatch.setattr(runner, "_head_op", head)
    y, _ = run_network(x, params, plan=plan)
    y2, _ = run_network(x, params, plan=plan)
    assert runner.jit_trace_count() == 1 and torch.equal(y, y2)


def test_evicted_entry_frees_its_graph(cuda, monkeypatch):
    import gc
    import weakref

    from repro_torch.net import runner

    graph, master, plan, params, x = _vgg_b1(cuda)
    monkeypatch.setattr(runner, "COMPILED_CACHE_SIZE", 1)
    runner.clear_compiled_cache()
    run_network(x, params, plan=plan)
    (entry,) = runner._COMPILED.values()
    refs = [weakref.ref(o) for o in (entry.graph, entry.static_x,
                                     entry.logits)]
    del entry
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    run_network(x.repeat(2, 1, 1, 1), params, plan=plan)  # evicts batch 1
    gc.collect()
    assert runner.compiled_cache_info()["currsize"] == 1
    assert all(r() is None for r in refs)
    runner.clear_compiled_cache()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) < held


def test_graph_dies_with_its_params(cuda):
    """The compiled cache holds its params weakly: when the caller drops
    them, the entry goes, and its graph, static tensors and pool with it."""
    import gc
    import weakref

    from repro_torch.net import runner

    graph, master, plan, params, x = _vgg_b1(cuda)
    own = {k: v.clone() if isinstance(v, torch.Tensor)
           else tuple(t.clone() for t in v) for k, v in params.items()}
    runner.clear_compiled_cache()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    run_network(x, own, plan=plan)
    (entry,) = runner._COMPILED.values()
    refs = [weakref.ref(o) for o in (entry.graph, entry.static_x,
                                     entry.logits)]
    del entry
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    assert held > base
    del own
    gc.collect()
    assert runner.compiled_cache_info()["currsize"] == 0
    assert all(r() is None for r in refs)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) < held


def _lenet_engine(cuda, **cfg):
    from repro_torch.net.serve import ServeConfig, ServingEngine

    graph = MODELS["lenet"]()
    master = init_network_params(graph, seed=0, device=cuda)
    eng = ServingEngine(graph, master, ServeConfig(buckets=(1, 2, 4), **cfg),
                        device=cuda)
    return graph, master, eng


def _lenet_images(rows, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((rows, 32, 32, 1), generator=gen).numpy()


def test_staging_copy_is_ordered_before_the_replay(cuda, monkeypatch):
    """The copy stream is held up by a 50 ms device spin before the
    batch's copy: with the event the compute stream waits and the logits
    are right; with the wait taken out the replay reads the buffer before
    the copy lands and the logits are wrong — so the event is what orders
    them."""
    graph, master, eng = _lenet_engine(cuda)
    eng.serve([_lenet_images(4, 0)])  # capture bucket 4, make the stream
    assert eng._copy_stream is not None

    def served(seed):
        x = _lenet_images(4, seed)
        with torch.cuda.stream(eng._copy_stream):
            torch.cuda._sleep(100_000_000)
        (res,) = eng.serve([x])
        ref = reference_network(torch.from_numpy(x).to(cuda), graph, master)
        return float(np.abs(res.logits - ref.cpu().numpy()).max()), ref

    err, ref = served(1)
    assert err <= _tol(ref, torch.float32)

    def no_wait(staged):
        staged.x.record_stream(torch.cuda.current_stream(cuda))

    monkeypatch.setattr(eng, "_await_staging", no_wait)
    err, ref = served(2)
    assert err > _tol(ref, torch.float32)


def test_engine_waves_replay_and_count(cuda):
    """Two waves of the same stream: wave 1 captures one graph per bucket
    used, wave 2 captures none and misses no plan; A's launches equal the
    plan's times the batches served; every request within tolerance of
    reference_network."""
    from repro_torch.net import runner

    graph, master, eng = _lenet_engine(cuda)
    plan_launches = {b: eng._entry(b).plan.n_launches() for b in (1, 2, 4)}
    stream = [_lenet_images(r, 10 + i) for i, r in enumerate((1, 2, 1, 3))]
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    for wave in (1, 2):
        build.reset_launch_counts()
        misses = eng.cache_counters["misses"]
        before = dict(eng.route_batches)
        results = eng.serve(stream[:1]) + eng.serve(stream[1:])
        torch.cuda.synchronize()
        served = {k: v - before.get(k, 0) for k, v in eng.route_batches.items()}
        assert set(r for _, r in served) == {"fused"}
        want = sum(n * plan_launches[b] for (b, _), n in served.items())
        assert _counts()[fc.PYRAMID.symbol] == want
        if wave == 1:
            buckets = {b for b, _ in served}
            assert runner.jit_trace_count() == len(buckets)
        else:
            assert runner.jit_trace_count() == len(buckets)
            assert eng.cache_counters["misses"] == misses
        for x, res in zip(stream, results):
            ref = reference_network(torch.from_numpy(x).to(cuda), graph,
                                    master)
            assert res.ok
            assert float(np.abs(res.logits - ref.cpu().numpy()).max()) \
                <= _tol(ref, torch.float32)


def test_traced_engine_replays_its_graphs(cuda):
    """Under ``tracing()`` a warm engine's forward replays its captured
    graphs: no capture, no launch span, A's launches the plan's, and one
    ``runner.replay`` span inside each batch's ``serve.dispatch``, between
    its ``serve.h2d`` and its ``serve.sync``."""
    from repro_torch.net import runner

    graph, master, eng = _lenet_engine(cuda)
    plan = eng._entry(4).plan
    stream = [_lenet_images(4, 20 + i) for i in range(3)]
    eng.serve(stream[:1])  # captures bucket 4
    runner.reset_jit_trace_count()
    build.reset_launch_counts()
    with tracing() as col:
        results = eng.serve(stream)
    torch.cuda.synchronize()
    assert all(r.ok for r in results)
    assert runner.jit_trace_count() == 0 and not col.spans
    assert _counts()[fc.PYRAMID.symbol] == 3 * plan.n_launches()
    spans = {(s.name, s.batch): s for s in col.host_spans}
    replays = [s for s in col.host_spans if s.name == "runner.replay"]
    assert len(replays) == 3
    for r in replays:
        parent = next(s for s in col.host_spans if s.id == r.parent)
        assert parent.name == "serve.dispatch"
        seq = parent.batch
        assert (spans[("serve.h2d", seq)].end_ns <= parent.start_ns
                <= parent.end_ns <= spans[("serve.sync", seq)].start_ns)
        assert ("serve.pad", seq) in spans and ("serve.record", seq) in spans


def test_engine_keeps_two_batches_in_flight(cuda):
    """With the resilience hooks off the card's drain loop dispatches
    batch n+1 before it waits for batch n, reads each batch's logits from
    its own pinned copy, and answers every request as a one-deep loop
    does."""
    graph, master, eng = _lenet_engine(cuda)
    _, _, one = _lenet_engine(cuda)
    one._depth = lambda inj: 1
    from repro_torch.robust.faults import get_injector

    assert eng._depth(get_injector()) == 2
    stream = [_lenet_images(4, 60 + i) for i in range(6)]
    eng.serve(stream[:1])  # captures bucket 4
    with tracing() as col:
        results = eng.serve(stream)
    want = one.serve(stream)
    spans = {(s.name, s.batch): s for s in col.host_spans}
    seqs = sorted(b for n, b in spans if n == "serve.sync")
    assert len(seqs) == 6
    for n, m in zip(seqs, seqs[1:]):
        assert (spans[("serve.dispatch", m)].end_ns
                <= spans[("serve.sync", n)].start_ns)
    for x, res, res1 in zip(stream, results, want):
        ref = reference_network(torch.from_numpy(x).to(cuda), graph, master)
        assert res.ok and res1.ok
        assert float(np.abs(res.logits - ref.cpu().numpy()).max()) \
            <= _tol(ref, torch.float32)
        assert float(np.abs(res.logits - res1.logits).max()) \
            <= _tol(ref, torch.float32)

def test_frontend_on_the_card(cuda):
    """4 producer threads x 8 requests through the frontend, all CUDA work
    on its drain thread: every handle resolves exactly once with its own
    rows' logits."""
    import threading

    from repro_torch.net.frontend import ServingFrontend

    graph, master, eng = _lenet_engine(cuda)
    results, lock, errors = {}, threading.Lock(), []

    def producer(tid):
        try:
            for i in range(8):
                seed = 1000 + 100 * tid + i
                h = fe.submit(_lenet_images(1 + i % 2, seed))
                r = h.result(timeout=120.0)
                with lock:
                    results.setdefault(r.id, []).append((r, seed))
        except Exception as e:  # surfaced below
            errors.append(e)

    with ServingFrontend(eng) as fe:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 32 and all(len(v) == 1 for v in results.values())
    for ((r, seed),) in results.values():
        x = _lenet_images(r.rows, seed)
        ref = reference_network(torch.from_numpy(x).to(cuda), graph, master)
        assert r.ok and float(np.abs(r.logits - ref.cpu().numpy()).max()) \
            <= _tol(ref, torch.float32)


def test_breaker_pins_the_eager_route_on_the_card(cuda):
    """Two guarded batches whose launch takes the eager rung open the
    breaker pinned to ``eager``: the third batch runs every pyramid through
    its plain version on the card (no kernel launch) and stays right."""
    from repro_torch.robust import FaultInjector

    graph, master, eng = _lenet_engine(
        cuda, guarded=True, breaker_threshold=2, breaker_cooldown_s=600.0)
    xs = [_lenet_images(4, 40 + i) for i in range(3)]
    inj = FaultInjector(seed=0)
    build.reset_launch_counts()
    with inject(injector=inj):
        results = []
        for i, x in enumerate(xs):
            if i < 2:
                inj.raise_at("run", times=1)
            results += eng.serve([x])
    torch.cuda.synchronize()
    snap = eng.summary()["resilience"]["breakers"]["4"]
    assert snap["state"] == "open" and snap["pinned_rung"] == "eager"
    assert eng.route_batches == {(4, "fused"): 2, (4, "eager"): 1}
    assert _counts()[fc.PYRAMID.symbol] == 0
    for x, res in zip(xs, results):
        ref = reference_network(torch.from_numpy(x).to(cuda), graph, master)
        assert res.ok and float(np.abs(res.logits - ref.cpu().numpy()).max()) \
            <= _tol(ref, torch.float32)


def test_genuine_faults_stay_on_the_kernels_on_the_card(cuda, monkeypatch):
    """Non-finite logits and a slow batch that no injected fault explains
    fail their batches typed (``NumericError``, ``WatchdogError``) with the
    sentinel, the watchdog and breaker 1 all on: the breaker stays closed,
    every batch takes the fused route, and kernel A's launches are the
    plan's for each of them — nothing is re-served from a plain version."""
    from repro_torch.net import serve as tserve
    from repro_torch.robust import NumericError, WatchdogError

    graph, master, eng = _lenet_engine(
        cuda, output_sentinel=True, watchdog_factor=3.0,
        breaker_threshold=1, breaker_cooldown_s=600.0)
    for i in range(3):  # capture bucket 4, then calibrate on replays
        assert eng.serve([_lenet_images(4, 70 + i)])[0].ok
    real, calls = tserve.run_network, []

    def faulty(*args, **kwargs):
        logits, skips = real(*args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            logits = logits.clone()
            logits[0, 0] = float("nan")
        elif len(calls) == 2:
            torch.cuda.synchronize()
            time.sleep(0.5)
        return logits, skips

    monkeypatch.setattr(tserve, "run_network", faulty)
    build.reset_launch_counts()
    x = _lenet_images(4, 80)
    (nan,) = eng.serve([x])
    (slow,) = eng.serve([x])
    (good,) = eng.serve([x])
    torch.cuda.synchronize()
    assert isinstance(nan.error, NumericError)
    assert isinstance(slow.error, WatchdogError)
    ref = reference_network(torch.from_numpy(x).to(cuda), graph, master)
    assert good.ok and float(np.abs(good.logits - ref.cpu().numpy()).max()) \
        <= _tol(ref, torch.float32)
    snap = eng.summary()["resilience"]["breakers"]["4"]
    assert snap["state"] == "closed" and snap["opens"] == 0
    assert eng.route_batches == {(4, "fused"): 6}
    assert _counts()[fc.PYRAMID.symbol] == 3 * eng._entry(4).plan.n_launches()


def test_frontend_surfaces_a_capture_error_on_the_card(cuda, monkeypatch):
    """A capture that fails on the drain thread (a synchronisation inside
    the forward) ends the frontend's drain: every pending handle raises
    that error, and so does a later submit; nothing falls back."""
    from repro_torch.net import runner
    from repro_torch.net.frontend import ServingFrontend

    graph, master, eng = _lenet_engine(cuda)
    runner.clear_compiled_cache()
    head = runner._head_op

    def syncing_head(*args, **kwargs):
        torch.cuda.synchronize()
        return head(*args, **kwargs)

    monkeypatch.setattr(runner, "_head_op", syncing_head)
    fe = ServingFrontend(eng)
    handles = [fe.submit(_lenet_images(r, 90 + r)) for r in (2, 1, 4)]
    with fe:
        for h in handles:
            with pytest.raises(RuntimeError):
                h.result(timeout=120.0)
        with pytest.raises(RuntimeError):
            fe.submit(_lenet_images(1, 99))
    assert runner.compiled_cache_info()["currsize"] == 0
    assert eng.route_batches == {}
