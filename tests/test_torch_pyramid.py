"""Per-pyramid parity of the port's ``fused_pyramid`` (on the CPU, i.e. the
kernel's plain PyTorch version) against the reference's oracles, on the
same numpy inputs and the reference's own initialised params.

The reference's Pallas kernel cannot launch with the installed jax, so the
oracles are its pure-jnp ``reference_forward`` (and ``fused_forward`` for
the padded-pool stem, which ``reference_forward``'s VALID pool cannot
express); skip maps are held exactly against the dead-tile maps built from
the reference's intermediates (``test_pyramid_kernel._expected_skip_maps``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core.cnn_models import (  # noqa: E402
    LENET5_FUSION,
    VGG_FUSION,
    resnet18_fusions,
)
from repro.core.fusion import FusedLevel as JLevel  # noqa: E402
from repro.core.fusion import FusionSpec as JSpec  # noqa: E402
from repro.core.fusion import lockstep_plan as jlockstep  # noqa: E402
from repro.kernels.fused_conv import ops as jops  # noqa: E402
from repro_torch.core.fusion import FusedLevel, FusionSpec  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.kernels.fused_conv import fused_conv as fc  # noqa: E402
from repro_torch.kernels.fused_conv import ops  # noqa: E402
from repro_torch.kernels.fused_conv.ref import fused_pyramid_ref  # noqa: E402
from repro_torch.robust.errors import BudgetError  # noqa: E402

from test_pyramid_kernel import _expected_skip_maps  # noqa: E402

KEY = jax.random.PRNGKey(0)

Q3_CHAIN = JSpec(
    levels=(
        JLevel("conv", K=3, S=1, pad=1, n_in=2, n_out=6),
        JLevel("pool", K=2, S=2, pad=0, n_in=6, n_out=6),
        JLevel("conv", K=3, S=1, pad=1, n_in=6, n_out=8),
        JLevel("conv", K=3, S=1, pad=0, n_in=8, n_out=4),
    ),
    input_size=20,
)
# ResNet-18's stem at 32^2 with its 3x3/2 pad-1 pool and the first block's
# conv fused behind it: a padded pool in the middle of a pyramid
STEM = JSpec(
    levels=(
        JLevel("conv", K=7, S=2, pad=3, n_in=3, n_out=16),
        JLevel("pool", K=3, S=2, pad=1, n_in=16, n_out=16),
        JLevel("conv", K=3, S=1, pad=1, n_in=16, n_out=16),
    ),
    input_size=32,
)

# name -> (reference spec, out_region, c_tiles)
CASES = {
    "lenet_q2": (LENET5_FUSION, 1, 1),
    "odd_q3": (Q3_CHAIN, 4, 1),
    "vgg_q4_32": (dataclasses.replace(VGG_FUSION, input_size=32), 4, 1),
    "resnet18_strided_blk": (resnet18_fusions(32)[2], 4, 1),
    "stem_padded_pool": (STEM, 4, 1),
    "strided_blk_c_tiles4": (resnet18_fusions(32)[2], 4, 4),
}


def _port(jspec):
    return FusionSpec(
        levels=tuple(FusedLevel(**dataclasses.asdict(l)) for l in jspec.levels),
        input_size=jspec.input_size,
    )


def _case(jspec, *, batch=2, seed=1, shift=0.0, sparse=None):
    """The reference's params and a numpy input, and their port twins."""
    p = jex.init_pyramid_params(jspec, KEY)
    ws = [np.asarray(w) for w in p.weights]
    bs = [np.asarray(b) + np.float32(shift) for b in p.biases]
    n, c = jspec.input_size, jspec.levels[0].n_in
    if sparse is not None:
        # a constant blob of height ``sparse`` in one corner, zeros elsewhere
        x = np.zeros((batch, n, n, c), np.float32)
        x[:, : n // 3, : n // 3, :] = sparse
    else:
        x = np.random.default_rng(seed).standard_normal(
            (batch, n, n, c)
        ).astype(np.float32)
    tw = [torch.from_numpy(w.copy()) for w in ws]
    tb = [torch.from_numpy(b.copy()) for b in bs]
    return x, ws, bs, tw, tb


def _oracle(name, jspec, region, x, ws, bs):
    if name == "stem_padded_pool":
        return np.asarray(jex.fused_forward(
            jnp.asarray(x), jspec, jex.PyramidParams(ws, bs),
            jlockstep(jspec, region),
        ))
    return np.asarray(jex.reference_forward(
        jnp.asarray(x), jspec, jex.PyramidParams(ws, bs)
    ))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_pyramid_matches_reference(name):
    jspec, region, c_tiles = CASES[name]
    x, ws, bs, tw, tb = _case(jspec)
    y, skip = ops.fused_pyramid(
        torch.from_numpy(x), tw, tb, spec=_port(jspec), out_region=region,
        c_tiles=c_tiles, streamed=c_tiles > 1,
    )
    np.testing.assert_allclose(
        y.numpy(), _oracle(name, jspec, region, x, ws, bs), atol=1e-5
    )
    alpha = jspec.feature_sizes()[-1] // region
    assert skip.shape == (2, alpha, alpha, jspec.q_convs)
    assert skip.dtype == torch.int32


@pytest.mark.parametrize(
    "name,region,shift,blob",
    [("lenet_q2", 1, -0.5, 5.0), ("odd_q3", 1, -0.4, 5.0),
     ("vgg_q4_32", 2, -0.3, 1.0)],
)
def test_skip_maps_equal_reference_dead_tiles(name, region, shift, blob):
    """Sparse input and negative-shifted biases: live and dead tiles both
    occur, and the per-level flags equal the reference's dead-tile maps."""
    jspec = CASES[name][0]
    x, ws, bs, tw, tb = _case(jspec, batch=1, shift=shift, sparse=blob)
    y, skip = ops.fused_pyramid(torch.from_numpy(x), tw, tb,
                                spec=_port(jspec), out_region=region)
    expected, _ = _expected_skip_maps(jspec, ws, bs, jnp.asarray(x), region)
    np.testing.assert_array_equal(skip.numpy()[0], expected)
    assert 0 < expected[..., 1].sum() < expected[..., 1].size
    np.testing.assert_allclose(
        y.numpy(), _oracle(name, jspec, region, x, ws, bs), atol=1e-5
    )


def test_full_cascade_all_levels_skip():
    jspec = Q3_CHAIN
    x, ws, bs, tw, tb = _case(jspec, batch=1, shift=-10.0)
    y, skip = ops.fused_pyramid(torch.from_numpy(x), tw, tb,
                                spec=_port(jspec), out_region=4)
    assert (skip[..., 0] == 0).all() and (skip[..., 1:] == 1).all()
    np.testing.assert_allclose(
        y.numpy(), _oracle("odd_q3", jspec, 4, x, ws, bs), atol=1e-5
    )


@pytest.mark.parametrize("c_tiles", [2, 8])
def test_channel_tiling_and_streaming_change_no_value(c_tiles):
    """c_tiles, streamed flat weights and x_slots are schedule knobs: the
    result and the skip map stay those of the plain resident launch."""
    jspec = CASES["resnet18_strided_blk"][0]
    x, ws, bs, tw, tb = _case(jspec, shift=-0.05)
    spec = _port(jspec)
    base, s0 = ops.fused_pyramid(torch.from_numpy(x), tw, tb, spec=spec,
                                 out_region=2)
    flat = ops.flatten_weights(tw)
    y, s = ops.fused_pyramid(
        torch.from_numpy(x), None, tb, spec=spec, out_region=2,
        streamed=True, w_slots=1, x_slots=1, c_tiles=c_tiles,
        weights_flat=flat,
    )
    torch.testing.assert_close(y, base, atol=1e-6, rtol=0)
    assert torch.equal(s, s0)


@pytest.mark.parametrize("name", ["lenet_q2", "resnet18_strided_blk"])
def test_bf16_pyramid_tracks_f32(name):
    """bf16 operands with f32 accumulation: within bf16 rounding of the
    reference's f32 result, skip flags unchanged on dense input."""
    jspec, region, _ = CASES[name]
    x, ws, bs, tw, tb = _case(jspec)
    ref = _oracle(name, jspec, region, x, ws, bs)
    y, skip = ops.fused_pyramid(torch.from_numpy(x), tw, tb, spec=_port(jspec),
                                out_region=region, compute_dtype="bfloat16")
    assert y.dtype == torch.bfloat16
    err = np.abs(y.float().numpy() - ref).max()
    assert err <= 0.02 * max(1.0, np.abs(ref).max())


def test_plan_chunks_and_chain_match_reference():
    jspec = Q3_CHAIN
    jchunks = jops.plan_chunks(jspec, max_convs_per_chunk=2)
    tchunks = ops.plan_chunks(_port(jspec), max_convs_per_chunk=2)
    assert [dataclasses.asdict(c) for c in jchunks] == [
        dataclasses.asdict(c) for c in tchunks
    ]
    x, ws, bs, tw, tb = _case(jspec)
    y, skips = ops.fused_pyramid_chain(torch.from_numpy(x), tw, tb,
                                       spec=_port(jspec),
                                       max_convs_per_chunk=2)
    assert [s.shape[-1] for s in skips] == [2, 1]
    np.testing.assert_allclose(
        y.numpy(), _oracle("odd_q3", jspec, 4, x, ws, bs), atol=1e-5
    )
    with pytest.raises(BudgetError, match="even alone"):
        ops.plan_chunks(_port(LENET5_FUSION), vmem_budget=1024)


def test_fused_conv2_and_ref_wrappers():
    jspec = LENET5_FUSION
    x, ws, bs, tw, tb = _case(jspec)
    spec = _port(jspec)
    y, skip = ops.fused_conv2(torch.from_numpy(x), tw[0], tb[0], tw[1], tb[1],
                              spec=spec, out_region=1)
    assert skip.shape == (2, 5, 5)
    ref = fused_pyramid_ref(torch.from_numpy(x), spec, tw, tb)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=0)


def test_cpu_tensor_runs_plain_version_without_a_launch():
    jspec = LENET5_FUSION
    x, ws, bs, tw, tb = _case(jspec)
    prog = compile_program(_port(jspec), 1)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, 0, 0, 0))
    before = [k.launches for k in fc.KERNELS]
    y1, s1 = fc.fused_pyramid_kernel(xp, tw, tb, program=prog)
    y2, s2 = fc.fused_pyramid_plain(xp, tw, tb, program=prog)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert [k.launches for k in fc.KERNELS] == before


def test_wrapper_contract_errors():
    spec = _port(LENET5_FUSION)
    prog = compile_program(spec, 1)
    x = torch.zeros((1, 32, 32, 1))
    _, _, _, tw, tb = _case(LENET5_FUSION)
    with pytest.raises(ValueError, match="weights_flat was passed"):
        fc.fused_pyramid_kernel(x, tw, tb, program=prog,
                                weights_flat=ops.flatten_weights(tw))
    with pytest.raises(ValueError, match="must divide"):
        fc.fused_pyramid_kernel(x, tw, tb, program=prog, c_tiles=3)
    with pytest.raises(TypeError, match="dtype"):
        fc.fused_pyramid_kernel(x.double(), tw, tb, program=prog)
    with pytest.raises(ValueError, match="x_padded must be"):
        fc.fused_pyramid_kernel(x[:, :30], tw, tb, program=prog)
    with pytest.raises(NotImplementedError, match="modeled but not"):
        fc.fused_pyramid_kernel(
            x, tw, tb, program=compile_program(spec, 1, compute_dtype="int8")
        )
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        fc.fused_pyramid_kernel(x.to("meta"), [w.to("meta") for w in tw],
                                [b.to("meta") for b in tb], program=prog)


def test_descriptor_layout():
    """The int64 launch descriptor the CUDA entry points parse: header, then
    18 fields per conv level with running weight/bias offsets and the
    level's K-split."""
    spec = _port(Q3_CHAIN)
    prog = compile_program(spec, 4)
    desc, cap, partial = fc._descriptor(prog, True, True, 2, batch=3,
                                        grid=512)
    assert len(desc) == fc._HEADER + fc._PER_LEVEL * prog.q_convs
    assert desc[:10] == [3, prog.alpha, prog.tile0, prog.stride0,
                         prog.padded_input, 2, 3, 1, 1, 2]
    assert desc[10] == cap == max(
        max(p.out_size, p.pool_out) ** 2 * p.n_out for p in prog.levels
    )
    assert desc[11] == 512
    lvl1 = desc[fc._HEADER + fc._PER_LEVEL:][: fc._PER_LEVEL]
    assert lvl1[-3:-1] == [prog.level_weight_counts()[0], 6]
    splits = [desc[fc._HEADER + fc._PER_LEVEL * l + fc._PER_LEVEL - 1]
              for l in range(prog.q_convs)]
    assert all(s >= 1 for s in splits)
    assert partial == max(
        [s * 3 * prog.alpha ** 2 * p.out_size ** 2 * p.n_out
         for s, p in zip(splits, prog.levels) if s > 1], default=0
    )


@pytest.mark.parametrize(
    "tiles,kdim,grid,want",
    [(2000, 4608, 1056, 1),   # the tiles fill the grid: no split
     (16, 4608, 1056, 66),    # ResNet-18 b7 at batch 1: fill the grid
     (200, 147, 1056, 5),     # the stem: at least two K-steps per split
     (10, 16, 1056, 1)],      # a single K-step cannot split
)
def test_k_split_fills_the_grid(tiles, kdim, grid, want):
    assert fc._splits(tiles, kdim, grid) == want
