"""The port's executor oracle, dtypes, device resolution and interop against
the reference: ``reference_forward`` / ``fused_forward`` on the same numpy
inputs and the reference's own initialised params."""

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
from repro.core.fusion import lockstep_plan as jlockstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dtypes, resolve_device  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core.fusion import (  # noqa: E402
    FusedLevel,
    FusionSpec,
    lockstep_plan,
)

Q3_LEVELS = (
    FusedLevel("conv", K=3, S=1, pad=1, n_in=2, n_out=6),
    FusedLevel("pool", K=2, S=2, pad=0, n_in=6, n_out=6),
    FusedLevel("conv", K=3, S=1, pad=1, n_in=6, n_out=8),
    FusedLevel("conv", K=3, S=1, pad=0, n_in=8, n_out=4),
)


def _port_spec(jspec):
    """The reference's FusionSpec rebuilt from the port's classes."""
    return FusionSpec(
        levels=tuple(FusedLevel(**dataclasses.asdict(l)) for l in jspec.levels),
        input_size=jspec.input_size,
    )


# (reference spec, output region)
SPECS = {
    "lenet_q2": (LENET5_FUSION, 1),
    "vgg_q4_32": (dataclasses.replace(VGG_FUSION, input_size=32), 4),
    "resnet18_strided_blk": (resnet18_fusions(32)[2], 4),
}


def _case(name, batch=2, seed=1):
    jspec, region = SPECS[name]
    jp = jex.init_pyramid_params(jspec, jax.random.PRNGKey(0))
    x = np.random.default_rng(seed).standard_normal(
        (batch, jspec.input_size, jspec.input_size, jspec.levels[0].n_in)
    ).astype(np.float32)
    tp = interop.pyramid_params_from_numpy(
        dataclasses.replace(jp, weights=[np.asarray(w) for w in jp.weights],
                            biases=[np.asarray(b) for b in jp.biases]),
        device="cpu",
    )
    return jspec, _port_spec(jspec), region, jp, tp, x


@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_forward_matches(name):
    jspec, tspec, _, jp, tp, x = _case(name)
    want = np.asarray(jex.reference_forward(jnp.asarray(x), jspec, jp))
    got = tex.reference_forward(torch.from_numpy(x), tspec, tp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fused_forward_matches(name):
    jspec, tspec, region, jp, tp, x = _case(name)
    want = np.asarray(jex.fused_forward(jnp.asarray(x), jspec, jp,
                                        jlockstep(jspec, region)))
    got = tex.fused_forward(torch.from_numpy(x), tspec, tp,
                            lockstep_plan(tspec, region)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_forward_odd_q3_chain():
    spec = FusionSpec(levels=Q3_LEVELS, input_size=20)
    p = tex.init_pyramid_params(spec, seed=2, device="cpu")
    x = torch.randn((1, 20, 20, 2), generator=torch.Generator().manual_seed(3))
    ref = tex.reference_forward(x, spec, p)
    for region in (1, 2, 4):
        got = tex.fused_forward(x, spec, p, out_region=region)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_init_pyramid_params_seeded():
    spec = _port_spec(LENET5_FUSION)
    a = tex.init_pyramid_params(spec, seed=7, device="cpu")
    b = tex.init_pyramid_params(spec, seed=7, device="cpu")
    c = tex.init_pyramid_params(spec, seed=8, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a.weights, b.weights))
    assert not torch.equal(a.weights[0], c.weights[0])
    assert [tuple(w.shape) for w in a.weights] == [(5, 5, 1, 6), (5, 5, 6, 16)]


def test_dtypes_table():
    assert dtypes.torch_dtype("bfloat16") is torch.bfloat16
    assert dtypes.canonical_dtype(torch.float32) == "float32"
    assert dtypes.canonical_dtype(np.dtype("float32")) == "float32"
    assert dtypes.EXEC_DTYPES == ("float32", "bfloat16")
    with pytest.raises(KeyError, match="unknown compute dtype"):
        dtypes.canonical_dtype("float16")


def test_resolve_device_never_falls_back(monkeypatch):
    """No argument means the CUDA card, and no card is an error — never a
    quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.init_pyramid_params(_port_spec(LENET5_FUSION))
    assert resolve_device("cpu") == torch.device("cpu")


def test_params_from_numpy_keeps_layout():
    params = {
        "c": (np.ones((3, 3, 2, 4), np.float32), np.zeros(4, np.float32)),
        "_flat/p": np.arange(6, dtype=np.float32),
    }
    out = interop.params_from_numpy(params, device="cpu")
    assert out["c"][0].shape == (3, 3, 2, 4) and out["c"][1].shape == (4,)
    assert torch.equal(out["_flat/p"], torch.arange(6, dtype=torch.float32))
