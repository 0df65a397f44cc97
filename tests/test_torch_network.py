"""End-to-end parity: the port's ``run_network`` (on the CPU, each pyramid
through the kernel's plain PyTorch version) against the reference's
``reference_network``, for the four zoo models under auto, layerwise and
paper plans, with the reference's own initialised params carried across as
numpy arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net import graph as tgraph  # noqa: E402
from repro_torch.net import partition as tpart  # noqa: E402
from repro_torch.net import runner as trunner  # noqa: E402

SIZES = {"lenet": 32, "alexnet": 67, "vgg16": 32, "resnet18": 32}
PLANS = {
    "auto": tpart.auto_partition,
    "layerwise": tpart.layerwise_partition,
    "paper": tpart.paper_partition,
}
BATCH = 2

_CACHE = {}


def _model(name):
    """(port graph, port params, numpy input, reference f32 logits)."""
    if name not in _CACHE:
        size = SIZES[name]
        jg = jgraph.MODELS[name](input_size=size, num_classes=10)
        jp = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
        x = np.random.default_rng(1).standard_normal(
            (BATCH, size, size, jg.in_channels)
        ).astype(np.float32)
        ref = np.asarray(jrunner.reference_network(jnp.asarray(x), jg, jp))
        tp = params_from_numpy(
            {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jp.items()},
            device="cpu",
        )
        tg = tgraph.MODELS[name](input_size=size, num_classes=10)
        _CACHE[name] = (tg, tp, x, ref)
    return _CACHE[name]


@pytest.mark.parametrize("plan_kind", sorted(PLANS))
@pytest.mark.parametrize("name", sorted(SIZES))
def test_run_network_f32_matches_reference(name, plan_kind):
    tg, tp, x, ref = _model(name)
    plan = PLANS[plan_kind](tg, batch=BATCH)
    logits, skips = trunner.run_network(
        torch.from_numpy(x), trunner.prepare_network_params(plan, tp),
        plan=plan,
    )
    assert logits.shape == ref.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4)
    assert list(skips) == [p.name for p in plan.pyramids]
