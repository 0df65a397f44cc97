"""End-to-end parity beyond the f32 plans: bf16 runs within
``bf16_logit_tol`` of the reference's f32 logits, the port's own
``reference_network``, prepared ``_flat/`` params, the END cascade on
sparse input with a traced run, and ``run_model`` — all on the CPU against
the reference's ``reference_network`` and its initialised params."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro_torch.core.program import REFERENCE_BUDGET  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net import graph as tgraph  # noqa: E402
from repro_torch.net import partition as tpart  # noqa: E402
from repro_torch.net import runner as trunner  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

SIZES = {"lenet": 32, "alexnet": 67, "vgg16": 32, "resnet18": 32}
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


@pytest.mark.parametrize("name", sorted(SIZES))
def test_run_network_bf16_within_tolerance(name):
    tg, tp, x, ref = _model(name)
    plan = tpart.auto_partition(tg, batch=BATCH, compute_dtype="bfloat16",
                                budget=REFERENCE_BUDGET)
    logits, _ = trunner.run_network(
        torch.from_numpy(x), trunner.prepare_network_params(plan, tp),
        plan=plan,
    )
    assert logits.dtype == torch.bfloat16
    err = float(np.abs(logits.float().numpy() - ref).max())
    assert err <= trunner.bf16_logit_tol(ref)


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_reference_network_matches(name):
    tg, tp, x, ref = _model(name)
    got = trunner.reference_network(torch.from_numpy(x), tg, tp)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_prepare_params_matches_reference_flat_keys():
    """The streamed pyramid of ResNet-18 at f32/b1 gets a ``_flat/`` array
    equal to the reference's concatenation."""
    jg = jgraph.resnet18(input_size=32, num_classes=10)
    jp = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
    tg = tgraph.resnet18(input_size=32, num_classes=10)
    tp = params_from_numpy(
        {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jp.items()},
        device="cpu",
    )
    from repro.net.partition import auto_partition as jauto

    budget = tpart.min_budget(tg, budget=REFERENCE_BUDGET)
    jplan = jauto(jg, vmem_budget=budget.nbytes)
    tplan = tpart.auto_partition(tg, budget=budget)
    jprep = jrunner.prepare_network_params(jplan, jp)
    tprep = trunner.prepare_network_params(tplan, tp)
    jflat = sorted(k for k in jprep if k.startswith("_flat/"))
    assert jflat and jflat == sorted(k for k in tprep if k.startswith("_flat/"))
    for k in jflat:
        np.testing.assert_array_equal(tprep[k].numpy(), np.asarray(jprep[k]))


def test_sparse_input_skips_and_traced_spans():
    """The example's sparse recipe at the smallest regions: the END cascade
    fires, logits still match the reference, and a traced run records one
    span per launch plus the skip-count events."""
    tg, tp, x, _ = _model("lenet")
    jg = jgraph.lenet5(input_size=32, num_classes=10)
    xs = np.zeros_like(x)
    xs[:, :8, :8, :] = 3 * np.random.default_rng(2).standard_normal(
        (BATCH, 8, 8, 1)
    )
    shifted = {k: (w, b - 0.3) if tg.node(k).op == "conv" else (w, b)
               for k, (w, b) in tp.items()}
    jshift = {k: (jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
              for k, (w, b) in shifted.items()}
    ref = np.asarray(jrunner.reference_network(jnp.asarray(xs), jg, jshift))
    plan = tpart.auto_partition(tg, batch=BATCH, prefer_region="smallest",
                                budget=REFERENCE_BUDGET)
    with tracing(launches=True) as col:
        logits, skips = trunner.run_network(torch.from_numpy(xs), shifted,
                                            plan=plan)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4)
    fracs = trunner.skip_fractions(skips)
    assert any(0 < f < 1 for fr in fracs.values() for f in fr[1:])
    assert [s.name for s in col.spans] == [p.name for p in plan.pyramids]
    assert all(s.duration_ms >= 0 and s.model == "lenet" for s in col.spans)
    names = [e.name for e in col.events]
    assert names.count("end_skip_counts") == plan.n_launches()
    assert names[-1] == "run_network"


def test_run_model_and_seeded_init():
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 1)).astype(
        np.float32
    )
    logits, skips, plan, params = trunner.run_model(
        "lenet", x, seed=3, num_classes=10, device="cpu"
    )
    assert logits.shape == (1, 10) and plan.graph.name == "lenet"
    again = trunner.init_network_params(plan.graph, seed=3, device="cpu")
    assert all(torch.equal(params[k][0], again[k][0]) for k in params)
    ref = trunner.reference_network(torch.from_numpy(x), plan.graph, params)
    torch.testing.assert_close(logits, ref, atol=1e-4, rtol=0)
