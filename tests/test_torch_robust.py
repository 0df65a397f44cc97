"""The port's guarded runtime against the reference's ``repro.robust``:
typed errors, preflight and admission checks (the same error type and the
same ``context`` on the same bad inputs), the guard dispatch, the replan
entry point, the sentinels, and the seeded corruption positions.  Every
case of the reference's ``tests/test_robust.py`` is here, on the port's
plain path (the CPU)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import graph as jgraph  # noqa: E402
from repro.net import partition as jpart  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro.robust import faults as jfaults  # noqa: E402
from repro.robust import guard as jguard  # noqa: E402
from repro.robust import validate as jvalidate  # noqa: E402
from repro_torch.core.fusion import FusedLevel, FusionSpec  # noqa: E402
from repro_torch.core.program import compile_program, plan_launch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net import graph as tgraph  # noqa: E402
from repro_torch.net import partition as tpart  # noqa: E402
from repro_torch.net import runner as trunner  # noqa: E402
from repro_torch.net.graph import MODELS, Node, Segment, fusable_segments  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    BudgetError,
    GuardConfig,
    NumericError,
    PlanError,
    PreflightError,
    RobustError,
    check_request,
    guarding,
    preflight,
)
from repro_torch.robust import faults as tfaults  # noqa: E402
from repro_torch.robust.guard import (  # noqa: E402
    get_guard,
    sentinel_stats,
    sentinel_trips,
)

BATCH = 2


def _sides():
    """LeNet-5 at batch 2 on both packages from the reference's seeded
    params: one namespace per side with the helpers the bad-input cases
    need."""
    jg = jgraph.MODELS["lenet"]()
    jmaster = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, 32, 32, 1)).astype(np.float32)
    tg = tgraph.MODELS["lenet"]()
    tmaster = params_from_numpy(
        {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jmaster.items()},
        device="cpu",
    )
    sides = {}
    for name, graph, master, xs, mod in (
        ("port", tg, tmaster, torch.from_numpy(x), types.SimpleNamespace(
            auto=tpart.auto_partition, prep=trunner.prepare_network_params,
            preflight=preflight, corrupt=tfaults.corrupt_params,
            cat=lambda a: torch.cat(a, -1), zeros=lambda n: torch.zeros(n),
            ints=lambda w: w.to(torch.int32))),
        ("ref", jg, jmaster, jnp.asarray(x), types.SimpleNamespace(
            auto=jpart.auto_partition, prep=jrunner.prepare_network_params,
            preflight=jvalidate.preflight, corrupt=jfaults.corrupt_params,
            cat=lambda a: jnp.concatenate(a, -1),
            zeros=lambda n: jnp.zeros((n,), jnp.float32),
            ints=lambda w: w.astype(jnp.int32))),
    ):
        plan = mod.auto(graph, batch=BATCH)
        sides[name] = types.SimpleNamespace(
            graph=graph, master=master, x=xs, plan=plan,
            prepped=mod.prep(plan, master), **vars(mod),
        )
    return sides


@pytest.fixture(scope="module")
def sides():
    return _sides()


@pytest.fixture(scope="module")
def lenet_setup(sides):
    s = sides["port"]
    return s.graph, s.master, s.plan, s.prepped, s.x


def _replace(params, key, value):
    out = dict(params)
    out[key] = value
    return out


def _tight(s):
    tight = s.auto(s.graph, batch=BATCH, vmem_budget=10_000)
    return tight, s.prep(tight, s.master)


def _flat_short(s):
    tight, prepped = _tight(s)
    key = "_flat/" + next(p for p in tight.pyramids if p.launch.streamed).name
    return s.x, _replace(prepped, key, prepped[key][:-3]), tight, {}


def _flat_resident(s):
    name = next(p for p in s.plan.pyramids if not p.launch.streamed).name
    return s.x, _replace(s.prepped, "_flat/" + name, s.zeros(8)), s.plan, {}


# name -> side -> (x, params, plan, preflight kwargs)
PREFLIGHT_CASES = {
    "rank": lambda s: (s.x[0], s.prepped, s.plan, {}),
    "spatial": lambda s: (s.x[:, :16], s.prepped, s.plan, {}),
    "channels": lambda s: (s.cat([s.x, s.x]), s.prepped, s.plan, {}),
    "unknown_dtype": lambda s: (s.x, s.prepped, s.plan,
                                {"dtype": "float8_e4m3"}),
    "int8_modeled_only": lambda s: (s.x, s.prepped, s.plan,
                                    {"dtype": "int8"}),
    "missing_params": lambda s: (
        s.x, {k: v for k, v in s.prepped.items() if k != "CL2"}, s.plan, {}),
    "weight_shape": lambda s: (s.x, _replace(
        s.prepped, "CL1", (s.prepped["CL1"][0][..., :-1],
                           s.prepped["CL1"][1])), s.plan, {}),
    "bias_shape": lambda s: (s.x, _replace(
        s.prepped, "CL1", (s.prepped["CL1"][0],
                           s.prepped["CL1"][1][:-1])), s.plan, {}),
    "integer_params": lambda s: (s.x, _replace(
        s.prepped, "CL1", (s.ints(s.prepped["CL1"][0]),
                           s.prepped["CL1"][1])), s.plan, {}),
    "nonfinite_params": lambda s: (
        s.x, s.corrupt(s.prepped, "CL2", kind="inf"), s.plan, {}),
    "flat_dtype": lambda s: (s.x, _tight(s)[1], _tight(s)[0],
                             {"dtype": "bfloat16"}),
    "flat_size": _flat_short,
    "stale_flat": lambda s: (s.x, _replace(
        s.prepped, "_flat/NOPE..NADA", s.zeros(8)), s.plan, {}),
    "flat_for_resident": _flat_resident,
    "budget": lambda s: (s.x, s.prepped, s.plan, {"vmem_budget": 1024}),
}


@pytest.mark.parametrize("case", sorted(PREFLIGHT_CASES))
def test_preflight_rejects_like_the_reference(sides, case):
    errs = {}
    for name, s in sides.items():
        x, params, plan, kwargs = PREFLIGHT_CASES[case](s)
        with pytest.raises(Exception) as ei:
            s.preflight(x, params, plan=plan, **kwargs)
        errs[name] = ei.value
    port, ref = errs["port"], errs["ref"]
    assert isinstance(port, RobustError)
    assert type(port).__name__ == type(ref).__name__, (port, ref)
    assert port.context == ref.context


def _requests():
    """Bad (and good) serving requests, as numpy arrays."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    nan = x.copy()
    nan[0, 3, 4, 0] = np.nan
    big = x.astype(np.float64)
    big[0, 0, 0, 0] = 1e300
    return {
        "ok": x,
        "ok_int": (x * 10).astype(np.int32),
        "ok_bool": x > 0,
        "rank": x[0],
        "batch": x[:0],
        "spatial": x[:, :16],
        "channels": np.concatenate([x, x], -1),
        "dtype": x.astype(object),
        "values": nan,
        "values_f64": nan.astype(np.float64),
        "range": big,
    }


@pytest.mark.parametrize("case", sorted(_requests()))
def test_check_request_matches_the_reference(sides, case):
    x = _requests()[case]
    tg, jg = sides["port"].graph, sides["ref"].graph

    def outcome(fn, arr, graph):
        try:
            fn(arr, graph)
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__, e.context
        return None

    want = outcome(jvalidate.check_request, x, jg)
    assert outcome(check_request, x, tg) == want
    if x.dtype != object:  # a CPU tensor is a host array too
        assert outcome(check_request, torch.from_numpy(x), tg) == want
    assert (want is None) == case.startswith("ok")


class TestErrorHierarchy:
    def test_valueerror_compat(self):
        """Typed errors must keep historical except-clauses working."""
        assert issubclass(PreflightError, ValueError)
        assert issubclass(BudgetError, ValueError)
        assert issubclass(PlanError, PreflightError)
        assert issubclass(NumericError, FloatingPointError)
        assert issubclass(PreflightError, RobustError)

    def test_context_rides_in_message_and_attr(self):
        e = PreflightError("bad node", node="CL1", graph="lenet")
        assert e.context == {"node": "CL1", "graph": "lenet"}
        assert "CL1" in str(e) and "lenet" in str(e)


class TestPreflight:
    def test_clean_setup_passes(self, sides):
        for s in sides.values():
            assert s.preflight(s.x, s.prepped, plan=s.plan) == "float32"

    def test_nonfinite_params_localized(self, lenet_setup):
        g, params, plan, prepped, x = lenet_setup
        bad = tfaults.corrupt_params(prepped, "CL2", kind="inf")
        with pytest.raises(NumericError) as ei:
            preflight(x, bad, plan=plan)
        assert ei.value.context["nodes"] == ["CL2"]

    def test_flat_dtype_mismatch(self, lenet_setup):
        g, params, plan, prepped, x = lenet_setup
        tight = tpart.auto_partition(g, batch=BATCH, vmem_budget=10_000)
        assert any(p.launch.streamed for p in tight.pyramids)
        t_prepped = trunner.prepare_network_params(tight, params)
        with pytest.raises(PreflightError, match="different dtype"):
            preflight(x, t_prepped, plan=tight, dtype="bfloat16")

    def test_budget_headroom(self, lenet_setup):
        g, params, plan, prepped, x = lenet_setup
        with pytest.raises(BudgetError) as ei:
            preflight(x, prepped, plan=plan, vmem_budget=1024)
        assert ei.value.context["vmem_budget"] == 1024

    def test_run_network_guarded_preflights(self, lenet_setup):
        """The guarded runner rejects a dtype-mismatched request with the
        typed error, end to end through run_network."""
        g, params, plan, prepped, x = lenet_setup
        with guarding(GuardConfig()):
            with pytest.raises(PreflightError, match="not executable"):
                trunner.run_network(x, prepped, plan=plan, dtype="int8")


class TestTypedErrorsReplaceAsserts:
    def test_head_op_unhandled(self):
        n = Node("pool", "P1", ("x",), K=2, S=2)
        with pytest.raises(PreflightError, match="P1"):
            trunner._head_op({}, n, {})

    def test_compile_program_pool_first(self):
        spec = FusionSpec(
            levels=(FusedLevel("pool", K=2, S=2, pad=0, n_in=4, n_out=4),),
            input_size=8,
        )
        with pytest.raises(PlanError, match="start with a conv"):
            compile_program(spec, 4)

    def test_compile_program_region_must_tile(self):
        seg = fusable_segments(MODELS["lenet"]())[0]
        with pytest.raises(PlanError, match="must tile"):
            compile_program(seg.spec(), 3)

    def test_plan_launch_prefer_region_typo(self):
        seg = fusable_segments(MODELS["lenet"]())[0]
        with pytest.raises(PreflightError, match="prefer_region"):
            plan_launch(seg.spec(), prefer_region="biggest")

    def test_partition_infeasible_budget(self):
        seg = fusable_segments(MODELS["lenet"]())[0]
        with pytest.raises(BudgetError, match="fits no launch regime"):
            tpart.partition_segment(seg, vmem_budget=256)
        with pytest.raises(ValueError):
            tpart.partition_segment(seg, vmem_budget=256)


class TestReplanPyramid:
    def test_tighter_budget_chains_launches(self, sides):
        """The sub-pyramids tile the original chain, each under the budget,
        and equal the reference's replan."""
        subs = {}
        for name, s in sides.items():
            pyr = s.plan.pyramids[0]
            budget = pyr.launch.vmem_bytes() * 2 // 3
            replan = tpart.replan_pyramid if name == "port" \
                else jpart.replan_pyramid
            subs[name] = replan(s.graph, pyr, vmem_budget=budget,
                                batch=BATCH)
            assert tuple(n for sp in subs[name] for n in sp.node_names) \
                == pyr.node_names
            assert all(sp.launch.vmem_bytes() <= budget for sp in subs[name])
            assert len(subs[name]) >= 2
        assert [(sp.name, sp.launch.describe()) for sp in subs["port"]] == \
            [(sp.name, sp.launch.describe()) for sp in subs["ref"]]

    def test_exhausted_budget_raises(self, lenet_setup):
        g, params, plan, prepped, x = lenet_setup
        with pytest.raises(BudgetError):
            tpart.replan_pyramid(g, plan.pyramids[0], vmem_budget=128,
                                 batch=BATCH)


class TestGuardDispatch:
    def test_guard_off_takes_the_unguarded_path(self, lenet_setup,
                                                monkeypatch):
        """With no guard installed, run_network must not touch the guarded
        path at all — same contract as tracing-off."""
        g, params, plan, prepped, x = lenet_setup
        import repro_torch.robust.degrade as degrade

        def boom(*a, **k):
            raise AssertionError("guarded path must not run")

        monkeypatch.setattr(degrade, "run_network_guarded", boom)
        assert not get_guard().enabled
        logits, skips = trunner.run_network(x, prepped, plan=plan)
        assert logits.shape == (BATCH, 10)

    def test_guard_on_reports(self, lenet_setup):
        g, params, plan, prepped, x = lenet_setup
        base, _ = trunner.run_network(x, prepped, plan=plan)
        with guarding(GuardConfig()) as guard:
            y, skips = trunner.run_network(x, prepped, plan=plan)
        rep = guard.last_report
        assert rep is not None and not rep.degraded
        assert rep.clean_launches == rep.launches == plan.n_launches()
        assert torch.equal(y, base)
        assert set(skips) == {p.name for p in plan.pyramids}

    def test_guarding_nests_and_restores(self):
        assert not get_guard().enabled
        with guarding(GuardConfig(max_replans=1)) as outer:
            assert get_guard() is outer
            with guarding(GuardConfig(max_replans=5)) as inner:
                assert get_guard() is inner
            assert get_guard() is outer
        assert not get_guard().enabled


def _sentinel_inputs():
    ones = np.ones((4, 4), np.float32)
    nan = np.ones((4,), np.float32)
    nan[2] = np.nan
    inf = np.ones((4,), np.float32)
    inf[1] = np.inf
    neg = np.array([-3.0, 2.0, -7.5, 1.0], np.float32)
    return {"ones": ones, "nan": nan, "inf": inf, "neg": neg,
            "big": np.full((4,), 1e6, np.float32)}


@pytest.mark.parametrize("limit", [None, 1e3])
@pytest.mark.parametrize("case", sorted(_sentinel_inputs()))
def test_sentinels_equal_the_reference(case, limit):
    a = _sentinel_inputs()[case]
    stats = sentinel_stats(torch.from_numpy(a))
    jstats = jguard.sentinel_stats(jnp.asarray(a))
    assert sentinel_trips(stats, limit) == jguard.sentinel_trips(jstats, limit)
    assert bool(stats["finite"]) == bool(jstats["finite"])
    if bool(jstats["finite"]):
        assert float(stats["max_abs"]) == float(jstats["max_abs"])


class TestSentinels:
    def test_clean_tensor(self):
        stats = sentinel_stats(torch.ones((4, 4)))
        assert sentinel_trips(stats, None) is None
        assert float(stats["max_abs"]) == 1.0

    def test_nan_and_inf_trip(self):
        bad = torch.ones(4)
        bad[2] = float("nan")
        assert sentinel_trips(sentinel_stats(bad), None) == "non-finite"
        worse = torch.ones(4)
        worse[1] = float("inf")
        assert sentinel_trips(sentinel_stats(worse), None) == "non-finite"

    def test_magnitude_limit(self):
        big = torch.full((4,), 1e6)
        assert sentinel_trips(sentinel_stats(big), None) is None
        assert sentinel_trips(sentinel_stats(big), 1e3) == "magnitude"

    def test_bf16_cast_safe(self):
        stats = sentinel_stats(torch.ones(4, dtype=torch.bfloat16))
        assert sentinel_trips(stats, None) is None


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("fraction", [0.05, 0.3])
def test_corrupt_params_positions_equal_the_reference(sides, kind, seed,
                                                      fraction):
    bad = tfaults.corrupt_params(sides["port"].prepped, "CL2", kind=kind,
                                 seed=seed, fraction=fraction)
    jbad = jfaults.corrupt_params(sides["ref"].prepped, "CL2", kind=kind,
                                  seed=seed, fraction=fraction)
    got = bad["CL2"][0].numpy()
    want = np.asarray(jbad["CL2"][0], dtype=np.float32)
    test = np.isnan if kind == "nan" else np.isinf
    np.testing.assert_array_equal(test(got), test(want))
    assert test(got).any()
    # the rest of the tensor, and every other entry, untouched
    np.testing.assert_array_equal(got[~test(got)], want[~test(want)])
    assert bad["CL1"] is sides["port"].prepped["CL1"]
    assert not torch.isnan(sides["port"].prepped["CL2"][0]).any()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_output_positions_equal_the_reference(kind, seed, dtype):
    y = np.random.default_rng(seed).standard_normal((2, 10, 10, 6)).astype(
        np.float32)
    inj = tfaults.FaultInjector(seed=seed)
    inj.poison_output(launch="CL1", kind=kind)
    jinj = jfaults.FaultInjector(seed=seed)
    jinj.poison_output(launch="CL1", kind=kind)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = inj.corrupt_output("CL1..MPL2", torch.from_numpy(y).to(tdt))
    want = jinj.corrupt_output("CL1..MPL2", jnp.asarray(y, dtype=dtype))
    assert got.dtype == tdt and got.shape == y.shape
    test = np.isnan if kind == "nan" else np.isinf
    np.testing.assert_array_equal(test(got.float().numpy()),
                                  test(np.asarray(want, dtype=np.float32)))
    assert inj.fired == jinj.fired
    # fired once: a second output passes unchanged
    again = torch.from_numpy(y)
    assert inj.corrupt_output("CL1..MPL2", again) is again


class TestSegmentReluThreading:
    def test_replan_preserves_relu_mode(self):
        """resnet18 shortcut pyramids are relu-free; a replan must not
        reintroduce the activation."""
        g = MODELS["resnet18"](input_size=32, num_classes=10)
        plan = tpart.auto_partition(g, batch=1)
        no_relu = [p for p in plan.pyramids if not p.relu]
        assert no_relu, "expected relu-free shortcut pyramids"
        subs = tpart.replan_pyramid(
            g, no_relu[0], vmem_budget=plan.vmem_budget, batch=1
        )
        assert all(not sp.relu for sp in subs)

    def test_segment_requires_relu_field(self):
        seg = fusable_segments(MODELS["lenet"]())[0]
        assert isinstance(seg, Segment) and seg.relu is True
