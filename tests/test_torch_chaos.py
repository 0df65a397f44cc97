"""Chaos suite for the port: seeded fault injection proving the degradation
ladder, every case of the reference's ``tests/test_chaos.py`` on the port's
plain path (the CPU), plus the circuit-breaker cases of
``tests/test_serve_chaos.py`` held against the reference's breaker.

Each fault must end in a successful forward whose logits are within
``atol 1e-4`` of the reference's pure-jnp ``reference_network`` on the same
params, with the rung the reference's own test asserts (its ``interpret``
rung is the port's ``eager``) in the :class:`RunReport` and, under a
tracer, as ``"degrade"`` trace events.  The reference's guarded runner is
not run: its fused kernel does not launch on this jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import graph as jgraph  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro.robust import breaker as jbreaker  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.net.partition import auto_partition  # noqa: E402
from repro_torch.net.runner import (  # noqa: E402
    prepare_network_params,
    run_network,
)
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    GuardConfig,
    NumericError,
    corrupt_params,
    guarding,
    inject,
)
from repro_torch.robust import breaker as tbreaker  # noqa: E402

# LeNet's single fused pyramid: 50 kB resident.  These factors of the
# 16 MiB budget bracket the replan rung: GENTLE leaves ~33 kB (the fused
# launch fails, the layerwise split fits), HARSH leaves ~1.7 kB (nothing
# fits, the ladder must bottom out at the reference path).
SQUEEZE_GENTLE = 0.002
SQUEEZE_HARSH = 0.0001


def _setup(model):
    """(graph, x, master params, plan, prepared params, reference logits):
    the reference's seeded params carried across, the reference's pure-jnp
    ``reference_network`` logits on them."""
    if model == "lenet":
        kwargs, shape = {}, (2, 32, 32, 1)
    else:
        kwargs, shape = {"input_size": 32, "num_classes": 10}, (1, 32, 32, 3)
    jg = jgraph.MODELS[model](**kwargs)
    jp = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jrunner.reference_network(jnp.asarray(x), jg, jp))
    g = MODELS[model](**kwargs)
    params = params_from_numpy(
        {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jp.items()},
        device="cpu",
    )
    plan = auto_partition(g, batch=shape[0])
    prepped = prepare_network_params(plan, params)
    return g, torch.from_numpy(x), params, plan, prepped, ref


@pytest.fixture(scope="module")
def lenet():
    return _setup("lenet")


@pytest.fixture(scope="module")
def resnet():
    return _setup("resnet18")


def _assert_correct(y, ref, tag=""):
    err = float(np.abs(y.float().numpy() - ref).max())
    assert err < 1e-4, f"{tag}: logits diverge from reference by {err}"


class TestWeightCorruption:
    @pytest.mark.parametrize("kind", ["nan", "inf"])
    def test_corrupt_weights_healed_from_source(self, lenet, kind):
        g, x, params, plan, prepped, ref = lenet
        bad = corrupt_params(prepped, "CL1", kind=kind, seed=3)
        with guarding(GuardConfig(), source_params=params) as guard:
            y, _ = run_network(x, bad, plan=plan)
        _assert_correct(y, ref, f"heal-{kind}")
        rep = guard.last_report
        assert rep.fallback_counts() == {"heal": 1}
        assert rep.events[0].detail["nodes"] == ["CL1"]

    def test_corrupt_weights_without_source_raise(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        bad = corrupt_params(prepped, "CL2", kind="nan", seed=3)
        with guarding(GuardConfig()):
            with pytest.raises(NumericError) as ei:
                run_network(x, bad, plan=plan)
        assert ei.value.context["nodes"] == ["CL2"]

    def test_corrupt_source_too_raises(self, lenet):
        """Healing is bounded: when the master copy is corrupt as well, the
        run must fail loudly, not loop."""
        g, x, params, plan, prepped, ref = lenet
        bad_prep = corrupt_params(prepped, "CL1", seed=3)
        bad_src = corrupt_params(params, "CL1", seed=3)
        with guarding(GuardConfig(), source_params=bad_src):
            with pytest.raises(NumericError, match="master copy"):
                run_network(x, bad_prep, plan=plan)

    def test_corruption_is_deterministic(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        a = corrupt_params(prepped, "CL1", kind="nan", seed=7)
        b = corrupt_params(prepped, "CL1", kind="nan", seed=7)
        assert torch.equal(torch.isnan(a["CL1"][0]), torch.isnan(b["CL1"][0]))


class TestOutputPoisoning:
    @pytest.mark.parametrize("kind", ["nan", "inf"])
    def test_poisoned_launch_quarantined(self, lenet, kind):
        """A kernel miscompute (poisoned launch output) trips the numeric
        sentinel; the launch is quarantined to the reference segment and
        the logits stay correct."""
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.poison_output(kind=kind)
                y, skips = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, f"poison-{kind}")
        rep = guard.last_report
        assert rep.fallback_counts() == {"reference": 1}
        assert "sentinel tripped: non-finite" in rep.events[0].reason
        assert rep.events[0].detail["level"] == "kernel-only"
        q = plan.pyramids[0]
        assert int(skips[q.name].sum()) == 0
        assert tuple(skips[q.name].shape) == (2, 1, 1, q.q_convs)

    def test_magnitude_sentinel(self, lenet):
        """A tight magnitude limit: every real activation exceeds it, and
        so does the reference recompute — the fault is localized to a level
        and surfaced, not swallowed."""
        g, x, params, plan, prepped, ref = lenet
        with guarding(
            GuardConfig(magnitude_limit=1e-6), source_params=params
        ) as guard:
            with pytest.raises(NumericError, match="even on the reference"):
                run_network(x, prepped, plan=plan)
        assert guard.last_report is None  # report not stored on raise

    def test_poison_specific_resnet_launch(self, resnet):
        g, x, params, plan, prepped, ref = resnet
        target = plan.pyramids[3].name
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.poison_output(launch=target, kind="nan")
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "resnet-poison")
        rep = guard.last_report
        assert rep.fallback_counts() == {"reference": 1}
        assert rep.events[0].launch == target
        assert rep.clean_launches == plan.n_launches() - 1


class TestBudgetSqueeze:
    def test_squeeze_replans_to_chained_launches(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.squeeze_budget(SQUEEZE_GENTLE)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "squeeze")
        rep = guard.last_report
        assert rep.fallback_counts() == {"replan": 1}
        ev = rep.events[0]
        assert len(ev.detail["sub_launches"]) >= 2  # tighter cuts: a chain
        assert ev.detail["budget"] <= int(plan.vmem_budget * SQUEEZE_GENTLE)
        assert set(ev.detail["sub_skip_fractions"]) == set(
            ev.detail["sub_launches"])

    def test_harsh_squeeze_bottoms_out_at_reference(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(max_replans=2),
                      source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.squeeze_budget(SQUEEZE_HARSH)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "squeeze-harsh")
        rep = guard.last_report
        assert rep.fallback_counts() == {"reference": 1}
        assert "replan exhausted" in rep.events[0].reason

    def test_squeeze_resnet(self, resnet):
        """The multi-pyramid plan degrades only the launches that no longer
        fit; everything else stays on the fast path."""
        g, x, params, plan, prepped, ref = resnet
        vmems = sorted(p.launch.vmem_bytes() for p in plan.pyramids)
        below = [v for v in vmems if v < vmems[-1]]
        target = (vmems[-1] + (below[-1] if below else 0)) // 2
        factor = target / plan.vmem_budget
        effective = int(plan.vmem_budget * factor)
        n_over = sum(1 for v in vmems if v > effective)
        assert 1 <= n_over < len(vmems)
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.squeeze_budget(factor)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "resnet-squeeze")
        rep = guard.last_report
        assert sum(rep.fallback_counts().values()) == n_over
        assert rep.clean_launches == plan.n_launches() - n_over


class TestStageFaults:
    def test_plan_fault_goes_to_reference(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.raise_at("plan")
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "plan-fault")
        assert guard.last_report.fallback_counts() == {"reference": 1}

    @pytest.mark.parametrize("stage", ["compile", "run"])
    def test_transient_fault_retries_eager(self, lenet, stage):
        """A single-shot build/launch failure retries once through the
        plain version (the reference's interpret rung) and succeeds."""
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.raise_at(stage)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, f"{stage}-fault")
        rep = guard.last_report
        assert rep.fallback_counts() == {"eager": 1}
        assert rep.clean_launches == plan.n_launches() - 1
        assert inj.fired == [(stage, plan.pyramids[0].name, "raise")]

    def test_eager_rung_passes_plain(self, lenet, monkeypatch):
        """The eager rung re-issues the launch with plain=True, and only it
        does."""
        import repro_torch.kernels.fused_conv.ops as ops

        g, x, params, plan, prepped, ref = lenet
        seen = []
        real = ops.fused_pyramid

        def spy(*a, **k):
            seen.append(k.get("plain", False))
            return real(*a, **k)

        monkeypatch.setattr(ops, "fused_pyramid", spy)
        import repro_torch.net.runner as runner

        monkeypatch.setattr(runner, "fused_pyramid", spy)
        with guarding(GuardConfig(), source_params=params):
            run_network(x, prepped, plan=plan)
            assert seen == [False] * plan.n_launches()
            seen.clear()
            with inject(seed=0) as inj:
                inj.raise_at("run")
                run_network(x, prepped, plan=plan)
        assert seen == [True]  # the first call raised before the launch

    @pytest.mark.parametrize("error", [RuntimeError, ValueError])
    def test_genuine_launch_error_propagates(self, lenet, monkeypatch, error):
        """A build or launch error that no injector planted takes no rung:
        it leaves the guarded run as it was raised, the plain version is
        never tried and no report is left behind."""
        import repro_torch.net.runner as runner

        g, x, params, plan, prepped, ref = lenet
        seen = []

        def broken(*a, **k):
            seen.append(k.get("plain", False))
            raise error("CUDA kernel fused_pyramid: launch failed")

        monkeypatch.setattr(runner, "fused_pyramid", broken)
        with guarding(GuardConfig(), source_params=params) as guard:
            with pytest.raises(error, match="launch failed"):
                run_network(x, prepped, plan=plan)
        assert seen == [False]
        assert guard.last_report is None

    def test_persistent_fault_falls_to_reference(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.raise_at("run", times=4)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "persistent-fault")
        rep = guard.last_report
        assert rep.fallback_counts() == {"reference": 1}
        assert "eager retry failed too" in rep.events[0].reason

    def test_resnet_stage_fault_on_named_launch(self, resnet):
        g, x, params, plan, prepped, ref = resnet
        target = plan.pyramids[5].name
        with guarding(GuardConfig(), source_params=params) as guard:
            with inject(seed=0) as inj:
                inj.raise_at("run", launch=target, times=4)
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "resnet-stage-fault")
        assert [e.launch for e in guard.last_report.events] == [target]


class TestObservability:
    def test_rungs_visible_as_trace_events(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with tracing() as collector:
            with guarding(GuardConfig(), source_params=params):
                with inject(seed=0) as inj:
                    inj.poison_output(kind="nan")
                    y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "traced-poison")
        degrades = [e for e in collector.events if e.name == "degrade"]
        assert len(degrades) == 1
        assert degrades[0].args["rung"] == "reference"
        assert degrades[0].args["launch"] == plan.pyramids[0].name
        summary = [e for e in collector.events if e.name == "guarded_run"]
        assert summary and summary[0].args["fallbacks"] == {"reference": 1}

    def test_clean_guarded_run_emits_summary_only(self, lenet):
        g, x, params, plan, prepped, ref = lenet
        with tracing() as collector:
            with guarding(GuardConfig(), source_params=params):
                y, _ = run_network(x, prepped, plan=plan)
        _assert_correct(y, ref, "traced-clean")
        assert not [e for e in collector.events if e.name == "degrade"]
        summary = [e for e in collector.events if e.name == "guarded_run"]
        assert summary[0].args["clean_launches"] == plan.n_launches()


class TestGuardOffUnaffected:
    def test_injector_ignored_without_guard(self, lenet):
        """Armed faults are consumed only by the guarded runner."""
        g, x, params, plan, prepped, ref = lenet
        base, _ = run_network(x, prepped, plan=plan)
        with inject(seed=0) as inj:
            inj.poison_output(kind="nan")
            inj.raise_at("run", times=99)
            y, _ = run_network(x, prepped, plan=plan)
        assert not inj.fired
        assert torch.equal(y, base)

    def test_determinism_across_repeats(self, lenet):
        """Same seed, same faults, same rungs, same logits — twice."""
        g, x, params, plan, prepped, ref = lenet

        def once():
            with guarding(GuardConfig(), source_params=params) as guard:
                with inject(seed=5) as inj:
                    inj.poison_output(kind="inf")
                    inj.squeeze_budget(SQUEEZE_GENTLE)
                    y, _ = run_network(x, prepped, plan=plan)
            return y, guard.last_report.fallback_counts(), list(inj.fired)

        y1, f1, log1 = once()
        y2, f2, log2 = once()
        assert torch.equal(y1, y2)
        assert f1 == f2 and log1 == log2


# ---------------------------------------------------------------------------
# circuit breaker (fake clock), against the reference's breaker
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _opens_after_threshold(m, rung):
    br = m.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=FakeClock())
    for _ in range(2):
        br.record_failure()
        assert br.state == m.CLOSED and br.allow()
    br.record_failure()
    assert br.state == m.OPEN and not br.allow()
    assert br.opens == 1
    assert br.transitions[-1]["why"] == "3 consecutive failures"
    return br


def _success_resets(m, rung):
    br = m.CircuitBreaker(threshold=2, clock=FakeClock())
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == m.CLOSED  # never two *consecutive* failures
    return br


def _cooldown_probe(m, rung):
    clock = FakeClock()
    br = m.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
    br.record_failure(rung=rung)
    assert br.state == m.OPEN and br.pinned_rung == rung
    assert not br.allow()  # cooldown not elapsed
    clock.t = 5.0
    assert br.allow()  # the probe
    assert br.state == m.HALF_OPEN
    assert not br.allow()  # only one probe outstanding
    return br


def _probe_success(m, rung):
    clock = FakeClock()
    br = m.CircuitBreaker(threshold=1, cooldown_s=1.0, clock=clock)
    br.record_failure(rung="reference")
    clock.t = 1.0
    assert br.allow()
    br.record_success()
    assert br.state == m.CLOSED and br.pinned_rung is None
    assert [(t["from"], t["to"]) for t in br.transitions] == [
        (m.CLOSED, m.OPEN), (m.OPEN, m.HALF_OPEN), (m.HALF_OPEN, m.CLOSED),
    ]
    return br


def _probe_failure(m, rung):
    clock = FakeClock()
    br = m.CircuitBreaker(threshold=1, cooldown_s=2.0, clock=clock)
    br.record_failure()
    clock.t = 2.0
    assert br.allow()
    br.record_failure(rung="reference")
    assert br.state == m.OPEN and br.opens == 2
    clock.t = 3.0  # only 1s since reopen: still open
    assert not br.allow()
    clock.t = 4.0
    assert br.allow() and br.state == m.HALF_OPEN
    return br


def _snapshot_and_validation(m, rung):
    br = m.CircuitBreaker(threshold=2, clock=FakeClock())
    br.record_failure()
    snap = br.snapshot()
    assert snap.state == m.CLOSED and snap.failures == 1
    assert snap.threshold == 2 and snap.opens == 0
    with pytest.raises(ValueError):
        m.CircuitBreaker(threshold=0)
    with pytest.raises(ValueError):
        m.CircuitBreaker(cooldown_s=-1.0)
    return br


BREAKER_CASES = {
    f.__name__.lstrip("_"): f for f in (
        _opens_after_threshold, _success_resets, _cooldown_probe,
        _probe_success, _probe_failure, _snapshot_and_validation,
    )
}


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_circuit_breaker_matches_the_reference(case):
    """Each of the reference's breaker cases on both breakers: the same
    states, the same transition sequence, the same snapshot (the
    reference's ``interpret`` pin is the port's ``eager``)."""
    br = BREAKER_CASES[case](tbreaker, "eager")
    jbr = BREAKER_CASES[case](jbreaker, "interpret")
    assert br.transitions == jbr.transitions
    snap, jsnap = br.snapshot(), jbr.snapshot()
    rename = {"interpret": "eager"}
    assert snap.pinned_rung == rename.get(jsnap.pinned_rung,
                                          jsnap.pinned_rung)
    assert (snap.state, snap.failures, snap.threshold, snap.opens,
            snap.transitions) == (jsnap.state, jsnap.failures,
                                  jsnap.threshold, jsnap.opens,
                                  jsnap.transitions)
    assert tbreaker.PIN_RUNGS == tuple(
        rename.get(r, r) for r in jbreaker.PIN_RUNGS)
