"""Serving chaos suite for the port: the counterpart of the reference's
``tests/test_serve_chaos.py`` on the port's CPU path.

Every serving fault class must end with typed per-request results while
later requests keep being served: blown deadlines (expiry, admission
shedding, EDF order), overload, staging failure, stuck launches (watchdog
and breaker), repeated kernel failure (the breaker pins ``eager``, the
reference's ``interpret``), poisoned output (re-served from ``reference``),
queue overflow, drain-loop stalls, the multi-threaded frontend, the
default-config equivalence and admission hardening.  The circuit breaker's
own unit cases are in ``tests/test_torch_chaos.py``.

Where the reference's test asserts a deterministic outcome, the same case
also runs on the reference engine — with ``repro.net.serve.run_network``
replaced (pytest ``monkeypatch``) by a pure-jnp stand-in returning
``reference_network`` logits, since its fused kernel does not launch on this
jax — and both engines must give the same batches, buckets, counters,
breaker snapshots and statuses.  Logits are held to ``atol 1e-4`` against
the reference's ``reference_network`` on the same params."""

import contextlib
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import graph as jgraph  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro.net import serve as jserve  # noqa: E402
from repro.obs import tracing as jtracing  # noqa: E402
from repro.robust import errors as jerrors  # noqa: E402
from repro.robust import faults as jfaults  # noqa: E402
from repro_torch.core.program import REFERENCE_BUDGET  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net.frontend import ServingFrontend  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.net.serve import (  # noqa: E402
    Request,
    ServeConfig,
    ServingEngine,
)
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.obs.stats import percentile  # noqa: E402
from repro_torch.robust import errors as terrors  # noqa: E402
from repro_torch.robust import faults as tfaults  # noqa: E402
from repro_torch.robust.errors import (  # noqa: E402
    DeadlineExceeded,
    FaultInjected,
    NumericError,
    PreflightError,
)
from repro_torch.robust.faults import FaultInjector, inject  # noqa: E402
from repro_torch.robust.validate import check_request  # noqa: E402

# f32 logits against the reference's reference_network (the runner's
# end-to-end contract: the same math summed in another order)
LOGIT_ATOL = 1e-4

JGRAPH = jgraph.lenet5()
JPARAMS = jrunner.init_network_params(JGRAPH, jax.random.PRNGKey(0))
GRAPH = MODELS["lenet"]()
PARAMS = params_from_numpy(
    {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in JPARAMS.items()},
    device="cpu",
)


def _images(rows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (rows, GRAPH.input_size, GRAPH.input_size, GRAPH.in_channels)
    ).astype(np.float32)


def _engine(**overrides) -> ServingEngine:
    """The port's engine under the reference's TPU budget, whose plans are
    the reference engine's."""
    cfg = ServeConfig(**{"buckets": (1, 2, 4), "budget": REFERENCE_BUDGET,
                         **overrides})
    return ServingEngine(GRAPH, PARAMS, cfg, device="cpu")


def _ref_engine(**overrides):
    cfg = jserve.ServeConfig(**{"buckets": (1, 2, 4), **overrides})
    return jserve.ServingEngine(JGRAPH, JPARAMS, cfg)


def _reference_logits(x) -> np.ndarray:
    return np.asarray(jrunner.reference_network(jnp.asarray(x), JGRAPH,
                                                JPARAMS))


def _standin(x, params, *, plan, end_skip=True, interpret=None, dtype=None):
    master = {k: v for k, v in params.items() if not k.startswith("_flat/")}
    return jrunner.reference_network(x, plan.graph, master), {}


# one namespace per package, so each paired case is written once
PORT = SimpleNamespace(engine=_engine, errors=terrors, faults=tfaults,
                       tracing=tracing)
REF = SimpleNamespace(engine=_ref_engine, errors=jerrors, faults=jfaults,
                      tracing=jtracing)


@pytest.fixture
def both(monkeypatch):
    """Run a case on the port's engine and on the reference engine (its
    launch the pure-jnp stand-in); returns the two outcomes."""
    monkeypatch.setattr(jserve, "run_network", _standin)
    # jax compiles each jnp op at its first shape: run the stand-in once
    # per bucket, so a reference engine's first batch (which calibrates its
    # watchdog) times the forward and not the compiles (a no-op once warm)
    for b in (1, 2, 4):
        _reference_logits(_images(b))

    def run(case):
        return case(PORT), case(REF)

    return run


@pytest.fixture(autouse=True)
def _one_thread():
    """The timing cases compare injected stalls with measured batch walls;
    one intra-op thread keeps a LeNet forward's wall steady while the
    suite runs beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(collector, name):
    return [e for e in collector.events if e.name == name]


def _status(result):
    """A result's deterministic fingerprint: id, rows, bucket, and its
    error's type name (None when it completed)."""
    return (result.id, result.rows, result.bucket,
            None if result.ok else type(result.error).__name__)


def _state(eng):
    """An engine's deterministic counters: cache, resilience (breaker
    snapshots included), completed and rejected."""
    s = eng.summary()
    return dict(serve=s["cache"]["serve"], resilience=s["resilience"],
                completed=s["completed"], rejected=s["rejected"],
                batches={r["bucket"]: (r["batches"], r["requests"],
                                       r["images"]) for r in s["buckets"]})


def _check_logits(results, xs):
    for res, x in zip(results, xs):
        assert res.ok
        np.testing.assert_allclose(res.logits, _reference_logits(x),
                                   atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# deadlines: expiry, shedding, EDF order
# ---------------------------------------------------------------------------


class TestDeadlines:
    def test_expired_request_completes_typed_never_launches(self):
        eng = _engine(deadline_aware=True)
        # generous vs the modeled ETA (so admission passes), tiny vs the
        # wall clock (so it blows while queued before the drain)
        deadline_us = 20 * eng._entry(1).slo_us
        with tracing() as col:
            dead = eng.submit(_images(1, seed=1), deadline_us=deadline_us)
            live = eng.submit(_images(1, seed=2))
            time.sleep(deadline_us * 1e-6 + 0.01)
            eng.drain()
        res = eng.results[dead]
        assert not res.ok and isinstance(res.error, DeadlineExceeded)
        assert res.error.context["late_us"] > 0
        assert res.bucket is None
        assert eng.results[live].ok
        assert eng.resilience["expired"] == 1
        assert len(_events(col, "serve_expired")) == 1
        assert eng.route_batches == {(1, "fused"): 1}

    def test_admission_shed_is_typed_and_counted(self, both):
        def case(m):
            eng = m.engine(deadline_aware=True, shed_margin=1e12)
            with m.tracing() as col:
                rid = eng.submit(_images(1), deadline_us=1e6)
            res = eng.results[rid]
            assert not res.ok
            assert isinstance(res.error, m.errors.DeadlineExceeded)
            assert res.error.context["eta_us"] > 0
            assert res.error.context["deadline_us"] == 1e6
            assert not eng.queue
            assert eng.resilience["shed"] == 1 and eng.rejected == 1
            assert len(_events(col, "serve_shed")) == 1
            return _status(res), res.error.context, _state(eng)

        assert both(case)[0] == both(case)[1]

    def test_no_deadline_requests_never_shed_or_expire(self, both):
        def case(m):
            eng = m.engine(deadline_aware=True, shed_margin=1e12)
            res = eng.serve([_images(1, seed=s) for s in range(3)])
            assert all(r.ok for r in res)
            assert eng.resilience["shed"] == eng.resilience["expired"] == 0
            return [_status(r) for r in res], _state(eng)

        ours, theirs = both(case)
        assert ours == theirs

    def test_edf_order_priority_then_deadline(self):
        now = time.perf_counter()
        specs = [(0, 10.0), (0, 1.0), (1, 10.0), (0, None)]
        orders = []
        for eng, req in ((_engine(deadline_aware=True), Request),
                         (_ref_engine(deadline_aware=True), jserve.Request)):
            for i, (prio, off) in enumerate(specs):
                eng.queue.append(req(
                    id=i, x=np.zeros((1, 1, 1, 1)), rows=1, enqueue_s=now,
                    deadline_us=None if off is None else off * 1e6,
                    deadline_s=None if off is None else now + off,
                    priority=prio,
                ))
            orders.append([r.id for r in eng._form_batch()])
        assert orders == [[2, 1, 0, 3]] * 2

    def test_fifo_engine_ignores_deadlines(self, both):
        def case(m):
            eng = m.engine()
            rid = eng.submit(_images(1), deadline_us=1.0)
            time.sleep(0.002)
            eng.drain()
            assert eng.results[rid].ok
            assert eng.resilience["shed"] == eng.resilience["expired"] == 0
            return _status(eng.results[rid]), _state(eng)

        ours, theirs = both(case)
        assert ours == theirs


class TestOverloadShedding:
    """Under overload, deadline-aware admission sheds what cannot meet its
    deadline and what it admits completes on time, while the FIFO engine
    serves everything late.  Injected slow launches make the batch wall
    ~250 ms (the reference's 60 ms is too close to a forward's wall when
    this suite shares the cores with other test workers)."""

    DELAY_S = 0.25

    def _slow(self):
        inj = FaultInjector(seed=0)
        inj.slow_launch(self.DELAY_S, times=999)
        return inj

    def _warmed(self, **overrides):
        eng = _engine(**overrides)
        for r in (1, 2, 4):
            eng.serve([_images(r, seed=r)])
        with inject(injector=self._slow()):
            for rep in range(2):
                for r in (1, 2, 4):
                    eng.serve([_images(r, seed=10 * rep + r)])
        for b in (1, 2, 4):
            p50 = percentile(eng._stats[b].batch_walls_ms, 50)
            assert p50 >= self.DELAY_S * 1e3
        return eng

    def test_edf_sheds_and_admitted_meet_deadlines(self):
        eng = self._warmed(deadline_aware=True, shed_margin=1.6)
        deadline_us = 2.6 * self.DELAY_S * 1e6  # room for ~2 slow batches
        with inject(injector=self._slow()):
            ids = [
                eng.submit(_images(1, seed=s), deadline_us=deadline_us)
                for s in range(20)
            ]
            eng.drain()
        results = [eng.results[i] for i in ids]
        completed = [r for r in results if r.ok]
        typed = [
            r for r in results
            if not r.ok and isinstance(r.error, DeadlineExceeded)
        ]
        shed = [r for r in typed if "eta_us" in r.error.context]
        assert len(completed) + len(typed) == 20
        assert completed and shed
        on_time = [
            r for r in completed if r.latency_ms * 1e3 <= deadline_us
        ]
        assert len(on_time) / len(completed) >= 0.95

    def test_fifo_baseline_misses_deadlines(self):
        eng = self._warmed()
        deadline_us = 2.6 * self.DELAY_S * 1e6
        with inject(injector=self._slow()):
            ids = [
                eng.submit(_images(1, seed=s), deadline_us=deadline_us)
                for s in range(20)
            ]
            eng.drain()
        results = [eng.results[i] for i in ids]
        assert all(r.ok for r in results)
        late = [r for r in results if r.latency_ms * 1e3 > deadline_us]
        assert len(late) >= len(results) // 2


# ---------------------------------------------------------------------------
# serving fault classes
# ---------------------------------------------------------------------------


class TestStagingFailure:
    def test_staging_fault_fails_batch_typed_queue_drains(self, both):
        def case(m):
            eng = m.engine()
            inj = m.faults.FaultInjector(seed=0)
            inj.raise_at("stage", times=2, message="injected staging failure")
            with m.tracing() as col, m.faults.inject(injector=inj):
                res = eng.serve([_images(4, seed=s) for s in range(3)])
            assert [r.ok for r in res] == [False, False, True]
            for r in res[:2]:
                assert isinstance(r.error, m.errors.FaultInjected)
                assert r.error.context["stage"] == "stage"
                assert r.bucket == 4
            assert eng.resilience["failed"] == 2
            assert len(_events(col, "serve_batch_error")) == 2
            after = eng.serve([_images(1, seed=7)])
            assert after[0].ok
            return [_status(r) for r in res + after], _state(eng), res[2]

        (ours, ostate, last), (theirs, tstate, _) = both(case)
        assert ours == theirs and ostate == tstate
        _check_logits([last], [_images(4, seed=2)])


# a stuck launch: the reference's 0.25 s, raised so that 3x a clean wall
# stays below it when this suite shares the cores with other test workers
STALL_S = 1.0


class TestStuckLaunch:
    def test_watchdog_trips_and_breaker_cycles(self, both):
        def case(m):
            eng = m.engine(watchdog_factor=3.0, breaker_threshold=1,
                           breaker_cooldown_s=0.0)
            eng.serve([_images(4, seed=0)])  # a clean wall calibrates
            inj = m.faults.FaultInjector(seed=0)
            inj.slow_launch(STALL_S, times=1)
            with m.tracing() as col, m.faults.inject(injector=inj):
                stuck = eng.serve([_images(4, seed=1)])
            assert stuck[0].ok  # slow, not wrong
            assert eng.resilience["watchdog_trips"] == 1
            wd = _events(col, "serve_watchdog")
            assert len(wd) == 1 and wd[0].args["wall_ms"] >= STALL_S * 1e3
            snap = eng.summary()["resilience"]["breakers"]["4"]
            assert snap["opens"] == 1 and snap["state"] == "open"
            with m.tracing() as col2:
                probe = eng.serve([_images(4, seed=2)])
            assert probe[0].ok
            trans = [
                (e.args["from_state"], e.args["to_state"])
                for e in _events(col2, "serve_breaker")
            ]
            assert trans == [("open", "half_open"), ("half_open", "closed")]
            snap = eng.summary()["resilience"]["breakers"]["4"]
            assert snap["state"] == "closed" and snap["pinned_rung"] is None
            return [_status(r) for r in stuck + probe], _state(eng)

        ours, theirs = both(case)
        assert ours == theirs

    def test_tripped_wall_not_used_for_calibration(self):
        eng = _engine(watchdog_factor=3.0)
        eng.serve([_images(4, seed=0)])
        clean_walls = list(eng._stats[4].batch_walls_ms)
        inj = FaultInjector(seed=0)
        inj.slow_launch(STALL_S, times=1)
        with inject(injector=inj):
            eng.serve([_images(4, seed=1)])
        assert eng.resilience["watchdog_trips"] == 1
        assert eng._stats[4].batch_walls_ms == clean_walls


class TestRepeatedKernelFailure:
    def test_degraded_launches_open_breaker_and_pin_rung(self):
        """Two guarded launches that each take the eager rung open the
        breaker, which pins the bucket to ``eager`` for the cooldown: the
        third batch runs every pyramid through its plain version without a
        failed fused attempt.  (The reference pins ``interpret``; its
        guarded runner does not run on this jax.)"""
        eng = _engine(guarded=True, breaker_threshold=2,
                      breaker_cooldown_s=600.0)
        inj = FaultInjector(seed=0)
        with tracing() as col, inject(injector=inj):
            inj.raise_at("run", times=1)
            r1 = eng.serve([_images(4, seed=1)])
            inj.raise_at("run", times=1)
            r2 = eng.serve([_images(4, seed=2)])
            r3 = eng.serve([_images(4, seed=3)])
        assert all(r[0].ok for r in (r1, r2, r3))
        snap = eng.summary()["resilience"]["breakers"]["4"]
        assert snap["state"] == "open"
        assert snap["pinned_rung"] == "eager"
        opens = [
            e for e in _events(col, "serve_breaker")
            if e.args["to_state"] == "open"
        ]
        assert len(opens) == 1 and opens[0].args["bucket"] == 4
        routes = [e.args["route"] for e in _events(col, "serve_batch")]
        assert routes[-1] == "eager"
        assert eng.route_batches == {(4, "fused"): 2, (4, "eager"): 1}
        _check_logits([r1[0], r2[0], r3[0]],
                      [_images(4, seed=s) for s in (1, 2, 3)])


class TestPoisonedOutput:
    def test_sentinel_reserves_from_reference(self, both):
        def case(m):
            eng = m.engine(output_sentinel=True, breaker_threshold=1,
                           breaker_cooldown_s=600.0)
            x = _images(2, seed=5)
            inj = m.faults.FaultInjector(seed=0)
            inj.poison_output(times=1)
            with m.tracing() as col, m.faults.inject(injector=inj):
                res = eng.serve([x])
            assert res[0].ok
            assert np.isfinite(np.asarray(res[0].logits, np.float32)).all()
            assert eng.resilience["sentinel_trips"] == 1
            sent = _events(col, "serve_sentinel")
            assert len(sent) == 1
            assert sent[0].args["action"] == "reference_retry"
            snap = eng.summary()["resilience"]["breakers"]["2"]
            assert snap["state"] == "open"
            assert snap["pinned_rung"] == "reference"
            with m.tracing() as col2:
                res2 = eng.serve([x.copy()])
            assert res2[0].ok
            routes = [e.args["route"] for e in _events(col2, "serve_batch")]
            assert routes == ["reference"]
            return [_status(r) for r in res + res2], _state(eng), res + res2

        (ours, ostate, results), (theirs, tstate, _) = both(case)
        assert ours == theirs and ostate == tstate
        _check_logits(results, [_images(2, seed=5)] * 2)


class TestQueueOverflow:
    def test_overflow_rejects_typed_then_recovers(self, both):
        def case(m):
            eng = m.engine(max_queue=2)
            ids = [eng.submit(_images(1, seed=s)) for s in range(3)]
            res = eng.results[ids[2]]
            assert not res.ok and isinstance(res.error,
                                             m.errors.PreflightError)
            assert res.error.context["field"] == "queue"
            eng.drain()
            assert eng.results[ids[0]].ok and eng.results[ids[1]].ok
            after = eng.serve([_images(1, seed=9)])
            assert after[0].ok
            return ([_status(eng.results[i]) for i in ids]
                    + [_status(after[0])], _state(eng))

        ours, theirs = both(case)
        assert ours == theirs


class TestQueueStall:
    def test_stalls_delay_but_never_drop(self, both):
        def case(m):
            eng = m.engine()
            inj = m.faults.FaultInjector(seed=0)
            inj.stall_queue(2)
            with m.tracing() as col, m.faults.inject(injector=inj):
                res = eng.serve([_images(1, seed=s) for s in range(3)])
            assert all(r.ok for r in res)
            assert eng.resilience["stalls"] == 2
            assert len(_events(col, "serve_stall")) == 2
            assert inj.fired.count(("stall", "<queue>", "skip")) == 2
            return [_status(r) for r in res], _state(eng), list(inj.fired)

        ours, theirs = both(case)
        assert ours == theirs


class TestGenuineFaultsStayOnTheKernels:
    """A failure no injected fault explains — non-finite logits, a slow
    batch, a typed error out of the route — fails its batch typed and
    leaves the key on the fused route: the breaker does not open and the
    sentinel does not re-serve, so a broken kernel is never hidden behind
    the reference walk or the plain versions.  (The port's own rule: the
    reference engine serves such a batch and counts a breaker failure.)"""

    @staticmethod
    def _once(monkeypatch, effect):
        """Replace the engine's ``run_network`` by one whose first call
        goes through ``effect(logits, skips)``; later calls are plain."""
        from repro_torch.net import serve as tserve

        real, calls = tserve.run_network, []

        def patched(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append(1)
            return effect(*out) if len(calls) == 1 else out

        monkeypatch.setattr(tserve, "run_network", patched)

    @staticmethod
    def _closed_and_fused(eng, bucket, batches):
        snap = eng.summary()["resilience"]["breakers"][str(bucket)]
        assert snap["state"] == "closed" and snap["opens"] == 0
        assert snap["pinned_rung"] is None
        assert eng.route_batches == {(bucket, "fused"): batches}

    @pytest.mark.parametrize("idle_injector", [False, True])
    def test_non_finite_logits_fail_typed(self, monkeypatch, idle_injector):
        """With or without an injector installed (one that fires nothing
        in the batch), NaN logits fail the batch with ``NumericError``."""
        eng = _engine(output_sentinel=True, breaker_threshold=1,
                      breaker_cooldown_s=600.0)

        def nan(logits, skips):
            logits = logits.clone()
            logits[0, 0] = float("nan")
            return logits, skips

        self._once(monkeypatch, nan)
        x = _images(2, seed=5)
        scope = inject(injector=FaultInjector(seed=0)) if idle_injector \
            else contextlib.nullcontext()
        with tracing() as col, scope:
            (bad,) = eng.serve([x])
        assert not bad.ok and isinstance(bad.error, NumericError)
        assert bad.error.context == {"bucket": 2, "route": "fused"}
        assert eng.resilience["sentinel_trips"] == 1
        assert eng.resilience["failed"] == 1
        sent = _events(col, "serve_sentinel")
        assert [e.args["action"] for e in sent] == ["fail"]
        (good,) = eng.serve([x.copy()])
        _check_logits([good], [x])
        self._closed_and_fused(eng, 2, 2)

    def test_slow_batch_fails_with_watchdog_error(self, monkeypatch):
        eng = _engine(watchdog_factor=3.0, breaker_threshold=1,
                      breaker_cooldown_s=600.0)
        eng.serve([_images(4, seed=0)])  # a clean wall calibrates
        clean_walls = list(eng._stats[4].batch_walls_ms)

        def stall(logits, skips):
            time.sleep(STALL_S)
            return logits, skips

        self._once(monkeypatch, stall)
        (slow,) = eng.serve([_images(4, seed=1)])
        assert not slow.ok and isinstance(slow.error, terrors.WatchdogError)
        assert isinstance(slow.error, TimeoutError)
        ctx = slow.error.context
        assert ctx["bucket"] == 4 and ctx["route"] == "fused"
        assert ctx["wall_ms"] > ctx["threshold_ms"]
        assert eng.resilience["watchdog_trips"] == 1
        assert eng._stats[4].batch_walls_ms == clean_walls
        x = _images(4, seed=2)
        (good,) = eng.serve([x])
        _check_logits([good], [x])
        self._closed_and_fused(eng, 4, 3)

    def test_typed_route_error_leaves_the_breaker_closed(self, monkeypatch):
        from repro_torch.net import serve as tserve

        eng = _engine(breaker_threshold=1, breaker_cooldown_s=600.0)
        real, calls = tserve.run_network, []

        def failing(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise PreflightError("params disagree with the plan",
                                     node="c1")
            return real(*args, **kwargs)

        monkeypatch.setattr(tserve, "run_network", failing)
        (bad,) = eng.serve([_images(1, seed=3)])
        assert not bad.ok and isinstance(bad.error, PreflightError)
        x = _images(1, seed=4)
        (good,) = eng.serve([x])
        _check_logits([good], [x])
        snap = eng.summary()["resilience"]["breakers"]["1"]
        assert snap["state"] == "closed" and snap["opens"] == 0
        assert eng.route_batches == {(1, "fused"): 1}

    def test_probe_that_fails_on_its_own_reopens_typed(self, monkeypatch):
        """An injected stall opens the breaker; the half-open probe then
        returns NaN logits with no fault fired: the probe fails typed (not
        re-served) and the breaker re-opens on the injected fault's pin."""
        eng = _engine(watchdog_factor=3.0, output_sentinel=True,
                      breaker_threshold=1, breaker_cooldown_s=0.0)
        eng.serve([_images(4, seed=0)])
        inj = FaultInjector(seed=0)
        inj.slow_launch(STALL_S, times=1)
        with inject(injector=inj):
            (stuck,) = eng.serve([_images(4, seed=1)])
        assert stuck.ok  # injected: slow, not wrong, and served

        def nan(logits, skips):
            logits = logits.clone()
            logits[:] = float("nan")
            return logits, skips

        self._once(monkeypatch, nan)
        (probe,) = eng.serve([_images(4, seed=2)])
        assert not probe.ok and isinstance(probe.error, NumericError)
        snap = eng.summary()["resilience"]["breakers"]["4"]
        assert snap["state"] == "open" and snap["opens"] == 2
        assert eng.route_batches == {(4, "fused"): 3}


# ---------------------------------------------------------------------------
# concurrent frontend: hammer + handle semantics
# ---------------------------------------------------------------------------


class TestFrontend:
    def test_handle_resolves_with_result(self):
        eng = _engine()
        with ServingFrontend(eng) as fe:
            h = fe.submit(_images(2, seed=1))
            res = h.result(timeout=60.0)
        assert res.ok and res.id == h.id and h.done()
        _check_logits([res], [_images(2, seed=1)])

    def test_rejection_resolves_immediately(self):
        eng = _engine()
        fe = ServingFrontend(eng)  # not even started: rejection is sync
        h = fe.submit(np.zeros((1, 8, 8, 1), np.float32))
        res = h.result(timeout=1.0)
        assert not res.ok and isinstance(res.error, PreflightError)

    def test_drain_error_resolves_every_pending_handle(self, monkeypatch):
        """An untyped error out of the drain (a kernel that fails to build
        or launch) ends the drain thread: the batch in flight and the
        requests queued behind it resolve with that error, and a later
        submit raises it."""
        from repro_torch.net import serve as tserve

        def broken(*args, **kwargs):
            raise RuntimeError("fused_pyramid: launch failed")

        monkeypatch.setattr(tserve, "run_network", broken)
        fe = ServingFrontend(_engine())
        handles = [fe.submit(_images(r, seed=r)) for r in (4, 2, 1)]
        assert not any(h.done() for h in handles)
        with fe:
            for h in handles:
                with pytest.raises(RuntimeError, match="launch failed"):
                    h.result(timeout=60.0)
            fe._thread.join(timeout=60.0)
            assert not fe._thread.is_alive()
            with pytest.raises(RuntimeError, match="launch failed"):
                fe.submit(_images(1, seed=9))
        assert all(h.done() for h in handles)

    def test_multithreaded_hammer_no_lost_no_duplicate(self):
        """More producer threads than this machine's cores, a shortened
        switch interval: every handle resolves once, with its own rows."""
        eng = _engine()
        eng.serve([_images(4, seed=0)])  # pre-warm: the hammer reuses plans
        misses_before = eng.cache_counters["misses"]
        n_threads, per_thread = 6, 8
        results: dict[int, list] = {}
        res_lock = threading.Lock()
        errors: list = []

        def producer(tid: int) -> None:
            try:
                for i in range(per_thread):
                    h = fe.submit(_images(1, seed=tid * 100 + i))
                    r = h.result(timeout=120.0)
                    with res_lock:
                        results.setdefault(r.id, []).append(
                            (r, tid * 100 + i))
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ServingFrontend(eng) as fe:
                threads = [
                    threading.Thread(target=producer, args=(t,))
                    for t in range(n_threads)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120.0)
                assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert not errors, errors
        assert len(results) == n_threads * per_thread
        assert all(len(v) == 1 for v in results.values())
        assert all(v[0][0].ok for v in results.values())
        for (r, seed), in list(results.values())[:8]:
            _check_logits([r], [_images(1, seed=seed)])
        assert eng.cache_counters["misses"] <= misses_before + 2
        assert eng.cache_counters["evictions"] == 0


# ---------------------------------------------------------------------------
# all resilience knobs off == the plain engine
# ---------------------------------------------------------------------------


class TestDefaultConfigEquivalence:
    def test_default_engine_is_the_plain_engine(self, both):
        xs = [_images(r, seed=r) for r in (1, 4, 2)]

        def case(m):
            eng_a, eng_b = m.engine(), m.engine()
            res_a = eng_a.serve(xs)
            res_b = eng_b.serve([x.copy() for x in xs])
            for a, b in zip(res_a, res_b):
                assert a.ok and b.ok and a.bucket == b.bucket
                assert np.array_equal(a.logits, b.logits)
            summary = eng_a.summary()
            assert all(
                v == 0 for k, v in summary["resilience"].items()
                if k != "breakers"
            )
            assert summary["resilience"]["breakers"] == {}
            assert eng_a._breakers == {}
            return [_status(r) for r in res_a], _state(eng_a), res_a

        (ours, ostate, results), (theirs, tstate, _) = both(case)
        assert ours == theirs and ostate == tstate
        _check_logits(results, xs)

    def test_config_validation(self):
        with pytest.raises(PreflightError):
            ServeConfig(shed_margin=0.0)
        with pytest.raises(PreflightError):
            ServeConfig(breaker_threshold=0)
        with pytest.raises(PreflightError):
            ServeConfig(watchdog_factor=1.0)


# ---------------------------------------------------------------------------
# admission hardening: check_request edge cases through the engine
# ---------------------------------------------------------------------------


class TestAdmissionHardening:
    def _field(self, exc_info) -> str:
        return exc_info.value.context["field"]

    def test_non_contiguous_view_accepted(self):
        base = _images(8, seed=1)
        view = base[::2]
        assert not view.flags["C_CONTIGUOUS"]
        check_request(view, GRAPH)
        eng = _engine()
        res = eng.serve([view])
        assert res[0].ok and res[0].rows == 4
        _check_logits(res, [np.ascontiguousarray(view)])

    def test_f64_finite_accepted_f64_overflow_rejected(self):
        ok64 = _images(1).astype(np.float64)
        check_request(ok64, GRAPH)
        big = ok64.copy()
        big[0, 0, 0, 0] = 1e200
        with pytest.raises(NumericError) as ei:
            check_request(big, GRAPH)
        assert self._field(ei) == "range"
        eng = _engine()
        ok, bad = eng.serve([ok64, big])
        assert ok.ok and isinstance(bad.error, NumericError)

    def test_f64_nan_named_values_not_range(self):
        bad = _images(1).astype(np.float64)
        bad[0, 1, 1, 0] = np.nan
        with pytest.raises(NumericError) as ei:
            check_request(bad, GRAPH)
        assert self._field(ei) == "values"

    def test_zero_row_batch_rejected(self):
        empty = np.zeros(
            (0, GRAPH.input_size, GRAPH.input_size, GRAPH.in_channels),
            np.float32,
        )
        with pytest.raises(PreflightError) as ei:
            check_request(empty, GRAPH)
        assert self._field(ei) == "batch"
        res = _engine().serve([empty])
        assert isinstance(res[0].error, PreflightError)

    def test_rejection_fields_name_the_offender(self):
        cases = [
            (np.zeros((32, 32, 1), np.float32), "rank"),
            (np.zeros((1, 8, 8, 1), np.float32), "spatial"),
            (np.zeros((1, 32, 32, 3), np.float32), "channels"),
        ]
        for x, field in cases:
            with pytest.raises(PreflightError) as ei:
                check_request(x, GRAPH)
            assert self._field(ei) == field
        bad_dtype = np.empty(
            (1, GRAPH.input_size, GRAPH.input_size, GRAPH.in_channels),
            dtype=object,
        )
        with pytest.raises(PreflightError) as ei:
            check_request(bad_dtype, GRAPH)
        assert self._field(ei) == "dtype"

    def test_engine_rejection_carries_field_context(self, both):
        def case(m):
            eng = m.engine()
            rid = eng.submit(np.zeros((1, 8, 8, 1), np.float32))
            res = eng.results[rid]
            assert not res.ok
            assert res.error.context["field"] == "spatial"
            return _status(res), res.error.context

        ours, theirs = both(case)
        assert ours == theirs


def test_typed_errors_are_the_references():
    """Every typed error a serving result can carry has the reference's
    name and bases (so a client's handling carries across)."""
    for err in (DeadlineExceeded, FaultInjected, NumericError,
                PreflightError):
        ref = getattr(jerrors, err.__name__)
        assert [b.__name__ for b in err.__mro__] == [
            b.__name__ for b in ref.__mro__]
