"""The port's serving engine against the reference's ``tests/test_serve.py``
and against the reference's own pure-Python parts.

Every case of the reference's serving suite has its counterpart here, on
the port's CPU path (each pyramid through its kernel's plain version):
bucketing, bitwise pad parity, admission order and packing, typed
rejection, the plan cache and the compiled forward's trace count (wave 2:
zero), the summary and its SLO columns, batch-aware costing and the
serving cycle models.  Parity with the reference covers:

* ``bucket_for``, ``pad_to_bucket`` and ``ServeConfig`` errors: the same
  exception type and ``context``;
* the three serving cycle models: exactly equal (integer models) over
  hypothesis inputs;
* ``serve_table``: the same lines from the same summary dict;
* each bucket's plan (field by field), ``compute_cycles``,
  ``staging_cycles``, ``slo_us`` and ``steady_us``: equal to the reference
  engine's ``_entry`` (its plans come from the pure-Python
  ``auto_partition``);
* FIFO packing: the same batches as the reference engine's ``_form_batch``;
* logits: within ``atol 1e-4`` of the reference's pure-jnp
  ``reference_network`` on the reference's params, carried across with
  ``params_from_numpy``.

The reference engine itself is run only where a case needs its decisions,
with ``repro.net.serve.run_network`` replaced (pytest ``monkeypatch``) by a
pure-jnp stand-in returning ``reference_network`` logits: its fused kernel
does not launch on this jax."""

import dataclasses
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import cycle_model as jcm  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro.net import serve as jserve  # noqa: E402
from repro.obs import explain as jexplain  # noqa: E402
from repro_torch.core.program import (  # noqa: E402
    REFERENCE_BUDGET,
    TpuVmemBudget,
)
from repro_torch.core import cycle_model as tcm  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.net import runner  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.net.partition import (  # noqa: E402
    auto_partition,
    clear_partition_cache,
    partition_cache_info,
)
from repro_torch.net.runner import (  # noqa: E402
    prepare_network_params,
    run_network,
)
from repro_torch.net.serve import (  # noqa: E402
    Request,
    ServeConfig,
    ServingEngine,
    bucket_for,
    pad_to_bucket,
)
from repro_torch.obs.explain import serve_table  # noqa: E402
from test_torch_plans import _plan_fields  # noqa: E402
from repro_torch.robust.errors import NumericError, PreflightError  # noqa: E402

# f32 logits against the reference's reference_network: the same math,
# summed in another order over up to ~20 layers (the runner's contract)
LOGIT_ATOL = 1e-4

# small sides: LeNet at its 32x32 and ResNet-18 at input_size=32, 10 classes
SIDES = {
    "lenet": {},
    "resnet18": {"input_size": 32, "num_classes": 10},
}


def _side(model):
    jg = jgraph.MODELS[model](**SIDES[model])
    jp = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
    tp = params_from_numpy(
        {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jp.items()},
        device="cpu",
    )
    return jg, jp, MODELS[model](**SIDES[model]), tp


JGRAPH, JPARAMS, GRAPH, PARAMS = _side("lenet")


def _images(rows: int, seed: int = 0, graph=GRAPH) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (rows, graph.input_size, graph.input_size, graph.in_channels)
    ).astype(np.float32)


def _engine(**overrides) -> ServingEngine:
    cfg = ServeConfig(**{"buckets": (1, 2, 4), **overrides})
    return ServingEngine(GRAPH, PARAMS, cfg, device="cpu")


def _ref_engine(graph=JGRAPH, params=JPARAMS, **overrides):
    cfg = jserve.ServeConfig(**{"buckets": (1, 2, 4), **overrides})
    return jserve.ServingEngine(graph, params, cfg)


def _standin(x, params, *, plan, end_skip=True, interpret=None, dtype=None):
    """The reference engine's launch replaced by its pure-jnp oracle on the
    prepared params (the kernel does not launch on this jax)."""
    master = {k: v for k, v in params.items() if not k.startswith("_flat/")}
    return jrunner.reference_network(x, plan.graph, master), {}


@pytest.fixture
def ref_serving(monkeypatch):
    monkeypatch.setattr(jserve, "run_network", _standin)


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``(error type name, context)``."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, getattr(e, "context", None)


# ---------------------------------------------------------------------------
# bucketing helpers, against the reference
# ---------------------------------------------------------------------------

BUCKET_CASES = [
    (1, (1, 2, 4, 8)), (3, (1, 2, 4, 8)), (8, (1, 2, 4, 8)),
    (3, (8, 4, 2, 1)), (9, (1, 2, 4, 8)), (0, (1, 2)), (5, (4,)),
]


@pytest.mark.parametrize("rows,buckets", BUCKET_CASES)
def test_bucket_for_matches_the_reference(rows, buckets):
    assert _outcome(bucket_for, rows, buckets) == _outcome(
        jserve.bucket_for, rows, buckets)


@pytest.mark.parametrize("bucket", [2, 3, 4, 8])
def test_pad_to_bucket_matches_the_reference(bucket):
    x = _images(3)
    kind, got = _outcome(pad_to_bucket, x, bucket)
    jkind, want = _outcome(jserve.pad_to_bucket, x, bucket)
    assert kind == jkind
    if kind == "ok":
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


CONFIG_ERRORS = [
    {"buckets": (4, 2)}, {"buckets": ()}, {"buckets": (1, 1, 2)},
    {"shed_margin": 0.0}, {"shed_margin": -1.0}, {"breaker_threshold": 0},
    {"watchdog_factor": 1.0}, {"watchdog_factor": 0.5},
]


@pytest.mark.parametrize("kwargs", CONFIG_ERRORS, ids=str)
def test_config_errors_match_the_reference(kwargs):
    kind, ctx = _outcome(ServeConfig, **kwargs)
    assert (kind, ctx) == _outcome(jserve.ServeConfig, **kwargs)
    assert kind == "PreflightError"


def test_config_fields_are_the_references_without_interpret():
    """The reference's fields but ``interpret``, its ``vmem_budget`` int
    carried as a ``budget``; under the reference's budget model the defaults
    are the reference's."""
    ours = [f.name for f in dataclasses.fields(ServeConfig)]
    theirs = [f.name for f in dataclasses.fields(jserve.ServeConfig)]
    assert ours == ["budget" if f == "vmem_budget" else f
                    for f in theirs if f != "interpret"]
    ref = jserve.ServeConfig()
    assert ServeConfig(budget=REFERENCE_BUDGET) == ServeConfig(**{
        f: (TpuVmemBudget(ref.vmem_budget) if f == "budget"
            else getattr(ref, f)) for f in ours})


class TestBucketing:
    def test_bucket_for_picks_smallest_fit(self):
        assert bucket_for(1, (1, 2, 4, 8)) == 1
        assert bucket_for(3, (1, 2, 4, 8)) == 4
        assert bucket_for(8, (1, 2, 4, 8)) == 8
        assert bucket_for(3, (8, 4, 2, 1)) == 4

    def test_bucket_for_overflow_is_typed(self):
        with pytest.raises(PreflightError):
            bucket_for(9, (1, 2, 4, 8))

    def test_pad_to_bucket_shapes(self):
        x = _images(3)
        padded = pad_to_bucket(x, 4)
        assert padded.shape[0] == 4
        assert np.array_equal(padded[:3], x)
        assert not padded[3:].any()
        assert np.array_equal(pad_to_bucket(x, 3), x)
        with pytest.raises(PreflightError):
            pad_to_bucket(x, 2)


# ---------------------------------------------------------------------------
# pad-to-bucket bitwise parity (the port's CPU path)
# ---------------------------------------------------------------------------


def _run(x, prepared, plan):
    logits, _ = run_network(torch.from_numpy(x), prepared, plan=plan)
    return logits


class TestPadParity:
    """A padded batch's real rows are bit-identical to the unpadded run
    under the same bucket plan (on the CPU; the card's claim is a
    tolerance, see chip_smoke.py)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_padded_rows_bit_identical(self, dtype):
        rows, bucket = 3, 4
        x = _images(rows, seed=7)
        plan = auto_partition(GRAPH, batch=bucket, compute_dtype=dtype)
        prepared = prepare_network_params(plan, PARAMS)
        full = _run(pad_to_bucket(x, bucket), prepared, plan)
        part = _run(x, prepared, plan)
        assert torch.equal(full[:rows], part)

    def test_neighbor_content_does_not_leak(self):
        bucket = 4
        a, b = _images(1, seed=1), _images(bucket - 1, seed=2)
        c = _images(bucket - 1, seed=3)
        plan = auto_partition(GRAPH, batch=bucket)
        prepared = prepare_network_params(plan, PARAMS)
        with_b = _run(np.concatenate([a, b]), prepared, plan)
        with_c = _run(np.concatenate([a, c]), prepared, plan)
        assert torch.equal(with_b[0], with_c[0])

    def test_engine_matches_manual_padded_run(self):
        x1, x2 = _images(2, seed=4), _images(1, seed=5)
        eng = _engine()
        r1, r2 = eng.serve([x1, x2])
        assert r1.ok and r2.ok and r1.bucket == r2.bucket == 4
        plan = auto_partition(GRAPH, batch=4)
        prepared = prepare_network_params(plan, PARAMS)
        manual = _run(
            pad_to_bucket(np.concatenate([x1, x2]), 4), prepared, plan
        ).numpy()
        assert np.array_equal(r1.logits, manual[:2])
        assert np.array_equal(r2.logits, manual[2:3])


class TestDispatchDepth:
    """The drain loop keeps two batches dispatched on a card with every
    resilience hook off, one otherwise; the batches it serves and their
    logits do not depend on the depth (run here on the CPU with the depth
    forced to two)."""

    @staticmethod
    def _depth(device, inj_enabled=False, **cfg):
        host = SimpleNamespace(device=torch.device(device),
                               config=ServeConfig(**cfg))
        return ServingEngine._depth(host, SimpleNamespace(
            enabled=inj_enabled))

    @pytest.mark.parametrize("device,inj,cfg,depth", [
        ("cuda", False, {}, 2),
        ("cpu", False, {}, 1),
        ("cuda", True, {}, 1),
        ("cuda", False, {"guarded": True}, 1),
        ("cuda", False, {"output_sentinel": True}, 1),
        ("cuda", False, {"watchdog_factor": 3.0}, 1),
        ("cuda", False, {"breaker_threshold": 2}, 1),
        ("cuda", False, {"deadline_aware": True}, 1),
        ("cuda", False, {"end_skip": False, "buckets": (8, 32)}, 2),
    ])
    def test_depth(self, device, inj, cfg, depth):
        assert self._depth(device, inj, **cfg) == depth

    def test_two_in_flight_serve_what_one_serves(self, monkeypatch):
        sizes = [1, 4, 2, 1, 3, 2, 2, 4, 1]
        xs = [_images(r, seed=40 + i) for i, r in enumerate(sizes)]
        one = _engine()
        want = one.serve(xs)
        two = _engine()
        monkeypatch.setattr(two, "_depth", lambda inj: 2)
        ids = two.submit_many(xs)
        t0 = time.perf_counter()
        done = two.drain()
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        got = [two.results[i] for i in ids]
        assert [r.id for r in done] == ids  # completion order is FIFO
        for a, b in zip(want, got):
            assert b.ok and (a.rows, a.bucket) == (b.rows, b.bucket)
            assert np.array_equal(a.logits, b.logits)
        walls = sum(st.wall_ms for st in two._stats.values())
        assert walls <= elapsed_ms
        assert two.summary()["buckets"] == [
            {**row, "p50_ms": row2["p50_ms"], "p95_ms": row2["p95_ms"],
             "imgs_per_s": row2["imgs_per_s"]}
            for row, row2 in zip(one.summary()["buckets"],
                                 two.summary()["buckets"])
        ]

    @pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
    def test_staged_rows_equal_the_padded_concatenation(self, dtype):
        eng = _engine()
        xs = [(_images(r, seed=r) * 10).astype(dtype) for r in (1, 2)]
        batch = [Request(id=i, x=x, rows=x.shape[0], enqueue_s=0.0)
                 for i, x in enumerate(xs)]
        host = eng._padded(batch, 4)
        want = pad_to_bucket(np.concatenate(xs), 4).astype(np.float32)
        assert host.dtype == torch.float32
        assert np.array_equal(host.numpy(), want)


# ---------------------------------------------------------------------------
# admission order / fairness
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_results_in_submission_order(self):
        eng = _engine()
        sizes = [1, 4, 2, 1, 3]
        results = eng.serve([_images(r, seed=r) for r in sizes])
        assert [r.rows for r in results] == sizes
        assert [r.id for r in results] == sorted(r.id for r in results)
        assert all(r.ok for r in results)

    def test_large_request_not_starved(self):
        eng = _engine()
        eng.submit_many([_images(4, seed=0)] + [_images(1, seed=i)
                                                for i in range(1, 5)])
        first = eng._form_batch()
        assert [r.rows for r in first] == [4]

    @given(st.lists(st.integers(min_value=1, max_value=4), min_size=1,
                    max_size=12))
    @settings(max_examples=25, deadline=None)
    def test_packing_properties_and_reference_batches(self, sizes):
        """FIFO packing invariants (admission order kept, each batch fits
        the largest bucket, each batch the greedy prefix), and the same
        batches as the reference engine's ``_form_batch``."""
        eng, ref = _engine(), _ref_engine()
        for i, r in enumerate(sizes):
            eng.queue.append(
                Request(id=i, x=np.zeros((r, 1, 1, 1)), rows=r, enqueue_s=0.0)
            )
            ref.queue.append(jserve.Request(
                id=i, x=np.zeros((r, 1, 1, 1)), rows=r, enqueue_s=0.0
            ))
        limit = max(eng.config.buckets)
        seen = []
        while True:
            batch, jbatch = eng._form_batch(), ref._form_batch()
            if batch is None:
                assert jbatch is None
                break
            assert [r.id for r in batch] == [r.id for r in jbatch]
            rows = sum(r.rows for r in batch)
            assert rows <= limit
            if eng.queue:
                assert rows + eng.queue[0].rows > limit
            seen.extend(r.id for r in batch)
        assert seen == list(range(len(sizes)))


# ---------------------------------------------------------------------------
# rejection path
# ---------------------------------------------------------------------------


class TestRejection:
    def test_nonfinite_request_rejected_not_raised(self):
        eng = _engine()
        bad = _images(1)
        bad[0, 0, 0, 0] = np.nan
        rid = eng.submit(bad)
        res = eng.results[rid]
        assert not res.ok and isinstance(res.error, NumericError)
        assert not eng.queue

    def test_bad_shape_and_oversize_rejected(self):
        eng = _engine()
        r1 = eng.results[eng.submit(np.zeros((1, 8, 8, 1), np.float32))]
        assert isinstance(r1.error, PreflightError)
        r2 = eng.results[eng.submit(_images(5))]
        assert isinstance(r2.error, PreflightError)
        assert eng.rejected == 2

    def test_device_tensor_rejected_without_device_work(self):
        """Admission is host-only: a request that lives on a device (here
        the meta device, which holds no data) is rejected typed."""
        eng = _engine()
        x = torch.empty((1, 32, 32, 1), device="meta")
        res = eng.results[eng.submit(x)]
        assert isinstance(res.error, PreflightError)
        assert res.error.context["field"] == "device"
        assert not eng.queue and eng.rejected == 1

    def test_cpu_tensor_request_accepted(self):
        eng = _engine()
        x = _images(2, seed=3)
        (res,) = eng.serve([torch.from_numpy(x)])
        (want,) = _engine().serve([x])
        assert res.ok and np.array_equal(res.logits, want.logits)

    def test_rejection_does_not_stall_queue(self):
        eng = _engine()
        good1 = eng.submit(_images(1, seed=1))
        bad = _images(1)
        bad[0] = np.inf
        bad_id = eng.submit(bad)
        good2 = eng.submit(_images(1, seed=2))
        eng.drain()
        assert eng.results[good1].ok and eng.results[good2].ok
        assert not eng.results[bad_id].ok
        summary = eng.summary()
        assert summary["completed"] == 2 and summary["rejected"] == 1

    def test_queue_backpressure(self):
        eng = _engine(max_queue=1)
        eng.submit(_images(1))
        res = eng.results[eng.submit(_images(1))]
        assert isinstance(res.error, PreflightError)
        eng.drain()
        assert eng.results[0].ok


# ---------------------------------------------------------------------------
# plan + compile cache accounting
# ---------------------------------------------------------------------------


class TestPlanCache:
    def test_second_wave_zero_replans_zero_retraces(self):
        clear_partition_cache()
        runner.clear_compiled_cache()
        eng = _engine()
        wave = [[_images(r, seed=r)] for r in (1, 2, 3)]
        for w in wave:
            eng.serve(w)
        part1 = partition_cache_info()
        traces1 = runner.jit_trace_count()
        misses1 = eng.cache_counters["misses"]
        assert misses1 == 3  # buckets 1, 2, 4 (3 rounds up)

        for w in wave:
            eng.serve([x.copy() for x in w])
        part2 = partition_cache_info()
        assert eng.cache_counters["misses"] == misses1  # zero replans
        assert eng.cache_counters["hits"] >= 3
        assert part2.misses == part1.misses
        assert runner.jit_trace_count() == traces1  # zero recompiles

    def test_second_engine_reuses_partition_and_compiled_caches(self):
        """Plan reuse crosses engine instances: the memoized auto_partition
        returns the same plan object, and f32 prepared params are the
        master tensors themselves, so the compiled key hits."""
        eng1 = _engine()
        eng1.serve([_images(2, seed=0)])
        part = partition_cache_info()
        traces = runner.jit_trace_count()
        eng2 = _engine()
        eng2.serve([_images(2, seed=9)])
        assert partition_cache_info().hits == part.hits + 1
        assert partition_cache_info().misses == part.misses
        assert runner.jit_trace_count() == traces

    def test_eviction_counter(self):
        eng = _engine(plan_cache_size=1, buckets=(1, 2))
        eng.serve([_images(1, seed=0)])
        eng.serve([_images(2, seed=1)])  # evicts bucket-1 entry
        eng.serve([_images(1, seed=2)])  # evicts bucket-2 entry
        info = eng.cache_info()
        assert info["evictions"] == 2
        assert info["currsize"] == 1
        assert info["misses"] == 3

    def test_partition_cache_info_has_eviction_field(self):
        clear_partition_cache()
        info = partition_cache_info()
        assert info.evictions == 0
        auto_partition(GRAPH)
        assert partition_cache_info().evictions == 0
        clear_partition_cache()
        assert partition_cache_info() == partition_cache_info()._replace(
            hits=0, misses=0, evictions=0, currsize=0
        )


class TestJitRetrace:
    def test_distinct_batch_sizes_retrace_same_plan(self):
        """One plan, two batch sizes: two traces — then replaying either
        shape adds none (the reference's expected 2, then 0)."""
        plan = auto_partition(GRAPH, batch=1)
        prepared = prepare_network_params(plan, PARAMS)
        runner.clear_compiled_cache()
        runner.reset_jit_trace_count()
        for rows in (3, 5, 3, 5):
            _run(_images(rows), prepared, plan)
        assert runner.jit_trace_count() == 2
        runner.reset_jit_trace_count()
        _run(_images(3), prepared, plan)
        assert runner.jit_trace_count() == 0  # reset counts, cache survives

    def test_key_holds_dtype_end_skip_and_params(self):
        """The compiled key is (plan, shape, dtype, end_skip, the params'
        tensors): a change of any of them is a new trace."""
        plan = auto_partition(GRAPH, batch=2)
        prepared = prepare_network_params(plan, PARAMS)
        x = torch.from_numpy(_images(2, seed=1))
        runner.clear_compiled_cache()
        runner.reset_jit_trace_count()
        run_network(x, prepared, plan=plan)
        run_network(x, dict(prepared), plan=plan)  # same tensors
        assert runner.jit_trace_count() == 1
        run_network(x, prepared, plan=plan, end_skip=False)
        run_network(x.double(), prepared, plan=plan)
        other = {k: tuple(t.clone() for t in v) for k, v in prepared.items()}
        run_network(x, other, plan=plan)
        assert runner.jit_trace_count() == 4

    def test_entry_dies_with_its_params(self):
        """The compiled cache holds its params weakly: once the caller's
        params are gone, so is the entry (on a card, its graph and pool),
        and a new tensor that reuses a dead one's id cannot hit it."""
        import gc

        plan = auto_partition(GRAPH, batch=2)
        prepared = prepare_network_params(plan, PARAMS)
        other = {k: tuple(t.clone() for t in v) for k, v in prepared.items()}
        x = torch.from_numpy(_images(2, seed=1))
        runner.clear_compiled_cache()
        runner.reset_jit_trace_count()
        run_network(x, prepared, plan=plan)
        run_network(x, other, plan=plan)
        assert runner.compiled_cache_info()["currsize"] == 2
        del other
        gc.collect()
        assert runner.compiled_cache_info()["currsize"] == 1
        run_network(x, prepared, plan=plan)
        assert runner.jit_trace_count() == 2  # the live entry still hits

    def test_lru_bounds_the_compiled_cache(self, monkeypatch):
        monkeypatch.setattr(runner, "COMPILED_CACHE_SIZE", 2)
        plan = auto_partition(GRAPH, batch=1)
        prepared = prepare_network_params(plan, PARAMS)
        runner.clear_compiled_cache()
        runner.reset_jit_trace_count()
        for rows in (1, 2, 3, 1):
            _run(_images(rows), prepared, plan)
        info = runner.compiled_cache_info()
        assert info == {"currsize": 2, "maxsize": 2}
        assert runner.jit_trace_count() == 4  # rows=1 was evicted by 3


# ---------------------------------------------------------------------------
# SLO / summary / renderer
# ---------------------------------------------------------------------------


class TestSummary:
    def test_bucket_rows_publish_slo_and_measured(self, ref_serving):
        eng = _engine(budget=REFERENCE_BUDGET)
        eng.serve([_images(r, seed=r) for r in (1, 2, 4)])
        summary = eng.summary()
        assert summary["model"] == "lenet"
        assert summary["buckets"], "no bucket rows"
        for row in summary["buckets"]:
            assert row["slo_us"] > 0
            assert row["steady_us"] > 0
            assert row["steady_us"] <= row["slo_us"]
            assert row["p50_ms"] > 0 and row["p95_ms"] >= row["p50_ms"]
            assert row["imgs_per_s"] > 0
            assert row["modeled_cycles"] > 0
        assert summary["cache"]["serve"]["misses"] == len(summary["buckets"])
        # the reference engine's summary of the same stream: the same keys
        # at every level, the same counts and modeled columns
        ref = _ref_engine()
        ref.serve([_images(r, seed=r) for r in (1, 2, 4)])
        jsum = ref.summary()
        assert _keys(summary) == _keys(jsum)
        measured = ("p50_ms", "p95_ms", "imgs_per_s")
        assert [{k: v for k, v in r.items() if k not in measured}
                for r in summary["buckets"]] == [
            {k: v for k, v in r.items() if k not in measured}
            for r in jsum["buckets"]]
        assert summary["resilience"] == jsum["resilience"]
        assert summary["cache"]["serve"] == jsum["cache"]["serve"]

    def test_slo_scales_with_bucket(self):
        eng = _engine()
        e1, e4 = eng._entry(1), eng._entry(4)
        assert e4.compute_cycles > e1.compute_cycles
        assert e4.staging_cycles > e1.staging_cycles
        assert e4.slo_us > e1.slo_us

    def test_serve_table_renders(self):
        eng = _engine()
        eng.serve([_images(2, seed=0)])
        summary = eng.summary()
        summary["waves"] = [
            {"serve_hits": 0, "serve_misses": 1, "partition_hits": 0,
             "partition_misses": 1, "jit_traces": 1, "wall_s": 0.5},
        ]
        lines = []
        serve_table(summary, out=lines.append)
        text = "\n".join(lines)
        assert "slo_us" in text and "p50_ms" in text
        assert "wave 1" in text and "jit traces" in text

    def test_guarded_engine_completes(self):
        eng = _engine(guarded=True)
        res = eng.serve([_images(1, seed=3)])
        assert all(r.ok for r in res)
        ref = _engine().serve([_images(1, seed=3)])
        np.testing.assert_allclose(res[0].logits, ref[0].logits,
                                   atol=LOGIT_ATOL)


def _keys(d):
    """The nested key structure of a summary (lists by their rows)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(v) for v in d]
    return None


SUMMARIES = {
    "plain": dict(
        model="lenet", compute_dtype="float32", guarded=False, completed=7,
        rejected=1, images=12, imgs_per_s=1234.5,
        buckets=[
            dict(bucket=1, batches=2, requests=2, images=2, p50_ms=1.5,
                 p95_ms=2.25, imgs_per_s=800.0, slo_us=15.0, steady_us=10.2,
                 modeled_cycles=1500, staging_cycles=512, launches=1,
                 hbm_bytes=4096),
            dict(bucket=4, batches=3, requests=5, images=10, p50_ms=3.0,
                 p95_ms=4.5, imgs_per_s=1500.0),
        ],
        cache=dict(serve=dict(hits=3, misses=2, evictions=1, currsize=1,
                              maxsize=1),
                   partition=dict(hits=1, misses=2, evictions=0, currsize=2,
                                  maxsize=128),
                   jit_traces=2),
        resilience=dict(shed=0, expired=0, failed=0, watchdog_trips=0,
                        sentinel_trips=0, stalls=0, breakers={}),
    ),
}
SUMMARIES["resilient"] = dict(
    SUMMARIES["plain"], guarded=True,
    resilience=dict(
        shed=2, expired=1, failed=0, watchdog_trips=1, sentinel_trips=0,
        stalls=3,
        breakers={
            "4": dict(state="open", failures=1, threshold=1,
                      pinned_rung="reference", opens=1, transitions=1),
            "1": dict(state="closed", failures=0, threshold=1,
                      pinned_rung=None, opens=0, transitions=0),
        }),
    waves=[
        {"serve_hits": 0, "serve_misses": 2, "partition_hits": 0,
         "partition_misses": 2, "jit_traces": 2, "wall_s": 0.513},
        {"serve_hits": 6, "serve_misses": 0, "partition_hits": 0,
         "partition_misses": 0, "jit_traces": 0, "wall_s": 0.042},
    ],
)
SUMMARIES["quiet_resilience"] = dict(
    SUMMARIES["plain"],
    resilience=dict(SUMMARIES["plain"]["resilience"], breakers={
        "2": dict(state="closed", failures=0, threshold=2, pinned_rung=None,
                  opens=1, transitions=3)}),
)


@pytest.mark.parametrize("name", sorted(SUMMARIES))
def test_serve_table_lines_equal_the_reference(name):
    ours, theirs = [], []
    serve_table(SUMMARIES[name], out=ours.append)
    jexplain.serve_table(SUMMARIES[name], out=theirs.append)
    assert ours == theirs


def test_serve_table_of_a_served_engine_equals_the_reference():
    eng = _engine(breaker_threshold=1)
    eng.serve([_images(r, seed=r) for r in (1, 3)])
    summary = eng.summary()
    ours, theirs = [], []
    serve_table(summary, out=ours.append)
    jexplain.serve_table(summary, out=theirs.append)
    assert ours == theirs and len(ours) >= 4


# ---------------------------------------------------------------------------
# each bucket's plan cache entry against the reference engine's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(SIDES))
def test_bucket_entries_equal_the_references(model, dtype):
    jg, jp, g, tp = (_side(model) if model != "lenet"
                     else (JGRAPH, JPARAMS, GRAPH, PARAMS))
    eng = ServingEngine(g, tp, ServeConfig(buckets=(1, 2, 4),
                                           compute_dtype=dtype,
                                           budget=REFERENCE_BUDGET),
                        device="cpu")
    ref = _ref_engine(jg, jp, compute_dtype=dtype)
    assert eng.compute_dtype == ref.compute_dtype == dtype
    for bucket in (1, 2, 4):
        e, je = eng._entry(bucket), ref._entry(bucket)
        assert _plan_fields(e.plan) == dataclasses.asdict(je.plan)
        assert (e.compute_cycles, e.staging_cycles) == (
            je.compute_cycles, je.staging_cycles)
        assert (e.slo_us, e.steady_us) == (je.slo_us, je.steady_us)
        assert sorted(e.prepared) == sorted(je.prepared)


@pytest.mark.parametrize("model", sorted(SIDES))
def test_served_logits_match_the_reference_network(model):
    """Every request of a mixed stream, served through buckets 1, 2 and 4,
    against the reference's reference_network on its own rows."""
    jg, jp, g, tp = (_side(model) if model != "lenet"
                     else (JGRAPH, JPARAMS, GRAPH, PARAMS))
    eng = ServingEngine(g, tp, ServeConfig(buckets=(1, 2, 4)), device="cpu")
    xs = [_images(r, seed=10 + i, graph=g) for i, r in enumerate((1, 3, 2, 4))]
    results = eng.serve(xs[:1]) + eng.serve(xs[1:3]) + eng.serve(xs[3:])
    assert sorted({r.bucket for r in results}) == [1, 2, 4]
    for x, res in zip(xs, results):
        assert res.ok and res.logits.shape == (x.shape[0], 10)
        want = np.asarray(jrunner.reference_network(jnp.asarray(x), jg, jp))
        np.testing.assert_allclose(res.logits, want, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# batch-aware costing + serving cost model
# ---------------------------------------------------------------------------


class TestBatchAwareCosting:
    def test_plan_launch_accepts_batch(self):
        from repro_torch.core.cnn_models import LENET5_FUSION
        from repro_torch.core.program import plan_launch

        p1 = plan_launch(LENET5_FUSION)
        p8 = plan_launch(LENET5_FUSION, batch=8)
        assert p1.regime == p8.regime
        assert p8.modeled_cycles(8) == 8 * p8.modeled_cycles(1)

    def test_modeled_us_matches_cycles(self):
        from repro_torch.core.cycle_model import DEFAULT_PARAMS

        plan = auto_partition(GRAPH, batch=4)
        lp = plan.pyramids[0].launch
        assert lp.modeled_us(4) == pytest.approx(
            lp.modeled_cycles(4) / DEFAULT_PARAMS.freq_mhz
        )
        assert plan.modeled_us() == pytest.approx(
            plan.modeled_cycles() / DEFAULT_PARAMS.freq_mhz
        )

    def test_partition_shifts_with_batch(self):
        g = MODELS["resnet18"]()
        p1 = auto_partition(g, batch=1, budget=REFERENCE_BUDGET)
        p8 = auto_partition(g, batch=8, budget=REFERENCE_BUDGET)
        assert [p.launch.regime for p in p1.pyramids] != [
            p.launch.regime for p in p8.pyramids
        ]


class TestServeCycleModel:
    def test_host_staging_cycles_ceil(self):
        assert tcm.HOST_BYTES_PER_CYCLE == jcm.HOST_BYTES_PER_CYCLE
        assert tcm.host_staging_cycles(0) == 0
        assert tcm.host_staging_cycles(1) == 1
        assert tcm.host_staging_cycles(tcm.HOST_BYTES_PER_CYCLE) == 1
        assert tcm.host_staging_cycles(tcm.HOST_BYTES_PER_CYCLE + 1) == 2

    def test_serve_stream_cycles_shapes(self):
        c, s = 100, 30
        f = tcm.serve_stream_cycles
        assert f(0, c, s, double_buffered=True) == 0
        assert f(1, c, s, double_buffered=True) == c + s
        assert f(3, c, s, double_buffered=False) == 3 * (c + s)
        assert f(3, c, s, double_buffered=True) == s + c + 2 * max(c, s)

    @given(st.integers(1, 32), st.integers(1, 10**6), st.integers(1, 10**6))
    @settings(max_examples=50, deadline=None)
    def test_double_buffering_never_worse(self, batches, compute, staging):
        db = tcm.serve_stream_cycles(batches, compute, staging,
                                     double_buffered=True)
        serial = tcm.serve_stream_cycles(batches, compute, staging,
                                         double_buffered=False)
        assert db <= serial
        assert db >= batches * max(compute, staging)


@given(st.integers(0, 2**40))
@settings(max_examples=100, deadline=None)
def test_host_staging_cycles_equal_the_reference(nbytes):
    assert tcm.host_staging_cycles(nbytes) == jcm.host_staging_cycles(nbytes)


@given(st.integers(-3, 64), st.integers(0, 10**9), st.integers(0, 10**9),
       st.booleans())
@settings(max_examples=200, deadline=None)
def test_serve_stream_cycles_equal_the_reference(batches, compute, staging,
                                                 double_buffered):
    assert tcm.serve_stream_cycles(
        batches, compute, staging, double_buffered=double_buffered
    ) == jcm.serve_stream_cycles(
        batches, compute, staging, double_buffered=double_buffered
    )


@given(st.integers(-3, 64), st.integers(0, 10**9), st.integers(0, 10**9))
@settings(max_examples=200, deadline=None)
def test_queue_delay_cycles_equal_the_reference(batches, compute, staging):
    assert tcm.queue_delay_cycles(batches, compute, staging) == (
        jcm.queue_delay_cycles(batches, compute, staging))


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------


def test_cli_dry_stream_two_waves_on_the_cpu(capsys, tmp_path):
    from repro_torch.net import serve as tserve

    out = tmp_path / "summary.json"
    rc = tserve.main(["--model", "lenet", "--requests", "8", "--buckets",
                      "1,2,4", "--dry-stream", "--device", "cpu",
                      "--json", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "wave 2: +0 plans, +0 jit traces" in text
    import json

    summary = json.loads(out.read_text())
    assert summary["submitted"] == summary["terminal"] == 16
    assert summary["completed"] == 16
    assert summary["waves"][1]["serve_misses"] == 0
