"""Host spans of the serving path (``repro_torch.obs.trace.HostSpan``).

Under ``tracing()`` the serving engine's drain loop, its admission and the
front end's wait record host spans that carry their batch's sequence
number; ``run_network`` keeps its compiled route (per-launch spans, and
a span per residual join, only with ``tracing(launches=True)``); the
``auto_partition`` event and the ``runner.replay`` span carry the plan's
fused convs and joins, which the reports list; the default tracer builds
no span; and
the benchmark's ``cardbench.program_trace.profiler_offset_us`` maps a
span of a thread the profiler does not record onto the profiler's
timeline.  All on the CPU, with no timing thresholds: every check is an
order, a count or an identity.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cardbench.program_trace import profiler_offset_us
from repro_torch.net import runner
from repro_torch.net.frontend import ServingFrontend
from repro_torch.net.graph import (
    MODELS,
    infer_shapes,
    join_bytes,
    residual_joins,
)
from repro_torch.net.partition import auto_partition
from repro_torch.net.runner import (
    init_network_params,
    prepare_network_params,
    run_network,
)
from repro_torch.net.serve import ServeConfig, ServingEngine
from repro_torch.obs import trace
from repro_torch.obs.trace import NULL_TRACER, get_tracer, tracing

GRAPH = MODELS["lenet"]()
PARAMS = init_network_params(GRAPH, seed=0, device="cpu")
# the drain loop's spans on the CPU (no pinning, no device to wait on)
CPU_STAGES = ("serve.form", "serve.pad", "serve.h2d", "serve.dispatch",
              "serve.record")
WAIT_S = 60.0


def _images(rows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (rows, GRAPH.input_size, GRAPH.input_size, GRAPH.in_channels)
    ).astype(np.float32)


def _engine(**cfg) -> ServingEngine:
    return ServingEngine(GRAPH, PARAMS, ServeConfig(buckets=(1, 2, 4), **cfg),
                         device="cpu")


def _by_batch(spans) -> dict:
    out: dict = {}
    for s in spans:
        if s.batch is not None and s.thread is not None:
            out.setdefault(s.batch, []).append(s)
    return out


def _check_drain_spans(col, stages) -> dict:
    """Per batch: each stage span once, in pipeline order; the drain
    thread's stage spans never overlap; every request span names a batch
    whose spans exist, its dispatch stamp inside the request."""
    batches = _by_batch(s for s in col.host_spans if s.name in stages)
    assert batches
    for seq, spans in batches.items():
        names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
        assert names == list(stages), (seq, names)
    drain = sorted((s for s in col.host_spans if s.name in stages
                    or s.name in ("serve.sync", "frontend.wait")),
                   key=lambda s: s.start_ns)
    assert len({s.thread for s in drain}) == 1
    for a, b in zip(drain, drain[1:]):
        assert a.start_ns <= a.end_ns <= b.start_ns, (a, b)
    requests = [s for s in col.host_spans if s.name == "serve.request"]
    assert requests
    for r in requests:
        assert r.batch in batches and r.thread is None
        dispatch = {s.name: s for s in batches[r.batch]}["serve.dispatch"]
        assert r.dispatch_ns == dispatch.start_ns
        assert r.start_ns <= r.dispatch_ns <= r.end_ns
    return batches


def test_drain_records_each_stage_span_once_a_batch():
    eng = _engine()
    with tracing() as col:
        ids = [eng.submit(_images(2, seed=s)) for s in range(6)]
        eng.drain()
    assert all(eng.results[i].ok for i in ids)
    batches = _check_drain_spans(col, CPU_STAGES)
    assert sorted(batches) == [0, 1, 2]  # 6 requests of 2 rows, bucket 4
    admits = [s for s in col.host_spans if s.name == "serve.admit"]
    assert [s.request for s in admits] == ids
    requests = {s.request: s for s in col.host_spans
                if s.name == "serve.request"}
    assert sorted(requests) == ids
    for s in admits:
        # the request's span starts inside its admission
        assert s.start_ns <= requests[s.request].start_ns <= s.end_ns
    # one empty formation ends the drain; it names no batch
    empty = [s for s in col.host_spans
             if s.name == "serve.form" and s.batch is None]
    assert len(empty) == 1
    assert not col.spans  # no launch span without the explicit request


def test_two_batches_in_flight_dispatch_ahead(monkeypatch):
    """With two batches in flight (a card's default, forced here) each
    batch's stage spans keep their order and the drain thread's spans still
    never overlap, and batch n+1 is dispatched before batch n's results
    are recorded."""
    eng = _engine()
    monkeypatch.setattr(eng, "_depth", lambda inj: 2)
    with tracing() as col:
        ids = [eng.submit(_images(2, seed=s)) for s in range(8)]
        eng.drain()
    assert all(eng.results[i].ok for i in ids)
    batches = _check_drain_spans(col, CPU_STAGES)
    assert sorted(batches) == [0, 1, 2, 3]
    span = {(s.name, s.batch): s for s in col.host_spans}
    for n in range(3):
        assert (span[("serve.dispatch", n + 1)].end_ns
                <= span[("serve.record", n)].start_ns)

def test_sentinel_is_a_span_of_its_batch():
    eng = _engine(output_sentinel=True)
    with tracing() as col:
        eng.serve([_images(4, seed=s) for s in range(2)])
    stages = CPU_STAGES[:-1] + ("serve.sentinel", "serve.record")
    assert sorted(_check_drain_spans(col, stages)) == [0, 1]


def test_a_staging_fault_closes_its_span_and_fails_its_requests():
    from repro_torch.robust.faults import FaultInjector, inject

    eng = _engine()
    inj = FaultInjector(seed=0)
    inj.raise_at("stage", times=1, message="injected staging failure")
    with tracing() as col, inject(injector=inj):
        res = eng.serve([_images(4, seed=s) for s in range(2)])
    assert [r.ok for r in res] == [False, True]
    pads = [s for s in col.host_spans if s.name == "serve.pad"]
    assert [s.batch for s in pads] == [0, 1]
    (failed,) = [s for s in col.host_spans
                 if s.name == "serve.request" and s.request == res[0].id]
    assert failed.batch == 0 and failed.dispatch_ns is None
    assert not [s for s in col.host_spans
                if s.name in CPU_STAGES and s.parent is not None]


def test_frontend_drain_thread_spans_tile_its_loop():
    eng = _engine()
    with tracing() as col:
        with ServingFrontend(eng) as front:
            handles = [front.submit(_images(1, seed=s)) for s in range(8)]
            results = [h.result(WAIT_S) for h in handles]
    assert all(r.ok for r in results)
    _check_drain_spans(col, CPU_STAGES)
    caller = threading.get_native_id()
    waits = [s for s in col.host_spans if s.name == "frontend.wait"]
    assert waits and {s.thread for s in waits} != {caller}
    drain = {s.thread for s in col.host_spans if s.name == "serve.dispatch"}
    assert drain == {waits[0].thread}
    admits = [s for s in col.host_spans if s.name == "serve.admit"]
    assert [s.request for s in admits] == [h.id for h in handles]
    assert {s.thread for s in admits} == {caller}


def test_host_spans_nest_on_their_thread():
    col = trace.TraceCollector()
    outer = col.begin("outer", batch=3)
    inner = col.begin("inner")
    col.end(inner, request=7)
    col.end(outer)
    spans = {s.name: s for s in col.host_spans}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["outer"].parent is None
    assert (spans["inner"].request, spans["outer"].batch) == (7, 3)
    o, i = spans["outer"], spans["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    # a span an exception left open is dropped when its parent ends
    outer = col.begin("outer2")
    col.begin("abandoned")
    col.end(outer)
    after = col.begin("after")
    col.end(after)
    names = [s.name for s in col.host_spans]
    assert "abandoned" not in names
    assert col.host_spans[-1].parent is None


def test_replay_is_a_host_span_inside_dispatch():
    """``_Compiled.replay`` (the card's route) records ``runner.replay``
    under the span open around it; a stand-in graph replays here."""
    replays = []
    entry = runner._Compiled(
        keep=(), graph=SimpleNamespace(replay=lambda: replays.append(1)),
        static_x=torch.zeros(2, 3), logits=torch.ones(2, 4),
        skips={"p": torch.zeros(2, 1)}, launches={},
    )
    with tracing() as col:
        outer = col.begin("serve.dispatch", batch=0)
        logits, skips = entry.replay(torch.full((2, 3), 5.0))
        col.end(outer)
    assert replays == [1] and torch.equal(entry.static_x, torch.full((2, 3), 5.0))
    assert torch.equal(logits, torch.ones(2, 4)) and list(skips) == ["p"]
    spans = {s.name: s for s in col.host_spans}
    assert spans["runner.replay"].parent == spans["serve.dispatch"].id


def _lenet_plan():
    graph = MODELS["lenet"](input_size=32, num_classes=10)
    plan = auto_partition(graph, batch=2)
    params = prepare_network_params(
        plan, init_network_params(graph, seed=1, device="cpu")
    )
    x = torch.randn((2, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    return plan, params, x


def test_traced_run_network_takes_the_compiled_route():
    plan, params, x = _lenet_plan()
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    base, _ = run_network(x, params, plan=plan)
    run_network(x, params, plan=plan)
    untraced = runner.jit_trace_count()
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    with tracing() as col:
        for _ in range(2):
            logits, _ = run_network(x, params, plan=plan)
    assert runner.jit_trace_count() == untraced == 1
    assert torch.equal(logits, base)
    assert not col.spans
    assert "run_network" not in [e.name for e in col.events]


def test_launch_spans_only_when_asked_for():
    plan, params, x = _lenet_plan()
    runner.clear_compiled_cache()
    runner.reset_jit_trace_count()
    with tracing(launches=True) as col:
        run_network(x, params, plan=plan)
    assert runner.jit_trace_count() == 0  # the eager route counts no trace
    assert [s.name for s in col.spans] == [p.name for p in plan.pyramids]
    names = [e.name for e in col.events]
    assert names.count("end_skip_counts") == plan.n_launches()
    assert names[-1] == "run_network"
    assert get_tracer() is NULL_TRACER


def test_null_tracer_builds_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was built with tracing off")

    monkeypatch.setattr(trace, "HostSpan", refuse)
    monkeypatch.setattr(trace, "_Open", refuse)
    monkeypatch.setattr(trace.TraceCollector, "begin", refuse)
    assert get_tracer() is NULL_TRACER
    eng = _engine(output_sentinel=True)
    with ServingFrontend(eng) as front:
        handles = [front.submit(_images(2, seed=s)) for s in range(4)]
        assert all(h.result(WAIT_S).ok for h in handles)
    res = eng.serve([_images(4, seed=9)])
    assert res[0].ok


def test_profiled_thread_maps_a_span_of_an_unprofiled_one():
    """A host span recorded on a thread started before the profiler has no
    profiler twin; the offset read from the profiled thread's pairs puts
    it between the two markers that bracket it (ordered by events)."""
    from torch.profiler import ProfilerActivity, profile

    go, done = threading.Event(), threading.Event()
    with tracing() as col:

        def worker():
            go.wait(WAIT_S)
            span = col.begin("worker.span")
            sum(range(10_000))
            col.end(span)
            done.set()

        t = threading.Thread(target=worker)
        t.start()
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        a = col.begin("marker.a")
        col.end(a)
        go.set()
        assert done.wait(WAIT_S)
        b = col.begin("marker.b")
        col.end(b)
        prof.stop()
        t.join(WAIT_S)
    assert not t.is_alive()
    events = prof.events()
    names = {e.name for e in events}
    assert {"marker.a", "marker.b"} <= names and "worker.span" not in names
    offset = profiler_offset_us(events, col.host_spans)
    assert offset is not None
    marks = {e.name: e.time_range for e in events if e.name.startswith("marker")}
    w = {s.name: s for s in col.host_spans}["worker.span"]
    start, end = w.start_ns / 1e3 + offset, w.end_ns / 1e3 + offset
    assert marks["marker.a"].end - 1e3 <= start <= end
    assert end <= marks["marker.b"].start + 1e3


def _event(name, start_us, device="CPU"):
    return SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}",
        time_range=SimpleNamespace(start=start_us, end=start_us + 5.0),
    )


@pytest.mark.parametrize("offset_us", [-1.7e9, 0.0, 123_456.789])
def test_offset_from_mirrored_pairs(offset_us):
    """Twins share one start difference (plus a microsecond of jitter);
    spans before the profiler started and spans of an unprofiled thread,
    interleaved with the twins, take no part."""
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.uniform(20.0, 900.0, 400)) + 1e9  # us
    spans, events = [], []
    for i, t in enumerate(starts):
        spans.append(SimpleNamespace(name="serve.admit",
                                     start_ns=int(t * 1e3)))
        spans.append(SimpleNamespace(  # another thread's: no twin
            name="serve.admit",
            start_ns=int((t + rng.uniform(-300.0, 300.0)) * 1e3)))
        spans.append(SimpleNamespace(name="serve.pad",  # never profiled
                                     start_ns=int((t + 3.0) * 1e3)))
        if i >= 40:  # the profiler started late
            jitter = rng.uniform(-1.0, 1.0)
            events.append(_event("serve.admit", t + offset_us + jitter))
    events.append(_event("serve.admit", starts[50] + offset_us, "CUDA"))
    events.append(_event("cardbench.window", starts[40] + offset_us))
    got = profiler_offset_us(events, spans)
    assert got == pytest.approx(offset_us, abs=1.0)
    assert profiler_offset_us(events[:0], spans) is None


# ---------------------------------------------------------------------------
# residual joins and fused-level counts (ResNet-50 at 32 x 32)
# ---------------------------------------------------------------------------


def _resnet50_plan(batch=2):
    graph = MODELS["resnet50"](input_size=32, num_classes=10)
    plan = auto_partition(graph, batch=batch)
    params = prepare_network_params(
        plan, init_network_params(graph, seed=3, device="cpu")
    )
    x = torch.randn((batch, 32, 32, 3),
                    generator=torch.Generator().manual_seed(4))
    return plan, params, x


def test_join_spans_time_each_residual_join():
    """Under ``tracing(launches=True)`` each add and the relu after it is
    one join span, named by its add, in graph order, with the bytes the
    pair moves; the forward's logits are the untraced ones."""
    plan, params, x = _resnet50_plan()
    runner.clear_compiled_cache()
    base, _ = run_network(x, params, plan=plan)
    with tracing(launches=True) as col:
        logits, _ = run_network(x, params, plan=plan)
    assert torch.equal(logits, base)
    adds = [n.name for n in plan.graph.nodes if n.op == "add"]
    assert [s.name for s in col.join_spans] == adds and len(adds) == 16
    shapes = infer_shapes(plan.graph)
    for s in col.join_spans:
        m = shapes[s.name]
        # add: two maps in, one out; relu: one in, one out; float32
        assert s.hbm_bytes == 2 * m.size ** 2 * m.channels * 4 * 5
        assert s.kind == "join" and s.device == "cpu" and s.batch == 2
        assert s.model == "resnet50" and s.duration_ms >= 0
    assert [s.start_s for s in col.join_spans] == sorted(
        s.start_s for s in col.join_spans)
    assert len(col.spans) == plan.n_launches()
    event = [e for e in col.events if e.name == "run_network"][-1]
    assert event.args["joins"] == 16 and event.args["launches"] == len(
        col.spans)


def test_join_bytes_without_a_relu():
    g = MODELS["resnet18"](input_size=32, num_classes=10)
    assert residual_joins(g)[0] == ("b0_add", "b0_relu")
    m = infer_shapes(g)["b0_add"]
    one = m.size ** 2 * m.channels
    assert join_bytes(g, "b0_add", None, 3, "bfloat16") == 3 * one * 2 * 3
    assert join_bytes(g, "b0_add", "b0_relu", 3, "float32") == 3 * one * 4 * 5
    assert residual_joins(MODELS["vgg16"](input_size=32)) == ()


def test_joins_are_timed_only_on_the_launch_route(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a join span was built")

    plan, params, x = _resnet50_plan()
    monkeypatch.setattr(runner, "JoinSpan", refuse)
    runner.clear_compiled_cache()
    run_network(x, params, plan=plan)
    with tracing() as col:
        run_network(x, params, plan=plan)
    assert not col.join_spans and not col.spans
    with pytest.raises(AssertionError, match="join span"):
        with tracing(launches=True):
            run_network(x, params, plan=plan)


def test_auto_partition_event_counts_fused_convs_and_joins():
    with tracing() as col:
        plan = auto_partition(MODELS["resnet50"](), batch=32)
        lenet = auto_partition(MODELS["lenet"](), batch=1)
    first, second = [e.args for e in col.events if e.name == "auto_partition"]
    assert (first["model"], first["launches"]) == ("resnet50", 43)
    assert first["fused_convs"] == plan.fused_convs() == 20
    assert first["joins"] == plan.joins() == 16
    assert second["joins"] == 0
    assert second["fused_convs"] == lenet.fused_convs() == sum(
        p.q_convs for p in lenet.pyramids if p.q_convs >= 2)


def test_replay_span_carries_the_plans_counts():
    plan = auto_partition(MODELS["resnet50"](), batch=32)
    entry = runner._Compiled(
        keep=(plan,), graph=SimpleNamespace(replay=lambda: None),
        static_x=torch.zeros(2, 3), logits=torch.ones(2, 4), skips={},
        launches={},
    )
    with tracing() as col:
        entry.replay(torch.ones(2, 3))
    (span,) = col.host_spans
    assert span.name == "runner.replay"
    assert span.args == {"fused_convs": 20, "joins": 16}


def test_reports_list_the_joins_beside_the_launches():
    from repro_torch.obs import explain, report

    plan, params, x = _resnet50_plan()
    with tracing(launches=True) as col:
        for _ in range(3):
            run_network(x, params, plan=plan)
    rows = report.join_rows_from_spans(col.join_spans)
    assert [r["join"] for r in rows] == [
        f"resnet50/b{i}_add" for i in range(16)]
    assert all(r["reps"] == 3 and r["batch"] == 2 for r in rows)
    lines = []
    report.format_joins(rows, lines.append, measured_on="cpu")
    assert lines[0].endswith("measured_ms: cpu") and len(lines) == 19
    assert lines[-1].startswith("joins: 16, ")
    report.format_joins([], lines.append)
    assert len(lines) == 19
    table = []
    explain.join_table(plan, table.append)
    assert len(table) == 18 and table[1].split()[:2] == ["b0_add", "b0_relu"]
    assert table[-1].startswith("joins: 16, ")
    assert "convs in launches of two or more" in table[-1]
    nothing = []
    explain.join_table(auto_partition(MODELS["lenet"]()), nothing.append)
    assert nothing == []
