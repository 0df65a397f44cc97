"""The port's observability layer against the reference's ``repro.obs``:
percentiles, timed stats, ``SpanTimer``, the cycle model's timeline twins
segment for segment, the Chrome trace event for event, the validator, the
drift rows (from spans and from the committed ``BENCH_pyramid.json``), the
``explain`` plan table line for line, and the ``explain`` CLI end to end on
the CPU."""

import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cycle_model import timeline_end as jtimeline_end  # noqa: E402
from repro.net.graph import MODELS as JMODELS  # noqa: E402
from repro.net.partition import auto_partition as jauto  # noqa: E402
from repro.obs import explain as jexplain  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import stats as jstats  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.obs.trace import LaunchSpan as JLaunchSpan  # noqa: E402
from repro_torch.core.cycle_model import timeline_end  # noqa: E402
from repro_torch.net.graph import MODELS  # noqa: E402
from repro_torch.net.partition import auto_partition  # noqa: E402
from repro_torch.net.runner import (  # noqa: E402
    init_network_params,
    prepare_network_params,
    run_network,
)
from repro_torch.obs import explain, report, stats, timeline  # noqa: E402
from repro_torch.obs.trace import LaunchSpan, SpanTimer, tracing  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DTYPES = ("float32", "bfloat16")


def _plans(model, dtype):
    """The port's and the reference's auto plan of one zoo model at its
    full (paper) size."""
    return (auto_partition(MODELS[model](), compute_dtype=dtype),
            jauto(JMODELS[model](), compute_dtype=dtype))


def _segs(segments):
    return [(s.lane, s.label, s.start, s.duration) for s in segments]


@pytest.mark.parametrize("q", [0.0, 25.0, 50.0, 95.0, 100.0])
@pytest.mark.parametrize("n", [1, 2, 7, 50])
def test_percentile_matches_reference(n, q):
    values = np.random.default_rng(n).standard_normal(n).tolist()
    assert stats.percentile(values, q) == jstats.percentile(values, q)
    assert stats.percentile(values, q) == pytest.approx(
        float(np.percentile(values, q))
    )


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 50.0)


def test_timed_stats_keys_and_ordering():
    calls = []
    got = stats.timed_stats_ms(lambda: calls.append(1), reps=7)
    assert set(got) == {"p50_ms", "p95_ms", "reps"} and got["reps"] == 7
    assert 0 <= got["p50_ms"] <= got["p95_ms"]
    assert len(calls) == 8  # one warm-up, then the timed reps


def test_span_timer_on_the_cpu():
    timer = SpanTimer(device=torch.device("cpu")).start()
    assert timer.start_s > 0
    time.sleep(0.01)
    assert timer.stop_ms() >= 10.0
    assert SpanTimer().start().stop_ms() >= 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_modeled_timelines_equal_the_reference(model, dtype):
    """Every launch of every zoo plan: the grid timeline (at two elision
    levels, and with the serial knobs) and the per-cell detail, segment for
    segment, each ending at the modeled cycles."""
    plan, jplan = _plans(model, dtype)
    assert len(plan.pyramids) == len(jplan.pyramids)
    for p, jp in zip(plan.pyramids, jplan.pyramids):
        serial = dataclasses.replace(p.launch, x_slots=1, w_slots=1)
        jserial = dataclasses.replace(jp.launch, x_slots=1, w_slots=1)
        for lp, jlp in ((p.launch, jp.launch), (serial, jserial)):
            for cells in (64, 4):
                segs = lp.modeled_timeline(max_cells=cells)
                assert _segs(segs) == _segs(
                    jlp.modeled_timeline(max_cells=cells)
                )
                assert timeline_end(segs) == lp.modeled_cycles()
                assert jtimeline_end(segs) == timeline_end(segs)
            detail = lp.body_detail_timeline()
            assert _segs(detail) == _segs(jlp.body_detail_timeline())
            assert timeline_end(detail) == lp.body_cycles()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_modeled_chrome_trace_equals_the_reference(model, dtype):
    plan, jplan = _plans(model, dtype)
    trace = timeline.chrome_trace(
        launches=[(p.name, p.launch) for p in plan.pyramids]
    )
    jtrace = jtimeline.chrome_trace(
        launches=[(p.name, p.launch) for p in jplan.pyramids]
    )
    assert timeline.validate_chrome_trace(trace) == []
    assert json.dumps(trace["traceEvents"]) == json.dumps(
        jtrace["traceEvents"]
    )
    assert trace["displayTimeUnit"] == jtrace["displayTimeUnit"]
    assert trace["otherData"]["freq_mhz"] == jtrace["otherData"]["freq_mhz"]


MALFORMED = [
    {"traceEvents": [{"ph": "Z"}]},
    {"traceEvents": "nope"},
    {"traceEvents": [{"ph": "X", "name": "s", "pid": 1, "tid": 0, "ts": -1,
                      "dur": 1}]},
    {"traceEvents": []},
    {"traceEvents": [{"ph": "M", "name": "m", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "i", "name": "e", "pid": 1.5, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "name": "s", "pid": 1, "tid": 0, "ts": 0,
                      "dur": 1, "args": {"x": object()}}]},
    [],
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_validator_rejects_the_malformed_cases(case):
    trace = MALFORMED[case]
    problems = timeline.validate_chrome_trace(trace)
    assert problems
    assert problems == jtimeline.validate_chrome_trace(trace)


def _span_fields(i, rep):
    return dict(
        name=f"P{i}", model="m", regime=("resident", "streamed_w2")[i % 2],
        out_region=4, alpha=2, q_convs=2, x_slots=2, w_slots=1, c_tiles=1,
        batch=1, compute_dtype="float32", streamed=bool(i % 2),
        hbm_bytes=1000 * (i + 1), vmem_bytes=500, modeled_cycles=100 * (i + 1),
        modeled_us=float(i + 1), start_s=float(10 * i + rep),
        duration_ms=0.5 + 0.25 * i * (rep + 1),
    )


def test_drift_rows_from_spans_equal_the_reference():
    fields = [_span_fields(i, rep) for i in range(4) for rep in range(3)]
    spans = [LaunchSpan(**f) for f in fields]
    jspans = [JLaunchSpan(**f) for f in fields]
    rows = report.drift_rows_from_spans(spans)
    assert rows == jreport.drift_rows_from_spans(jspans)
    assert len(rows) == 4 and all(r["reps"] == 3 for r in rows)
    assert report.drift_report(rows) == jreport.drift_report(rows)


def test_drift_rows_from_the_committed_bench_file_equal_the_reference():
    bench = json.loads((REPO / "BENCH_pyramid.json").read_text())
    rows = report.drift_rows_from_bench(bench)
    assert rows and rows == jreport.drift_rows_from_bench(bench)
    rep = report.drift_report(rows)
    assert rep == jreport.drift_report(rows) and rep["median_ratio"] > 0
    assert report.drift_rows_from_bench(
        {"workloads": {"old": {"wallclock_ms": 1.0}}}
    ) == []


def test_format_report_labels_each_time():
    lines = []
    rows = report.drift_rows_from_spans(
        [LaunchSpan(**_span_fields(i, 0)) for i in range(3)]
    )
    report.format_report(report.drift_report(rows), lines.append,
                         measured_on="NVIDIA H100 80GB HBM3")
    assert "cycle model at 100 MHz" in lines[0]
    assert lines[0].endswith("measured_ms: NVIDIA H100 80GB HBM3")
    jlines = []
    jreport.format_report(jreport.drift_report(rows), jlines.append)
    assert lines[1:] == jlines


@pytest.mark.parametrize("model", ["lenet", "vgg16", "resnet18"])
def test_plan_table_equals_the_reference(model):
    plan, jplan = _plans(model, "float32")
    lines, jlines = [], []
    explain.plan_table(plan, plan.vmem_budget, lines.append)
    jexplain.plan_table(jplan, jplan.vmem_budget, jlines.append)
    assert lines == jlines


def test_traced_cpu_run_names_its_device():
    graph = MODELS["lenet"](input_size=32, num_classes=10)
    plan = auto_partition(graph, batch=1)
    params = prepare_network_params(
        plan, init_network_params(graph, seed=0, device="cpu")
    )
    x = torch.randn((1, 32, 32, 1), generator=torch.Generator().manual_seed(1))
    with tracing() as col:
        run_network(x, params, plan=plan)
    assert [s.device for s in col.spans] == ["cpu"] * plan.n_launches()
    trace = timeline.chrome_trace(
        col, launches=[(p.name, p.launch) for p in plan.pyramids]
    )
    assert timeline.validate_chrome_trace(trace) == []
    procs = [e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "process_name"]
    assert "measured: cpu" in procs
    assert {e.get("cat") for e in trace["traceEvents"]} >= {
        "modeled", "measured", "event"}


def test_explain_runs_guarded_and_traced_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert explain.main([
        "--model", "resnet18", "--input-size", "32", "--device", "cpu",
        "--run", "--reps", "2", "--guard", "--trace", str(out),
    ]) == 0
    text = capsys.readouterr().out
    assert "total:" in text and "no fallbacks" in text
    assert "measured_ms: cpu" in text
    trace = json.loads(out.read_text())
    assert timeline.validate_chrome_trace(trace) == []
    assert any(e.get("cat") == "measured" for e in trace["traceEvents"])


def test_explain_squeeze_shows_the_replan_rung(capsys):
    assert explain.main([
        "--model", "lenet", "--device", "cpu", "--guard",
        "--squeeze", "0.002",
    ]) == 0
    text = capsys.readouterr().out
    assert "'replan': 1" in text and "degraded plan:" in text


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_explain_tables_render(model, dtype, capsys):
    assert explain.main(["--model", model, "--dtype", dtype]) == 0
    text = capsys.readouterr().out
    assert "total:" in text and "launches" in text
