"""The program's host spans read against a profiler trace
(``cardbench/program_trace.py``) and the entry that records them
(``cardbench/spans.py``)."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cardbench import harness, program_trace
from repro_torch.obs.trace import HostSpan

ROOT = Path(__file__).resolve().parents[2]
OFFSET_US = 5_000_123.25  # the profiler's clock minus the program's
DRAIN, CALLER = 11, 7  # thread ids


def _ev(name, start, end, device=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        cpu_parent=None,
    )


def _span(i, name, start_us, end_us, batch=None, thread=DRAIN):
    """A host span at profiler times ``start_us``..``end_us``, on the
    program's clock."""
    return HostSpan(i, name, round((start_us - OFFSET_US) * 1e3),
                    round((end_us - OFFSET_US) * 1e3), thread, batch)


def _window():
    """A 1000-us window: the device busy in [0, 300], [500, 800] and
    [950, 1000] (the device-side copy of a program range is no work); the
    drain thread dispatches batches 0 and 1 in it; the callers' admissions
    are mirrored in the profiler."""
    events = [
        _ev("cardbench.window", 0, 1000),
        _ev("cardbench.window", 0, 1000, device=True),
        _ev("k1", -40, 300, device=True),
        _ev("k1", 500, 800, device=True),
        _ev("Memcpy HtoD", 950, 1000, device=True),
        _ev("serve.record", 320, 330, device=True),  # an annotation's copy
        _ev("cardbench.submit", 100, 250),
        _ev("cardbench.result_wait", 250, 1000),
    ]
    spans = [
        _span(0, "serve.form", -100, -50, batch=0),
        _span(1, "serve.dispatch", 5, 50, batch=0),
        _span(2, "serve.pad", 60, 290, batch=1),
        _span(3, "serve.sync", 290, 310, batch=0),
        _span(4, "serve.record", 310, 480, batch=0),
        _span(5, "serve.dispatch", 480, 520, batch=1),
        _span(6, "runner.replay", 485, 515),
        _span(7, "serve.sync", 520, 800, batch=1),
        _span(8, "serve.record", 800, 940, batch=1),
        _span(9, "frontend.wait", 940, 1000),
    ]
    for i, t in enumerate((100.0, 400.0, 700.0, 900.0)):
        jitter = (-0.4, 0.3, 0.1, -0.2)[i]
        events.append(_ev("serve.admit", t + jitter, t + jitter + 4))
        spans.append(_span(20 + i, "serve.admit", t, t + 4, thread=CALLER))
    for i, (t0, dispatch, batch) in enumerate(
            ((-90, -80, None), (-40, 5, 0), (400, 480, 1), (900, None, 2))):
        spans.append(_request(30 + i, t0, dispatch, batch))
    return events, spans


def _request(i, start_us, dispatch_us, batch):
    """A ``serve.request`` span admitted at ``start_us``, its batch
    dispatched at ``dispatch_us`` (None: it failed before dispatch)."""
    ns = lambda us: round((us - OFFSET_US) * 1e3)  # noqa: E731
    return HostSpan(i, "serve.request", ns(start_us), ns(start_us + 990),
                    None, batch, i,
                    dispatch_ns=None if dispatch_us is None else ns(dispatch_us))


def test_offset_from_mirrored_pairs():
    events, spans = _window()
    got = program_trace.profiler_offset_us(events, spans)
    assert got == pytest.approx(OFFSET_US, abs=0.5)
    assert program_trace.profiler_offset_us(events, spans[:10]) is None


def test_idle_split_by_span_and_labelled_gaps():
    events, spans = _window()
    p = program_trace.read(events, spans)
    assert p.window_s == pytest.approx(1e-3)
    assert p.idle_s == pytest.approx(350e-6)
    us = {n: s * 1e6 for n, s in p.idle_by_span.items()}
    assert us["serve.record"] == pytest.approx(170 + 140, abs=1)
    assert us["serve.sync"] == pytest.approx(10, abs=1)
    assert us["serve.dispatch"] == pytest.approx(20, abs=1)
    assert us["serve.pad"] == pytest.approx(0, abs=1)
    assert p.idle_under_host_s * 1e6 == pytest.approx(330, abs=2)
    assert p.idle_under_host_s <= p.idle_s
    assert p.batches == 2
    # batch 0: form 50 (before the window), dispatch 45, record 170;
    # batch 1: pad 230, dispatch 40, record 140 (sync and waits not counted)
    assert p.host_s * 1e6 == pytest.approx(675, abs=2)
    gaps = p.trace.gaps
    assert [g[0] for g in gaps] == ["result_wait / serve.record"] * 2
    assert [g[1] for g in gaps] == [pytest.approx(200e-6),
                                    pytest.approx(150e-6)]
    summary = p.summary()
    # uncovered: [0, 5] and [50, 60]; runner.replay nests, and is no leaf
    assert summary["drain_cover"] == pytest.approx(0.985, abs=0.001)
    assert p.drain_s["runner.replay"] == pytest.approx(30e-6)
    assert summary["glue_share_of_window"] == {
        "serve.dispatch>serve.pad": pytest.approx(0.01, abs=1e-4),
        "serve.form>serve.dispatch": pytest.approx(0.005, abs=1e-4)}
    assert summary["idle_in_glue_s"] == {
        "serve.dispatch>serve.pad": pytest.approx(0.0),
        "serve.form>serve.dispatch": pytest.approx(0.0)}
    # requests dispatched in the window wait 45 and 80 us; the one of the
    # batch dispatched before it and the one that failed before dispatch
    # take no part
    assert p.queue_wait_ms == [pytest.approx(0.045), pytest.approx(0.080)]
    assert summary["queue_wait_ms"]["n"] == 2
    assert list(summary["idle_by_span_s"])[0] == "serve.record"


def test_without_host_spans_no_reading():
    events, spans = _window()
    assert program_trace.read(events, []) is None
    assert program_trace.read(events[2:], spans) is None  # no window
    assert program_trace.read(
        [e for e in events if e.device_type.endswith("CPU")], spans) is None


def _run(program=None):
    cell = harness.find_cell("vgg16_f32.bulk")
    run = harness.Run(cell=cell, seconds=1.0, setup_s=1.0,
                      latency_s=np.array([0.01]), completed_in_window=8,
                      delta={"buckets": {}, "launches": {}})
    if program is not None:
        run.program = program
    return run


def test_readers():
    events, spans = _window()
    run = _run(program_trace.read(events, spans))
    read = lambda n: harness.load_reader("metrics", n)(run)  # noqa: E731
    assert read("host_ms_per_batch.bulk") == pytest.approx(0.3375, abs=0.002)
    assert read("idle_under_host_work.bulk") == pytest.approx(33.0, abs=0.2)
    run = _run()  # a run without the program's spans
    assert read("host_ms_per_batch.bulk") is None
    assert read("idle_under_host_work.bulk") is None


def test_span_entry_dry_run_records_the_programs_spans():
    p = subprocess.run(
        [sys.executable, "cardbench/spans.py", "--workload", "vgg16_f32.bulk",
         "--seed", "2147483651", "--seconds", "0.5", "--trace", "0",
         "--cpu-dry-run", "32"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["program"]["host_spans"] > 0
    assert out["program"]["us_per_span"] > 0
