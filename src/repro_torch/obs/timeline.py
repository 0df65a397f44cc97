"""Chrome-trace (``chrome://tracing`` / Perfetto) export of fusion launches.

The port of the reference's ``repro.obs.timeline``.  Two kinds of track are
rendered into one JSON Event Trace:

* **Modeled** — one process per launch, two threads (``MXU`` and ``DMA``),
  holding the cycle model's fill/steady/drain bars
  (:meth:`~repro_torch.core.program.LaunchPlan.modeled_timeline` for the
  grid's input halo-tile stream vs the per-cell pyramid bodies, plus the
  per-cell weight-movement detail of
  :meth:`~repro_torch.core.program.LaunchPlan.body_detail_timeline`).
  Cycles are converted to microseconds at the cycle model's clock (100 MHz
  default): the paper accelerator's modeled time, neither an H100 time nor
  a TPU time.  These events equal the reference's, event for event.
* **Measured** — one thread of spans from a
  :class:`~repro_torch.obs.trace.TraceCollector` (a traced ``run_network``),
  on a process named after the device the spans were measured on (the
  card's name, or ``cpu``), with every planned knob and modeled cost
  attached as event ``args``, plus the collector's point events (cache
  hits/misses, skip stats, fallbacks) as instants.  A span's ``ts`` is its
  host issue time (``start_s``) and its ``dur`` its measured time (CUDA
  events on a card), so a bar's left edge is when the host issued the
  launch, not when the device began it.

The trace loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  :func:`validate_chrome_trace` checks the subset of
the Trace Event Format this module emits.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.core.cycle_model import DEFAULT_PARAMS

# pid layout: measured spans + instant events live on MEASURED_PID; each
# modeled launch gets its own process starting here (one per launch keeps
# Perfetto's per-process track grouping readable for deep plans)
MEASURED_PID = 1
MODELED_PID0 = 1000

_LANE_TID = {"mxu": 0, "dma": 1}
_LANE_NAME = {"mxu": "MXU (compute)", "dma": "DMA (HBM)"}


def _meta(pid: int, name: str, tids: dict[int, str]) -> list[dict]:
    evs = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": name},
        }
    ]
    for tid, tname in tids.items():
        evs.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    return evs


def modeled_launch_events(
    name: str,
    launch,
    pid: int,
    *,
    freq_mhz: float = DEFAULT_PARAMS.freq_mhz,
    max_cells: int = 64,
) -> list[dict]:
    """Complete ("X") events of one launch's modeled timeline: the grid-level
    DMA-vs-MXU bars, and — when the per-cell body has internal weight
    movement (streamed regimes) — the cell-0 detail on a second thread pair.
    ``ts``/``dur`` are microseconds at ``freq_mhz``."""
    scale = 1.0 / freq_mhz  # cycles -> us
    events = _meta(
        pid,
        f"modeled: {name} [{launch.regime}]",
        {
            0: _LANE_NAME["mxu"],
            1: _LANE_NAME["dma"],
            2: "cell 0 MXU (weight detail)",
            3: "cell 0 DMA (weight detail)",
        },
    )
    args = launch.describe()
    for seg in launch.modeled_timeline(max_cells=max_cells):
        events.append(
            {
                "ph": "X",
                "name": seg.label,
                "cat": "modeled",
                "pid": pid,
                "tid": _LANE_TID[seg.lane],
                "ts": seg.start * scale,
                "dur": seg.duration * scale,
                "args": args,
            }
        )
    detail = launch.body_detail_timeline()
    if launch.streamed and detail:
        # align the detail with cell 0's body: it starts after the first
        # halo-tile fetch in both the serial and pipelined grid schedules
        off = launch.program.input_dma_cycles()
        for seg in detail:
            events.append(
                {
                    "ph": "X",
                    "name": seg.label,
                    "cat": "modeled-detail",
                    "pid": pid,
                    "tid": 2 + _LANE_TID[seg.lane],
                    "ts": (off + seg.start) * scale,
                    "dur": seg.duration * scale,
                    "args": {"regime": launch.regime},
                }
            )
    return events


def measured_events(collector) -> list[dict]:
    """Measured spans + instant events of a collector, on one process named
    after the device(s) the spans were measured on (``"cpu"`` when there
    are none).

    Timestamps are rebased to the earliest span/event so the trace starts
    at ~0; span ``args`` carry the full span schema, so every modeled
    quantity is clickable next to its measured bar."""
    spans = list(collector.spans)
    events = list(collector.events)
    if not spans and not events:
        return []
    t0 = min(
        [s.start_s for s in spans] + [e.ts_s for e in events]
    )
    devices = ", ".join(sorted({s.device for s in spans})) or "cpu"
    out = _meta(
        MEASURED_PID,
        f"measured: {devices}",
        {0: "launch spans", 1: "events"},
    )
    for s in spans:
        out.append(
            {
                "ph": "X",
                "name": f"{s.model}/{s.name} [{s.regime}]",
                "cat": "measured",
                "pid": MEASURED_PID,
                "tid": 0,
                "ts": (s.start_s - t0) * 1e6,
                "dur": s.duration_ms * 1e3,
                "args": dataclasses.asdict(s),
            }
        )
    for e in events:
        out.append(
            {
                "ph": "i",
                "name": e.name,
                "cat": "event",
                "pid": MEASURED_PID,
                "tid": 1,
                "ts": (e.ts_s - t0) * 1e6,
                "s": "p",
                "args": dict(e.args),
            }
        )
    return out


def chrome_trace(
    collector=None,
    *,
    launches=(),
    freq_mhz: float = DEFAULT_PARAMS.freq_mhz,
    max_cells: int = 64,
) -> dict:
    """Build the full Trace Event Format dict.

    ``launches`` is an iterable of ``(name, LaunchPlan)`` pairs to render as
    modeled tracks (e.g. ``[(p.name, p.launch) for p in plan.pyramids]``);
    ``collector`` adds the measured tracks.  Either side may be omitted —
    ``repro_torch.obs.explain`` without ``--run`` exports modeled-only
    traces.
    """
    events: list[dict] = []
    for i, (name, launch) in enumerate(launches):
        events.extend(
            modeled_launch_events(
                name, launch, MODELED_PID0 + i,
                freq_mhz=freq_mhz, max_cells=max_cells,
            )
        )
    if collector is not None:
        events.extend(measured_events(collector))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "repro_torch.obs",
            "freq_mhz": freq_mhz,
            "note": "modeled bars are the cycle model's time at freq_mhz"
                    " (neither an H100 nor a TPU time); measured bars are"
                    " the named device's (CUDA events on a card) — compare"
                    " shapes, not absolute scales",
        },
    }


def validate_chrome_trace(trace: dict) -> list[str]:
    """Check ``trace`` against the subset of the Chrome Trace Event Format
    this module emits; returns a list of problems (empty = loadable)."""
    problems: list[str] = []
    if not isinstance(trace, dict):
        return ["trace must be a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    if not events:
        problems.append("traceEvents is empty")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "B", "E"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: {key} must be an int")
        if ph == "X":
            for key in ("ts", "dur"):
                v = ev.get(key)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(f"{where}: {key} must be >= 0")
        if ph == "i" and not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: instant event needs ts")
        if ph == "M" and "args" not in ev:
            problems.append(f"{where}: metadata event needs args")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


def write_chrome_trace(path: str, trace: dict) -> None:
    """Validate then write the trace JSON; raises ``ValueError`` with the
    problem list if the trace would not load."""
    problems = validate_chrome_trace(trace)
    if problems:
        raise ValueError("invalid chrome trace: " + "; ".join(problems))
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
