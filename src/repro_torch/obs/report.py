"""Model-vs-measured drift report: is the cycle model still predictive?

The port of the reference's ``repro.obs.report``.  The partitioner picks
cuts and regimes by modeled cycles alone; this report joins those modeled
costs against measured medians per launch and flags the launches whose
measured-vs-modeled ratio deviates from the fleet median.

The modeled side is the cycle model's time at its 100 MHz clock
(``DEFAULT_PARAMS.freq_mhz``): the paper accelerator's, neither an H100's
nor a TPU's.  The *absolute* ratio is therefore far from 1 on any real
device, so drift is defined **relatively**: the fleet-median ratio is the
calibration constant, and a launch is flagged when its own ratio falls
outside ``[median / factor, median * factor]`` — a launch the model prices
wrongly *relative to its peers*.

Inputs: spans from a traced ``run_network`` (:func:`drift_rows_from_spans`)
or a benchmark JSON in the reference's ``BENCH_pyramid.json`` schema
(:func:`drift_rows_from_bench`).  CLI::

    PYTHONPATH=src python -m repro_torch.obs.report --bench BENCH_pyramid.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from repro_torch.core.cycle_model import DEFAULT_PARAMS

FLAG_FACTOR = 3.0


def _modeled_ms(cycles: float, freq_mhz: float = DEFAULT_PARAMS.freq_mhz):
    return cycles / (freq_mhz * 1e3)


def drift_rows_from_spans(spans) -> list[dict]:
    """One row per distinct launch from traced spans: the measured median of
    that launch's repetitions against its modeled cost."""
    groups: dict[tuple, list] = {}
    for s in spans:
        key = (s.model, s.name, s.regime, s.compute_dtype, s.batch)
        groups.setdefault(key, []).append(s)
    rows = []
    for (model, name, regime, dtype, batch), ss in groups.items():
        measured = statistics.median(s.duration_ms for s in ss)
        modeled = ss[0].modeled_cycles
        rows.append(
            {
                "launch": f"{model}/{name}",
                "regime": regime,
                "compute_dtype": dtype,
                "batch": batch,
                "reps": len(ss),
                "modeled_cycles": modeled,
                "modeled_ms": _modeled_ms(modeled),
                "measured_ms": measured,
            }
        )
    return rows


def drift_rows_from_bench(bench: dict) -> list[dict]:
    """Joinable (modeled, measured) pairs from a benchmark JSON in the
    reference's ``BENCH_pyramid.json`` schema.

    Launch rows under ``kernel_dataflow.launches`` carry ``modeled_cycles``;
    measured medians come from the ``kernel_dataflow.wallclock`` section
    (the LeNet Q=2 kernel, interpret and compiled) and from the end-to-end
    workload sections, which record ``modeled_cycles`` alongside their wall
    clocks.  Rows missing either side are skipped, so the report runs on
    old and new files alike."""
    rows: list[dict] = []
    kd = bench.get("kernel_dataflow", {})
    wall = kd.get("wallclock", {})
    lenet = kd.get("launches", {}).get("lenet_q2")
    if lenet:
        for mode in ("interpret", "compiled"):
            ms = wall.get(f"{mode}_ms")
            if ms is None:
                continue
            rows.append(
                {
                    "launch": f"kernel/lenet_q2 ({mode})",
                    "regime": lenet.get("regime", "?"),
                    "compute_dtype": lenet.get("compute_dtype", "float32"),
                    "batch": 1,
                    "reps": wall.get("reps", 1),
                    "modeled_cycles": lenet["modeled_cycles"],
                    "modeled_ms": _modeled_ms(lenet["modeled_cycles"]),
                    "measured_ms": ms,
                }
            )
    for name, wl in bench.get("workloads", {}).items():
        variants = [("", wl)]
        if isinstance(wl.get("bf16"), dict):
            variants.append(("_bf16", wl["bf16"]))
        for suffix, row in variants:
            cycles, ms = row.get("modeled_cycles"), row.get("wallclock_ms")
            if cycles is None or ms is None:
                continue
            rows.append(
                {
                    "launch": f"workload/{name}{suffix}",
                    "regime": row.get("regime", "plan"),
                    "compute_dtype": (
                        "bfloat16" if suffix else "float32"
                    ),
                    "batch": wl.get("batch", 1),
                    "reps": wl.get("wallclock_reps", 1),
                    "modeled_cycles": cycles,
                    "modeled_ms": _modeled_ms(cycles),
                    "measured_ms": ms,
                }
            )
    return rows


def drift_report(rows: list[dict], flag_factor: float = FLAG_FACTOR) -> dict:
    """Attach per-row ratios and drift flags; compute the fleet median.

    Each row gains ``ratio`` (measured / modeled — the launch's private
    "slowdown constant"), ``drift`` (ratio / fleet median) and ``flagged``
    (drift outside ``[1/flag_factor, flag_factor]``).  Returns
    ``{"rows", "median_ratio", "flag_factor", "flagged"}``."""
    rows = [dict(r) for r in rows]
    ratios = []
    for r in rows:
        r["ratio"] = (
            r["measured_ms"] / r["modeled_ms"] if r["modeled_ms"] else float("inf")
        )
        ratios.append(r["ratio"])
    median = statistics.median(ratios) if ratios else 0.0
    flagged = []
    for r in rows:
        r["drift"] = r["ratio"] / median if median else 0.0
        r["flagged"] = not (1.0 / flag_factor <= r["drift"] <= flag_factor)
        if r["flagged"]:
            flagged.append(r["launch"])
    return {
        "rows": rows,
        "median_ratio": median,
        "flag_factor": flag_factor,
        "flagged": flagged,
    }


def format_report(report: dict, out=print, *, measured_on: str = "") -> None:
    """Print the drift table, highest drift first, under a legend saying
    what each time is: ``modeled_ms`` the cycle model's, ``measured_ms``
    that of ``measured_on`` (the device's name, when the caller knows
    it)."""
    rows = report["rows"]
    if not rows:
        out("drift report: no joinable (modeled, measured) launches")
        return
    out(
        f"modeled_ms: the cycle model at {DEFAULT_PARAMS.freq_mhz:g} MHz"
        " (neither an H100 nor a TPU time); measured_ms: "
        + (measured_on or "the measuring device")
    )
    out(
        f"{'launch':<36} {'regime':<16} {'dtype':<9} {'modeled_ms':>11} "
        f"{'measured_ms':>11} {'ratio':>10} {'drift':>7}  flag"
    )
    for r in sorted(rows, key=lambda r: -r["drift"]):
        out(
            f"{r['launch']:<36} {r['regime']:<16} {r['compute_dtype']:<9} "
            f"{r['modeled_ms']:>11.4f} {r['measured_ms']:>11.4f} "
            f"{r['ratio']:>10.1f} {r['drift']:>7.2f}  "
            f"{'DRIFT' if r['flagged'] else 'ok'}"
        )
    out(
        f"fleet median measured/modeled ratio: {report['median_ratio']:.1f} "
        f"(flag factor {report['flag_factor']:g}; "
        f"{len(report['flagged'])} flagged)"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bench", default="BENCH_pyramid.json",
                    help="benchmark JSON to join modeled vs measured from")
    ap.add_argument("--flag-factor", type=float, default=FLAG_FACTOR,
                    help="relative deviation from the fleet median ratio "
                         "that flags a launch (default 3.0)")
    args = ap.parse_args(argv)
    with open(args.bench) as f:
        bench = json.load(f)
    report = drift_report(drift_rows_from_bench(bench), args.flag_factor)
    format_report(report, measured_on=f"as recorded in {args.bench}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
