"""``python -m repro_torch.obs.explain`` — show what the planner decided and why.

Prints the auto-partition of a zoo model as a per-launch table (covered
nodes, Q, grid, regime, plan knobs, modeled HBM/VMEM bytes with budget
headroom, modeled cycles), and optionally:

* ``--trace out.json`` — export a Chrome-trace / Perfetto JSON of every
  launch's modeled fill/steady/drain DMA-vs-MXU timeline
  (:mod:`repro_torch.obs.timeline`); with ``--run`` the measured spans of a
  traced ``run_network`` ride alongside.
* ``--run`` — execute the plan with tracing enabled (one untraced warm-up,
  then ``--reps`` traced forwards) and print the model-vs-measured drift
  table (:mod:`repro_torch.obs.report`).
* ``--guard`` — execute the plan under the guarded runtime
  (:mod:`repro_torch.robust`) and print the fallback table: which launches
  ran clean and which rung of the degradation ladder each degraded launch
  took.  ``--squeeze F`` simulates budget pressure (budget scaled by F) so
  the replan rung is demonstrable from the CLI.

``--run`` and ``--guard`` execute on ``--device`` (default ``cuda``: the
CUDA kernels; it fails when there is no card), at the model's full input
size unless ``--input-size`` says otherwise; the plan table alone needs no
device.  Examples::

    PYTHONPATH=src python -m repro_torch.obs.explain --model vgg16
    PYTHONPATH=src python -m repro_torch.obs.explain --model resnet18 \\
        --run --guard --trace t.json
    PYTHONPATH=src python -m repro_torch.obs.explain --model lenet \\
        --guard --squeeze 0.002 --device cpu
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.cycle_model import DEFAULT_PARAMS


def _fmt_bytes(n: int) -> str:
    return f"{n / 1024:,.0f}K" if n < 32 * 1024 * 1024 else f"{n / 2**20:,.1f}M"


def plan_table(plan, vmem_budget: int, out=print) -> None:
    """Render a PartitionPlan as one row per launch (the tabular twin of the
    trace's span schema)."""
    out(
        f"{'launch':<26} {'nodes':>5} {'Q':>2} {'grid':>6} {'region':>6} "
        f"{'regime':<16} {'x/w/c':>6} {'hbm':>9} {'vmem':>9} "
        f"{'headroom':>9} {'cycles':>10} {'us':>9}"
    )
    for p in plan.pyramids:
        d = p.launch.describe(plan.batch, vmem_budget)
        out(
            f"{p.name:<26} {len(p.node_names):>5} {d['q_convs']:>2} "
            f"{d['alpha']}x{d['alpha']:<4} {d['out_region']:>6} "
            f"{d['regime']:<16} "
            f"{d['x_slots']}/{d['w_slots']}/{d['c_tiles']:<2} "
            f"{_fmt_bytes(d['hbm_bytes']):>9} "
            f"{_fmt_bytes(d['vmem_bytes']):>9} "
            f"{_fmt_bytes(d['vmem_headroom_bytes']):>9} "
            f"{d['modeled_cycles']:>10,} "
            f"{d['modeled_cycles'] / DEFAULT_PARAMS.freq_mhz:>9,.1f}"
        )
    out(
        f"total: {plan.n_launches()} launches, "
        f"{plan.hbm_bytes():,} modeled HBM bytes, "
        f"{plan.modeled_cycles():,} modeled cycles "
        f"({plan.modeled_cycles() / DEFAULT_PARAMS.freq_mhz:,.1f} us at "
        f"{DEFAULT_PARAMS.freq_mhz:g} MHz)"
    )


def fallback_table(report, out=print) -> None:
    """Render a guarded run's :class:`~repro_torch.robust.degrade.RunReport`:
    one row per fallback event, plus the degraded-plan detail (the chained
    sub-launches a replan substituted for the planned launch)."""
    out(
        f"guarded: {report.clean_launches}/{report.launches} launches clean"
        + (
            f", fallbacks {report.fallback_counts()}"
            if report.degraded else ", no fallbacks"
        )
    )
    if not report.degraded:
        return
    out(f"{'launch':<26} {'rung':<12} reason")
    for e in report.events:
        out(f"{e.launch:<26} {e.rung:<12} {e.reason}")
        subs = e.detail.get("sub_launches")
        if subs:
            out(
                f"{'':<26} {'':<12} degraded plan: "
                + " -> ".join(subs)
                + f" (budget {_fmt_bytes(e.detail['budget'])})"
            )


def _inputs(graph, plan, batch: int, device):
    """Master params (seed 0), the plan's prepared params and a random
    input batch (seed 1) on ``device``."""
    import torch

    from repro_torch.net.runner import (
        init_network_params,
        prepare_network_params,
    )

    master = init_network_params(graph, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(
        (batch, graph.input_size, graph.input_size, graph.in_channels),
        generator=gen,
    ).to(device)
    return master, prepare_network_params(plan, master), x


def main(argv: list[str] | None = None) -> int:
    from repro_torch.core.program import VMEM_BUDGET_BYTES
    from repro_torch.net.graph import MODELS
    from repro_torch.net.partition import auto_partition, partition_cache_info

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--model", choices=sorted(MODELS), default="lenet")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--input-size", type=int, default=None,
                    help="spatial input size (default: the model's full "
                         "size, 224 for VGG-16 and ResNet-18)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--vmem-budget", type=int, default=VMEM_BUDGET_BYTES)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto/chrome://tracing JSON of the "
                         "modeled (and, with --run, measured) timelines")
    ap.add_argument("--run", action="store_true",
                    help="execute the plan with tracing enabled and report "
                         "model-vs-measured drift")
    ap.add_argument("--reps", type=int, default=3,
                    help="traced forwards after the warm-up (with --run)")
    ap.add_argument("--guard", action="store_true",
                    help="execute the plan under the guarded runtime and "
                         "print the fallback table")
    ap.add_argument("--squeeze", type=float, default=None, metavar="F",
                    help="with --guard: simulate budget pressure by scaling "
                         "the budget by F (0 < F <= 1) via the fault "
                         "injector, demonstrating the replan rung")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --run and --guard execute (default cuda: "
                         "the CUDA kernels; cpu: their plain versions)")
    args = ap.parse_args(argv)

    device = None
    if args.run or args.guard:
        from repro_torch.core import resolve_device

        device = resolve_device(None if args.device == "cuda" else "cpu")

    kwargs = {"compute_dtype": args.dtype}
    if args.input_size is not None:
        kwargs["input_size"] = args.input_size
    graph = MODELS[args.model](**kwargs)

    plan = auto_partition(
        graph, batch=args.batch, vmem_budget=args.vmem_budget
    )
    print(
        f"{graph.name}: input {graph.input_size}x{graph.input_size}, "
        f"batch {args.batch}, dtype {plan.compute_dtype}, "
        f"VMEM budget {_fmt_bytes(args.vmem_budget)}"
    )
    plan_table(plan, args.vmem_budget)
    info = partition_cache_info()
    print(
        f"partition cache: {info.hits} hits / {info.misses} misses "
        f"({info.currsize} plans cached)"
    )

    if args.guard:
        import contextlib

        from repro_torch.net.runner import run_network
        from repro_torch.obs.trace import device_label
        from repro_torch.robust import GuardConfig, guarding, inject

        master, params, x = _inputs(graph, plan, args.batch, device)
        squeeze = contextlib.nullcontext()
        if args.squeeze is not None:
            squeeze = inject(seed=0)
        print(f"\nguarded run on {device_label(device)}"
              + (f" (budget squeezed x{args.squeeze})" if args.squeeze
                 is not None else ""))
        with guarding(GuardConfig(), source_params=master) as guard:
            with squeeze as inj:
                if inj is not None:
                    inj.squeeze_budget(args.squeeze)
                run_network(x, params, plan=plan)
        fallback_table(guard.last_report)

    collector = None
    if args.run:
        from repro_torch.net.runner import run_network, skip_fractions
        from repro_torch.obs.report import (
            drift_report,
            drift_rows_from_spans,
            format_report,
        )
        from repro_torch.obs.trace import device_label, tracing

        _, params, x = _inputs(graph, plan, args.batch, device)
        run_network(x, params, plan=plan)  # untraced warm-up: kernel builds
        label = device_label(device)
        print(f"\nrunning {args.reps} traced forwards on {label} ...")
        with tracing() as collector:
            for _ in range(args.reps):
                _, skips = run_network(x, params, plan=plan)
        frac = skip_fractions(skips)
        for name, f in frac.items():
            if any(v > 0 for v in f):
                print(f"END skips {name}: "
                      + ", ".join(f"L{i}={v:.0%}" for i, v in enumerate(f)))
        print()
        format_report(drift_report(drift_rows_from_spans(collector.spans)),
                      measured_on=label)

    if args.trace:
        from repro_torch.obs.timeline import chrome_trace, write_chrome_trace

        trace = chrome_trace(
            collector,
            launches=[(p.name, p.launch) for p in plan.pyramids],
        )
        write_chrome_trace(args.trace, trace)
        print(f"\nwrote {args.trace} "
              f"({len(trace['traceEvents'])} events — load in "
              "ui.perfetto.dev or chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
