"""Run one cell with the program's host spans recorded, and read them.

    python3 cardbench/spans.py --workload vgg16_f32.bulk --seed 7 \
        --seconds 50 --trace 1

Temporary: the benchmark's own harness does not install the program's
collector yet.  The ``benchmark`` change that puts ``tracing()`` and
``program_trace.read`` into ``harness.run_cell``'s traced branch, and
registers ``host_ms_per_batch.bulk`` and ``idle_under_host_work.bulk`` in
``BENCHMARK.json``, deletes this file.

The harness's run of the cell (``harness.run_cell``, unchanged) with a
``repro_torch`` ``TraceCollector`` installed for its whole length.  With
``--trace 1`` the profiler's events that the harness reduces are kept too,
the program's spans are read against them (``program_trace.read``) and the
result line gains ``program``: ``host_ms_per_batch.bulk`` and
``idle_under_host_work.bulk`` (their readers under ``metrics/``), the
device-idle seconds each drain-thread span overlaps, the share of the
window each takes, the queue wait of the requests dispatched in it, and
the trace's idle gaps labelled with the spans.  ``--trace 0`` gives the
end-to-end metrics with the collector installed; ``run.py`` gives them
without it, so the two give the cost of tracing when on.
``program.us_per_span`` times a span's ``begin`` and ``end`` in a loop
after the run.  ``--cpu-dry-run N`` runs on the CPU with N x N images, as
``run.py``'s does.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAN_COST_REPS = 20_000
METRICS = ("host_ms_per_batch.bulk", "idle_under_host_work.bulk")


def span_cost_us(collector_type, reps: int = SPAN_COST_REPS) -> float:
    """Microseconds of one host span's ``begin`` and ``end``, no profiler
    running."""
    col = collector_type()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        col.end(col.begin("cost"))
    return (time.perf_counter_ns() - t0) / reps / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--cpu-dry-run", type=int, default=None, metavar="N")
    args = ap.parse_args(argv)

    cache = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    dry = args.cpu_dry_run is not None
    if not dry and not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on a card", file=sys.stderr)
        return 3
    from cardbench import harness, program_trace
    from cardbench import trace as tr
    from repro_torch.obs.trace import TraceCollector, tracing

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    kept = {}
    reduce = tr.reduce

    def keep(events):
        kept["events"] = events
        return reduce(events)

    tr.reduce = keep
    try:
        with tracing() as col:
            out = harness.run_cell(
                args.workload, args.seed, args.seconds, bool(args.trace),
                device="cpu" if dry else "cuda", input_size=args.cpu_dry_run,
                started=_STARTED, log=log,
            )
    finally:
        tr.reduce = reduce
    program = {"host_spans": len(col.host_spans),
               "us_per_span": span_cost_us(TraceCollector)}
    read = (program_trace.read(kept["events"], col.host_spans)
            if "events" in kept else None)
    if read is not None:
        run = SimpleNamespace(program=read)
        for name in METRICS:
            program[name] = harness.load_reader("metrics", name)(run)
        program.update(read.summary())
    out["program"] = program
    log(f"program: {json.dumps(program)}")
    if dry:
        out = {"dry_run": True, **out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
