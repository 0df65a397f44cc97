"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 cardbench/run.py --workload vgg16_f32.bulk --seed 7 \
        --seconds 50 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window.  The
run needs a CUDA card and exits non-zero without one; ``--cpu-dry-run N``
instead runs the whole path on the CPU with N x N images and prints no
device metric.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-dry-run", type=int, default=None, metavar="N",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # every cache of the run lies at a fixed path inside the checkout
    cache = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    early = {}
    last = _STARTED

    def stage(what: str) -> None:
        nonlocal last
        now = time.perf_counter()
        early[what] = round(now - last, 3)
        last = now

    import torch

    stage("torch_import")
    dry = args.cpu_dry_run is not None
    if not dry and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < 1):
        print("no CUDA device: the benchmark runs on a card", file=sys.stderr)
        return 3
    stage("cuda_check")

    from cardbench.harness import forbidden_modules, process_age_s, run_cell

    stage("harness_import")
    age0 = max(process_age_s() - (time.perf_counter() - _STARTED), 0.0)
    early = {"python_start": round(age0, 3), **early}
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    out = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cpu" if dry else "cuda", input_size=args.cpu_dry_run,
        started=_STARTED, age0=age0, early=early, log=log,
    )
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 4
    if dry:
        out = {"dry_run": True, **out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
