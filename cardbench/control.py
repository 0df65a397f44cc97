"""Read the comparison's number for the program and for its control on
several seeds, in one process.

    python3 cardbench/control.py --workload vgg16_f32.bulk \
        --seeds 11,12,13 --seconds 20

Each seed is a whole run of the cell at its own load (``run_cell``); beside
the program's ``logit_rel_err`` it prints the control's: the plain
reference computed at TF32 in the program's place, compared over the same
requests.  The benchmark's own runs never compute the control.  A limit is
set between the largest program reading and the smallest control reading.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from cardbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=True,
                               log=lambda m: print(m, file=sys.stderr))
        line = {"workload": args.workload, "seed": seed,
                "correct": out["correct"], "attempted": out["attempted"],
                "program": out["checks"]["logit_rel_err"]["value"],
                "control": out["control"],
                "metrics": out["metrics"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
