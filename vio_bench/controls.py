"""Readings of a cell's comparison with the reference in a lower precision
put in the program's place (the control that has to come out not
correct), on several seeds in one process, at the cell's own size:

    python3 vio_bench/controls.py --workload vio_f32_fused.mc2048 --control tf32 \\
        --seeds 11,12,13 --seconds 2

``--control float32`` runs the float32 reference on the CPU; ``tf32`` runs
it on the card with TF32 matrix products. Prints one JSON line a seed with
the numbers compared and their limits. The benchmark's runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench.harness import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=("float32", "tf32"), required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, control=args.control)
        print(json.dumps({"seed": seed, "control": args.control, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
