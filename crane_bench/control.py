"""The check's control and its readings, outside the benchmark's runs.

    python3 -m crane_bench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 10

runs the cell on the card once per seed (set-up and a short window at the
cell's own load) and prints, per seed, the compared numbers of the program
(the lower readings) and of the control: the plain reference computed in
bfloat16, the precision below the float32 the configuration states, put in
the program's place for the checked ticks (the upper readings), each judged
by the run's own ``check.verdict``.  Every limit is 0; the control has to
come out not correct on every seed, and the command exits 1 where it does
not.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from crane_bench import check, harness

    if not torch.cuda.is_available():
        print("crane_bench.control: no CUDA card", file=sys.stderr)
        return 2
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers = harness.run_cell(args.workload, seed, args.seconds,
                                           False, control=True)
        keys = list(check.LIMITS)
        control_correct, _ = check.verdict(numbers["control"])
        passed += control_correct
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"],
            "control_correct": control_correct,
            "program": {k: numbers[k] for k in keys},
            "control": {k: numbers["control"][k] for k in keys},
            "ticks_checked": numbers["_ticks_checked"],
        }), flush=True)
    if passed:
        print(f"crane_bench.control: the control came out correct on "
              f"{passed} seed(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
