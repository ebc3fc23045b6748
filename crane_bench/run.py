"""Run one cell of the benchmark once.

    python3 -m crane_bench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The last line
of standard output is the result as one JSON object; the last lines of
standard error are the numbers the check compared, each beside its limit.
Exits 2 without a card (printing no result), and 3 if JAX or the JAX package
got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# whole top-level module names the port must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "cranesched_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from crane_bench import harness, spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print("crane_bench: no CUDA card, or fewer than the cell asks for",
              file=sys.stderr)
        return 2
    result, _numbers = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"crane_bench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
