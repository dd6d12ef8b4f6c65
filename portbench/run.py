"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``checks``: each number compared
with its limit, which also end standard error). Without the cards the cell
asks for, it exits with code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = harness.find_cell(bench, args.workload)
    try:
        result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except harness.NoDevice as e:
        harness.log(f"no result: {e}")
        return 3
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: modules loaded in this process: {found}")
        return 4
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
