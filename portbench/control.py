"""The control of the comparison that decides ``correct``: the reference
put in the program's place with one guarantee broken, the transcript
leaving the public input v out (a prover whose challenges are not bound to
the statement). A run of the cell with it in the program's place has to
print ``correct`` false.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

Per seed it makes one run of the cell through ``harness.run_cell``, with
its set-up, closed loop and comparison: the program's set-up (keys and
index on the card, which the run's key check reads), then the loop, whose
calls hand out the control's proofs of the called instances. The control
proves the whole pool in the run's set-up, in forked processes, so the
loop calls at the cell's batch and pool without waiting on the reference.
It prints each run's result line with its seed. The benchmark's own runs
do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import check, harness  # noqa: E402
from portbench.reference.spartan import Reference  # noqa: E402


class _Proof:
    def __init__(self, data: bytes):
        self._data = data

    def serialize(self) -> bytes:
        return self._data


class ControlProgram(harness.Program):
    """The program's set-up, with the control's proofs in place of its two
    entry points."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        super().__init__(config, traffic, seed, device)
        ref = Reference(*self.matrices, self.key_seed)
        ids = sorted(self.instances)
        made = check.parallel_map(
            lambda i: b"".join(b for _n, b in ref.prove(*self.instances[i], absorb_public_input=False)), ids)
        by_v = {tuple(self.instances[i][0]): _Proof(b) for i, b in zip(ids, made)}
        self.prove_one = lambda pk, v, w, pp: by_v[tuple(v)]
        self.prove_many = lambda pk, instances, pp: [by_v[tuple(v)] for v, _w in instances]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    spec = harness.find_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        res = harness.run_cell(spec, seed, args.seconds, False, "cuda", program_class=ControlProgram)
        harness.print_result({"workload": args.workload, "seed": seed, **res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
