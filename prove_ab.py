"""Prove wall time at 2^16 of two checkouts of the port, in turns on one GPU.

    python3 prove_ab.py DIR_A DIR_B [ROUNDS]
    python3 prove_ab.py --summary DIR_X DIR_Y LOG [LOG ...]

Rounds run A, B, B, A and B, A, A, B in turn (with A, B, B, A alone, the B
side ran 10-25 ms slower in three runs on an H100 host, one of them a tree
against a copy of itself), every run in a process of its own that imports
``spartan_tpu_torch`` from its directory (each checkout builds its kernels
once, into its own ``spartan_tpu_torch/build``). A run takes the circuit
of chip_smoke.py's phase 4 (log_n = 16, density 0, circuit seed 0, key
seed 42) from this script's checkout, sets up twice (the second one warm:
keygen's fixed-base MSM runs the point kernels) and indexes on the card,
then proves once cold and five times warm, and times the decode to affine of one
G1 point (the commitment's) and of 16 G2 points (an opening's at 2^16), host
included: each decode inverts once. Before the setups and after the proves it
times a fixed piece of host work that touches no card (HOST_STEPS products
of Python integers mod r), so that a side whose processes ran on a slower
host shows it. It prints one JSON line per run and, at the end, the medians
of each side: warm prove wall, the SPANS below, the warm setup, the decode
walls and the host work; then B minus A paired by round (each round's runs
of a side averaged), mean and standard error over the rounds. A run is one
sample of its host: its spans rise and fall together. ``--summary`` prints
the paired differences DIR_X minus DIR_Y of saved logs, and their mean over
the logs (a log that ran DIR_X as A and one that ran it as B cancel the
positions).
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

# timers spans whose medians are reported
# (a checkout proves its sumchecks through one of the two routes: the host
# loop's spans or the device-resident phases'; the other side's read nan)
SPANS = ("commit MSM", "open G2 MSMs", "Prove Sumcheck 1", "Prove Sumcheck 2",
         "Prove Sumcheck 1 (fused)", "Prove Sumcheck 2 (fused)", "Prove 1: commit z", "open quotients + eval",
         "Prove 3: sparse mat-vec + eq", "Prove 5: eval_on_x + combine")
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
HOST_STEPS = 200_000


def host_work_ms() -> float:
    """Milliseconds of HOST_STEPS products mod r in Python, on the host alone."""
    t, x = time.perf_counter(), 3
    for _ in range(HOST_STEPS):
        x = x * x % R
    return (time.perf_counter() - t) * 1e3


def child(root: str) -> None:
    # the circuit comes from this script's checkout, the prover from `root`
    from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input

    log_n = 16
    cs, v, w = generate_circuit_with_random_input(
        num_public=4, num_private=(1 << log_n) - 4, pad_to_square=True, density=0,
        rng=random.Random(0))
    a, b, c = cs.to_matrices()
    for name in [m for m in sys.modules if m.split(".")[0] == "spartan_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from spartan_tpu_torch import kernels, timers
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

    kernels.load()
    host_ms = [host_work_ms()]
    dev = torch.device("cuda", 0)
    class Keys:  # the same keys at every setup
        def __init__(self):
            self.rng = random.Random(42)

        def sample_fr(self):
            return self.rng.randrange(R)

    setup_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pp, _vp = MLArgumentForR1CS.setup(log_n, Keys(), dev)
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t)
    pk = MLArgumentForR1CS.index(a, b, c, dev)
    walls, spans = [], []
    for _ in range(6):
        timers.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        MLArgumentForR1CS.prove(pk, v, w, pp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        spans.append({k: timers.SPANS.get(k, float("nan")) for k in SPANS})
    host_ms.append(host_work_ms())
    from spartan_tpu_torch.ops import curve as cv

    def wall_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    g1, g2 = pp.powers_of_g[0].take(slice(0, 1)), pp.powers_of_h[0].take(slice(0, 16))
    print(json.dumps({"root": root, "setup_s": setup_s, "cold_s": walls[0], "warm_s": walls[1:],
                      "spans_s": spans[1:],
                      "g1_decode_1_ms": wall_ms(lambda: cv.g1_decode(g1)),
                      "g2_decode_16_ms": wall_ms(lambda: cv.g2_decode(g2)), "host_ms": host_ms}), flush=True)


# a run's numbers that the paired summary compares, each the median over the run's warm proves
PAIRED = ("warm prove", "commit MSM", "open G2 MSMs", "Prove Sumcheck 1 (fused)", "Prove Sumcheck 2 (fused)",
          "Prove 1: commit z", "open quotients + eval", "Prove 3: sparse mat-vec + eq",
          "Prove 5: eval_on_x + combine", "host work")


def run_medians(r: dict) -> dict:
    """A run's PAIRED numbers in ms."""
    m = {"warm prove": statistics.median(r["warm_s"]) * 1e3,
         "host work": statistics.mean(r.get("host_ms") or [float("nan")])}  # nan in logs from before it
    for k in PAIRED[1:-1]:
        m[k] = statistics.median(x[k] for x in r["spans_s"]) * 1e3
    return m


def paired(rounds: list, x: str, y: str) -> dict:
    """Per PAIRED number, the differences checkout x minus checkout y, each
    round's runs of a side averaged: {name: [difference a round, ...]}."""
    out = {k: [] for k in PAIRED}
    for rnd in rounds:
        side = {root: [run_medians(r) for r in rnd if r["root"] == root] for root in (x, y)}
        for k in PAIRED:
            out[k].append(statistics.mean(m[k] for m in side[x]) - statistics.mean(m[k] for m in side[y]))
    return out


def _mean_se(d: list) -> tuple:
    if len(d) < 2 or any(v != v for v in d):  # a number the log lacks
        return float("nan"), float("nan")
    return statistics.mean(d), statistics.stdev(d) / len(d) ** 0.5


def print_paired(logs: list, x: str, y: str) -> None:
    """The paired differences x - y of each log's rounds, and their mean
    over the logs: a log that ran x as A and one that ran it as B cancel
    what the position in a round adds."""
    per_log = []
    for name, rounds in logs:
        diff = paired(rounds, x, y)
        per_log.append(diff)
        print(f"paired {name}: {x} - {y}, mean +- standard error over {len(rounds)} rounds (ms): "
              + "; ".join(f"{k} {m:+.2f} +- {se:.2f} (higher in {sum(v > 0 for v in diff[k])})"
                          for k in PAIRED for m, se in [_mean_se(diff[k])]), flush=True)
    if len(per_log) > 1:
        parts = []
        for k in PAIRED:
            stats = [_mean_se(d[k]) for d in per_log]
            m = statistics.mean(s[0] for s in stats)
            se = sum(s[1] ** 2 for s in stats) ** 0.5 / len(stats)
            parts.append(f"{k} {m:+.2f} +- {se:.2f}")
        print(f"paired, mean over {len(per_log)} logs: {x} - {y} (ms): " + "; ".join(parts), flush=True)


def read_log(path: str) -> list:
    """The rounds (four runs each) of a log this script printed."""
    with open(path) as f:
        runs = [json.loads(line[2:]) for line in f if line[:2] in ("A ", "B ") and line[2:3] == "{"]
    return [runs[i:i + 4] for i in range(0, len(runs) - len(runs) % 4, 4)]


def main() -> int:
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if sys.argv[1] == "--summary":
        # python3 prove_ab.py --summary ROOT_X ROOT_Y LOG [LOG ...]: the paired differences of saved logs
        x, y = sys.argv[2], sys.argv[3]
        print_paired([(path, read_log(path)) for path in sys.argv[4:]], x, y)
        return 0
    roots = {"A": sys.argv[1], "B": sys.argv[2]}
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    runs = {"A": [], "B": []}
    by_round = []
    for i in range(rounds):
        by_round.append([])
        # every other round swaps the positions, so each side runs first and last as often as in the middle
        for side in ("ABBA" if i % 2 == 0 else "BAAB"):
            out = subprocess.run([sys.executable, __file__, "--child", roots[side]],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise SystemExit(f"{side} ({roots[side]}) failed:\n{out.stderr[-4000:]}")
            line = out.stdout.strip().splitlines()[-1]
            print(f"{side} {line}", flush=True)
            runs[side].append(json.loads(line))
            by_round[-1].append(runs[side][-1])
    for side in "AB":
        warm = [x for r in runs[side] for x in r["warm_s"]]
        span = {k: statistics.median(x[k] for r in runs[side] for x in r["spans_s"]) for k in SPANS}
        dec = {k: statistics.median(r[k] for r in runs[side])
               for k in ("g1_decode_1_ms", "g2_decode_16_ms")}
        setup = statistics.median(r["setup_s"][1] for r in runs[side])
        host = statistics.median(x for r in runs[side] for x in r["host_ms"])
        print(f"{side} {roots[side]}: warm prove median {statistics.median(warm):.4f} s "
              f"(min {min(warm):.4f}, max {max(warm):.4f}, {len(warm)} proves); span medians "
              + ", ".join(f"{k} {s:.4f} s" for k, s in span.items())
              + f"; warm setup median {setup:.4f} s; decode ms, median of runs: G1 x1 "
              f"{dec['g1_decode_1_ms']:.3f}, G2 x16 {dec['g2_decode_16_ms']:.3f}; host work median "
              f"{host:.2f} ms; cold "
              + ", ".join(f"{r['cold_s']:.3f}" for r in runs[side]), flush=True)
    if roots["A"] != roots["B"]:
        print_paired([("this run", by_round)], roots["B"], roots["A"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
