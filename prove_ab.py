"""Prove wall time at 2^16 of two checkouts of the port, in turns on one GPU.

    python3 prove_ab.py DIR_A DIR_B [ROUNDS]

Each round runs A, B, B, A, every run in a process of its own that imports
``spartan_tpu_torch`` from its directory (each checkout builds its kernels
once, into its own ``spartan_tpu_torch/build``). A run takes the circuit
of chip_smoke.py's phase 4 (log_n = 16, density 0, circuit seed 0, key
seed 42) from this script's checkout, sets up and indexes on the card, then
proves once cold and five times warm, and times the decode to affine of one
G1 point (the commitment's) and of 16 G2 points (an opening's at 2^16), host
included: each decode inverts once. It prints one JSON line per run and, at
the end, the medians of each side: warm prove wall, the SPANS below, and the
decode walls.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

SPANS = ("commit MSM", "open G2 MSMs")  # timers spans whose medians are reported


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
    dev = torch.device("cuda", 0)
    key_rng = random.Random(42)

    class Keys:
        def sample_fr(self):
            return key_rng.randrange(0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001)

    pp, _vp = MLArgumentForR1CS.setup(log_n, Keys(), dev)
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
    print(json.dumps({"root": root, "cold_s": walls[0], "warm_s": walls[1:],
                      "spans_s": spans[1:],
                      "g1_decode_1_ms": wall_ms(lambda: cv.g1_decode(g1)),
                      "g2_decode_16_ms": wall_ms(lambda: cv.g2_decode(g2))}), flush=True)


def main() -> int:
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    roots = {"A": sys.argv[1], "B": sys.argv[2]}
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    runs = {"A": [], "B": []}
    for _ in range(rounds):
        for side in "ABBA":
            out = subprocess.run([sys.executable, __file__, "--child", roots[side]],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise SystemExit(f"{side} ({roots[side]}) failed:\n{out.stderr[-4000:]}")
            line = out.stdout.strip().splitlines()[-1]
            print(f"{side} {line}", flush=True)
            runs[side].append(json.loads(line))
    for side in "AB":
        warm = [x for r in runs[side] for x in r["warm_s"]]
        span = {k: statistics.median(x[k] for r in runs[side] for x in r["spans_s"]) for k in SPANS}
        dec = {k: statistics.median(r[k] for r in runs[side])
               for k in ("g1_decode_1_ms", "g2_decode_16_ms")}
        print(f"{side} {roots[side]}: warm prove median {statistics.median(warm):.4f} s "
              f"(min {min(warm):.4f}, max {max(warm):.4f}, {len(warm)} proves); span medians "
              + ", ".join(f"{k} {s:.4f} s" for k, s in span.items())
              + f"; decode ms, median of runs: G1 x1 "
              f"{dec['g1_decode_1_ms']:.3f}, G2 x16 {dec['g2_decode_16_ms']:.3f}; cold "
              + ", ".join(f"{r['cold_s']:.3f}" for r in runs[side]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
