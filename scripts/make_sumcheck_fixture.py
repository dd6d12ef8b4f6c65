"""Write spartan_tpu's device-resident sumcheck phases' results as a fixture.

    JAX_PLATFORMS=cpu python scripts/make_sumcheck_fixture.py [OUT]

For log_n = 3..10 it runs spartan_tpu/protocol/fused.py's sc1_phase (with
prover round 4) and sc2_phase, the JAX package's fused cores, on tables,
challenges tor and a chain state drawn from random.Random(seed) by
``phase_inputs`` (tests/test_torch_fs_device.py draws the same), and writes
their messages, challenges, round 4's values and the chain states as hex to
tests/fixtures/sumcheck_phases_jax.json. The JAX programs take about half a
minute a size to compile on a CPU, too long for the CPU tests, which hold
the port's phases against this file instead.
"""

from __future__ import annotations

import json
import os
import random
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spartan_tpu.host import field as hf  # noqa: E402
from spartan_tpu.ops import field as jf  # noqa: E402
from spartan_tpu.ops import mle as jm  # noqa: E402
from spartan_tpu.protocol import fused as jfu  # noqa: E402

LOG_NS = range(3, 11)


def phase_inputs(log_n: int):
    """Tables Az, Bz, Cz, W, Z (n canonical ints each), tor (log_n ints) and
    a 32-byte chain state, from random.Random(1000 + log_n)."""
    rng = random.Random(1000 + log_n)
    n = 1 << log_n
    tabs = [[rng.randrange(hf.R) for _ in range(n)] for _ in range(5)]
    tor = [rng.randrange(hf.R) for _ in range(log_n)]
    state = bytes(rng.randrange(256) for _ in range(32))
    return tabs, tor, state


def _hex(ints) -> list:
    return [f"{int(x):x}" for x in ints]


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tests", "fixtures", "sumcheck_phases_jax.json")
    res = {}
    for log_n in LOG_NS:
        tabs, tor, state = phase_inputs(log_n)
        st = jnp.asarray(np.frombuffer(state, dtype="<u4").copy())
        mont = [jf.encode_mont(jf.FR, t) for t in tabs]
        tor_m = jf.encode_mont(jf.FR, tor)
        ev1, rs1, vabc, rabc, st1 = jfu.sc1_phase(*mont[:3], tuple(jm.eq_suffix_tables_mont(tor_m)), tor_m, st)
        ev2, rs2, st2 = jfu.sc2_phase(mont[3], mont[4], st)
        res[str(log_n)] = {
            "sc1": {"evals": [_hex(jf.decode_ints(jf.FR, e)) for e in ev1], "rs": _hex(jf.decode_ints(jf.FR, rs1)),
                    "vabc": _hex(jf.decode_ints(jf.FR, vabc)), "rabc": _hex(jf.decode_ints(jf.FR, rabc)),
                    "state": np.asarray(st1).astype("<u4").tobytes().hex()},
            "sc2": {"evals": [_hex(jf.decode_ints(jf.FR, e)) for e in ev2], "rs": _hex(jf.decode_ints(jf.FR, rs2)),
                    "state": np.asarray(st2).astype("<u4").tobytes().hex()},
        }
        print(f"log_n={log_n} done", flush=True)
    with open(out, "w") as fh:
        json.dump(res, fh, indent=0)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
