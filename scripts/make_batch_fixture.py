"""Write spartan_tpu's batched proofs (``prove_many``) as a fixture.

    JAX_PLATFORMS=cpu python scripts/make_batch_fixture.py [OUT]

Two cases at log_n = 3, B = 2, both on the keys of key seed 11:

- ``free``: tests/test_batch.py's case (circuit seed 5, density 1), whose
  instances it makes distinct by setting free witness variables (columns no
  matrix entry references); at 2^3 there is none, so its two instances are
  one;
- ``seeds``: density 0, circuit seeds 0 and 1, which give the same matrices
  with different v and w, as chip_smoke.py's batched phase makes them.

It writes each case's inputs (v and w as hex), the seeds they came from and
every proof's bytes as hex to tests/fixtures/prove_many_jax.json, and under
"keys" the parts of the keys that the commits, the openings and the
verifier read (g, h, powers_of_g[0], powers_of_h_comb and the verifier's
g_mask_random, affine, as hex), so that a test can hold commit_many,
open_many and verify_batch against these proofs without running the setup.
The JAX package's batched program family takes many minutes to compile on
a CPU, too long for the CPU tests, which hold the port's ``prove_many``
against this file instead.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from spartan_tpu.host import field as hf  # noqa: E402
from spartan_tpu.ops import curve as cv  # noqa: E402
from spartan_tpu.models.synthesizer import generate_circuit_with_random_input  # noqa: E402
from spartan_tpu.protocol.argument import MLArgumentForR1CS  # noqa: E402
from spartan_tpu.protocol.batched import prove_many  # noqa: E402

LOG_N, LOG_V, KEY_SEED = 3, 2, 11


class _Rng:
    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def sample_fr(self) -> int:
        return self._r.randrange(hf.R)


def circuit(density: int, seed: int):
    cs, v, w = generate_circuit_with_random_input(
        num_public=1 << LOG_V, num_private=(1 << LOG_N) - (1 << LOG_V),
        pad_to_square=True, density=density, rng=random.Random(seed))
    return cs.to_matrices(), v, w


def free_case():
    """tests/test_batch.py:test_prove_many_bit_identical's instances."""
    (a, b, c), v, w = circuit(1, 5)
    used = {idx for m in (a, b, c) for row in m for _, idx in row}
    free = [i - len(v) for i in range(len(v), len(v) + len(w)) if i not in used]
    instances = [(v, list(w)), (v, list(w))]
    for k, fi in enumerate(free[: len(instances)]):
        for j in range(k + 1):
            instances[k][1][fi] = (j + 7) % hf.R
    return (a, b, c), instances, {"density": 1, "circuit_seeds": [5]}


def seeds_case():
    """Density 0, circuit seeds 0 and 1: one set of matrices, two witnesses."""
    (a, b, c), v0, w0 = circuit(0, 0)
    m1, v1, w1 = circuit(0, 1)
    if m1 != (a, b, c):
        raise SystemExit("circuit seeds 0 and 1 at density 0 gave different matrices")
    return (a, b, c), [(v0, w0), (v1, w1)], {"density": 0, "circuit_seeds": [0, 1]}


def _hex(xs) -> list:
    return [f"{int(x):x}" for x in xs]


def _g1_hex(pt) -> list:
    return [f"{c:x}" for c in pt]


def _g2_hex(pt) -> list:
    return [[f"{c:x}" for c in coord] for coord in pt]


def keys(pp, vp) -> dict:
    """The affine points commits, openings and the verifier read, as hex."""
    return {"nv": pp.nv, "g": _g1_hex(pp.g), "h": _g2_hex(pp.h),
            "g_mask_random": [_g1_hex(p) for p in vp.g_mask_random],
            "powers_of_g0": [_g1_hex(p) for p in cv.g1_decode(pp.powers_of_g[0])],
            "powers_of_h_comb": [[_g2_hex(p) for p in cv.g2_decode(lv)] for lv in pp.powers_of_h_comb]}


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tests", "fixtures", "prove_many_jax.json")
    pp, vp = MLArgumentForR1CS.setup(LOG_N, _Rng(KEY_SEED))
    res = {"keys": keys(pp, vp)}
    for name, make in (("free", free_case), ("seeds", seeds_case)):
        (a, b, c), instances, meta = make()
        pk = MLArgumentForR1CS.index(a, b, c)
        t0 = time.perf_counter()
        proofs = prove_many(pk, instances, pp)
        print(f"{name}: prove_many B={len(instances)} took {time.perf_counter() - t0:.1f} s", flush=True)
        res[name] = {"log_n": LOG_N, "log_v": LOG_V, "key_seed": KEY_SEED, **meta,
                     "instances": [{"v": _hex(v), "w": _hex(w)} for v, w in instances],
                     "proofs": [p.serialize().hex() for p in proofs]}
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
