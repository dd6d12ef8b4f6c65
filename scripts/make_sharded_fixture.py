"""Write spartan_tpu's sharded sumcheck rounds and MSMs, and its generic
sumcheck prover's messages, as a fixture.

    python scripts/make_sharded_fixture.py [OUT]

Runs ``spartan_tpu.parallel.sharded`` on XLA's virtual 8-device CPU mesh
(as tests/conftest.py sets it up) at D = 2, 4 and 8 devices:

- ``rounds``: the sharded sumcheck-1 round (``make_sharded_sc1_round``) and
  the sharded degree-2 round (``make_sharded_prod2_round``) on 16 and 32
  entries, with and without the fold; their evaluations and the tables they
  return;
- ``msm``: the point-range-sharded MSM (``make_sharded_msm``, 8-bit
  windows) in G1 and G2 on 16, 32 and 64 points, some with one shard's
  scalars all zero (its partial point is infinity); the points are the
  chain P_0 = s0 G, P_(i+1) = P_i + s1 G, so only s0 and s1 are stored;
- ``sumcheck``: ``spartan_tpu.protocol.sumcheck``'s generic prover
  (``prover_init``, ``prove_round``) on two combinations of products, every
  round's message under the stored challenges.

Every input is drawn from a seeded ``numpy`` generator and stored (Fr
values as hex), and every output as hex; tests/test_torch_sharded.py holds
the port's counterparts against this file. The JAX programs take a few
minutes to compile on a CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_enable_async_dispatch", False)

from spartan_tpu.host import curve as hc  # noqa: E402
from spartan_tpu.host import field as hf  # noqa: E402
from spartan_tpu.ops import curve as cv  # noqa: E402
from spartan_tpu.ops import field as fo  # noqa: E402
from spartan_tpu.ops.field import FR  # noqa: E402
from spartan_tpu.parallel import sharded as sh  # noqa: E402
from spartan_tpu.protocol import sumcheck as sc  # noqa: E402

ROUND_CASES = [(d, n, fold) for d in (2, 4, 8) for n, fold in ((32, True), (16, False))]
# (group, devices, points, shard whose scalars are all zero or None)
MSM_CASES = [("g1", 2, 16, None), ("g1", 4, 32, 1), ("g1", 8, 64, None),
             ("g2", 2, 16, 0), ("g2", 4, 32, None), ("g2", 8, 64, 5)]
# (num_variables, factors of each product)
SUMCHECK_CASES = [(3, [2]), (4, [3, 1, 2])]


def draw(rng: np.random.Generator, n: int) -> list:
    return [int.from_bytes(rng.bytes(32), "little") % hf.R for _ in range(n)]


def chain_points(group: str, n: int, s0: int, s1: int) -> list:
    ops, gen = (hc.G1, hf.G1_GEN) if group == "g1" else (hc.G2, hf.G2_GEN)
    p, step = ops.mul(gen, s0), ops.mul(gen, s1)
    out = []
    for _ in range(n):
        out.append(p)
        p = ops.add(p, step)
    return out


def _hex(xs) -> list:
    return [f"{int(x):x}" for x in xs]


def _pt_hex(group: str, pt):
    if pt is None:
        return None
    if group == "g1":
        return _hex(pt)
    return [_hex(c) for c in pt]


def round_case(d: int, n: int, fold: bool) -> dict:
    rng = np.random.default_rng(100 * d + n + int(fold))
    az, bz, cz, w, z = (draw(rng, n) for _ in range(5))
    s = draw(rng, n // 4 if fold else n // 2)
    r = draw(rng, 1)[0] if fold else 0
    mesh = sh.make_mesh(d)
    mont = lambda xs: fo.encode_mont(FR, xs)  # noqa: E731
    back = lambda t: fo.decode_mont(FR, jax.device_get(t))  # noqa: E731
    ev1, az2, bz2, cz2 = sh.make_sharded_sc1_round(mesh, do_fold=fold)(
        *(sh.shard_table(mesh, mont(t)) for t in (az, bz, cz, s)), mont([r]))
    ev2, w2, z2 = sh.make_sharded_prod2_round(mesh, do_fold=fold)(
        sh.shard_table(mesh, mont(w)), sh.shard_table(mesh, mont(z)), mont([r]))
    return {"devices": d, "n": n, "fold": fold, "az": _hex(az), "bz": _hex(bz), "cz": _hex(cz),
            "s": _hex(s), "w": _hex(w), "z": _hex(z), "r": f"{r:x}",
            "sc1": {"evals": _hex(back(ev1)), "az": _hex(back(az2)), "bz": _hex(back(bz2)),
                    "cz": _hex(back(cz2))},
            "prod2": {"evals": _hex(back(ev2)), "w": _hex(back(w2)), "z": _hex(back(z2))}}


def msm_case(group: str, d: int, n: int, zero_shard) -> dict:
    rng = np.random.default_rng(1000 + 10 * d + n + (group == "g2"))
    s0, s1 = draw(rng, 2)
    scalars = draw(rng, n)
    if zero_shard is not None:
        m = n // d
        scalars[zero_shard * m : (zero_shard + 1) * m] = [0] * m
    mesh = sh.make_mesh(d)
    pts = chain_points(group, n, s0, s1)
    enc, dec = (cv.g1_encode, cv.g1_decode) if group == "g1" else (cv.g2_encode, cv.g2_decode)
    res = sh.make_sharded_msm(mesh, "fp" if group == "g1" else "fp2")(
        sh.shard_points(mesh, enc(pts)), sh.shard_table(mesh, fo.encode_ints(FR, scalars)))
    return {"group": group, "devices": d, "n": n, "zero_shard": zero_shard, "s0": f"{s0:x}",
            "s1": f"{s1:x}", "scalars": _hex(scalars), "result": _pt_hex(group, dec(res)[0])}


def sumcheck_case(nv: int, factors: list) -> dict:
    rng = np.random.default_rng(7000 + nv)
    tables = [[draw(rng, 1 << nv) for _ in range(k)] for k in factors]
    challenges = draw(rng, nv - 1)
    state = sc.prover_init([[fo.encode_mont(FR, t) for t in prod] for prod in tables], nv)
    msgs = [sc.prove_round(state, None).evaluations]
    for r in challenges:
        msgs.append(sc.prove_round(state, sc.VerifierMsg(randomness=r)).evaluations)
    info = sc.index_info(state)
    return {"num_variables": nv, "products": [[_hex(t) for t in prod] for prod in tables],
            "challenges": _hex(challenges), "messages": [_hex(m) for m in msgs],
            "index_info": [info.max_multiplicands, info.num_variables]}


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "tests", "fixtures", "sharded_jax.json")
    if len(jax.devices()) < 8:
        raise SystemExit(f"needs the 8-device virtual CPU mesh, found {len(jax.devices())} devices")
    res = {"rounds": [], "msm": [], "sumcheck": []}
    for key, cases, make in (("rounds", ROUND_CASES, round_case), ("msm", MSM_CASES, msm_case),
                             ("sumcheck", SUMCHECK_CASES, sumcheck_case)):
        for case in cases:
            t0 = time.perf_counter()
            res[key].append(make(*case))
            print(f"{key} {case}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
