"""The port's multi-device prover (``spartan_tpu_torch/parallel``), its
generic sumcheck prover and the verifier's device matrix evaluation, on
named CPU "devices" (``make_mesh(devices=["cpu"] * D)``): every sharded code
path runs, in one process.

- the sharded proof of the golden instance (2^5, circuit seed 3, key seed 7)
  at D = 2, 4 and 8 equals tests/fixtures/proof_2e5_seed3.bin, a
  spartan_tpu proof. No level of a 2^5 opening reaches the sharded G2
  MSM's threshold, so the opening's banded MSMs are computed once and
  reused (``torch_golden.reuse_openings``), and the sharded-level branch is
  held alone: with the threshold lowered, an opening whose largest level
  runs sharded gives the golden proof's second message;
- the sharded sumcheck rounds and the sharded G1 and G2 MSMs (8-bit
  windows, shards whose partial point is infinity), and the generic
  sumcheck prover's messages, equal spartan_tpu's on the same inputs
  (tests/fixtures/sharded_jax.json, from scripts/make_sharded_fixture.py);
- the verifier's device matrix evaluation equals the native walk, and
  verify accepts the golden proof on that route;
- make_mesh never falls back to the CPU.
"""

import json
import random

import numpy as np
import pytest
import torch
from torch_golden import GOLDEN, instance, keys, reuse_openings, transcript_from_matrices

from spartan_tpu_torch import timers
from spartan_tpu_torch.host import curve as hc
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.host import native
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.parallel import sharded, sharded_prove
from spartan_tpu_torch.protocol import prover as pr
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol import verifier as vr
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.utils.errors import SpartanError

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

JAX = json.loads((GOLDEN.parent / "sharded_jax.json").read_text())
SHARDED_SPANS = ["Prove 1 (sharded)", "Prove 2 (sharded)", "Prove 3 (sharded)", "Prove Sumcheck 1 (sharded)",
                 "Prove 4 (sharded)", "Prove 5 (sharded)", "Prove Sumcheck 2 (sharded)", "Prove 6 (sharded)"]


def cpu_mesh(d: int) -> sharded.Mesh:
    return sharded.make_mesh(devices=["cpu"] * d)


def ints(xs) -> list:
    return [int(x, 16) for x in xs]


@pytest.fixture(scope="module")
def golden():
    pk, v, w = instance()
    return (pk, v, w, *keys())


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_proof_equals_golden(golden, d, monkeypatch):
    reuse_openings(monkeypatch)
    pk, v, w, pp, _vp = golden
    timers.reset()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp, mesh=cpu_mesh(d))
    assert proof.serialize() == GOLDEN.read_bytes()
    assert [k for k in timers.SPANS if k in SHARDED_SPANS] == SHARDED_SPANS


def test_sharded_level_of_an_opening_equals_golden(golden, monkeypatch):
    """With SHARDED_LEVEL = 8 at D = 2, the opening at (r_v, 0)'s level of
    16 points runs the sharded G2 MSM and its four smaller levels the
    banded ones: the golden proof's second message."""
    pk, v, w, pp, _vp = golden
    monkeypatch.setattr(sharded_prove, "SHARDED_LEVEL", 8)
    sizes = []
    real_msm = sharded.msm

    def counted(mesh, points, scalars):
        sizes.append(sum(p.n for p in points))
        return real_msm(mesh, points, scalars)

    monkeypatch.setattr(sharded, "msm", counted)
    want = Proof.deserialize(GOLDEN.read_bytes())
    fs = transcript_from_matrices(pk, v)
    fs.feed(want.prover_first_message.serialize())
    r_v = fs.sample_fr_vec(len(v).bit_length() - 1)
    z_rv_0, op = sharded_prove.sharded_open(pp, fo.encode_mont(FR, v + w), list(r_v) + [0] * (5 - len(r_v)),
                                            cpu_mesh(2))
    assert sizes == [16]
    got = pr.ProverSecondMessage(z_rv_0=z_rv_0, proof_for_z_rv_0=op)
    assert got.serialize() == want.prover_second_message.serialize()


def test_sharded_prove_needs_pp_on_the_first_device(golden):
    pk, v, w, pp, _vp = golden
    with pytest.raises(SpartanError, match="first device"):
        MLArgumentForR1CS.prove(pk, v, w, pp, mesh=sharded.make_mesh(devices=["meta", "cpu"]))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (lambda: sharded.make_mesh(2), lambda: sharded.make_mesh(),
                 lambda: sharded.make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            call()
    assert sharded.make_mesh(devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 3


def test_shard_table_views_and_gather():
    t = torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16)
    mesh = cpu_mesh(4)
    shards = sharded.shard_table(mesh, t)
    assert all(s.data_ptr() == t[:, 4 * k].data_ptr() for k, s in enumerate(shards))  # views, no copies
    assert torch.equal(sharded.gather(mesh, shards), t)
    with pytest.raises(SpartanError):
        sharded.shard_table(cpu_mesh(3), t)


@pytest.mark.parametrize("case", JAX["rounds"], ids=lambda c: f"D{c['devices']}-n{c['n']}-fold{int(c['fold'])}")
def test_sharded_rounds_match_jax(case):
    mesh = cpu_mesh(case["devices"])
    mont = lambda k: fo.encode_mont(FR, ints(case[k]))  # noqa: E731
    r = fo.encode_mont(FR, [int(case["r"], 16)])
    fold = case["fold"]
    ev, *tabs = sharded.sc1_round(mesh, *(sharded.shard_table(mesh, mont(k)) for k in ("az", "bz", "cz")),
                                  mont("s"), fold, r)
    want = case["sc1"]
    assert fo.decode_mont(FR, ev) == ints(want["evals"])
    for k, t in zip(("az", "bz", "cz"), tabs):
        assert len(t) == case["devices"]
        assert fo.decode_mont(FR, sharded.gather(mesh, t)) == ints(want[k])
    ev, ws, zs = sharded.prod2_round(mesh, sharded.shard_table(mesh, mont("w")), sharded.shard_table(mesh, mont("z")),
                                     fold, r)
    want = case["prod2"]
    assert fo.decode_mont(FR, ev) == ints(want["evals"])
    assert fo.decode_mont(FR, sharded.gather(mesh, ws)) == ints(want["w"])
    assert fo.decode_mont(FR, sharded.gather(mesh, zs)) == ints(want["z"])


def _chain_points(group: str, n: int, s0: int, s1: int) -> list:
    ops, gen = (hc.G1, hf.G1_GEN) if group == "g1" else (hc.G2, hf.G2_GEN)
    p, step = ops.mul(gen, s0), ops.mul(gen, s1)
    out = []
    for _ in range(n):
        out.append(p)
        p = ops.add(p, step)
    return out


@pytest.mark.parametrize("case", JAX["msm"], ids=lambda c: f"{c['group']}-D{c['devices']}-n{c['n']}")
def test_sharded_msm_matches_jax(case):
    group, d = case["group"], case["devices"]
    mesh = cpu_mesh(d)
    pts = _chain_points(group, case["n"], int(case["s0"], 16), int(case["s1"], 16))
    enc, dec = (cv.g1_encode, cv.g1_decode) if group == "g1" else (cv.g2_encode, cv.g2_decode)
    scalars = fo.encode_ints(FR, ints(case["scalars"]))
    assert sharded.MSM_WINDOW == 8
    res = sharded.msm(mesh, sharded.shard_points(mesh, enc(pts)), sharded.shard_table(mesh, scalars))
    got = dec(res)[0]
    want = case["result"]
    want = tuple(ints(want)) if group == "g1" else tuple(tuple(ints(c)) for c in want)
    assert got == want
    if case["zero_shard"] is not None:  # that shard's partial is infinity and passes through the reduction
        m = case["n"] // d
        k = case["zero_shard"]
        assert not any(ints(case["scalars"])[k * m : (k + 1) * m])


def test_tree_reduce_odd_count():
    """Six partials, one of them infinity, then three: at three the
    halving's odd lane is added into the first."""
    pts = _chain_points("g1", 5, 3, 5)
    got = cv.g1_decode(sharded.tree_reduce(cv.g1_encode(pts + [None])))[0]
    assert got == hc.G1.mul(hf.G1_GEN, sum(3 + 5 * i for i in range(5)))
    assert cv.g1_decode(sharded.tree_reduce(cv.g1_encode(pts[:3])))[0] == hc.G1.mul(hf.G1_GEN, 3 + 8 + 13)


@pytest.mark.parametrize("case", JAX["sumcheck"], ids=lambda c: f"nv{c['num_variables']}")
def test_generic_sumcheck_prover_matches_jax(case):
    nv = case["num_variables"]
    products = [[fo.encode_mont(FR, ints(t)) for t in prod] for prod in case["products"]]
    state = sc.prover_init(products, nv)
    assert [sc.index_info(state).max_multiplicands, sc.index_info(state).num_variables] == case["index_info"]
    msgs = [sc.prove_round(state, None).evaluations]
    for r in ints(case["challenges"]):
        msgs.append(sc.prove_round(state, sc.VerifierMsg(randomness=r)).evaluations)
    assert msgs == [ints(m) for m in case["messages"]]
    with pytest.raises(SpartanError):
        sc.prove_round(state, sc.VerifierMsg(randomness=1))
    # the transcript's own check: each message sums to the previous one's value at its challenge
    vs = sc.verifier_init(sc.index_info(state))
    rs = iter(ints(case["challenges"]) + [5])
    vs.polynomials, vs.randomness, vs.finished = msgs, list(rs), True
    claim = sum(
        np.prod([ints(t)[b] for t in prod], dtype=object) for prod in case["products"] for b in range(1 << nv)) % hf.R
    sc.check_and_generate_subclaim(vs, claim)


def test_eval_binary_matches_jax():
    from spartan_tpu.ops import field as jfo
    from spartan_tpu.ops import mle as jmle

    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % hf.R for _ in range(16)]
    t = fo.encode_mont(FR, vals)
    jt = jfo.encode_mont(jfo.FR, vals)
    for idx in (0, 5, 15):
        assert fo.decode_mont(FR, mle.eval_binary(t, idx)) == jfo.decode_mont(jfo.FR, jmle.eval_binary(jt, idx))


def test_device_matrix_evals_equal_native(golden):
    pk = golden[0]
    rng = random.Random(11)
    r_x = [rng.randrange(hf.R) for _ in range(5)]
    r_y = [rng.randrange(hf.R) for _ in range(5)]
    want = native.matrix_eval3_native(pk.matrix_a.serialize(), pk.matrix_b.serialize(), pk.matrix_c.serialize(),
                                      r_x, r_y, 5)
    assert want is not None
    assert vr.matrix_evals_device(pk.vk(), r_x, r_y) == want


def test_verify_takes_the_device_route_without_native(golden, monkeypatch):
    """Where the native walk returns None, verify takes the device matrix
    evaluation."""
    pk, v, _w, _pp, vp = golden
    monkeypatch.setattr(native, "matrix_eval3_native", lambda *a: None)
    timers.reset()
    assert MLArgumentForR1CS.verify(pk.vk(), v, Proof.deserialize(GOLDEN.read_bytes()), vp) is True
    assert "Verify: matrix evals at (r_x, r_y) (device)" in timers.SPANS
