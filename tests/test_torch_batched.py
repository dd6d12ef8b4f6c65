"""The port's batched prover, ``spartan_tpu_torch/protocol/batched.py``, on the
CPU (plain versions), held against the JAX package's ``prove_many`` through
tests/fixtures/prove_many_jax.json (scripts/make_batch_fixture.py; about ten
minutes of JAX compile on a CPU, so no live JAX call is made here):

- ``prove_many``'s proofs equal the fixture's bytes and the port's
  sequential proofs (``prove_batch``), for tests/test_batch.py's case
  (log_n = 3, B = 2, density 1, circuit seed 5, key seed 11; at 2^3 its
  circuit has no free witness variable, so its two instances are one) and
  a density-0 case of circuit seeds 0 and 1, two distinct instances. The
  commitment's messages are taken from the fixture by stand-ins that check
  what they are asked: the committed tables, and each opening's evaluation
  at the point it is asked for. So no MSM runs there; ``commit_many``, ``open_many`` and ``verify_batch`` are
  held against the fixture on its own keys by tests of their own;
- the batched sparse products, eq tables, fold and both batched sumcheck
  phases against the single-instance port functions for each of B = 3
  instances, one of them an entry of tests/fixtures/sumcheck_phases_jax.json;
- the errors, as ``InvalidArgument``.

The batch-axis kernels themselves are compiled and held against their plain
versions by tests/test_torch_csrc_host.py here and by chip_smoke.py on the
card, which also holds a 2^16 ``prove_many`` of 64 instances against the
sequential proofs.
"""

import json
import pathlib
import random
import types

import pytest
import torch

from spartan_tpu_torch.commitment import PublicParameter, VerifierParameter
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle, sparse
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.protocol import batched, fused
from spartan_tpu_torch.protocol import prover as pr
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.utils.errors import InvalidArgument

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIX = json.loads((FIXTURES / "prove_many_jax.json").read_text())


def _h(x: str) -> int:
    return int(x, 16)


def _g1(p):
    return _h(p[0]), _h(p[1])


def _g2(p):
    return (_h(p[0][0]), _h(p[0][1])), (_h(p[1][0]), _h(p[1][1]))


@pytest.fixture(scope="module")
def keys():
    """The fixture's keys (key seed 11, nv = 3) as the port's parameters:
    the parts commits, openings and the verifier read."""
    k = FIX["keys"]
    pp = PublicParameter(nv=k["nv"], powers_of_g=[cv.g1_encode([_g1(p) for p in k["powers_of_g0"]])],
                         powers_of_h=[], g=_g1(k["g"]), h=_g2(k["h"]),
                         powers_of_h_comb=[cv.g2_encode([_g2(p) for p in lv]) for lv in k["powers_of_h_comb"]])
    vp = VerifierParameter(nv=k["nv"], g=_g1(k["g"]), h=_g2(k["h"]),
                           g_mask_random=[_g1(p) for p in k["g_mask_random"]])
    return pp, vp


def _circuit(case: dict, seed: int):
    log_n, log_v = case["log_n"], case["log_v"]
    cs, v, w = generate_circuit_with_random_input(num_public=1 << log_v, num_private=(1 << log_n) - (1 << log_v),
                                                  pad_to_square=True, density=case["density"],
                                                  rng=random.Random(seed))
    return cs.to_matrices(), v, w


@pytest.fixture(scope="module", params=["free", "seeds"])
def case(request):
    """A fixture case: its pk on the CPU, instances and the JAX proofs."""
    c = FIX[request.param]
    mats, _v, _w = _circuit(c, c["circuit_seeds"][0])
    instances = [([_h(x) for x in i["v"]], [_h(x) for x in i["w"]]) for i in c["instances"]]
    if request.param == "seeds":  # distinct circuit seeds: one circuit, their own v and w
        for seed, inst in zip(c["circuit_seeds"], instances):
            m, v, w = _circuit(c, seed)
            assert m == mats and (v, w) == inst
    pk = MLArgumentForR1CS.index(*mats, "cpu")
    proofs = [bytes.fromhex(p) for p in c["proofs"]]
    return types.SimpleNamespace(name=request.param, pk=pk, instances=instances, proofs=proofs,
                                 parsed=[Proof.deserialize(p) for p in proofs])


def _z(inst):
    v, w = inst
    return fo.encode_mont(FR, list(v) + list(w))


def _eval(z: torch.Tensor, point) -> int:
    return fo.decode_mont(FR, mle.eval_at(z, fo.encode_mont(FR, point)))[0]


def _opening(proof: Proof, k: int):
    m = proof.prover_second_message if k == 0 else proof.prover_sixth_message
    return (m.z_rv_0, m.proof_for_z_rv_0) if k == 0 else (m.z_ry, m.proof_for_z_ry)


def _stand_in_batched(monkeypatch, case):
    """commit_many and open_many return the fixture proofs' messages, after
    checking the tables they are given and each evaluation claim at the
    points they are asked for."""
    zs = torch.stack([_z(i) for i in case.instances])
    calls = []

    def commit_many(pp, polys):
        assert torch.equal(polys, zs)
        return [p.prover_first_message.commitment for p in case.parsed]

    def open_many(pp, polys, points):
        assert torch.equal(polys, zs)
        k = len(calls)
        calls.append(points)
        out = [_opening(p, k) for p in case.parsed]
        assert [_eval(z, pt) for z, pt in zip(zs, points)] == [ev for ev, _prf in out]
        return out

    monkeypatch.setattr(batched, "commit_many", commit_many)
    monkeypatch.setattr(batched, "open_many", open_many)
    return calls


def _stand_in_single(monkeypatch, proof: Proof, z: torch.Tensor):
    it = iter([_opening(proof, 0), _opening(proof, 1)])

    def open_poly(pp, poly, point):
        ev, prf = next(it)
        assert torch.equal(poly, z) and _eval(z, point) == ev
        return ev, prf, None

    monkeypatch.setattr(pr, "commit", lambda pp, poly: proof.prover_first_message.commitment)
    monkeypatch.setattr(pr, "open_poly", open_poly)


def test_prove_many_matches_jax_and_sequential(case, keys, monkeypatch):
    """prove_many's B proofs equal the JAX package's prove_many byte for byte,
    and the port's sequential prove of each instance; the stand-ins saw the
    two openings' points (r_v, 0..) and r_y."""
    from spartan_tpu_torch import timers

    pp, _vp = keys
    calls = _stand_in_batched(monkeypatch, case)
    timers.reset()
    got = [p.serialize() for p in batched.prove_many(case.pk, case.instances, pp)]
    assert got == case.proofs
    assert len(calls) == 2 and all(pt[2] == 0 for pt in calls[0])  # log_v = 2: z(r_v, 0)
    assert {"Batch Prove 1: commits", "Batch Prove SC1 (fused)", "Batch Prove 6: opens z(r_y)"} <= set(timers.SPANS)
    # the seeds case's instances differ; test_batch.py's two are one instance at 2^3 (no free variable)
    assert len(set(got)) == len({(tuple(v), tuple(w)) for v, w in case.instances}) == (2 if case.name == "seeds" else 1)
    for inst, proof, want in zip(case.instances, case.parsed, got):
        _stand_in_single(monkeypatch, proof, _z(inst))
        assert batched.prove_batch(case.pk, [inst], pp)[0].serialize() == want


def test_commit_many_matches_jax(keys):
    """One commit_many of the four instances of both cases (one msm_many of
    four problems over the shared bases) gives the fixture's commitments."""
    pp, _vp = keys
    insts = [i for name in ("free", "seeds") for i in FIX[name]["instances"]]
    zs = torch.stack([_z(([_h(x) for x in i["v"]], [_h(x) for x in i["w"]])) for i in insts])
    want = [Proof.deserialize(bytes.fromhex(p)).prover_first_message.commitment
            for name in ("free", "seeds") for p in FIX[name]["proofs"]]
    assert batched.commit_many(pp, zs) == want
    assert batched.commit_many(pp, list(zs[:1])) == want[:1]


def test_open_many_matches_jax(keys):
    """One open_many of the four instances of both cases at their points
    (r_v, 0), r_v replayed from each transcript, gives the fixture's
    evaluations and opening proofs."""
    from torch_golden import transcript_from_matrices

    pp, _vp = keys
    zs, points, want = [], [], []
    for name in ("free", "seeds"):
        c = FIX[name]
        mats, _v, _w = _circuit(c, c["circuit_seeds"][0])
        pk = MLArgumentForR1CS.index(*mats, "cpu")
        for i, p in zip(c["instances"], c["proofs"]):
            inst = ([_h(x) for x in i["v"]], [_h(x) for x in i["w"]])
            proof = Proof.deserialize(bytes.fromhex(p))
            fs = transcript_from_matrices(pk, inst[0])
            fs.feed(proof.prover_first_message.serialize())
            r_v = fs.sample_fr_vec(c["log_v"])
            zs.append(_z(inst))
            points.append(r_v + [0] * (c["log_n"] - c["log_v"]))
            want.append(_opening(proof, 0))
    got = batched.open_many(pp, torch.stack(zs), points)
    assert [(ev, prf.serialize()) for ev, prf in got] == [(ev, prf.serialize()) for ev, prf in want]


def test_verify_batch_accepts_the_jax_proofs_and_rejects_a_swap(keys):
    """verify_batch accepts each fixture proof for its own public input; the
    second instance's proof against the first's public input is rejected."""
    _pp, vp = keys
    c = FIX["seeds"]
    mats, _v, _w = _circuit(c, 0)
    pk = MLArgumentForR1CS.index(*mats, "cpu")
    insts = [([_h(x) for x in i["v"]], None) for i in c["instances"]]
    proofs = [Proof.deserialize(bytes.fromhex(p)) for p in c["proofs"]]
    assert batched.verify_batch(pk.vk(), insts, proofs, vp) == [True, True]
    try:
        ok = batched.verify_batch(pk.vk(), insts[:1], proofs[1:], vp)[0]
    except InvalidArgument:  # the verifier may raise instead of returning False
        ok = False
    assert ok is False


def _rand_tables(rng, bsz: int, n: int) -> torch.Tensor:
    return torch.stack([fo.encode_mont(FR, [rng.randrange(hf.R) for _ in range(n)]) for _ in range(bsz)])


@pytest.mark.parametrize("chunk", ["one pass", "an instance a pass"])
def test_batched_sparse_products_match_single(chunk, monkeypatch):
    """sum_over_y and eval_on_x_table on B = 3 instances equal the B = 1
    products of each, in one pass and in passes of one instance."""
    rng = random.Random(17)
    cs, _v, _w = generate_circuit_with_random_input(num_public=4, num_private=28, pad_to_square=True,
                                                    density=1, rng=random.Random(3))
    pk = MLArgumentForR1CS.index(*cs.to_matrices(), "cpu")
    coo = pk.matrix_b.coo
    if chunk != "one pass":
        monkeypatch.setattr(sparse, "SEGSUM_B_LANES", coo[0].shape[0])
    tabs = _rand_tables(rng, 3, 32)
    got_y, got_x = sparse.sum_over_y(coo, tabs, 32), sparse.eval_on_x_table(coo, tabs, 32)
    for b in range(3):
        assert torch.equal(got_y[b], sparse.sum_over_y(coo, tabs[b : b + 1], 32)[0])
        assert torch.equal(got_x[b], sparse.eval_on_x_table(coo, tabs[b : b + 1], 32)[0])


def test_batched_eq_tables_and_fold_match_single():
    """eq_suffix_tables_mont and eq_table on B = 3 points equal their B = 1
    tables of each point, and eq_suffix_tables of its ints."""
    rng = random.Random(23)
    nv, bsz = 4, 3
    pts = [[rng.randrange(hf.R) for _ in range(nv)] for _ in range(bsz)]
    ts = torch.stack([fo.encode_mont(FR, p) for p in pts])
    suffix, eq = mle.eq_suffix_tables_mont(ts), mle.eq_table(ts)
    assert [tuple(s.shape) for s in suffix] == [(bsz, 8, 1 << (nv - j)) for j in range(nv + 1)]
    for b in range(bsz):
        single = mle.eq_suffix_tables(pts[b])
        assert all(torch.equal(suffix[j][b], single[j]) for j in range(nv + 1))
        assert torch.equal(eq[b], mle.eq_table(ts[b : b + 1])[0])


def test_batched_phases_match_single_and_jax():
    """sc1_phase and sc2_phase at log_n = 9 (a round launch, then the tail)
    on B = 3 instances equal their B = 1 runs of each; instance 1 is the
    phases fixture's log_n = 9 entry, so it also equals the JAX package's
    fused phases."""
    log_n, bsz = 9, 3
    want = json.loads((FIXTURES / "sumcheck_phases_jax.json").read_text())[str(log_n)]
    fix = random.Random(1000 + log_n)  # as scripts/make_sumcheck_fixture.py draws them
    n = 1 << log_n
    fix_tabs = [[fix.randrange(hf.R) for _ in range(n)] for _ in range(5)]
    fix_tor = [fix.randrange(hf.R) for _ in range(log_n)]
    fix_state = bytes(fix.randrange(256) for _ in range(32))
    rng = random.Random(29)
    tabs = [_rand_tables(rng, bsz, n) for _ in range(5)]
    for t, ft in zip(tabs, fix_tabs):
        t[1] = fo.encode_mont(FR, ft)
    tors = [[rng.randrange(hf.R) for _ in range(log_n)] for _ in range(bsz)]
    tors[1] = fix_tor
    states = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(bsz)]
    states[1] = fix_state
    ts = torch.stack([fo.encode_mont(FR, t) for t in tors])
    r1 = fused.sc1_phase(*tabs[:3], mle.eq_suffix_tables_mont(ts), tors, states)
    r2 = fused.sc2_phase(tabs[3], tabs[4], states)
    for b in range(bsz):
        one = slice(b, b + 1)
        assert [r1[b]] == fused.sc1_phase(*(t[one] for t in tabs[:3]), [t[None] for t in mle.eq_suffix_tables(tors[b])],
                                          [tors[b]], [states[b]])
        assert [r2[b]] == fused.sc2_phase(tabs[3][one], tabs[4][one], [states[b]])
    ints = lambda xs: [_h(x) for x in xs]  # noqa: E731
    assert r1[1].evals == [ints(e) for e in want["sc1"]["evals"]] and r1[1].rs == ints(want["sc1"]["rs"])
    assert (r1[1].vabc, r1[1].rabc, r1[1].state.hex()) == (ints(want["sc1"]["vabc"]), ints(want["sc1"]["rabc"]),
                                                           want["sc1"]["state"])
    assert r2[1].evals == [ints(e) for e in want["sc2"]["evals"]] and r2[1].state.hex() == want["sc2"]["state"]


def _tiny_pk(log_n: int):
    coo = (torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64), torch.zeros((8, 1), dtype=torch.int32))
    m = types.SimpleNamespace(coo=coo)
    return types.SimpleNamespace(log_n=log_n, matrix_a=m, matrix_b=m, matrix_c=m)


@pytest.mark.parametrize("what", ["public lengths differ", "|v| + |w| != n", "log_n < 2", "no combined bases"])
def test_prove_many_errors(what, keys):
    """The JAX package's errors, as InvalidArgument, before any work."""
    pp, _vp = keys
    four = ([1, 2, 3, 4], [5, 6, 7, 8])
    with pytest.raises(InvalidArgument):
        if what == "public lengths differ":
            batched.prove_many(_tiny_pk(3), [four, ([1, 2], [3, 4, 5, 6, 7, 8])], pp)
        elif what == "|v| + |w| != n":
            batched.prove_many(_tiny_pk(3), [four, ([1, 2, 3, 4], [5, 6, 7])], pp)
        elif what == "log_n < 2":
            batched.prove_many(_tiny_pk(1), [([1], [2])], pp)
        else:
            no_comb = PublicParameter(nv=pp.nv, powers_of_g=pp.powers_of_g, powers_of_h=[], g=pp.g, h=pp.h)
            batched.open_many(no_comb, [_z(four)], [[1, 2, 3]])


def test_prove_many_of_nothing_is_empty(keys):
    assert batched.prove_many(_tiny_pk(3), [], keys[0]) == []
