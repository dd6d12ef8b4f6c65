"""Port protocol host logic: the sumcheck verifier, the proof wire format and
the indexer, against Python integers, the golden proof bytes and the JAX
package's own parser and transcript bytes.
"""

import pathlib
import random

import pytest

from spartan_tpu.host import field as hf
from spartan_tpu.protocol import indexer as jindexer
from spartan_tpu.protocol.proof import Proof as JaxProof
from spartan_tpu_torch import timers
from spartan_tpu_torch.protocol import indexer as tindexer
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.utils.errors import SpartanError

GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "proof_2e5_seed3.bin"


class SeededFr:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def sample_fr(self):
        return self._r.randrange(hf.R)


def _poly_at(coeffs, x):
    return sum(c * pow(x, i, hf.R) for i, c in enumerate(coeffs)) % hf.R


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 7])
def test_interpolate_uni_poly_matches_direct_evaluation(degree):
    rng = random.Random(degree)
    coeffs = [rng.randrange(hf.R) for _ in range(degree + 1)]
    evals = [_poly_at(coeffs, t) for t in range(degree + 1)]
    for r in (0, degree, rng.randrange(hf.R)):
        assert sc.interpolate_uni_poly(evals, r) == _poly_at(coeffs, r)


def _honest_rounds(nv: int, degree: int, seed: int):
    """Round polynomials of sum_b f(b) for a product of `degree` random
    multilinear tables, as the prover would send them."""
    rng = random.Random(seed)
    tables = [[rng.randrange(hf.R) for _ in range(1 << nv)] for _ in range(degree)]
    claimed = sum(_prod(t[b] for t in tables) for b in range(1 << nv)) % hf.R
    return tables, claimed


def _prod(xs):
    out = 1
    for x in xs:
        out = out * x % hf.R
    return out


def _run_sumcheck(tables, degree, tamper_round=None):
    fs = SeededFr(99)
    info = sc.IndexInfo(max_multiplicands=degree, num_variables=len(tables[0]).bit_length() - 1)
    state = sc.verifier_init(info)
    for i in range(info.num_variables):
        evals = []
        for t in range(degree + 1):
            folded = [[(tab[2 * b] + t * (tab[2 * b + 1] - tab[2 * b])) % hf.R
                       for b in range(len(tab) // 2)] for tab in tables]
            evals.append(sum(_prod(col) for col in zip(*folded)) % hf.R)
        if i == tamper_round:
            evals[0] = (evals[0] + 1) % hf.R
        r = sc.verify_round(state, sc.ProverMsg(evaluations=evals), fs).randomness
        tables = [[(tab[2 * b] + r * (tab[2 * b + 1] - tab[2 * b])) % hf.R
                   for b in range(len(tab) // 2)] for tab in tables]
    return state, tables


@pytest.mark.parametrize("tamper_round", [None, 0, 2])
def test_sumcheck_verifier_subclaim(tamper_round):
    tables, claimed = _honest_rounds(3, 2, 5)
    state, final = _run_sumcheck(tables, 2, tamper_round)
    if tamper_round is None:
        sub = sc.check_and_generate_subclaim(state, claimed)
        assert sub.point == state.randomness
        assert sub.expected_evaluation == _prod(t[0] for t in final)
    else:
        with pytest.raises(SpartanError):
            sc.check_and_generate_subclaim(state, claimed)


def test_sumcheck_verifier_rejects_malformed_rounds():
    fs = SeededFr(1)
    state = sc.verifier_init(sc.IndexInfo(max_multiplicands=2, num_variables=1))
    with pytest.raises(SpartanError):
        sc.verify_round(state, sc.ProverMsg(evaluations=[1, 2]), fs)
    sc.verify_round(state, sc.ProverMsg(evaluations=[1, 2, 3]), fs)
    with pytest.raises(SpartanError):
        sc.verify_round(state, sc.ProverMsg(evaluations=[1, 2, 3]), fs)
    with pytest.raises(SpartanError):
        sc.check_and_generate_subclaim(sc.verifier_init(state.index_info), 0)


def test_golden_proof_parses_like_the_jax_package():
    data = GOLDEN.read_bytes()
    proof = Proof.deserialize(data)
    assert proof.serialize() == data
    assert JaxProof.deserialize(data).serialize() == data
    assert len(proof.first_sumcheck_messages) == len(proof.second_sumcheck_messages) == 5
    assert proof.prover_sixth_message.z_ry == JaxProof.deserialize(data).prover_sixth_message.z_ry


@pytest.mark.parametrize("cut", ["empty", "header", "mid_opening", "last_byte", "trailing"])
def test_proof_deserialize_rejects_bad_lengths(cut):
    data = GOLDEN.read_bytes()
    bad = {"empty": b"", "header": data[:8], "mid_opening": data[:200],
           "last_byte": data[:-1], "trailing": data + b"\x00"}[cut]
    with pytest.raises(SpartanError):
        Proof.deserialize(bad)


def _matrices():
    a = [[(1, 0), (hf.R - 1, 2)], [(5, 1)], [], [(7, 3), (1, 0)]]
    b = [[(2, 1)], [(1, 1), (3, 2)], [(hf.R - 2, 0)], []]
    c = [[], [(9, 3)], [(1, 2)], [(4, 1)]]
    return a, b, c


def test_index_transcript_bytes_match_jax_package():
    a, b, c = _matrices()
    mine = tindexer.index(a, b, c, "cpu")
    ref = jindexer.index(a, b, c)
    assert mine.log_n == ref.log_n == 2
    for m, r in ((mine.matrix_a, ref.matrix_a), (mine.matrix_b, ref.matrix_b),
                 (mine.matrix_c, ref.matrix_c)):
        assert m.serialize() == r.serialize()
        rows, cols, vals = m.coo
        assert rows.shape == cols.shape == vals.shape[1:]


@pytest.mark.parametrize("bad", ["three_rows", "column_out_of_range"])
def test_index_rejects_malformed_matrices(bad):
    a, b, c = _matrices()
    if bad == "three_rows":
        a, b, c = a[:3], b[:3], c[:3]
    else:
        b = [row[:] for row in b]
        b[0] = [(1, 4)]
    with pytest.raises(SpartanError):
        tindexer.index(a, b, c, "cpu")


def test_spans_accumulate_per_label():
    timers.reset()
    for _ in range(3):
        with timers.span("unit"):
            pass
    with pytest.raises(KeyError):
        with timers.span("raises"):
            raise KeyError("x")
    assert set(timers.SPANS) == {"unit", "raises"}
    assert all(s >= 0.0 for s in timers.SPANS.values())
    timers.reset()
    assert not timers.SPANS

# -- the port's own host layer against the JAX package's ----------------------


def test_serialize_bytes_match_jax_package():
    from spartan_tpu.utils import serialize as jser
    from spartan_tpu_torch.host import curve as thc
    from spartan_tpu_torch.utils import serialize as tser

    a, _b, _c = _matrices()
    assert tser.ser_matrix(a) == tser.ser_matrix_py(a) == jser.ser_matrix(a)
    rng = random.Random(4)
    xs = [rng.randrange(hf.R) for _ in range(3)]
    assert tser.ser_fr_vec(xs) == jser.ser_fr_vec(xs)
    for ops, ser, jser_pt, deser in ((thc.G1, tser.ser_g1, jser.ser_g1, tser.deser_g1),
                                     (thc.G2, tser.ser_g2, jser.ser_g2, tser.deser_g2)):
        gen = hf.G1_GEN if ops is thc.G1 else hf.G2_GEN
        for pt in (ops.mul(gen, rng.randrange(hf.R)), ops.neg(gen), None):
            data = ser(pt)
            assert data == jser_pt(pt)
            assert deser(data) == (pt, len(data))


def test_transcript_stream_matches_jax_package():
    from spartan_tpu.utils.transcript import Blake2sRng as JaxRng
    from spartan_tpu_torch.utils.transcript import Blake2sRng

    mine, ref, py = Blake2sRng.setup(), JaxRng.setup(), Blake2sRng.setup()
    py._native = None  # the Python stream must equal the native one
    seed = random.Random(8).randbytes(77)
    for fs in (mine, ref, py):
        fs.feed(seed)
    want = ref.sample_fr_vec(5)
    assert mine.sample_fr_vec(5) == py.sample_fr_vec(5) == want
    for fs in (mine, ref, py):
        fs.feed(b"round 2")
    assert mine.next_bytes(40) == py.next_bytes(40) == ref.next_bytes(40)


def test_synthesizer_circuit_matches_jax_package():
    from spartan_tpu.models.synthesizer import generate_circuit_with_random_input as jgen
    from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input as tgen

    cs, v, w = tgen(num_public=4, num_private=(1 << 5) - 4, pad_to_square=True, density=1,
                    rng=random.Random(3))
    jcs, jv, jw = jgen(num_public=4, num_private=(1 << 5) - 4, pad_to_square=True, density=1,
                       rng=random.Random(3))
    assert (v, w) == (jv, jw)
    assert cs.to_matrices() == jcs.to_matrices()
    assert cs.is_satisfied()
