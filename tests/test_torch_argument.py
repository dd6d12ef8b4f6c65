"""The port's whole argument at 2^5 (circuit seed 3, key seed 7).

- its proof bytes equal the golden fixture tests/fixtures/proof_2e5_seed3.bin;
- spartan_tpu's own Proof.deserialize + MLArgumentForR1CS.verify accept it;
- the port's verify accepts it and rejects a tampered proof and a wrong
  public input.
"""

import pathlib
import random

import pytest
import torch

from spartan_tpu.host import field as hf
from spartan_tpu.models.synthesizer import generate_circuit_with_random_input
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.utils.errors import SpartanError

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "proof_2e5_seed3.bin"


class SeededFr:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def sample_fr(self):
        return self._r.randrange(hf.R)


@pytest.fixture(scope="module")
def instance():
    log_n, log_v = 5, 2
    cs, v, w = generate_circuit_with_random_input(
        num_public=1 << log_v, num_private=(1 << log_n) - (1 << log_v),
        pad_to_square=True, density=1, rng=random.Random(3),
    )
    a, b, c = cs.to_matrices()
    pp, vp = MLArgumentForR1CS.setup(log_n, SeededFr(7), "cpu")
    pk = MLArgumentForR1CS.index(a, b, c, "cpu")
    proof = MLArgumentForR1CS.prove(pk, v, w, pp)
    return (a, b, c), v, pk, vp, proof


def test_proof_bytes_equal_golden_fixture(instance):
    _m, _v, _pk, _vp, proof = instance
    assert proof.serialize() == GOLDEN.read_bytes()


def test_jax_package_verifier_accepts_port_proof(instance):
    from spartan_tpu.commitment import VerifierParameter
    from spartan_tpu.protocol.argument import MLArgumentForR1CS as JaxArgument
    from spartan_tpu.protocol.proof import Proof as JaxProof

    (a, b, c), v, _pk, vp, proof = instance
    jax_proof = JaxProof.deserialize(proof.serialize())
    jax_vk = JaxArgument.index(a, b, c).vk()
    jax_vp = VerifierParameter(nv=vp.nv, g=vp.g, h=vp.h, g_mask_random=vp.g_mask_random)
    assert JaxArgument.verify(jax_vk, v, jax_proof, jax_vp)


def test_port_verify_accepts_and_round_trips(instance):
    _m, v, pk, vp, proof = instance
    again = Proof.deserialize(proof.serialize())
    assert again.serialize() == proof.serialize()
    assert MLArgumentForR1CS.verify(pk.vk(), v, again, vp) is True


@pytest.mark.parametrize("how", ["opening_sign_byte", "sumcheck_value", "public_input"])
def test_port_verify_rejects_tampering(instance, how):
    _m, v, pk, vp, proof = instance
    data = bytearray(proof.serialize())
    log_n = pk.log_n
    if how == "opening_sign_byte":  # last opening's first point -> its negation
        data[len(data) - log_n * 96 + 95] ^= 0x80
    elif how == "sumcheck_value":  # low byte of the first sumcheck-1 evaluation
        # commitment 8 + 48; z_rv_0 32 + opening 96 + 8 + log_n * 96;
        # index info 16; message count 8; evaluation count 8
        data[56 + 32 + 96 + 8 + log_n * 96 + 16 + 8 + 8] ^= 0x01
    else:
        v = [(v[0] + 1) % hf.R] + list(v[1:])
    bad = Proof.deserialize(bytes(data))
    with pytest.raises(SpartanError):
        MLArgumentForR1CS.verify(pk.vk(), v, bad, vp)


def _entry_points():
    from spartan_tpu_torch.commitment import keygen
    from spartan_tpu_torch.protocol import indexer

    return {"setup": MLArgumentForR1CS.setup, "index": MLArgumentForR1CS.index,
            "keygen": keygen, "indexer.index": indexer.index}


@pytest.mark.parametrize("name", ["setup", "index", "keygen", "indexer.index"])
def test_entry_points_default_to_the_card(name):
    import inspect

    assert inspect.signature(_entry_points()[name]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["setup", "index", "keygen", "indexer.index"])
def test_entry_point_without_a_card_raises_instead_of_using_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device builds there")
    fn = _entry_points()[name]
    args = (2, SeededFr(1)) if name in ("setup", "keygen") else ([[(0, 1)]] * 2,) * 3
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
