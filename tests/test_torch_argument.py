"""The port's whole argument at 2^5 (circuit seed 3, key seed 7), proved
through the default route, the device-resident transcript (on the CPU, its
plain versions; tests/test_torch_fs_device.py holds it against the host
loop):

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
from spartan_tpu_torch import timers
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
    timers.reset()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp)
    ROUTE_SPANS.extend(timers.SPANS)
    return (a, b, c), v, pk, vp, proof


ROUTE_SPANS = []  # the spans of the fixture's prove


def test_prove_takes_the_device_transcript_by_default(instance):
    """The proof these tests hold came through the device-resident sumcheck
    phases, the default route (SPARTAN_DEVICE_FS unset)."""
    assert "Prove Sumcheck 1 (fused)" in ROUTE_SPANS and "Prove Sumcheck 2 (fused)" in ROUTE_SPANS
    assert "Prove Sumcheck 1" not in ROUTE_SPANS


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


ENTRY_POINTS = ["setup", "index", "keygen", "indexer.index", "pp_from_numpy",
                "fixed_base_table_device", "MatrixExtension.new"]


def _entry_points():
    """name -> (function, arguments that would build on the default device)"""
    from spartan_tpu.host import curve as hc
    from spartan_tpu_torch.commitment import keygen, pp_from_numpy
    from spartan_tpu_torch.ops import curve as cv
    from spartan_tpu_torch.ops import msm
    from spartan_tpu_torch.protocol import indexer

    mats = ([[(0, 1)]] * 2,) * 3
    return {"setup": (MLArgumentForR1CS.setup, (2, SeededFr(1))),
            "index": (MLArgumentForR1CS.index, mats),
            "keygen": (keygen, (2, SeededFr(1))),
            "indexer.index": (indexer.index, mats),
            "pp_from_numpy": (pp_from_numpy, (1, [()], [()], hf.G1_GEN, hf.G2_GEN)),
            "fixed_base_table_device": (msm.fixed_base_table_device,
                                        (hf.G1_GEN, hc.G1, cv.g1_encode, 4)),
            "MatrixExtension.new": (indexer.MatrixExtension.new, (mats[0], 2))}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    import inspect

    assert inspect.signature(_entry_points()[name][0]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_a_card_raises_instead_of_using_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device builds there")
    fn, args = _entry_points()[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
