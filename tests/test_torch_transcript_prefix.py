"""The transcript's prefix over the index, on the CPU: ``index`` keeps the
chain state after absorbing the serialized A, B and C (``fs_state``), and
``prove`` and ``verify`` start their transcripts from it.

- the state equals a Blake2s chain over the matrices' bytes computed with
  hashlib alone, for a density-0 and a dense ``TestSynthesizer`` circuit,
  on the native and the pure-Python stream;
- a prove through the state gives the golden proof's bytes; verify accepts
  that proof, and a verifier key with another state rejects it;
- the host transcript's feed counter (``kernels.LANES["fs_absorb"]``) sees
  the three matrices once in ``index`` and no feed of a matrix's size in a
  prove, on both routes through the sumchecks.
"""

import collections
import hashlib
import random

import pytest
import torch
from torch_golden import GOLDEN, instance, keys, reuse_openings

from spartan_tpu_torch import kernels
from spartan_tpu_torch.host import native
from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.utils.errors import SpartanError
from spartan_tpu_torch.utils.transcript import FS_ABSORB, Blake2sRng

torch.set_num_threads(1)


def _matrices(density: int):
    cs, _v, _w = generate_circuit_with_random_input(
        num_public=4, num_private=28, pad_to_square=True, density=density, rng=random.Random(11))
    return cs.to_matrices()


def _chain(*parts: bytes) -> bytes:
    state = hashlib.blake2s(b"").digest()
    for p in parts:
        state = hashlib.blake2s(state + p).digest()
    return state


@pytest.mark.parametrize("stream", ["native", "python"])
@pytest.mark.parametrize("density", [0, 229])
def test_index_state_is_the_chain_over_the_matrices(density, stream, monkeypatch):
    if stream == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    assert (Blake2sRng.setup()._native is None) == (stream == "python")
    a, b, c = _matrices(density)
    pk = MLArgumentForR1CS.index(a, b, c, "cpu")
    mats = (pk.matrix_a, pk.matrix_b, pk.matrix_c)
    assert pk.fs_state == _chain(*(m.serialize() for m in mats))
    assert pk.vk().fs_state == pk.fs_state


def test_verify_starts_from_the_state():
    """The verifier key's state is the transcript's prefix: the golden proof
    verifies with it and not with the state of other matrices."""
    pk, v, _w = instance()
    _pp, vp = keys()
    proof = Proof.deserialize(GOLDEN.read_bytes())
    assert MLArgumentForR1CS.verify(pk.vk(), v, proof, vp) is True
    vk = pk.vk()
    vk.fs_state = _chain(b"another index")
    try:
        accepted = MLArgumentForR1CS.verify(vk, v, proof, vp)
    except SpartanError:
        accepted = False
    assert accepted is False


def test_index_feeds_each_matrix_once():
    kernels.reset_counts()
    pk, _v, _w = instance()
    sizes = [len(m.serialize()) for m in (pk.matrix_a, pk.matrix_b, pk.matrix_c)]
    assert kernels.LANES[FS_ABSORB] == collections.Counter((s,) for s in sizes)


@pytest.mark.parametrize("device_fs", ["1", "0"])
def test_prove_from_the_state_feeds_no_matrix(device_fs, monkeypatch):
    """A prove through the index's state gives the golden proof's bytes on
    both routes. Counted as a traced run counts (reset before the prove),
    every feed is smaller than the smallest serialized matrix; the default
    route absorbs v and the messages of rounds 1, 2, 3 and 5 on the host."""
    reuse_openings(monkeypatch)
    monkeypatch.setenv("SPARTAN_DEVICE_FS", device_fs)
    pk, v, w = instance()
    pp, _vp = keys()
    smallest = min(len(m.serialize()) for m in (pk.matrix_a, pk.matrix_b, pk.matrix_c))
    kernels.reset_counts()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp)
    assert proof.serialize() == GOLDEN.read_bytes()
    fed = kernels.LANES[FS_ABSORB]
    assert fed and max(k[0] for k in fed) < smallest
    if device_fs == "1":
        assert sum(fed.values()) == 5
